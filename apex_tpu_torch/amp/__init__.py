"""Mixed precision — counterpart of ``apex_tpu.amp`` (reference
``apex/amp``): the opt-level presets O0-O4, the imperative API
(``initialize``, ``scale_loss``, ``state_dict``/``load_state_dict``,
``master_params``), the O1 policy (``init``/``shutdown``, the
registries and decorators, ``disable_casts``), and the functional pieces
``make_train_step`` runs (``convert_params``, ``LossScaler``).  O4 is O2
plus the int8 projections of :mod:`apex_tpu_torch.quant`."""

from ._amp_state import _amp_state, master_params
from .autocast import (cached_cast, clear_cast_cache, float_function,
                       half_function, init, promote_function,
                       register_banned_function, register_float_function,
                       register_half_function, register_promote_function,
                       shutdown)
from .frontend import initialize, load_state_dict, state_dict
from .handle import AmpHandle, NoOpHandle, disable_casts, scale_loss
from .loss_scaler import LossScaler, LossScalerState, all_finite
from .policy import (applier, convert_params, default_norm_predicate,
                     make_master, master_to_model, to_type, wrap_forward)
from .properties import AmpOptionError, Properties, opt_levels

__all__ = ["AmpHandle", "AmpOptionError", "LossScaler", "LossScalerState",
           "NoOpHandle", "Properties", "all_finite", "applier",
           "cached_cast", "clear_cast_cache", "convert_params",
           "default_norm_predicate", "disable_casts", "float_function",
           "half_function", "init", "initialize", "load_state_dict",
           "make_master", "master_params", "master_to_model",
           "opt_levels", "promote_function", "register_banned_function",
           "register_float_function", "register_half_function",
           "register_promote_function", "scale_loss", "shutdown",
           "state_dict", "to_type", "wrap_forward"]
