"""Mixed precision: the opt-level presets O0-O4, the parameter cast and
the functional loss scaler (the imperative ``amp.initialize`` API
waits).  O4 is O2 plus the int8 projections of :mod:`apex_tpu_torch.quant`."""

from .loss_scaler import LossScaler, LossScalerState, all_finite
from .policy import convert_params, default_norm_predicate
from .properties import AmpOptionError, Properties, opt_levels

__all__ = ["AmpOptionError", "LossScaler", "LossScalerState", "Properties",
           "all_finite", "convert_params", "default_norm_predicate",
           "opt_levels"]
