"""``amp.initialize`` and the amp checkpoint state — counterpart of
``apex_tpu/amp/frontend.py`` (reference ``apex/amp/frontend.py:195-400``
and ``_initialize.py``), over ``nn.Module``s and the fused optimizer
classes:

* O2/O3: each module is cast in place (``convert_params``'s rule: every
  floating parameter to the half dtype, the norms' kept fp32 at O2 by
  ``default_norm_predicate``; parameter identities kept), its forward
  wrapped by ``wrap_forward`` (floating inputs to the half dtype,
  outputs to ``cast_model_outputs`` or fp32), and each optimizer wired:
  fp32 masters in its ``param_groups`` at O2 (the reference's
  ``_process_optimizer``, JAX's ``_amp_wire``), its store and state
  rebuilt on the cast parameters at O3;
* O1: the autocast mode is pushed (``autocast.init``); parameters stay
  fp32;
* O0: everything fp32.

One scaler is made per loss (``num_losses``); lists in give lists out;
``enabled=False`` pops the O1 mode and returns its inputs untouched.
Refused as in the reference: reduced-precision parameters below O3, an
optimizer passed twice, a wrapped ``FP16_Optimizer``.

``state_dict``/``load_state_dict`` write and read every scaler's
``{"loss_scale", "unskipped"}`` under ``loss_scaler{i}``: the
reference's format and the JAX package's, so one package reads the
other's.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from . import autocast
from ._amp_state import _amp_state, maybe_print, warn_or_err
from .loss_scaler import LossScaler
from .policy import convert_params, wrap_forward
from .properties import AmpOptionError, Properties, opt_levels


def initialize(models=None, optimizers=None, enabled: bool = True,
               opt_level: str = "O1", cast_model_type=None,
               patch_functions=None, keep_batchnorm_fp32=None,
               master_weights=None, loss_scale=None,
               cast_model_outputs=None, num_losses: int = 1,
               verbosity: int = 1, min_loss_scale=None,
               max_loss_scale: float = 2.**24, norm_predicate=None):
    """Initialize mixed precision; returns ``(models, optimizers)``
    shaped like the inputs (one object in, one out; a list in, a list
    out), or just the one that was given."""
    _amp_state.verbosity = verbosity
    if not enabled:
        autocast.shutdown()
        _amp_state.opt_properties = Properties()
        return _unlistify(models, optimizers, True, True,
                          models is not None, optimizers is not None)
    if opt_level not in opt_levels:
        raise AmpOptionError(
            "Unexpected optimization level {!r}; options are 'O0', 'O1', "
            "'O2', 'O3', 'O4'. Note the 'O' is the letter O.".format(
                opt_level))
    properties = opt_levels[opt_level]()
    maybe_print("apex_tpu_torch.amp: opt_level {}".format(opt_level), True)
    overrides = dict(cast_model_type=cast_model_type,
                     patch_functions=patch_functions,
                     keep_batchnorm_fp32=keep_batchnorm_fp32,
                     master_weights=master_weights, loss_scale=loss_scale,
                     cast_model_outputs=cast_model_outputs)
    for k, v in overrides.items():
        if v is not None:
            setattr(properties, k, v)

    models_was_list = isinstance(models, (list, tuple))
    opts_was_list = isinstance(optimizers, (list, tuple))
    model_list = (list(models) if models_was_list
                  else [] if models is None else [models])
    opt_list = (list(optimizers) if opts_was_list
                else [] if optimizers is None else [optimizers])
    _check_models(model_list)
    _check_optimizers(opt_list)
    if opt_level != "O3":
        _check_params_fp32(model_list)
    for opt in opt_list:
        if getattr(opt, "_amp_wired", False):
            warn_or_err("An optimizer was passed to amp.initialize twice; "
                        "call initialize once with all models and "
                        "optimizers.")

    _amp_state.opt_properties = properties
    _amp_state.loss_scalers = [
        LossScaler(properties.loss_scale, min_loss_scale=min_loss_scale,
                   max_loss_scale=max_loss_scale)
        for _ in range(num_losses)]

    cast_type = properties.cast_model_type
    if cast_type is not None and cast_type != torch.float32:
        keep_bn = properties.keep_batchnorm_fp32
        for model in model_list:
            _cast_module(model, cast_type,
                         True if keep_bn is None else keep_bn,
                         norm_predicate)
            model.forward = wrap_forward(
                model.forward, cast_type,
                properties.cast_model_outputs or torch.float32)

    if properties.patch_functions:
        autocast.init(enabled=True, verbose=verbosity >= 2)
    else:
        _amp_state.autocast_enabled = False

    names = {}
    for model in model_list:
        for name, p in model.named_parameters():
            names.setdefault(id(p), name)
    for i, opt in enumerate(opt_list):
        if hasattr(opt, "_amp_wire"):
            opt._amp_wire(properties,
                          _amp_state.loss_scalers[min(i, num_losses - 1)],
                          names=names, norm_predicate=norm_predicate)
    return _unlistify(model_list, opt_list, models_was_list, opts_was_list,
                      models is not None, optimizers is not None)


def _cast_module(model: nn.Module, dtype, keep_norm_fp32: bool,
                 norm_predicate) -> None:
    """Every floating parameter of ``model`` cast in place to ``dtype``
    by ``convert_params``'s rule (the ``nn.Parameter`` objects are
    kept, so an optimizer's references stay valid)."""
    params = dict(model.named_parameters())
    cast = convert_params({k: v.detach() for k, v in params.items()}, dtype,
                          keep_norm_fp32=keep_norm_fp32,
                          norm_predicate=norm_predicate)
    for name, p in params.items():
        if cast[name].dtype != p.dtype:
            p.data = cast[name]


def _check_models(model_list):
    """Modules only, and not yet wrapped (reference
    ``_initialize.py:60-72``): torch's parallel wrappers and the port's
    own :class:`~apex_tpu_torch.parallel.DistributedDataParallel`."""
    from ..parallel.distributed import DistributedDataParallel
    for model in model_list:
        if not isinstance(model, nn.Module):
            raise TypeError(
                "amp.initialize takes torch.nn.Module models, got "
                f"{type(model).__name__}")
        if isinstance(model, (nn.parallel.DistributedDataParallel,
                              nn.DataParallel, DistributedDataParallel)):
            raise RuntimeError(
                "Incoming model is an instance of {}. Parallel wrappers "
                "should only be applied to the model(s) AFTER \nthe "
                "model(s) have been returned from amp.initialize.".format(
                    type(model).__name__))


def _check_params_fp32(model_list):
    """Reduced-precision incoming parameters are refused below O3
    (reference ``_initialize.py:75-112``)."""
    for model in model_list:
        for name, p in model.named_parameters():
            if p.is_floating_point() and p.dtype != torch.float32:
                warn_or_err(
                    "Found param {} with dtype {}, expected float32.\n"
                    "When using amp.initialize, you do not need to cast "
                    "your model to\nreduced precision before passing it, no "
                    "matter what optimization level\nyou choose.".format(
                        name, p.dtype))


def _check_optimizers(opt_list):
    """A wrapped ``FP16_Optimizer`` is refused (reference
    ``_initialize.py:115-126``)."""
    from ..bf16_utils.fp16_optimizer import FP16_Optimizer as _general
    from ..optimizers.fp16_optimizer import FP16_Optimizer as _fused
    for optim in opt_list:
        bad = None
        if isinstance(optim, _general):
            bad = "apex_tpu_torch.bf16_utils.FP16_Optimizer"
        if isinstance(optim, _fused):
            bad = "apex_tpu_torch.optimizers.FP16_Optimizer"
        if bad is not None:
            raise RuntimeError(
                "An incoming optimizer is an instance of {}. The "
                "optimizer(s) passed to amp.initialize() must be bare \n"
                "instances of the fused optimizers (master weights are "
                "wired in by\namp.initialize itself).\n".format(bad))


def _unlistify(models, optimizers, models_was_list, opts_was_list,
               had_models, had_optimizers):
    m = models if models_was_list else (
        models[0] if isinstance(models, list) and models else models)
    o = optimizers if opts_was_list else (
        optimizers[0] if isinstance(optimizers, list) and optimizers
        else optimizers)
    if had_models and had_optimizers:
        return m, o
    if had_models:
        return m
    if had_optimizers:
        return o
    return None


def state_dict(destination: Optional[dict] = None) -> dict:
    """Every loss scaler's state (reference ``frontend.py:361-370``)."""
    if destination is None:
        destination = {}
    for idx, ls in enumerate(_amp_state.loss_scalers):
        destination["loss_scaler%d" % idx] = ls.state_dict()
    return destination


def load_state_dict(sd: dict) -> None:
    """Restore the scalers (reference ``frontend.py:373-400``), warning
    on a count mismatch and loading the overlap."""
    n_src, n_dst = len(sd), len(_amp_state.loss_scalers)
    if n_src != n_dst:
        print("Warning: state dict has {} loss scalers, amp has {}; loading "
              "the overlap.".format(n_src, n_dst))
    for idx, ls in enumerate(_amp_state.loss_scalers):
        key = "loss_scaler%d" % idx
        if key in sd:
            ls.load_state_dict(sd[key])
