"""Opt-level frontend: the ``Properties`` option struct and the O0-O4
presets.

Counterpart of ``apex_tpu/amp/properties.py``: every assignment is
validated, incompatible combinations raise ``AmpOptionError``, and the
presets carry the JAX package's defaults — the half type is bfloat16,
static loss scale 1.0 at every level (dynamic on request), and
``cast_model_outputs`` unset (an O2/O3 model's outputs come back fp32).
O4 is O2's storage and scaling semantics exactly plus ``quantize=True``:
the int8 routing is a property of the model (``quant=``,
:mod:`apex_tpu_torch.quant`).
"""

from __future__ import annotations

import torch


class AmpOptionError(ValueError):
    pass


_DTYPE_NAMES = {
    "float32": torch.float32,
    "fp32": torch.float32,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
    "float16": torch.float16,
    "fp16": torch.float16,
}


def _canonical_dtype(value):
    """Accept torch dtypes or string names; return a torch dtype or
    None."""
    if value is None or value is False:
        return None
    if isinstance(value, torch.dtype):
        return value
    if isinstance(value, str):
        try:
            return _DTYPE_NAMES[value.lower()]
        except KeyError:
            raise AmpOptionError(
                "Unsupported cast type {!r}; expected one of {}".format(
                    value, sorted(_DTYPE_NAMES))) from None
    raise AmpOptionError(f"Unsupported cast type {value!r}")


class Properties:
    """Mutable option struct with consistency checking on every
    assignment: unknown options raise, and a few combinations are
    rejected when they are set."""

    def __init__(self):
        self.__dict__["options"] = {
            "enabled": False,
            "opt_level": None,
            "cast_model_type": None,
            "patch_functions": False,
            "keep_batchnorm_fp32": None,
            "master_weights": None,
            "loss_scale": 1.0,
            "cast_model_outputs": None,
            "quantize": False,
        }

    def _update_options_dict(self, new_options):
        for k, v in new_options.items():
            if k not in self.options:
                raise AmpOptionError(
                    "Tried to set unexpected option {!r}".format(k))
            setattr(self, k, v)

    def __getattr__(self, name):
        if "options" in self.__dict__ and name in self.__dict__["options"]:
            return self.__dict__["options"][name]
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if name not in self.__dict__.get("options", {}):
            raise AmpOptionError(
                "Tried to set unexpected option {!r}".format(name))
        if name == "cast_model_type":
            value = _canonical_dtype(value)
            if self.opt_level == "O1" and value is not None:
                raise AmpOptionError(
                    "O1 inserts casts around individual ops rather than "
                    "casting the model; cast_model_type is not allowed "
                    "with opt_level O1.")
        elif name == "patch_functions":
            if value and self.opt_level in ("O2", "O3", "O4"):
                raise AmpOptionError(
                    "patch_functions (the O1 autocast policy) cannot be "
                    "combined with a whole-model cast (O2/O3/O4).")
            if value and self.options.get("quantize"):
                raise AmpOptionError(
                    "patch_functions (the O1 autocast policy) cannot be "
                    "combined with quantize (the O4 int8 path composes "
                    "with a whole-model cast, O2 semantics).")
        elif name == "keep_batchnorm_fp32":
            if isinstance(value, str):
                if value.lower() not in ("true", "false"):
                    raise AmpOptionError(
                        "keep_batchnorm_fp32 must be a bool or the strings "
                        "'True'/'False', got {!r}".format(value))
                value = value.lower() == "true"
            if value is not None and not isinstance(value, bool):
                raise AmpOptionError(
                    "keep_batchnorm_fp32 must be a bool, a 'True'/'False' "
                    "string, or None, got {!r}".format(value))
        elif name == "loss_scale":
            if value != "dynamic" and value is not None:
                value = float(value)
                if value <= 0.0:
                    raise AmpOptionError("loss_scale must be positive")
        elif name == "cast_model_outputs":
            value = _canonical_dtype(value)
        elif name == "quantize":
            if not isinstance(value, bool):
                raise AmpOptionError(
                    "quantize must be a bool, got {!r}".format(value))
            if value and self.patch_functions:
                raise AmpOptionError(
                    "quantize (the O4 int8 path) composes with a "
                    "whole-model cast (O2 semantics), not with the O1 "
                    "autocast policy.")
        self.__dict__["options"][name] = value

    def __repr__(self):
        return "Properties({})".format(
            ", ".join("{}={!r}".format(k, v) for k, v in self.options.items()))

    @property
    def half_dtype(self):
        """The reduced-precision dtype in play: ``cast_model_type`` for
        O2-O4, bfloat16 for the O1 policy, None for O0."""
        if self.cast_model_type is not None:
            return self.cast_model_type
        if self.patch_functions:
            return torch.bfloat16
        return None


def _make_preset(name, doc, **opts):
    def build():
        p = Properties()
        p.__dict__["options"]["enabled"] = True
        p.__dict__["options"]["opt_level"] = name
        for k, v in opts.items():
            setattr(p, k, v)
        return p
    build.__name__ = name
    build.__doc__ = doc
    return build


O4 = _make_preset(
    "O4", "Calibrated int8 mixed precision: O2's storage semantics exactly "
          "(bf16 model cast, fp32 norms, fp32 master weights, loss "
          "scaling) plus the models' quant= projections on the int8 "
          "kernel.  Without a frozen calibration every site runs bitwise "
          "as O2.",
    cast_model_type=torch.bfloat16, patch_functions=False,
    keep_batchnorm_fp32=True, master_weights=True, loss_scale=1.0,
    quantize=True)

O3 = _make_preset(
    "O3", "Pure reduced precision (bf16). Fast but no fp32 batchnorm "
          "safety net.",
    cast_model_type=torch.bfloat16, patch_functions=False,
    keep_batchnorm_fp32=False, master_weights=False, loss_scale=1.0)

O2 = _make_preset(
    "O2", "'Almost bf16' mixed precision: bf16 model with fp32 norms, "
          "fp32 master weights, static loss scale 1.0 (dynamic on "
          "request).",
    cast_model_type=torch.bfloat16, patch_functions=False,
    keep_batchnorm_fp32=True, master_weights=True, loss_scale=1.0)

O1 = _make_preset(
    "O1", "Insert casts per-op via the autocast policy: matmul/conv run "
          "bf16, reductions and losses run fp32. Model weights stay fp32.",
    cast_model_type=None, patch_functions=True, keep_batchnorm_fp32=None,
    master_weights=False, loss_scale=1.0)

O0 = _make_preset(
    "O0", "Pure fp32 baseline.",
    cast_model_type=torch.float32, patch_functions=False,
    keep_batchnorm_fp32=None, master_weights=False, loss_scale=1.0)

opt_levels = {"O4": O4, "O3": O3, "O2": O2, "O1": O1, "O0": O0}
