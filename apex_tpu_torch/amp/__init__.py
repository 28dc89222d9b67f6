"""Mixed precision: the opt-level presets, the parameter cast and the
functional loss scaler (the imperative ``amp.initialize`` API and O4
wait)."""

from .loss_scaler import LossScaler, LossScalerState
from .policy import convert_params, default_norm_predicate
from .properties import AmpOptionError, Properties, opt_levels

__all__ = ["AmpOptionError", "LossScaler", "LossScalerState", "Properties",
           "convert_params", "default_norm_predicate", "opt_levels"]
