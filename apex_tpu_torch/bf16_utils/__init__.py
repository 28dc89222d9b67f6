"""The legacy manual mixed-precision API — counterpart of
``apex_tpu.bf16_utils`` (reference ``apex/fp16_utils``); "half" is
bfloat16, and :mod:`apex_tpu_torch.fp16_utils` is an alias."""

from .bf16util import (BF16Model, BN_convert_float, FP16Model,
                       clip_grad_norm, convert_module, convert_network,
                       master_params_to_model_params,
                       model_grads_to_master_grads, network_to_half,
                       prep_param_lists, to_bf16, to_half, tofp16)
from .fp16_optimizer import FP16_Optimizer
from .loss_scaler import DynamicLossScaler, LossScaler

__all__ = ["BF16Model", "BN_convert_float", "DynamicLossScaler",
           "FP16Model", "FP16_Optimizer", "LossScaler", "clip_grad_norm",
           "convert_module", "convert_network",
           "master_params_to_model_params", "model_grads_to_master_grads",
           "network_to_half", "prep_param_lists", "to_bf16", "to_half",
           "tofp16"]
