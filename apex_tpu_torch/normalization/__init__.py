"""Normalization: the fused LayerNorm kernels and module, and the fused
BN epilogue kernels."""

from .fused_bn_act import bn_act_epilogue_ref, bn_relu_residual
from .fused_layer_norm import (FusedLayerNorm, fused_layer_norm,
                               fused_layer_norm_affine)

__all__ = ["FusedLayerNorm", "bn_act_epilogue_ref", "bn_relu_residual",
           "fused_layer_norm", "fused_layer_norm_affine"]
