"""Normalization: the fused LayerNorm kernels and module."""

from .fused_layer_norm import (FusedLayerNorm, fused_layer_norm,
                               fused_layer_norm_affine)

__all__ = ["FusedLayerNorm", "fused_layer_norm", "fused_layer_norm_affine"]
