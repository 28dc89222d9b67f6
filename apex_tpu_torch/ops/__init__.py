"""Attention: the plain oracle (:mod:`.attention`) and the flash kernel
(:mod:`.flash_attention`); the NHWC implicit-GEMM conv (:mod:`.conv`)."""

from .attention import blockwise_attention, dot_product_attention
from .conv import (PallasConv, conv2d, conv2d_ref, conv_dispatch_stats,
                   reset_conv_dispatch_stats)
from .flash_attention import flash_attention

__all__ = ["blockwise_attention", "dot_product_attention",
           "flash_attention", "conv2d", "conv2d_ref", "PallasConv",
           "conv_dispatch_stats", "reset_conv_dispatch_stats"]
