"""Attention: the plain oracle (:mod:`.attention`) and the flash kernel
(:mod:`.flash_attention`); the NHWC implicit-GEMM conv (:mod:`.conv`);
the binary cross-entropies (:mod:`.losses`)."""

from .attention import (blockwise_attention, dot_product_attention,
                        mha_attention)
from .conv import (PallasConv, conv2d, conv2d_ref, conv_dispatch_stats,
                   publish_conv_counters, reset_conv_dispatch_stats)
from .flash_attention import flash_attention
from .losses import binary_cross_entropy, binary_cross_entropy_with_logits

__all__ = ["binary_cross_entropy", "binary_cross_entropy_with_logits",
           "blockwise_attention", "dot_product_attention", "mha_attention",
           "flash_attention", "conv2d", "conv2d_ref", "PallasConv",
           "conv_dispatch_stats", "reset_conv_dispatch_stats",
           "publish_conv_counters"]
