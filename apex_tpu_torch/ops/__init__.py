"""Attention: the plain oracle (:mod:`.attention`) and the flash kernel
(:mod:`.flash_attention`)."""

from .attention import blockwise_attention, dot_product_attention
from .flash_attention import flash_attention

__all__ = ["blockwise_attention", "dot_product_attention",
           "flash_attention"]
