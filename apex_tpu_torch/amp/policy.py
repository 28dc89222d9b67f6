"""Casting a parameter tree to the compute dtype, keeping norms fp32.

Counterpart of ``apex_tpu/amp/policy.py:57-107``.  The JAX package walks
a flax pytree and tests each leaf's path; the port's parameter tree is a
``state_dict``-like mapping, and the same ``_NORM_PATH_RE`` is applied to
its names (``block_3.ln1.scale``, ``ln_f.bias``), so both packages keep
the same leaves fp32.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Mapping, Optional

import torch

# Normalization parameters live under a module path containing one of
# these markers; ``convert_params`` keeps a matching leaf fp32 when
# keep_norm_fp32 is set.
_NORM_PATH_RE = re.compile(r"(?:^|[/._])(?:bn|batchnorm|batch_norm|norm|ln|layernorm|"
                           r"layer_norm|groupnorm|group_norm|batch_stats)(?:$|[/._\d])",
                           re.IGNORECASE)


def default_norm_predicate(path: str) -> bool:
    """True if a parameter name looks like it belongs to a normalization
    layer."""
    return bool(_NORM_PATH_RE.search(path))


def convert_params(params: Mapping[str, torch.Tensor], dtype: torch.dtype,
                   keep_norm_fp32: bool = True,
                   norm_predicate: Optional[Callable[[str], bool]] = None
                   ) -> Dict[str, torch.Tensor]:
    """Cast every float tensor of ``params`` to ``dtype``, keeping the
    normalization parameters fp32 when ``keep_norm_fp32``; other tensors
    pass through.  ``.to`` is differentiable, so gradients with respect
    to the result flow back to ``params`` in their own dtype."""
    pred = norm_predicate or default_norm_predicate

    def cast(name, x):
        if not x.is_floating_point():
            return x
        if keep_norm_fp32 and pred(name):
            return x.to(torch.float32)
        return x.to(dtype)

    return {name: cast(name, x) for name, x in params.items()}
