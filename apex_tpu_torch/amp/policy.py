"""Dtype policies: the recursive caster, the parameter cast that keeps
norms fp32, the O2/O3 forward wrapper and the master copies.

Counterpart of ``apex_tpu/amp/policy.py``.  The JAX package walks a flax
pytree and tests each leaf's path; the port's parameter tree is a
``state_dict``-like mapping, and the same ``_NORM_PATH_RE`` is applied to
its names (``block_3.ln1.scale``, ``ln_f.bias``), so both packages keep
the same leaves fp32.  :func:`applier` and :func:`to_type` walk any
nesting of dicts, lists and tuples (torch's pytree); integer and bool
tensors pass through.
"""

from __future__ import annotations

import functools
import re
from typing import Any, Callable, Dict, Mapping, Optional

import torch
from torch.utils import _pytree as pytree

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


def applier(value: Any, fn: Callable[[torch.Tensor], Any]) -> Any:
    """``fn`` applied to every tensor of ``value`` (any nesting of
    dicts, lists and tuples); everything else passes through (reference
    ``_initialize.py:35-57``)."""
    return pytree.tree_map(
        lambda x: fn(x) if isinstance(x, torch.Tensor) else x, value)


def to_type(dtype: torch.dtype, value: Any) -> Any:
    """``value`` with every floating tensor cast to ``dtype``; integer
    and bool tensors (ids, masks) stay as they are."""
    return applier(value, lambda x: x.to(dtype) if x.is_floating_point()
                   else x)


def wrap_forward(apply_fn: Callable, cast_input_type=None,
                 cast_output_type=torch.float32) -> Callable:
    """``apply_fn`` with its floating inputs cast to ``cast_input_type``
    and its floating outputs to ``cast_output_type`` (None leaves a side
    as it is): the O2/O3 model forward (reference
    ``_initialize.py:181-219``; outputs fp32 unless
    ``cast_model_outputs``).  ``.to`` is differentiable, so gradients
    flow back through both casts."""
    @functools.wraps(apply_fn)
    def wrapped(*args, **kwargs):
        if cast_input_type is not None:
            args = to_type(cast_input_type, args)
            kwargs = to_type(cast_input_type, kwargs)
        out = apply_fn(*args, **kwargs)
        if cast_output_type is not None:
            out = to_type(cast_output_type, out)
        return out
    wrapped.__amp_original__ = apply_fn
    return wrapped


def make_master(params: Any) -> Any:
    """fp32 copies of the floating tensors of ``params``, detached (the
    reference's ``param.detach().clone().float()``,
    ``_process_optimizer.py:43-51``); other tensors pass through."""
    return applier(params, lambda x: x.detach().to(torch.float32, copy=True)
                   if x.is_floating_point() else x)


def master_to_model(master_params: Any, model_params: Any) -> Any:
    """The masters cast back to the model's dtypes, leaf by leaf (the
    post-step copy, reference ``_process_optimizer.py:345-356``)."""
    masters, spec = pytree.tree_flatten(master_params)
    models = pytree.tree_leaves(model_params)
    return pytree.tree_unflatten(
        [m.to(p.dtype) if p.is_floating_point() else m
         for m, p in zip(masters, models)], spec)
