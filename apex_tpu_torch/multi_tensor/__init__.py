"""Multi-tensor ops: whole-model elementwise sweeps with a device-side
overflow flag.

Counterpart of ``apex_tpu/multi_tensor/__init__.py:64-200`` (the leafwise
path; the JAX package has no Pallas kernel here).  A "tree" is a mapping
of name to tensor (a ``state_dict``-like dict, the port's parameter
tree) or a list or tuple of tensors; every op returns the same kind of
container.  The sweeps run as ``torch._foreach_*`` ops, a few launches
for the whole model, with fp32 math whatever the storage dtype, and the
overflow flag stays a tensor on the device: nothing here syncs with the
host.
"""

from __future__ import annotations

from typing import Any, Callable, List, Mapping, Optional, Tuple

import torch

__all__ = ["flatten_tree", "tree_finite", "multi_tensor_scale",
           "multi_tensor_axpby", "multi_tensor_l2norm"]


def flatten_tree(tree) -> Tuple[List[torch.Tensor], Callable[[list], Any]]:
    """``(leaves, rebuild)``: the tensors of a dict (in its order) or of a
    list/tuple, and the function that puts new leaves back in the same
    container."""
    if isinstance(tree, Mapping):
        keys = list(tree)
        return [tree[k] for k in keys], lambda xs: dict(zip(keys, xs))
    kind = type(tree)
    return list(tree), lambda xs: kind(xs)


def _float_leaves(tree) -> List[torch.Tensor]:
    return [x for x in flatten_tree(tree)[0] if x.is_floating_point()]


def tree_finite(tree) -> torch.Tensor:
    """Device-side bool: every float leaf of ``tree`` is finite."""
    leaves = _float_leaves(tree)
    if not leaves:
        return torch.tensor(True)
    return torch.stack([torch.isfinite(x).all() for x in leaves]).all()


def _fp32(leaves):
    return [x.float() for x in leaves]


def multi_tensor_scale(tree, scale, out_dtype: Optional[torch.dtype] = None
                       ) -> Tuple[Any, torch.Tensor]:
    """``out = in * scale`` over every float leaf, in fp32, stored in
    ``out_dtype`` (default: each leaf's own); returns ``(out,
    overflow)``, ``overflow`` a device bool raised when any scaled value
    is inf or NaN.  ``scale`` is a float or a 0-dim tensor."""
    leaves, rebuild = flatten_tree(tree)
    idx = [i for i, x in enumerate(leaves) if x.is_floating_point()]
    scaled = torch._foreach_mul(_fp32([leaves[i] for i in idx]), scale)
    out = list(leaves)
    for i, y in zip(idx, scaled):
        out[i] = y.to(out_dtype or leaves[i].dtype)
    out = rebuild(out)
    return out, torch.logical_not(tree_finite(out))


def multi_tensor_axpby(x_tree, y_tree, a, b,
                       out_dtype: Optional[torch.dtype] = None
                       ) -> Tuple[Any, torch.Tensor]:
    """``out = a*x + b*y`` leafwise in fp32, overflow-checked (the
    gradient-accumulation unscale ``new/scale + stashed``)."""
    xs, rebuild = flatten_tree(x_tree)
    ys, _ = flatten_tree(y_tree)
    idx = [i for i, x in enumerate(xs) if x.is_floating_point()]
    ax = torch._foreach_mul(_fp32([xs[i] for i in idx]), a)
    by = torch._foreach_mul(_fp32([ys[i] for i in idx]), b)
    out = list(xs)
    for i, s in zip(idx, torch._foreach_add(ax, by)):
        out[i] = s.to(out_dtype or xs[i].dtype)
    out = rebuild(out)
    return out, torch.logical_not(tree_finite(out))


def multi_tensor_l2norm(tree, per_tensor: bool = False):
    """Global L2 norm over all float leaves, accumulated in fp32; with
    ``per_tensor`` also the list of per-leaf norms (flattened order)."""
    leaves = _float_leaves(tree)
    if not leaves:
        zero = torch.tensor(0.0)
        return (zero, []) if per_tensor else zero
    norms = torch._foreach_norm(_fp32(leaves))
    total = torch.stack(norms).square().sum().sqrt()
    return (total, list(norms)) if per_tensor else total
