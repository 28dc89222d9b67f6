"""Multi-tensor ops: whole-model elementwise sweeps with a device-side
overflow flag.

Counterpart of ``apex_tpu/multi_tensor/__init__.py`` (the JAX package
has no Pallas kernel here).  A "tree" is a mapping of name to tensor (a
``state_dict``-like dict, the port's parameter tree) or a list or tuple
of tensors; every op returns the same kind of container.  The sweeps run
as ``torch._foreach_*`` ops, a few launches for the whole model, with
fp32 math whatever the storage dtype, and the overflow flag stays a
tensor on the device: nothing here syncs with the host.

With ``store=`` (a :class:`~apex_tpu_torch.multi_tensor.buckets.
BucketStore`), or a :class:`~apex_tpu_torch.multi_tensor.buckets.Packed`
input, a sweep and its overflow check run over the store's few flat
buckets instead of the leaves; a ``Packed`` input gives a ``Packed``
output.
"""

from __future__ import annotations

from typing import Any, Callable, List, Mapping, Optional, Tuple

import torch

from .buckets import BucketStore, Packed

__all__ = ["flatten_tree", "tree_finite", "multi_tensor_scale",
           "multi_tensor_axpby", "multi_tensor_l2norm",
           "multi_tensor_maxnorm", "multi_tensor_lamb_stage1",
           "multi_tensor_lamb_stage2", "flatten", "unflatten",
           "MultiTensorApply", "multi_tensor_applier", "BucketStore",
           "Packed"]


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


def _as_packed(tree, store: Optional[BucketStore]):
    """``(packed, was_packed)``: a tree or an already-``Packed`` value
    through ``store``."""
    if isinstance(tree, Packed):
        return tree, True
    if store is None:
        raise ValueError(
            "mixing a Packed operand with a tree operand needs the store= "
            "that packed it (the index map to pack the other side)")
    return store.pack(tree), False


def _all_finite(xs) -> torch.Tensor:
    if not xs:
        return torch.tensor(True)
    return torch.stack([torch.isfinite(x).all() for x in xs]).all()


def tree_finite(tree, store: Optional[BucketStore] = None) -> torch.Tensor:
    """Device-side bool: every float leaf of ``tree`` is finite; with
    ``store`` (or a ``Packed`` tree) one reduction a bucket."""
    if store is not None or isinstance(tree, Packed):
        packed = tree if isinstance(tree, Packed) else store.pack(tree)
        return _all_finite(list(packed.data))
    return _all_finite(_float_leaves(tree))


def _fp32(leaves):
    return [x.float() for x in leaves]


def _bucketed(sweep, trees, store, out_dtype):
    """``sweep`` (fp32 lists -> fp32 list) over the buckets of ``trees``
    (the first decides whether the result stays ``Packed``), stored in
    ``out_dtype`` or each bucket's own; ``(out, overflow)``."""
    packed = [_as_packed(t, store) for t in trees]
    first, was_packed = packed[0]
    out = [y.to(out_dtype or x.dtype) for x, y in zip(
        first.data, sweep(*[_fp32(p.data) for p, _ in packed]))]
    result = Packed(data=tuple(out), rest=first.rest)
    if not was_packed:
        result = store.unpack(result)
    return result, torch.logical_not(_all_finite(out))


def multi_tensor_scale(tree, scale, out_dtype: Optional[torch.dtype] = None,
                       store: Optional[BucketStore] = None
                       ) -> Tuple[Any, torch.Tensor]:
    """``out = in * scale`` over every float leaf, in fp32, stored in
    ``out_dtype`` (default: each leaf's own); returns ``(out,
    overflow)``, ``overflow`` a device bool raised when any scaled value
    is inf or NaN.  ``scale`` is a float or a 0-dim tensor.  ``store``
    (or a ``Packed`` input) runs the sweep and the check per bucket."""
    if store is not None or isinstance(tree, Packed):
        return _bucketed(lambda xs: torch._foreach_mul(xs, scale), [tree],
                         store, out_dtype)
    leaves, rebuild = flatten_tree(tree)
    idx = [i for i, x in enumerate(leaves) if x.is_floating_point()]
    scaled = torch._foreach_mul(_fp32([leaves[i] for i in idx]), scale)
    out = list(leaves)
    for i, y in zip(idx, scaled):
        out[i] = y.to(out_dtype or leaves[i].dtype)
    out = rebuild(out)
    return out, torch.logical_not(tree_finite(out))


def multi_tensor_axpby(x_tree, y_tree, a, b,
                       out_dtype: Optional[torch.dtype] = None,
                       store: Optional[BucketStore] = None
                       ) -> Tuple[Any, torch.Tensor]:
    """``out = a*x + b*y`` leafwise in fp32, overflow-checked (the
    gradient-accumulation unscale ``new/scale + stashed``); ``store``
    runs it per bucket."""
    def axpby(xs, ys):
        return torch._foreach_add(torch._foreach_mul(xs, a),
                                  torch._foreach_mul(ys, b))
    if store is not None or isinstance(x_tree, Packed):
        return _bucketed(axpby, [x_tree, y_tree], store, out_dtype)
    xs, rebuild = flatten_tree(x_tree)
    ys, _ = flatten_tree(y_tree)
    idx = [i for i, x in enumerate(xs) if x.is_floating_point()]
    out = list(xs)
    for i, s in zip(idx, axpby(_fp32([xs[i] for i in idx]),
                               _fp32([ys[i] for i in idx]))):
        out[i] = s.to(out_dtype or xs[i].dtype)
    out = rebuild(out)
    return out, torch.logical_not(tree_finite(out))


def _empty_norm(per_tensor):
    zero = torch.tensor(0.0)
    return (zero, []) if per_tensor else zero


def multi_tensor_l2norm(tree, per_tensor: bool = False,
                        store: Optional[BucketStore] = None):
    """Global L2 norm over all float leaves, accumulated in fp32; with
    ``per_tensor`` also the list of per-leaf norms (the tree's flattened
    order).  ``store`` (or a ``Packed`` tree) takes the global norm from
    one reduction a bucket and the per-leaf norms from the store's
    per-leaf sums, in the same order as the leafwise path's."""
    if store is not None or isinstance(tree, Packed):
        if per_tensor and store is None:
            raise ValueError("per_tensor norms over a Packed input need "
                             "the store (the per-leaf index map)")
        packed = tree if isinstance(tree, Packed) else store.pack(tree)
        if not packed.data:
            return _empty_norm(per_tensor)
        if not per_tensor:
            norms = torch._foreach_norm(_fp32(packed.data))
            return torch.stack(norms).square().sum().sqrt()
        sums = store.per_leaf_sq_sums(packed.data)
        total = torch.stack([s.sum() for s in sums]).sum().sqrt()
        by_leaf = {}
        for b, s in zip(store.buckets, sums):
            for pos, leaf_id in enumerate(b.leaf_ids):
                by_leaf[leaf_id] = s[pos].sqrt()
        return total, [by_leaf[i] for i in store.tree_order()]
    leaves = _float_leaves(tree)
    if not leaves:
        return _empty_norm(per_tensor)
    norms = torch._foreach_norm(_fp32(leaves))
    total = torch.stack(norms).square().sum().sqrt()
    return (total, list(norms)) if per_tensor else total


def multi_tensor_maxnorm(tree, per_tensor: bool = False):
    """Global max-abs (infinity) norm over all float leaves, optionally
    per tensor (NovoGrad's ``norm_type`` inf)."""
    leaves = _float_leaves(tree)
    if not leaves:
        return _empty_norm(per_tensor)
    norms = torch._foreach_norm(_fp32(leaves), ord=float("inf"))
    total = torch.stack(norms).max()
    return (total, list(norms)) if per_tensor else total


# -- the two-stage LAMB entry points -----------------------------------------

def multi_tensor_lamb_stage1(grads, params, exp_avg, exp_avg_sq,
                             per_tensor_decay, *, beta1, beta2,
                             beta1_correction, beta2_correction, epsilon,
                             clipped_global_grad_norm):
    """Stage 1 of the two-stage LAMB (reference
    ``csrc/multi_tensor_lamb_stage_1.cu``): per leaf ``g /
    clipped_global_grad_norm``, the Adam moments, and ``update = m_hat /
    (sqrt(v_hat) + eps) + decay * p`` with one decay per leaf (the
    tree's order).  Returns ``(updates, new_exp_avg, new_exp_avg_sq)``
    in ``grads``' container."""
    gs, rebuild = flatten_tree(grads)
    ps = flatten_tree(params)[0]
    ms = flatten_tree(exp_avg)[0]
    vs = flatten_tree(exp_avg_sq)[0]
    if len(per_tensor_decay) != len(gs):
        raise ValueError("per_tensor_decay must have one entry per leaf "
                         f"({len(per_tensor_decay)} != {len(gs)})")
    upd, new_m, new_v = [], [], []
    for g, p, m, v, decay in zip(gs, ps, ms, vs, per_tensor_decay):
        sg = g.float() / clipped_global_grad_norm
        m_n = beta1 * m.float() + (1.0 - beta1) * sg
        v_n = beta2 * v.float() + (1.0 - beta2) * torch.square(sg)
        u = ((m_n / beta1_correction)
             / (torch.sqrt(v_n / beta2_correction) + epsilon)
             + decay * p.float())
        upd.append(u)
        new_m.append(m_n)
        new_v.append(v_n)
    return rebuild(upd), rebuild(new_m), rebuild(new_v)


def multi_tensor_lamb_stage2(params, updates, per_tensor_param_norm,
                             per_tensor_update_norm, learning_rate):
    """Stage 2 (reference ``csrc/multi_tensor_lamb_stage_2.cu``): per
    leaf ``ratio = lr * (p_norm / u_norm)`` where both norms are nonzero,
    ``lr`` otherwise, and ``p -= ratio * update`` (norms in the tree's
    order, e.g. from ``multi_tensor_l2norm(..., per_tensor=True)``)."""
    ps, rebuild = flatten_tree(params)
    us = flatten_tree(updates)[0]
    new_p = []
    for p, u, pn, un in zip(ps, us, per_tensor_param_norm,
                            per_tensor_update_norm):
        pn = torch.as_tensor(pn, dtype=torch.float32, device=p.device)
        un = torch.as_tensor(un, dtype=torch.float32, device=p.device)
        ratio = torch.where((pn != 0.0) & (un != 0.0),
                            learning_rate * (pn / un),
                            torch.full_like(pn, learning_rate))
        new_p.append((p.float() - ratio * u.float()).to(p.dtype))
    return rebuild(new_p)


# -- flatten / unflatten ------------------------------------------------------

def flatten(tensors) -> torch.Tensor:
    """One flat buffer of a list of tensors (reference ``apex_C.flatten``,
    DDP's flat communication buffer); the dtypes must agree."""
    return torch.cat([t.reshape(-1) for t in tensors])


def unflatten(flat, like) -> List[torch.Tensor]:
    """``flat`` split back into tensors shaped and typed like ``like``."""
    sizes = [t.numel() for t in like]
    return [seg.view(t.shape).to(t.dtype)
            for seg, t in zip(torch.split(flat, sizes), like)]


# -- the reference's applier ------------------------------------------------

class MultiTensorApply:
    """The reference's ``multi_tensor_applier(op, noop_flag, lists,
    *args)``: ``op`` is one of the functions above, called on the lists;
    the overflow flag is returned rather than written into a caller's
    buffer, and the chunking is the foreach kernels'.  ``available`` is
    always True: there is no optional extension to import."""
    available = True
    warned = False

    def __init__(self, chunk_size=2048 * 32):
        self.chunk_size = chunk_size

    def __call__(self, op, noop_flag, tensor_lists, *args):
        del noop_flag
        return op(*tensor_lists, *args)


multi_tensor_applier = MultiTensorApply(2048 * 32)
