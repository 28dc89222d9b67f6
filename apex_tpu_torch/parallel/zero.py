"""ZeRO-1: optimizer state sharded over a process group — counterpart of
``apex_tpu/parallel/zero.py``.

JAX's mesh axis is a process group here (``axis_name``: ``"data"``, the
default group, or a ``ProcessGroup``; :func:`~apex_tpu_torch.parallel.
distributed.axis_group`), one rank a device.  The update:

* the gradients are **reduce-scattered** (mean) over the group: each
  rank receives only its 1/n chunk of the flat gradient
  (``reduce_scatter_tensor``);
* the wrapped optimizer updates that chunk only: each rank holds the
  moments (and masters) of 1/n of the parameters;
* the updated chunks are **all-gathered** back into the full parameters
  (``all_gather_into_tensor``).

The parameter tree is raveled, in JAX's leaf order (a ``state_dict``
name's dots read as levels of the flax tree, keys sorted), into one flat
vector padded to ``padded_shard_len(size, num_shards)``
(:func:`~apex_tpu_torch.multi_tensor.buckets.padded_shard_len`, the rule
the checkpoint's bucket layout records); ``bucketed=True`` ravels it
through a :class:`~apex_tpu_torch.multi_tensor.BucketStore` instead, one
padded flat buffer a parameter dtype, each sharded on its own, so a
mixed-dtype tree works.  Only elementwise optimizers qualify
(``FunctionalOptimizer.elementwise``): per-tensor norms are wrong on a
flat chunk.

Where JAX's ``init`` builds the full state and ``shard_map`` hands each
device its slice, the port's ``init`` gives each rank its own chunk
(1/n of the padded state).  :func:`zero1_init_full` builds JAX's full
state (a checkpoint's template), :func:`zero1_gather_state` and
:func:`zero1_shard_state` move between the two.

Usage::

    tx = zero1(training.adam(1e-3), "data", num_shards=world)
    init_fn, step_fn = make_train_step(
        loss_fn, tx, opt_level="O2", axis_name="data",
        reduce_grads=False)   # zero1 reduces; axis_name still agrees the
                              # overflow flag and averages the metrics

The overflow flag is OR-reduced over the group by the step, so one
rank's inf skips the step on every rank (its inf reaches the other
ranks' chunks through the reduce-scatter).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from ..multi_tensor.buckets import (BucketStore, Packed, _sort_key,
                                    cached_store, padded_shard_len)
from .distributed import COLLECTIVES, _all_reduce_, _dtype_name, \
    _note_collective, _staged, axis_group

__all__ = ["Zero1State", "zero1", "zero1_partition_spec", "zero1_init_full",
           "zero1_gather_state", "zero1_shard_state"]


class Zero1State(NamedTuple):
    inner: Any      # the wrapped optimizer's state over this rank's chunk


def _ordered_leaves(tree):
    """``tree``'s leaves in JAX's flattening order, and the indices that
    put them back in the tree's own."""
    paths, spec = pytree.tree_flatten_with_path(tree)
    order = sorted(range(len(paths)), key=lambda i: _sort_key(paths[i][0]))
    return [paths[i][1] for i in order], order, spec


def _flatten(tree) -> torch.Tensor:
    leaves, _, _ = _ordered_leaves(tree)
    dtypes = {x.dtype for x in leaves}
    if len(dtypes) != 1:
        raise ValueError(
            f"zero1 needs a uniform parameter dtype to build the flat "
            f"buffer; got {sorted(map(str, dtypes))} — under amp O2 the "
            f"fp32 masters satisfy this, or pass bucketed=True to shard "
            f"per-dtype flat buckets")
    return torch.cat([x.reshape(-1) for x in leaves])


def _unflatten(flat: torch.Tensor, like):
    leaves, order, spec = _ordered_leaves(like)
    out: list = [None] * len(leaves)
    pieces = torch.split(flat[:sum(x.numel() for x in leaves)],
                         [x.numel() for x in leaves])
    for pos, (piece, x) in enumerate(zip(pieces, leaves)):
        out[order[pos]] = piece.view(x.shape).to(x.dtype)
    return pytree.tree_unflatten(out, spec)


def _pad(flat: torch.Tensor, num_shards: int) -> torch.Tensor:
    pad = padded_shard_len(flat.numel(), num_shards) - flat.numel()
    return torch.nn.functional.pad(flat, (0, pad)) if pad else flat


def _group_and_index(axis_name, num_shards: int):
    group = axis_group(axis_name)
    if group is None:
        raise ValueError("zero1 needs an axis_name (a process group)")
    n = dist.get_world_size(group)
    if n != num_shards:
        raise ValueError(f"zero1 was built for num_shards={num_shards}; the "
                         f"group has {n} ranks")
    return group, n, dist.get_rank(group)


def _chunk(flat: torch.Tensor, n: int, idx: int) -> torch.Tensor:
    c = flat.numel() // n
    return flat[idx * c:(idx + 1) * c]


def _reduce_scatter(flat: torch.Tensor, group, n: int, axis_name,
                    op: str = "psum_scatter"):
    dev = flat.device
    flat = flat.contiguous()
    if _staged(group, flat, "reduce-scatter"):
        flat = flat.cpu()
    out = torch.empty(flat.numel() // n, dtype=flat.dtype,
                      device=flat.device)
    dist.reduce_scatter_tensor(out, flat, op=dist.ReduceOp.SUM, group=group)
    out = out.to(dev)
    COLLECTIVES["reduce_scatter"].launches += 1
    _note_collective(op, axis_name, group,
                     flat.numel() * flat.element_size(), 1,
                     {_dtype_name(flat.dtype)})
    return out


def _all_gather(local: torch.Tensor, group, n: int, axis_name):
    dev = local.device
    local = local.contiguous()
    if _staged(group, local, "all-gather"):
        local = local.cpu()
    out = torch.empty(local.numel() * n, dtype=local.dtype,
                      device=local.device)
    dist.all_gather_into_tensor(out, local, group=group)
    out = out.to(dev)
    COLLECTIVES["all_gather"].launches += 1
    _note_collective("all_gather", axis_name, group,
                     out.numel() * out.element_size(), 1,
                     {_dtype_name(out.dtype)})
    return out


def _shard_one(flat_p, flat_g, inner, tx, group, n, idx, num_shards,
               axis_name, apply_mask, kw, *, pre=None, denom=None):
    """Reduce-scatter, local update and gather for one flat buffer.

    ``pre`` ``(group, axis_name)`` (JAX's ``pre_axes``) sums the
    scattered chunk over another group before the update (the mesh's
    pure-DP axis: replicas that hold the same chunks but saw other data);
    ``denom`` is the mean's divisor (default ``n``)."""
    size = flat_p.numel()
    flat_p, flat_g = _pad(flat_p, num_shards), _pad(flat_g, num_shards)
    g_local = _reduce_scatter(flat_g, group, n, axis_name)
    if pre is not None and dist.get_world_size(pre[0]) > 1:
        g_local = _all_reduce_(g_local, pre[0], "grads", pre[1])
    g_local = g_local / (n if denom is None else denom)
    new_local, new_inner = tx.update(g_local, inner,
                                     _chunk(flat_p, n, idx),
                                     apply_mask=apply_mask, **kw)
    new_local = new_local.to(flat_p.dtype)      # parameters keep theirs
    return _all_gather(new_local, group, n, axis_name)[:size], new_inner


def zero1(tx, axis_name, *, num_shards: int, bucketed: bool = False):
    """Wrap a :class:`~apex_tpu_torch.training.FunctionalOptimizer` with
    ZeRO-1 state sharding over ``axis_name`` (``num_shards`` its size).

    ``init(params)`` gives this rank's :class:`Zero1State`: the wrapped
    optimizer's state over its 1/n chunk of the padded flat parameters
    (one chunk a bucket with ``bucketed=True``).  ``update`` reduces the
    gradients itself, so the train step is built with
    ``reduce_grads=False`` and ``axis_name`` kept (the overflow
    agreement and the metric mean).  Refused: an optimizer that does not
    declare ``elementwise=True`` (LAMB, NovoGrad, unknown ones) and, on
    the flat path, a tree of mixed dtypes."""
    from ..training import FunctionalOptimizer

    if not getattr(tx, "elementwise", False):
        raise ValueError(
            "zero1 requires an optimizer that declares elementwise=True "
            "(FunctionalOptimizer capability flag) — adam/sgd qualify; "
            "per-tensor-norm optimizers (lamb, novograd) compute wrong "
            "trust ratios on arbitrary flat chunks, and unknown optimizers "
            "are rejected by default.  Shard at tensor granularity instead, "
            "or set elementwise=True on your FunctionalOptimizer if its "
            "update truly treats every element independently")

    if bucketed:
        cell: dict = {}

        def init(params):
            _, n, idx = _group_and_index(axis_name, num_shards)
            packed = cached_store(cell, params).pack(params)
            return Zero1State(inner=tuple(
                tx.init(_chunk(_pad(b, num_shards), n, idx).clone())
                for b in packed.data))

        def update(grads, state, params, *, apply_mask=None, **kw):
            group, n, idx = _group_and_index(axis_name, num_shards)
            store = cached_store(cell, params)
            packed_p = store.pack(params)
            packed_g = store.pack(grads, cast=True)
            new_data, new_inner = [], []
            for flat_p, flat_g, st in zip(packed_p.data, packed_g.data,
                                          state.inner):
                flat_new, ni = _shard_one(
                    flat_p, flat_g.to(flat_p.dtype), st, tx, group, n, idx,
                    num_shards, axis_name, apply_mask, kw)
                new_data.append(flat_new)
                new_inner.append(ni)
            out = Packed(data=tuple(new_data), rest=packed_p.rest)
            return store.unpack(out), Zero1State(inner=tuple(new_inner))

        return FunctionalOptimizer(init=init, update=update,
                                   elementwise=True)

    def init(params):
        flat = _pad(_flatten(params), num_shards)
        _, n, idx = _group_and_index(axis_name, num_shards)
        return Zero1State(inner=tx.init(_chunk(flat, n, idx).clone()))

    def update(grads, state, params, *, apply_mask=None, **kw):
        group, n, idx = _group_and_index(axis_name, num_shards)
        flat_p = _flatten(params)
        flat_g = _flatten(grads).to(flat_p.dtype)
        flat_new, new_inner = _shard_one(
            flat_p, flat_g, state.inner, tx, group, n, idx, num_shards,
            axis_name, apply_mask, kw)
        return _unflatten(flat_new, params), Zero1State(inner=new_inner)

    return FunctionalOptimizer(init=init, update=update, elementwise=True)


def zero1_partition_spec(state: Zero1State, axis_name):
    """Which leaves of a :class:`Zero1State` are this rank's shards: a
    :class:`Zero1State` of the same structure whose leaves stand in for
    JAX's ``PartitionSpec`` — ``axis_name`` (JAX's ``P(axis)``) for a
    flat leaf that holds this rank's 1/n chunk, None (JAX's ``P()``) for
    a replicated scalar such as the step count."""
    return Zero1State(inner=pytree.tree_map(
        lambda leaf: axis_name if leaf.dim() >= 1 else None, state.inner))


def zero1_init_full(tx, params, *, num_shards: int,
                    bucketed: bool = False) -> Zero1State:
    """JAX's zero1 ``init``: the FULL state over the padded flat
    parameters (every chunk of every rank), built in one process without
    a group — the template a zero1 checkpoint restores against at
    ``num_shards`` (:func:`zero1_shard_state` then takes a rank's
    chunk)."""
    if bucketed:
        packed = BucketStore(params).pack(params)
        return Zero1State(inner=tuple(tx.init(_pad(b, num_shards))
                                      for b in packed.data))
    return Zero1State(inner=tx.init(_pad(_flatten(params), num_shards)))


def zero1_gather_state(state: Zero1State, axis_name) -> Zero1State:
    """Every rank's chunks all-gathered into the full state (the one
    :func:`zero1_init_full` lays out), replicated on every rank: what a
    checkpoint of the state holds."""
    group = axis_group(axis_name)
    n = dist.get_world_size(group)
    leaves, spec = pytree.tree_flatten(state)
    return pytree.tree_unflatten(
        [_all_gather(x, group, n, axis_name) if x.dim() >= 1 else x
         for x in leaves], spec)


def zero1_shard_state(full: Zero1State, axis_name) -> Zero1State:
    """This rank's chunk of a full state (the inverse of
    :func:`zero1_gather_state`; no collective)."""
    group = axis_group(axis_name)
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    return pytree.tree_map(
        lambda leaf: _chunk(leaf, n, idx).clone() if leaf.dim() >= 1
        else leaf, full)
