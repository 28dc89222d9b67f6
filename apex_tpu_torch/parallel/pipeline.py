"""Pipeline parallelism: the SPMD pipeline over a process group —
counterpart of ``apex_tpu/parallel/pipeline.py``.

As in JAX it is one program on every rank, not a scheduler:

* each rank holds one stage's parameters (its slice of a ``[n_stages,
  ...]`` stack, :func:`stack_stage_params`);
* a loop over ``n_stages + n_microbatches - 1`` ticks runs every stage
  every tick and rotates the activations to the next rank: JAX's
  ``ppermute`` is :func:`~apex_tpu_torch.parallel.distributed.ppermute`,
  a ``batch_isend_irecv`` pair (send to rank ``r + 1``, receive from
  ``r - 1``) inside an autograd ``Function`` whose backward is the
  reverse rotation;
* stage 0 takes in microbatch ``t`` and the last stage collects output
  ``t - (n_stages - 1)``; off-schedule ticks compute on don't-care data
  that the collection masks out, so their gradients are zero;
* the backward is autograd's reverse of the loop: the rotations chain
  the ticks on every rank, so every rank runs its reverse rotations in
  the same (reverse tick) order.

:func:`spmd_pipeline_interleaved` is JAX's circular schedule: ``v``
virtual stages a rank, round-robin, ``m*v + p - 1`` ticks of one
virtual stage each, the bubble cut by ``v``.  The outputs are summed
over the group from the last rank (replicated; the backward hands each
rank the cotangent as it is), and the input ``x`` counts as replicated
(its gradient is summed over the group), as JAX's transposes give.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from .distributed import _Rotate, axis_group
from .tensor_parallel import psum_replicated, replicated_input

__all__ = ["spmd_pipeline", "spmd_pipeline_interleaved",
           "stack_stage_params", "stack_interleaved_stage_params"]


def _group(axis_name):
    group = axis_group(axis_name)
    if group is None:
        raise ValueError("a pipeline needs an axis_name (a process group)")
    return group


def _microbatches(x, m: int):
    batch = x.shape[0]
    if batch % m:
        raise ValueError(f"batch {batch} not divisible by "
                         f"num_microbatches {m}")
    return x.reshape(m, batch // m, *x.shape[1:])


def _collect(outs, last: bool, x, group, axis_name):
    """The last rank's outputs, replicated over the group."""
    stacked = torch.stack(outs)
    stacked = torch.where(torch.tensor(last, device=stacked.device),
                          stacked, torch.zeros_like(stacked))
    return psum_replicated(stacked, axis_name).reshape(x.shape)


def spmd_pipeline(stage_fn: Callable, stage_params, x, *, axis_name,
                  num_microbatches: int):
    """``x`` through ``n_stages`` (the group's size) chained applications
    of ``stage_fn``, pipelined over the group.

    ``stage_fn(params_i, h) -> h``: one stage, applied by rank ``i`` with
    its parameters; activations keep one shape through the stages.
    ``stage_params``: this rank's slice of the ``[n_stages, ...]`` stack
    (a leading axis of length 1 is squeezed).  ``x``: ``[batch, ...]``,
    the same on every rank, split into ``num_microbatches``.  Returns
    the ``[batch, ...]`` outputs on every rank."""
    group = _group(axis_name)
    n_stages, idx = dist.get_world_size(group), dist.get_rank(group)
    params_i = pytree.tree_map(
        lambda p: p.squeeze(0) if p.shape[0] == 1 else p, stage_params)
    micro = _microbatches(replicated_input(x, axis_name), num_microbatches)
    first = torch.tensor(idx == 0, device=x.device)
    buf = torch.zeros_like(micro[0])
    outs = [torch.zeros_like(micro[0]) for _ in range(num_microbatches)]
    for t in range(n_stages + num_microbatches - 1):
        # stage 0 takes in microbatch t (clamped: off-schedule data is
        # masked out at collection); the others the rotated activation
        feed = micro[min(t, num_microbatches - 1)]
        h_out = stage_fn(params_i, torch.where(first, feed, buf))
        # the last stage collects microbatch t - (n_stages - 1); every
        # rank selects, so every rank's graph reaches the loss through
        # every tick (and runs every reverse rotation)
        m = t - (n_stages - 1)
        slot = min(max(m, 0), num_microbatches - 1)
        valid = torch.tensor(idx == n_stages - 1 and m >= 0,
                             device=x.device)
        outs[slot] = torch.where(valid, h_out, outs[slot])
        buf = _Rotate.apply(h_out, group, axis_name)
    return _collect(outs, idx == n_stages - 1, x, group, axis_name)


def stack_stage_params(per_stage_params):
    """A list of per-stage trees stacked into the ``[n_stages, ...]``
    tree :func:`spmd_pipeline` takes (rank ``i`` passes ``[i:i+1]``)."""
    return pytree.tree_map(lambda *leaves: torch.stack(leaves),
                           *per_stage_params)


def spmd_pipeline_interleaved(stage_fn: Callable, stage_params, x, *,
                              axis_name, num_microbatches: int):
    """The interleaved (circular) pipeline: ``v`` virtual stages a rank,
    round-robin (virtual stage ``s`` on rank ``s % p``).

    ``stage_fn(params_c, h) -> h``: ONE virtual stage.
    ``stage_params``: this rank's ``[v, 1, ...]`` slice of the ``[v, p,
    ...]`` stack of :func:`stack_interleaved_stage_params` (every leaf
    with both leading axes; anything else is refused).  ``x``:
    ``[batch, ...]``; ``num_microbatches`` divides the batch and is a
    multiple of ``p`` (the ring fills in groups of ``p``).

    Microbatch group ``g``, member ``j`` enters chunk ``c`` on rank ``r``
    at tick ``g*p*v + c*p + j + r``; every rank runs exactly one
    microbatch-chunk a tick, ``m*v + p - 1`` ticks in all."""
    group = _group(axis_name)
    p, r = dist.get_world_size(group), dist.get_rank(group)
    leaves = pytree.tree_leaves(stage_params)
    v = int(leaves[0].shape[0])
    bad = [tuple(q.shape) for q in leaves
           if not (q.dim() >= 2 and q.shape[1] == 1)]
    if bad:
        why = ("axis 1 has length != 1 — the stack arrived unsharded or "
               "pre-squeezed" if all(len(s) >= 2 for s in bad)
               else "some leaves lack the [v, p] leading axes entirely")
        raise ValueError(
            f"stage_params must be this rank's [v, 1, ...] slice of the "
            f"[v, p, ...] stack from stack_interleaved_stage_params "
            f"(axis 1 cut to this rank's index); got leaves with shapes "
            f"{bad[:3]} ({why}). Pass the UN-squeezed stack's slice.")
    params_v = pytree.tree_map(lambda q: q.squeeze(1), stage_params)
    m = num_microbatches
    micro = _microbatches(replicated_input(x, axis_name), m)
    if m % p:
        # the ring fills in groups of p; a partial last group would drain
        # past the m*v + p - 1 tick horizon and lose outputs
        raise ValueError(f"num_microbatches {m} must be a multiple of the "
                         f"pp group size {p} for the interleaved schedule")
    buf = torch.zeros_like(micro[0])
    outs = [torch.zeros_like(micro[0]) for _ in range(m)]
    for tau in range(m * v + p - 1):
        u = tau - r
        upos = max(u, 0)
        g, rem = divmod(upos, p * v)
        c, j = divmod(rem, p)             # this rank's chunk, the member
        t_mb = g * p + j                  # the global microbatch
        valid = u >= 0 and t_mb < m
        feed_idx = min(max(t_mb, 0), m - 1)
        # rank 0's chunk 0 takes in a microbatch; every other stage the
        # rotated activation (rank r-1's, or rank p-1's chunk c-1)
        inject = torch.tensor(r == 0 and c == 0, device=x.device)
        h_in = torch.where(inject, micro[feed_idx], buf)
        h_out = stage_fn(pytree.tree_map(lambda q: q[c], params_v), h_in)
        emit = torch.tensor(r == p - 1 and c == v - 1 and valid,
                            device=x.device)
        outs[feed_idx] = torch.where(emit, h_out, outs[feed_idx])
        buf = _Rotate.apply(h_out, group, axis_name)
    return _collect(outs, r == p - 1, x, group, axis_name)


def stack_interleaved_stage_params(per_stage_params, n_ranks: int):
    """``S = v * n_ranks`` per-stage trees stacked into the ``[v, p, ...]``
    round-robin layout of :func:`spmd_pipeline_interleaved` (virtual stage
    ``s`` at ``[s // p, s % p]``); rank ``r`` passes ``[:, r:r+1]``."""
    s = len(per_stage_params)
    if s % n_ranks:
        raise ValueError(f"{s} stages not divisible by pp size {n_ranks}")
    v = s // n_ranks
    rows = [pytree.tree_map(lambda *leaves: torch.stack(leaves),
                            *(per_stage_params[c * n_ranks + r]
                              for r in range(n_ranks)))
            for c in range(v)]
    return pytree.tree_map(lambda *leaves: torch.stack(leaves), *rows)
