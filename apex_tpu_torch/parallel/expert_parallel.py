"""Expert parallelism: switch-style (top-1) mixture of experts with
``all_to_all`` dispatch — counterpart of
``apex_tpu/parallel/expert_parallel.py``.

Tokens and experts are both sharded over the group: each rank hosts one
expert and a shard of the batch.  Routing sends each token to its
expert's rank with one ``all_to_all_single``, the expert runs a dense
local product, and a second ``all_to_all_single`` brings the outputs
back.  Each expert takes at most ``capacity = ceil(tokens_per_rank *
capacity_factor / n_experts)`` tokens from each source rank; a token
past it is dropped (it contributes zero), in JAX's order
(:func:`_dispatch_indices`).  The gate multiplies on the combine side,
so gradients reach the router; the router is replicated, so its
gradient is summed over the group (JAX's transpose), and the
load-balance loss takes the group's means.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

from .distributed import (COLLECTIVES, _dtype_name, _note_collective,
                          _staged, axis_group)
from .tensor_parallel import replicated_input

__all__ = ["MoEAux", "moe_layer"]


class MoEAux(NamedTuple):
    """Routing diagnostics and the load-balancing loss."""
    load_balance_loss: torch.Tensor     # scalar, the Switch aux loss
    dropped_fraction: torch.Tensor      # scalar in [0, 1], this rank's


def _dispatch_indices(assign, n_experts: int, capacity: int):
    """``(slot, kept)``: each token's place in its expert's bucket (in
    ``[0, capacity)``) and whether the bucket still had room."""
    onehot = torch.nn.functional.one_hot(assign, n_experts).to(torch.int32)
    pos_in_expert = torch.cumsum(onehot, dim=0) * onehot      # 1-based
    slot = pos_in_expert.sum(dim=1) - 1
    kept = slot < capacity
    return slot.clamp(0, capacity - 1), kept


class _AllToAll(torch.autograd.Function):
    """``all_to_all`` along the leading axis (chunk ``e`` to rank ``e``);
    its transpose is the same exchange of the cotangent."""

    @staticmethod
    def forward(ctx, x, group, axis_name):
        ctx.group, ctx.axis_name = group, axis_name
        return _exchange(x, group, axis_name)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group, ctx.axis_name), None, None


def _exchange(x, group, axis_name):
    dev = x.device
    x = x.contiguous()
    if _staged(group, x, "all_to_all"):
        x = x.cpu()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    out = out.to(dev)
    COLLECTIVES["all_to_all"].launches += 1
    _note_collective("all_to_all", axis_name, group,
                     x.numel() * x.element_size(), 1,
                     {_dtype_name(x.dtype)})
    return out


def _pmean(x, group, axis_name):
    """The group mean of ``x``; the backward divides the cotangent by the
    group's size (the transpose of JAX's ``pmean`` of a varying value)."""
    from .tensor_parallel import psum_replicated
    return psum_replicated(x, axis_name) / dist.get_world_size(group)


def moe_layer(x, router_w, expert_fn: Callable, expert_params, *,
              axis_name, capacity_factor: float = 1.25):
    """Top-1 (switch) mixture of experts over the group ``axis_name``.

    ``x`` ``[T, d]``: this rank's tokens.  ``router_w`` ``[d, E]``: the
    replicated router, ``E`` the group's size (one expert a rank).
    ``expert_fn(params, h) -> h``: this rank's expert, applied to every
    token routed to it, with ``expert_params`` its parameters.  Returns
    ``(y [T, d], MoEAux)``."""
    group = axis_group(axis_name)
    if group is None:
        raise ValueError("moe_layer needs an axis_name (a process group)")
    n_experts = dist.get_world_size(group)
    if router_w.shape[-1] != n_experts:
        raise ValueError(
            f"router_w has {router_w.shape[-1]} expert columns but the "
            f"group has {n_experts} ranks — this layer places exactly one "
            f"expert per rank")
    t_local, d = x.shape
    capacity = max(1, math.ceil(t_local * capacity_factor / n_experts))

    router_w = replicated_input(router_w, axis_name)
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)                       # [T, E]
    gate, assign = probs.max(dim=-1)
    # the Switch loss from the GLOBAL means of the token fractions and
    # router probabilities
    f = torch.nn.functional.one_hot(assign, n_experts).float().mean(dim=0)
    p = probs.mean(dim=0)
    f, p = _pmean(f, group, axis_name), _pmean(p, group, axis_name)
    lb_loss = n_experts * torch.sum(f * p)

    slot, kept = _dispatch_indices(assign, n_experts, capacity)
    expert = torch.where(kept, assign, torch.zeros_like(assign))
    dispatch = torch.zeros((n_experts, capacity, d), dtype=x.dtype,
                           device=x.device).index_put(
        (expert, slot), torch.where(kept[:, None], x,
                                    torch.zeros_like(x)).to(x.dtype),
        accumulate=True)
    # exchange 1: bucket e of every source rank lands on rank e
    arrived = _AllToAll.apply(dispatch, group, axis_name)
    out = expert_fn(expert_params, arrived.reshape(-1, d))
    # exchange 2: each source rank gets its tokens back
    returned = _AllToAll.apply(out.reshape(n_experts, capacity, d), group,
                               axis_name)
    y = returned[expert, slot]
    y = torch.where(kept[:, None], y, torch.zeros_like(y))
    y = (y.float() * gate[:, None]).to(x.dtype)
    dropped = 1.0 - kept.float().mean()
    return y, MoEAux(load_balance_loss=lb_loss, dropped_fraction=dropped)
