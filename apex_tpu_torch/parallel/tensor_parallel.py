"""Tensor (model) parallelism over a process group, the Megatron split —
counterpart of ``apex_tpu/parallel/tensor_parallel.py``.

* **column-parallel**: this rank's weight is ``[d_in, d_out/n]``; the
  output is feature-sharded, with no collective;
* **row-parallel**: this rank's weight is ``[d_in/n, d_out]``; it takes
  the feature-sharded activation and sums the partial products over the
  group (one ``all_reduce``).

A column -> row pair (the transformer MLP, attention's output
projection) costs one all-reduce, and the weight gradients stay local
to each rank.  ``axis_name`` is a process group (``"data"`` the default
one, or a ``ProcessGroup``).

The gradients are JAX's under ``shard_map``: the row-parallel sum is a
``psum`` whose transpose hands each rank the replicated cotangent as it
is (no collective: autograd's ``all_reduce`` would sum it again), and a
replicated input that enters a rank-local product
(:func:`column_parallel_dense` given ``axis_name``; the router of
:func:`~apex_tpu_torch.parallel.expert_parallel.moe_layer`) gets the
sum over the group of its per-rank gradients, the transpose of the
broadcast JAX inserts there.  So the weight gradients equal the slices
of the dense model's, and an input's gradient its full one.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .distributed import (COLLECTIVES, _dtype_name, _note_collective,
                          axis_group)

__all__ = ["column_parallel_dense", "row_parallel_dense", "tp_mlp",
           "tp_self_attention", "shard_column", "shard_row"]


def _group(axis_name):
    group = axis_group(axis_name)
    if group is None:
        raise ValueError("a tensor-parallel op needs an axis_name (a "
                         "process group)")
    return group


def _sum_(t: torch.Tensor, group, axis_name) -> torch.Tensor:
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    COLLECTIVES["tp_psum"].launches += 1
    _note_collective("psum", axis_name, group, t.numel() * t.element_size(),
                     1, {_dtype_name(t.dtype)})
    return t


class _ReduceFromGroup(torch.autograd.Function):
    """``psum`` over the group; the backward passes the (replicated)
    cotangent through unchanged."""

    @staticmethod
    def forward(ctx, x, group, axis_name):
        return _sum_(x.detach().clone(memory_format=torch.contiguous_format),
                     group, axis_name)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyToGroup(torch.autograd.Function):
    """The identity on a replicated input; the backward sums the
    cotangent over the group (the transpose of JAX's implicit
    broadcast)."""

    @staticmethod
    def forward(ctx, x, group, axis_name):
        ctx.group, ctx.axis_name = group, axis_name
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (_sum_(g.clone(memory_format=torch.contiguous_format),
                      ctx.group, ctx.axis_name), None, None)


def psum_replicated(x: torch.Tensor, axis_name) -> torch.Tensor:
    """``psum`` of rank-local partials into a replicated tensor, with the
    identity as its backward (JAX's transpose)."""
    return _ReduceFromGroup.apply(x, _group(axis_name), axis_name)


def replicated_input(x: torch.Tensor, axis_name) -> torch.Tensor:
    """``x`` (replicated) as the input of rank-local work: the identity,
    whose backward sums the gradient over the group."""
    return _CopyToGroup.apply(x, _group(axis_name), axis_name)


def column_parallel_dense(x, w_local, b_local=None, axis_name=None):
    """``y_local = x @ w_local (+ b_local)``, feature-sharded; no
    collective.  ``w_local`` is this rank's ``[d_in, d_out/n]`` slice.
    With ``axis_name``, ``x`` counts as replicated over it: its gradient
    is summed over the group."""
    if axis_name is not None:
        x = replicated_input(x, axis_name)
    y = x @ w_local.to(x.dtype)
    if b_local is not None:
        y = y + b_local.to(y.dtype)
    return y


def row_parallel_dense(x_local, w_local, axis_name, b=None):
    """``y = psum(x_local @ w_local) (+ b)``, the one collective of a
    column -> row pair: ``x_local`` ``[..., d_in/n]``, ``w_local`` this
    rank's ``[d_in/n, d_out]``; the replicated bias ``b`` is added after
    the sum."""
    y = psum_replicated(x_local @ w_local.to(x_local.dtype), axis_name)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def _gelu(x):
    return F.gelu(x, approximate="tanh")   # jax.nn.gelu's default


def tp_mlp(x, w1_local, b1_local, w2_local, b2, axis_name,
           activation=_gelu):
    """The Megatron MLP: column-parallel up-projection, the activation in
    fp32 (tanh GELU by default, as ``jax.nn.gelu``), row-parallel
    down-projection; one all-reduce."""
    h = column_parallel_dense(x, w1_local, b1_local, axis_name=axis_name)
    h = activation(h.float()).to(x.dtype)
    return row_parallel_dense(h, w2_local, axis_name, b=b2)


def tp_self_attention(x, wqkv_local, wo_local, num_heads_local: int,
                      axis_name, causal: bool = False, attention_fn=None):
    """Head-parallel self-attention: each rank owns ``num_heads / n``
    heads end to end, the output projection row-parallel (one
    all-reduce).  ``wqkv_local`` ``[d, 3, heads_local, head_dim]``,
    ``wo_local`` ``[heads_local * head_dim, d]``.  The default
    ``attention_fn`` is :func:`~apex_tpu_torch.ops.flash_attention.
    flash_attention`: the flash kernel on the rank's local heads on
    CUDA, its plain version on the CPU."""
    if wqkv_local.shape[2] != num_heads_local:
        raise ValueError(
            f"num_heads_local={num_heads_local} does not match "
            f"wqkv_local's head dim {wqkv_local.shape[2]} — pass this "
            f"rank's head count (global heads / tp group size)")
    b, t, _ = x.shape
    x = replicated_input(x, axis_name)
    qkv = torch.einsum("btd,dche->btche", x, wqkv_local.to(x.dtype))
    q, k, v = (qkv[:, :, i] for i in range(3))   # each [b, t, h_local, e]
    if attention_fn is None:
        from ..ops.flash_attention import flash_attention

        def attention_fn(q, k, v):
            return flash_attention(q, k, v, causal=causal)
    ctx = attention_fn(q.contiguous(), k.contiguous(), v.contiguous())
    return row_parallel_dense(ctx.reshape(b, t, -1), wo_local, axis_name)


# -- replicated weight -> this rank's shard ---------------------------------------

def _rank_and_size(axis_name, n: Optional[int]):
    group = _group(axis_name)
    return dist.get_rank(group), n or dist.get_world_size(group)


def shard_column(w, axis_name, n: Optional[int] = None):
    """This rank's column-parallel ``[d_in, d_out/n]`` piece of a
    replicated ``[d_in, d_out]`` weight."""
    idx, n = _rank_and_size(axis_name, n)
    if w.shape[-1] % n:
        raise ValueError(
            f"column-parallel split needs d_out {w.shape[-1]} divisible by "
            f"the tp group size {n} — trailing columns would be dropped")
    cols = w.shape[-1] // n
    return w.narrow(w.dim() - 1, idx * cols, cols)


def shard_row(w, axis_name, n: Optional[int] = None):
    """This rank's row-parallel ``[d_in/n, d_out]`` piece of a replicated
    ``[d_in, d_out]`` weight."""
    idx, n = _rank_and_size(axis_name, n)
    if w.shape[0] % n:
        raise ValueError(
            f"row-parallel split needs d_in {w.shape[0]} divisible by "
            f"the tp group size {n} — trailing rows would be dropped")
    rows = w.shape[0] // n
    return w.narrow(0, idx * rows, rows)
