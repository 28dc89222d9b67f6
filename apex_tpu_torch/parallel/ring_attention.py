"""Sequence parallelism: ring attention, ring-flash attention and
Ulysses — counterpart of ``apex_tpu/parallel/ring_attention.py``.

The sequence is split contiguously over the process group ``axis_name``
in rank order (JAX's ``shard_map`` with ``P(None, "sp")``): each rank
holds ``[B, T/n, H, D]`` shards of q, k and v, and gets its shard of
the output.  Three strategies, with JAX's signatures:

* :func:`ring_attention` — q stays; the KV shards travel the ring
  (:func:`~apex_tpu_torch.parallel.distributed.ppermute`, JAX's
  ``perm = [(i, (i + 1) % n)]``) while each rank runs the online-softmax
  recurrence (:func:`~apex_tpu_torch.ops.attention.attention_block_update`)
  over them in plain torch, sub-blocked by ``block_size`` keys.  Causal
  masking uses each block's global offsets.  Each ring step is
  checkpointed (``jax.checkpoint``): its scores are recomputed in the
  backward, which is autograd's through the rotations.
* :func:`ring_flash_attention` — the same ring with the flash kernels
  as the local op (a ``torch.autograd.Function``, JAX's
  ``custom_vjp``).  The forward runs kernel 10 once a ring step, on the
  visiting shard, at the relative causal offset ``q_off - k_off``
  (negative when the shard lies ahead of this rank's queries: the
  kernel skips every tile no query sees and gives a row with no visible
  key ``out = 0`` and ``lse = -1e30``), and merges the partial outputs
  by their log-sum-exp weights in fp32.  The backward rotates KV again
  and runs kernels 11 (dQ) and 12 (dK/dV) against the GLOBAL ``lse`` and
  ``delta = rowsum(dO * out)``: dQ accumulates on this rank, dK and dV in
  fp32 buffers that rotate with their KV shard and are home after n
  rotations.  CUDA tensors launch the kernels (or raise); CPU tensors
  take their plain versions (``_flash_fwd_ref``, ``_flash_bwd_ref``).
* :func:`ulysses_attention` — two ``all_to_all``s re-shard from
  sequence to heads, plain blockwise attention runs over the whole
  sequence on ``H/n`` heads, and two more shard back; JAX runs no Pallas
  kernel there either.

The kernels' q, k and v are ``[B, T, H, D]`` with any strides (a unit
stride on D), so JAX's transposes to head-major have no counterpart.
Unlike JAX, :func:`ring_flash_attention` has no fallback to
:func:`ring_attention` for a shard that does not block-align: the
kernels take any length.  The KV rotation after the last ring step,
which JAX issues and never reads, is not issued.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from ..ops.attention import (_init_carry, attention_block_update,
                             blockwise_attention, finalize_attention)
from ..ops.flash_attention import (_delta, _flash_bwd_ref, _flash_fwd_ref,
                                   flash_bwd_dkv_kernel, flash_bwd_dq_kernel,
                                   flash_fwd_kernel)
from .distributed import _shift, axis_group, ppermute

__all__ = ["ring_attention", "ring_flash_attention", "ulysses_attention"]

NEG_INF = -1e30


def _group(axis_name):
    group = axis_group(axis_name)
    if group is None:
        raise ValueError("sequence parallelism needs an axis_name (a "
                         "process group)")
    return group


def ring_attention(q, k, v, axis_name, *, causal: bool = False,
                   sm_scale: Optional[float] = None,
                   block_size: int = 512):
    """Ring attention over sequence shards.  ``q``/``k``/``v``: this
    rank's ``[B, T/n, H, D]`` shards, the global sequence split
    contiguously over ``axis_name`` in rank order; returns this rank's
    ``[B, T/n, H, D]`` output shard in q's dtype."""
    group = _group(axis_name)
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    b, t_local, h, d = q.shape
    if sm_scale is None:
        sm_scale = d ** -0.5
    q_offset = idx * t_local
    # sub-blocks bound a step's score matrix at [B, H, T/n, block_size]
    blk = min(block_size, t_local)
    n_sub = t_local // blk
    rem = t_local - n_sub * blk

    def consume(kb, vb, m, l, acc, k_offset):
        if n_sub <= 1 and rem == 0:
            return attention_block_update(
                q, kb, vb, m, l, acc, sm_scale=sm_scale, causal=causal,
                q_offset=q_offset, k_offset=k_offset)
        for s in range(n_sub):
            m, l, acc = attention_block_update(
                q, kb[:, s * blk:(s + 1) * blk], vb[:, s * blk:(s + 1) * blk],
                m, l, acc, sm_scale=sm_scale, causal=causal,
                q_offset=q_offset, k_offset=k_offset + s * blk)
        if rem:
            m, l, acc = attention_block_update(
                q, kb[:, -rem:], vb[:, -rem:], m, l, acc, sm_scale=sm_scale,
                causal=causal, q_offset=q_offset,
                k_offset=k_offset + n_sub * blk)
        return m, l, acc

    m, l, acc = _init_carry(b, t_local, h, d, q.device)
    kb, vb = k, v
    for r in range(n):
        # this KV shard started at rank (idx - r) mod n
        k_offset = ((idx - r) % n) * t_local
        m, l, acc = checkpoint(consume, kb, vb, m, l, acc, k_offset,
                               use_reentrant=False)
        if r < n - 1:
            kb, vb = ppermute(kb, axis_name), ppermute(vb, axis_name)
    return finalize_attention(m, l, acc, q.dtype)


def _logaddexp(a, b):
    m = torch.maximum(a, b)
    return m + torch.log(torch.exp(a - m) + torch.exp(b - m))


def _rows(x):
    """``[B, H, T]`` row statistics as ``[B, T, H, 1]`` weights."""
    return x.permute(0, 2, 1)[..., None]


def _fwd_part(q, k, v, sm_scale, causal, offset):
    """One ring step's ``(out [B, T, H, D] in q's dtype, lse [B, H, T])``:
    kernel 10 on CUDA, its plain version on the CPU."""
    kw = dict(sm_scale=sm_scale, causal=causal, q_offset=offset)
    if q.is_cuda:
        return flash_fwd_kernel(q, k, v, None, None, **kw)
    return _flash_fwd_ref(q, k, v, None, None, **kw)


def _bwd_part(q, k, v, out, lse, do, delta, sm_scale, causal, offset):
    """One ring step's ``(dq, dk, dv)`` against the global ``lse`` and
    ``delta``: kernels 11 and 12 on CUDA, their plain version on the
    CPU."""
    kw = dict(sm_scale=sm_scale, causal=causal, q_offset=offset)
    if q.is_cuda:
        dq = flash_bwd_dq_kernel(q, k, v, do, lse, delta, None, None, **kw)
        dk, dv, _ = flash_bwd_dkv_kernel(q, k, v, do, lse, delta, None,
                                         None, **kw)
        return dq, dk, dv
    dq, dk, dv, _, _ = _flash_bwd_ref(q, k, v, None, None, out, lse, do,
                                      **kw)
    return dq, dk, dv


class _RingFlash(torch.autograd.Function):
    """JAX's ``_ring_flash`` custom VJP (``ring_attention.py:111-197``)."""

    @staticmethod
    def forward(ctx, q, k, v, group, axis_name, causal, sm_scale):
        n, idx = dist.get_world_size(group), dist.get_rank(group)
        b, t_local, h, d = q.shape
        q_off = idx * t_local
        lse_run = torch.full((b, h, t_local), NEG_INF, dtype=torch.float32,
                             device=q.device)
        out_run = torch.zeros((b, t_local, h, d), dtype=torch.float32,
                              device=q.device)
        kc, vc = k, v
        for r in range(n):
            j = (idx - r) % n
            out_i, lse_i = _fwd_part(q, kc, vc, sm_scale, causal,
                                     q_off - j * t_local)
            new_lse = _logaddexp(lse_run, lse_i)
            out_run = (out_run * _rows(torch.exp(lse_run - new_lse))
                       + out_i.float() * _rows(torch.exp(lse_i - new_lse)))
            lse_run = new_lse
            if r < n - 1:
                kc = _shift(kc, group, 1, axis_name)
                vc = _shift(vc, group, 1, axis_name)
        out = out_run.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse_run)
        ctx.group, ctx.axis_name = group, axis_name
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        group, axis_name = ctx.group, ctx.axis_name
        n, idx = dist.get_world_size(group), dist.get_rank(group)
        t_local = q.shape[1]
        q_off = idx * t_local
        do = do if do.stride(-1) == 1 else do.contiguous()
        # do and out are the same at every step: delta once
        delta = _delta(do, out)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dkc = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dvc = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        kc, vc = k, v
        for r in range(n):
            j = (idx - r) % n
            dq_i, dk_i, dv_i = _bwd_part(q, kc, vc, out, lse, do, delta,
                                         ctx.sm_scale, ctx.causal,
                                         q_off - j * t_local)
            dq = dq + dq_i.float()
            dkc = dkc + dk_i.float()
            dvc = dvc + dv_i.float()
            if r < n - 1:
                kc = _shift(kc, group, 1, axis_name)
                vc = _shift(vc, group, 1, axis_name)
            # n rotations bring each shard's dK/dV home
            dkc = _shift(dkc, group, 1, axis_name)
            dvc = _shift(dvc, group, 1, axis_name)
        return (dq.to(q.dtype), dkc.to(k.dtype), dvc.to(v.dtype), None,
                None, None, None)


def ring_flash_attention(q, k, v, axis_name, *, causal: bool = False,
                         sm_scale: Optional[float] = None,
                         block_q: int = 512, block_k: int = 512,
                         interpret: bool = False):
    """Ring attention with the flash kernels as the local op: the
    contract of :func:`ring_attention` (``[B, T/n, H, D]`` shards over
    ``axis_name``), n launches of the forward kernel a call and n of
    each backward kernel a backward, gradients exact against the global
    log-sum-exp.

    ``block_q``/``block_k`` are JAX's TPU block sizes; the CUDA kernels
    take their own tiles (the rule's), so here they choose nothing.
    ``interpret`` (JAX's Pallas interpret mode) chooses nothing either:
    a CPU tensor takes the kernels' plain versions, a CUDA tensor the
    kernels.  q, k and v share one dtype and shape."""
    del block_q, block_k, interpret
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"ring_flash_attention takes q, k and v of one "
                         f"shape (MHA); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    group = _group(axis_name)
    return _RingFlash.apply(q, k, v, group, axis_name, bool(causal),
                            float(sm_scale))


def ulysses_attention(q, k, v, axis_name, *, causal: bool = False,
                      sm_scale: Optional[float] = None,
                      block_size: int = 512):
    """Ulysses all-to-all sequence parallelism: ``[B, T/n, H, D]`` shards
    -> ``all_to_all`` -> ``[B, T, H/n, D]`` -> plain blockwise attention
    over the whole sequence -> ``all_to_all`` back.  Needs ``H % n ==
    0``."""
    from .expert_parallel import _AllToAll
    group = _group(axis_name)
    n = dist.get_world_size(group)
    h = q.shape[2]
    if h % n != 0:
        raise ValueError(f"num_heads {h} not divisible by axis size {n}")

    def seq_to_heads(x):
        # head group e goes to rank e; the sequence shards arrive in rank
        # order (JAX's split_axis=2, concat_axis=1, tiled)
        b, t, _, d = x.shape
        parts = x.reshape(b, t, n, h // n, d).permute(2, 0, 1, 3, 4)
        got = _AllToAll.apply(parts.contiguous(), group, axis_name)
        return got.permute(1, 0, 2, 3, 4).reshape(b, n * t, h // n, d)

    def heads_to_seq(x):
        b, t, hl, d = x.shape
        parts = x.reshape(b, n, t // n, hl, d).permute(1, 0, 2, 3, 4)
        got = _AllToAll.apply(parts.contiguous(), group, axis_name)
        return got.permute(1, 2, 0, 3, 4).reshape(b, t // n, n * hl, d)

    out = blockwise_attention(seq_to_heads(q), seq_to_heads(k),
                              seq_to_heads(v), causal=causal,
                              sm_scale=sm_scale, block_size=block_size)
    return heads_to_seq(out)
