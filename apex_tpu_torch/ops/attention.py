"""Plain attention in PyTorch: the materialized oracle and the blockwise
online-softmax recurrence.

Counterpart of ``apex_tpu/ops/attention.py``.  Shapes follow the JAX
convention ``[batch, seq, heads, head_dim]``; scores, softmax and the PV
product run in fp32 whatever the input dtype (bf16 products are exact in
fp32, so this is the ``preferred_element_type=float32`` of the JAX code).
These are the numerics oracle of the flash kernel
(:mod:`apex_tpu_torch.ops.flash_attention`).
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _block_scores(q, k, sm_scale):
    # [B, H, Tq, Tk] fp32 scores for one KV block
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale


def _causal_mask(q_offset, k_offset, tq, tk, device):
    qi = q_offset + torch.arange(tq, device=device)[:, None]
    ki = k_offset + torch.arange(tk, device=device)[None, :]
    return qi >= ki


def attention_block_update(q, k, v, m_prev, l_prev, acc_prev, *,
                           sm_scale, causal=False, q_offset=0, k_offset=0,
                           bias=None):
    """One online-softmax update with a KV block.  Carry: ``m`` running
    row max [B,H,Tq], ``l`` running denominator [B,H,Tq], ``acc``
    unnormalized output [B,Tq,H,D]; ``q_offset``/``k_offset`` are the
    global positions of the first query/key of these blocks."""
    s = _block_scores(q, k, sm_scale)
    if bias is not None:
        s = s + bias.float()
    if causal:
        mask = _causal_mask(q_offset, k_offset, q.shape[1], k.shape[1],
                            q.device)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m_prev, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    if causal:
        p = torch.where(mask, p, torch.zeros_like(p))
    alpha = torch.exp(m_prev - m_new)
    l_new = l_prev * alpha + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    acc_new = acc_prev * alpha.permute(0, 2, 1)[..., None] + pv
    return m_new, l_new, acc_new


def _init_carry(batch, tq, heads, dim, device):
    m = torch.full((batch, heads, tq), NEG_INF, device=device)
    l = torch.zeros((batch, heads, tq), device=device)
    acc = torch.zeros((batch, tq, heads, dim), device=device)
    return m, l, acc


def finalize_attention(m, l, acc, dtype):
    """Normalize the accumulator; fully-masked rows produce zeros."""
    l_t = l.permute(0, 2, 1)[..., None]
    safe = torch.where(l_t == 0, torch.ones_like(l_t), l_t)
    return (acc / safe).to(dtype)


def blockwise_attention(q, k, v, *, causal: bool = False,
                        sm_scale: Optional[float] = None,
                        block_size: int = 512,
                        q_offset: int = 0, k_offset: int = 0,
                        bias=None):
    """Flash-style attention over KV blocks of ``block_size`` keys (the
    last one may be partial).  [B,T,H,D] in and out; ``bias`` is any
    additive term broadcastable to [B, H, T, S]."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if sm_scale is None:
        sm_scale = d ** -0.5
    blk = min(block_size, tk)
    carry = _init_carry(b, tq, h, d, q.device)
    for start in range(0, tk, blk):
        stop = min(start + blk, tk)
        carry = attention_block_update(
            q, k[:, start:stop], v[:, start:stop], *carry,
            sm_scale=sm_scale, causal=causal, q_offset=q_offset,
            k_offset=k_offset + start,
            bias=None if bias is None else bias[..., start:stop])
    return finalize_attention(*carry, q.dtype)


def dot_product_attention(q, k, v, *, causal: bool = False,
                          sm_scale: Optional[float] = None, bias=None):
    """Reference (non-blockwise) attention — the numerics oracle."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    s = _block_scores(q, k, sm_scale)
    if bias is not None:
        s = s + bias.float()
    if causal:
        mask = _causal_mask(0, 0, q.shape[1], k.shape[1], q.device)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def mha_attention(q, k, v, **kw):
    """Alias choosing the blockwise path (public name)."""
    return blockwise_attention(q, k, v, **kw)
