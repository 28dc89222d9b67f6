"""Flash attention forward — CUDA C++ kernel for Hopper, with its plain
PyTorch version beside it.

Counterpart of ``apex_tpu/ops/flash_attention.py``: the same public
``flash_attention(q, k, v, *, causal, sm_scale, key_padding_bias, bias,
window)`` in the JAX layout ``[batch, seq, heads, head_dim]``, with every
validation and fold of the JAX API (``flash_attention.py:839-902``):
kv heads must divide query heads, ``q_len > kv_len`` under causal raises,
causal cross-length queries are the SUFFIX of the keys (``q_offset =
kv_len - q_len``), ``window`` needs causal, a 3-D bias is broadcast to
``[B, T, S]`` and a ``key_padding_bias`` is folded into it.

Dispatch is by the tensors' device and nothing else: CPU tensors take
:func:`_flash_fwd_ref`; CUDA tensors launch the kernel of
``csrc/flash_attention.cu`` (every shape, ``q_len = 1`` decode and short
prefills included — the TPU's measured crossovers do not carry over) or
raise.  The kernel replaces the Pallas ``_fwd_kernel``
(``apex_tpu/ops/flash_attention.py:238``); its source says what bounds it
on the card and how it is laid out.  Forward only: a CUDA call that needs
a gradient raises ``NotImplementedError`` (the backward kernels come with
the training slice).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import _build

NEG_INF = -1e30

_HEAD_DIMS = (32, 64, 128)


def _pick_block_q(tq: int) -> int:
    """Query rows per CUDA block: 64 for prefill-sized calls, fewer for
    short ones so a decode row is spread over a whole warp."""
    if tq >= 64:
        return 64
    return 16 if tq >= 16 else 4


# -- plain version ------------------------------------------------------------

def _visible(tq: int, tk: int, q_offset: int, window: Optional[int],
             device) -> torch.Tensor:
    """[tq, tk] causal (optionally sliding-window) visibility on global
    positions: query row i sits at ``q_offset + i``."""
    qp = q_offset + torch.arange(tq, device=device)[:, None]
    kp = torch.arange(tk, device=device)[None, :]
    vis = qp >= kp
    if window is not None:
        vis = vis & (qp - kp < window)
    return vis


def _flash_fwd_ref(q, k, v, kbias, bias, *, sm_scale: float, causal: bool,
                   q_offset: int = 0, window: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic in plain PyTorch, on materialized scores.

    q ``[B, T, H, D]``; k, v ``[B, S, H_kv, D]``; ``kbias`` ``[B, S]`` or
    None; ``bias`` ``[B, T, S]`` (broadcast over heads) or per-head
    ``[B, H, T, S]`` or None.  Returns ``(out [B, T, H, D] in q's dtype,
    lse [B, H, T] fp32)``.  Scores and softmax statistics are fp32, hidden
    keys get ``NEG_INF`` and ``p = 0``, ``p`` is rounded to the value
    dtype before the PV product, and a row with ``l == 0`` gives zeros
    and ``lse = NEG_INF`` — as the Pallas kernel does."""
    grp = q.shape[2] // k.shape[2]
    if grp > 1:
        k = k.repeat_interleave(grp, dim=2)
        v = v.repeat_interleave(grp, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    if kbias is not None:
        s = s + kbias.float()[:, None, None, :]
    if bias is not None:
        s = s + (bias.float()[:, None] if bias.dim() == 3 else bias.float())
    if causal:
        vis = _visible(q.shape[1], k.shape[1], q_offset, window, q.device)
        s = torch.where(vis, s, torch.full_like(s, NEG_INF))
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=NEG_INF)
    p = torch.exp(s - m)
    if causal:
        p = torch.where(vis, p, torch.zeros_like(p))
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    safe = torch.where(l == 0, torch.ones_like(l), l)
    out = pv / safe[..., 0].permute(0, 2, 1)[..., None]
    lse = torch.where(l == 0, torch.full_like(l, NEG_INF), m + torch.log(safe))
    return out.to(q.dtype), lse[..., 0]


# -- CUDA kernel --------------------------------------------------------------

class _FlashParams(ctypes.Structure):
    """Mirror of ``struct Params`` in ``csrc/flash_attention.cu``."""
    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ("q", "k", "v", "kbias", "bias", "out", "lse")]
                + [(n, ctypes.c_int64) for n in
                   ("sq_b", "sq_t", "sq_h", "sk_b", "sk_t", "sk_h",
                    "sv_b", "sv_t", "sv_h", "so_b", "so_t", "so_h",
                    "skb_b", "sb_b", "sb_t")]
                + [(n, ctypes.c_int32) for n in
                   ("B", "H", "Hkv", "tq", "tk", "causal", "q_offset",
                    "window")]
                + [("sm_scale", ctypes.c_float)])


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_fwd
    fn.argtypes = [ctypes.POINTER(_FlashParams), ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def flash_fwd_kernel(q, k, v, kbias, bias, *, sm_scale: float,
                     causal: bool, q_offset: int = 0,
                     window: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel: the arguments of :func:`_flash_fwd_ref`
    (a 3-D ``bias`` only), CUDA tensors; returns ``(out, lse)``.  Adds one
    to ``flash_fwd_kernel.launches`` per launch."""
    b, tq, h, d = q.shape
    tk, h_kv = k.shape[1], k.shape[2]
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash kernel takes bf16 or fp32, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash kernel head_dim must be one of "
                         f"{_HEAD_DIMS}, got {d}")
    if tq < 1 or tk < 1:
        raise ValueError("flash kernel needs q_len >= 1 and kv_len >= 1")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be on q's CUDA device")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a unit stride on head_dim")
    for name, t in (("bias", bias), ("key_padding_bias", kbias)):
        if t is not None and t.device != q.device:
            raise ValueError(f"{name} must be on q's CUDA device")
    if bias is not None:
        if bias.dim() != 3:
            raise ValueError("flash kernel takes a [B, T, S] bias only")
        bias = bias.to(torch.float32).expand(b, tq, tk)
        if bias.stride(-1) != 1:
            bias = bias.contiguous()
    if kbias is not None:
        kbias = kbias.to(torch.float32).expand(b, tk)
        if kbias.stride(-1) != 1:
            kbias = kbias.contiguous()
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    prm = _FlashParams(
        q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(),
        kbias=None if kbias is None else kbias.data_ptr(),
        bias=None if bias is None else bias.data_ptr(),
        out=out.data_ptr(), lse=lse.data_ptr(),
        sq_b=q.stride(0), sq_t=q.stride(1), sq_h=q.stride(2),
        sk_b=k.stride(0), sk_t=k.stride(1), sk_h=k.stride(2),
        sv_b=v.stride(0), sv_t=v.stride(1), sv_h=v.stride(2),
        so_b=out.stride(0), so_t=out.stride(1), so_h=out.stride(2),
        skb_b=0 if kbias is None else kbias.stride(0),
        sb_b=0 if bias is None else bias.stride(0),
        sb_t=0 if bias is None else bias.stride(1),
        B=b, H=h, Hkv=h_kv, tq=tq, tk=tk, causal=int(causal),
        q_offset=int(q_offset), window=0 if window is None else int(window),
        sm_scale=float(sm_scale))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _lib().flash_attention_fwd(
            ctypes.byref(prm), d, _pick_block_q(tq),
            int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error "
                           f"{err}")
    flash_fwd_kernel.launches += 1
    return out, lse


flash_fwd_kernel.launches = 0


# -- public API ---------------------------------------------------------------

def flash_attention(q, k, v, *, causal: bool = False,
                    sm_scale: Optional[float] = None,
                    key_padding_bias=None,
                    bias=None,
                    window: Optional[int] = None):
    """Flash attention.  ``q``: [batch, q_len, heads, head_dim]; ``k, v``:
    [batch, kv_len, kv_heads, head_dim]; returns q's shape and dtype.

    ``kv_heads`` may divide ``heads`` (GQA): each KV head serves
    ``heads / kv_heads`` query heads without being repeated on the card.
    ``key_padding_bias``: additive ``[batch, kv_len]`` (0 visible, large
    negative hidden).  ``bias``: additive ``[batch, q_len, kv_len]``
    broadcast over heads (anything broadcastable to it is accepted), or a
    per-head ``[batch, heads, q_len, kv_len]`` bias, which only the CPU
    path takes (the JAX package has no kernel for it either).
    ``window``: sliding-window local attention (needs ``causal``): each
    query sees the last ``window`` keys, itself included.  Causal
    ``q_len < kv_len`` aligns the queries to the END of the keys, the
    KV-cache decode convention.
    """
    tq, tk = q.shape[1], k.shape[1]
    d = q.shape[-1]
    n_heads, n_kv = q.shape[2], k.shape[2]
    if n_heads % n_kv or v.shape[2] != n_kv:
        raise ValueError(
            f"kv heads must divide query heads and match between k and v; "
            f"got q heads {n_heads}, k heads {n_kv}, v heads {v.shape[2]}")
    q_offset = 0
    if causal and tq != tk:
        if tq > tk:
            raise ValueError(
                f"causal attention needs q_len <= kv_len (queries are "
                f"the suffix of the key sequence); got q_len {tq} > "
                f"kv_len {tk}")
        q_offset = tk - tq
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True (sliding-window "
                             "local attention is causal)")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    if sm_scale is None:
        sm_scale = d ** -0.5
    per_head_bias = None
    if bias is not None and bias.dim() == 4:
        per_head_bias, bias = bias, None
    elif bias is not None and bias.dim() == 3:
        want = (q.shape[0], tq, tk)
        if tuple(bias.shape) != want:
            try:
                bias = bias.expand(want)
            except RuntimeError:
                raise ValueError(
                    f"bias shape {tuple(bias.shape)} is not broadcastable "
                    f"to [batch, q_len, kv_len] = {want}") from None
    elif bias is not None:
        raise ValueError(
            f"bias must be [batch, q_len, kv_len] (broadcast over heads) "
            f"or per-head [batch, heads, q_len, kv_len]; got "
            f"{tuple(bias.shape)}")
    if bias is not None and key_padding_bias is not None:
        bias = bias + key_padding_bias[:, None, :].to(bias.dtype)
        key_padding_bias = None

    if not q.is_cuda:
        if per_head_bias is not None:
            bias = per_head_bias
        out, _ = _flash_fwd_ref(q, k, v, key_padding_bias, bias,
                                sm_scale=sm_scale, causal=causal,
                                q_offset=q_offset, window=window)
        return out
    if per_head_bias is not None:
        raise NotImplementedError(
            "a per-head [B, H, T, S] bias has no CUDA kernel (nor a Pallas "
            "one); pass a [B, T, S] bias or run on the CPU")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (q, k, v, bias, key_padding_bias)):
        raise NotImplementedError(
            "the flash-attention backward kernels are not ported yet; run "
            "the CUDA forward under torch.no_grad() or inference_mode()")
    out, _ = flash_fwd_kernel(q, k, v, key_padding_bias, bias,
                              sm_scale=sm_scale, causal=causal,
                              q_offset=q_offset, window=window)
    return out
