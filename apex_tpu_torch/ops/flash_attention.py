"""Flash attention — CUDA C++ kernels for Hopper (forward, dQ, dK/dV),
with their plain PyTorch versions beside them.

Counterpart of ``apex_tpu/ops/flash_attention.py``: the same public
``flash_attention(q, k, v, *, causal, sm_scale, key_padding_bias, bias,
window)`` in the JAX layout ``[batch, seq, heads, head_dim]``, with every
validation and fold of the JAX API (``flash_attention.py:839-902``):
kv heads must divide query heads, ``q_len > kv_len`` under causal raises,
causal cross-length queries are the SUFFIX of the keys (``q_offset =
kv_len - q_len``), ``window`` needs causal, a 3-D bias is broadcast to
``[B, T, S]`` and a ``key_padding_bias`` is folded into it.

The gradient is a ``torch.autograd.Function`` (the JAX ``custom_vjp``):
its forward saves ``out`` and the fp32 ``lse``, its backward recomputes
``p = exp(s - lse)`` tile by tile.  Dispatch is by the tensors' device and
nothing else: CPU tensors take :func:`_flash_fwd_ref` and
:func:`_flash_bwd_ref`; CUDA tensors launch the kernels of
``csrc/flash_attention_sm90.cu`` (the forward of bf16/fp16 prefill at
widths 33-128 on ``wgmma`` and TMA), ``csrc/flash_decode_sm90.cu`` (the
forward of bf16/fp16 decode, ``q_len < 16``, at widths 33-128 on a TMA
ring, one launch a call) and ``csrc/flash_attention.cu`` (the
forward's other routes: ``mma.sync`` tensor cores for bf16/fp16 at
widths up to 32 or views TMA cannot read, a full-fp32 SIMT kernel for
fp32 and widths above 128, split-KV with a combine for the other
``q_len < 16`` calls — the TPU's block sizes and measured crossovers do
not carry over),
``csrc/flash_attention_bwd_sm90.cu`` (dQ and dK/dV of bf16/fp16 at widths
33-128 on ``wgmma`` and TMA) and ``csrc/flash_attention_bwd.cu`` (dQ and
dK/dV's other routes, ``mma.sync`` and SIMT, and, when a ``[B, T, S]``
bias needs a gradient, its head-summed gradient), or raise.  The
kernels take fp32, bf16 and fp16 and any head width, as the JAX package
does: up to 256 in the next of 16, 32, 64,
128, 256 (nothing padded is copied to device memory), a wider head in
the 256 kernels taken in 256-wide column slices; bf16 and fp16 up to 128
run the forward, dQ and dK/dV on the tensor cores, fp32 and the widths
above 128 run SIMT kernels.  The kernels
replace the Pallas ``_fwd_kernel``, ``_bwd_dq_kernel``,
``_bwd_dkv_kernel`` and ``_bwd_db2_kernel``
(``apex_tpu/ops/flash_attention.py:238, 440, 478, 562``); their sources
say what bounds them on the card and how they are laid out.  A per-head
``[B, H, T, S]`` bias has no kernel here or in the JAX package: it takes
the plain, differentiable path on either device, as JAX takes its jnp
``blockwise_attention``.

The route.  :func:`flash_fwd_kernel` picks one kernel a call
(:func:`_route`, counted in ``flash_fwd_kernel.routes``): for ``q_len <
16`` ``decode`` in bf16/fp16 at widths 33-128 where K and V meet TMA's
rules and the kernel takes the call (:func:`_decode_route`), else
``split``; ``simt`` for fp32 and widths
above 128; else ``wgmma``
where every view meets TMA's rules (:func:`_tma_ok`: 16-byte aligned
bases, strides multiples of 16 bytes, the width a multiple of 8) at
widths 33-128, and ``mma`` (``mma.sync``) otherwise, widths 16 and 32
included.  A view TMA cannot read is routed to ``mma`` by that rule, never
by a failed launch; a ``wgmma`` tile asked for on such a view raises.
dQ and dK/dV follow the same rule (:func:`_bwd_route`, counted in
``flash_bwd_dq_kernel.routes`` and ``flash_bwd_dkv_kernel.routes``):
``simt`` for fp32 and widths above 128, ``wgmma`` at widths 33-128 where
q, k, v, do, the outputs and the bias meet TMA's rules, else ``mma``.

The tile.  ``flash_attention(block_q=, block_k=)`` (JAX's names) sets the
forward's tile, and the tile names the kernel: the ``wgmma`` kernel's
64 x 96, 128 x 96, 64 x 160 and 128 x 160 (query rows by keys; 64 rows a
consumer warpgroup) at widths 64 and 128, the ``mma.sync`` kernel's
64 x 64 at every width and 64 x 32, 64 x 128, 128 x 64 and 128 x 128 at
widths 64 and 128 (:func:`tiles`; a half left at None is 64).  The rule
is :func:`rule_tile`.  On the decode routes ``block_k`` is the chunk of
keys a block reads (a multiple of 32 within the kernel's bounds; the
rules :func:`_decode_split` and :func:`_kv_split`; ``block_q`` has no
meaning there).
The fp32 and wide-head SIMT kernels and the backward kernels keep their
rule's tiles.  Left at None, a CUDA call consults the tuner's cache for
this shape's bucket (:func:`tune_bucket`, the JAX package's string,
:data:`TUNE_VERSION`).  Another tile reorders the online softmax's sums,
so its outputs agree with the rule's to a tolerance, not bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from .. import _build
from ..prof import costs as _costs
from ..tune import space as _space
from ..tune.dispatch import kernel_config as _tuned_config

NEG_INF = -1e30

#: the head widths the kernels are instantiated at; any width up to the
#: last runs in the next one, its missing columns read as zero, and a
#: wider one in the last, in slices of its width
_KERNEL_DIMS = (16, 32, 64, 128, 256)
#: q_len below this takes a decode route: ``decode`` (one CUDA kernel on a
#: TMA ring) or ``split`` (split-KV, two CUDA kernels)
_SPLIT_TQ = 16
#: keys per split-KV chunk: at least a few passes of a block, at most
#: what its shared-memory score rows hold
_MIN_CHUNK, _MAX_CHUNK = 64, 512
#: what the decode rule (:func:`_decode_split`) knows of the ``decode``
#: kernel (``csrc/flash_decode_sm90.cu``; its launcher checks the rest):
#: chunks are multiples of ``_DECODE_BK`` keys (a ring stage) up to
#: ``_DECODE_MAX_CHUNK``, and a block takes at most ``_DECODE_ROWS[width]``
#: query rows
_DECODE_BK, _DECODE_MAX_CHUNK = 32, 1024
_DECODE_ROWS = {64: 64, 128: 32}
#: the decode rule: at most this many blocks an SM (four fit one, so
#: every block of a call is resident at once), and at most
#: ``_DECODE_CLUSTER`` chunks (the kernel merges up to that many in one
#: thread block cluster)
_DECODE_WAVE, _DECODE_CLUSTER = 3, 8
#: the decode kernel merges a call of 2 .. ``_DECODE_CLUSTER`` chunks in a
#: thread block cluster (True) or, as a call of more, through its atomic
#: ticket (False: ``chip_smoke.py`` phase 4 times both)
_DECODE_CLUSTER_MERGE = True
#: the ``mma.sync`` forward's tile by its rule, and its other tiles,
#: instantiated at the widths in ``_TUNED_DIMS``
_RULE_TILE = (64, 64)
_TUNED_TILES = ((64, 32), (64, 128), (128, 64), (128, 128))
_TUNED_DIMS = (64, 128)
#: the ``wgmma`` forward's tiles (``csrc/flash_attention_sm90.cu``), at
#: the widths in ``_TUNED_DIMS``: 64 or 128 query rows by 96 or 160 keys
_WGMMA_TILES = ((64, 96), (128, 96), (64, 160), (128, 160))

#: the tuner's config version of the flash forward (2: the ``wgmma``
#: rule and tiles; 3: a decode chunk is the ``decode`` kernel's)
TUNE_VERSION = 3


def tune_bucket(tq: int, tk: int, d: int, causal: bool, has_bias: bool,
                windowed: bool) -> str:
    """Config-cache shape bucket (the JAX package's string): sequence
    lengths round up to powers of two; head width, causality, the
    ``[B, T, S]`` bias flag and the window flag are exact."""
    return (f"q{_space.pow2_bucket(tq)}_k{_space.pow2_bucket(tk)}_d{d}"
            f"_c{int(causal)}_b{int(has_bias)}_w{int(windowed)}")


def tiles(d: int, dtype: torch.dtype) -> Tuple[Tuple[int, int], ...]:
    """The tensor-core forwards' tiles ``(block_q, block_k)`` for head
    width ``d`` and ``dtype``, each naming one kernel: at widths 64 and
    128 the ``wgmma`` kernel's (the rule, :func:`rule_tile`, is one of
    them) and then the ``mma.sync`` kernel's; at 16 and 32 the ``mma.sync``
    rule's 64 x 64 alone; none for fp32 and widths above 128 (the SIMT
    kernel has no tile knob)."""
    dk = _kernel_dim(d)
    if dtype == torch.float32 or dk > 128:
        return ()
    if dk not in _TUNED_DIMS:
        return (_RULE_TILE,)
    return _WGMMA_TILES + (_RULE_TILE,) + _TUNED_TILES


def rule_tile(d: int, dtype: torch.dtype) -> Tuple[int, int]:
    """The forward's tile by the rule for a prefill of head width ``d``
    (a decode chunk is :func:`_decode_split`'s or :func:`_kv_split`'s):
    in bf16 and fp16 the
    ``wgmma`` kernel's 64 x 96 at width 64 (three blocks an SM) and its
    128 x 96 at 128, each the fastest tile at every phase-4 shape of
    ``chip_smoke.py`` on the H100; else the ``mma.sync`` rule's 64 x 64
    (the SIMT kernel ignores it).  A call whose views TMA cannot read
    takes the ``mma.sync`` rule instead (:func:`_route`)."""
    dk = _kernel_dim(d)
    if dtype == torch.float32 or dk not in _TUNED_DIMS:
        return _RULE_TILE
    return (64, 96) if dk == 64 else (128, 96)


def _is_wgmma(tile) -> bool:
    return tile is not None and tuple(tile) in _WGMMA_TILES


def tile_fits(tq: int, d: int, dtype: torch.dtype, tile: Tuple[int, int],
              bias: bool = False, route: Optional[str] = None) -> bool:
    """Whether the forward kernel that ``tile`` names takes it for ``tq``
    query rows of width ``d`` in ``dtype`` (with a ``[B, T, S]`` bias or
    none): a tensor-core tile it is instantiated at whose stages fit the
    block's shared memory, or on decode (``tq`` < 16) a chunk of
    ``tile[1]`` keys that the decode route's kernel takes (``route``:
    ``decode`` or ``split``; None: the one the rule gives views TMA can
    read).  The kernel's own check, asked of the built library without a
    launch, so only on the card."""
    decode = tq < _SPLIT_TQ
    prm = _FlashParams(tq=tq, splits=int(decode), H=1, Hkv=1,
                       chunk=int(tile[1]) if decode else 0,
                       bias=1 if bias and not decode else None)
    mma = (-1, -1) if decode else (int(tile[0]), int(tile[1]))
    dk, code = _kernel_dim(d), _build.dtype_code(dtype)
    if decode and (route or _route(tq, d, dtype, None, True)) == "decode":
        return _decode_lib().flash_attention_fwd_decode_check(
            ctypes.byref(prm), dk, code) == 0
    if not decode and _is_wgmma(mma):
        return _wgmma_lib().flash_attention_fwd_wgmma_check(
            ctypes.byref(prm), dk, code, *mma) == 0
    return _fwd_lib().flash_attention_fwd_check(
        ctypes.byref(prm), dk, code, *mma) == 0


# -- plain versions -------------------------------------------------------------

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


def _scores(q, k, kbias, bias, sm_scale):
    """fp32 ``[B, H, T, S]`` scores with both biases added; k already has
    one head per query head."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    if kbias is not None:
        s = s + kbias.float()[:, None, None, :]
    if bias is not None:
        s = s + (bias.float()[:, None] if bias.dim() == 3 else bias.float())
    return s


def _repeat_kv(q, *kv):
    grp = q.shape[2] // kv[0].shape[2]
    return [x.repeat_interleave(grp, dim=2) if grp > 1 else x for x in kv]


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
    k, v = _repeat_kv(q, k, v)
    s = _scores(q, k, kbias, bias, sm_scale)
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


def _flash_fwd_split_ref(q, k, v, kbias, bias, *, sm_scale: float,
                         causal: bool, q_offset: int = 0,
                         window: Optional[int] = None, chunk: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decode routes' arithmetic in plain PyTorch (the split-KV
    kernels' and ``csrc/flash_decode_sm90.cu``'s): the function of
    :func:`_flash_fwd_ref`, computed over keys in chunks of ``chunk`` and
    merged as the combine kernel and the decode kernel merge them.

    Each chunk c keeps fp32 ``(m_c, l_c, acc_c)``: its visible maximum,
    ``l_c = sum p``, ``acc_c = sum p v`` with ``p = exp(s - m_c)`` rounded
    to the value dtype for the product (``l_c == 0`` where the chunk has
    no visible key).  The merge takes ``M = max m_c`` over the chunks with
    ``l_c > 0``, weights ``w_c = exp(m_c - M)`` in chunk order, and
    returns ``out = sum w_c acc_c / sum w_c l_c`` and ``lse = M + log(sum
    w_c l_c)``; no live chunk gives zeros and ``lse = NEG_INF``."""
    k, v = _repeat_kv(q, k, v)
    s = _scores(q, k, kbias, bias, sm_scale)
    tq, tk = q.shape[1], k.shape[1]
    if causal:
        vis = _visible(tq, tk, q_offset, window, q.device)
    else:
        vis = torch.ones((tq, tk), dtype=torch.bool, device=q.device)
    s = torch.where(vis, s, torch.full_like(s, float("-inf")))
    parts = []
    for c0 in range(0, tk, chunk):
        sc = s[..., c0:c0 + chunk]
        mx = sc.amax(dim=-1, keepdim=True)
        mu = torch.where(mx == float("-inf"), torch.zeros_like(mx), mx)
        p = torch.exp(sc - mu)
        l_c = p.sum(dim=-1, keepdim=True)
        acc = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(),
                           v[:, c0:c0 + chunk].float())
        parts.append((mx, l_c, acc))
    live = [l_c > 0 for _, l_c, _ in parts]
    m_all = torch.stack([torch.where(ok, mx, torch.full_like(mx, -1e38))
                         for ok, (mx, _, _) in zip(live, parts)])
    big_m = m_all.amax(dim=0)
    l_sum = torch.zeros_like(big_m)
    o_sum = torch.zeros_like(parts[0][2])
    for ok, (mx, l_c, acc) in zip(live, parts):
        w = torch.where(ok, torch.exp(mx - big_m), torch.zeros_like(mx))
        l_sum = l_sum + l_c * w
        o_sum = o_sum + acc * w
    any_live = l_sum > 0
    out = torch.where(any_live, o_sum / torch.where(any_live, l_sum, 1.0),
                      torch.zeros_like(o_sum))
    lse = torch.where(any_live, big_m + torch.log(torch.where(
        any_live, l_sum, 1.0)), torch.full_like(l_sum, NEG_INF))
    return out.permute(0, 2, 1, 3).to(q.dtype), lse[..., 0]


def _delta(do, out) -> torch.Tensor:
    """``rowsum(dO * out)`` in fp32, ``[B, H, T]`` contiguous (a plain
    reduction outside the kernels, as in the JAX package)."""
    return (do.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()


def _flash_bwd_ref(q, k, v, kbias, bias, out, lse, do, *, sm_scale: float,
                   causal: bool, q_offset: int = 0,
                   window: Optional[int] = None):
    """The backward kernels' arithmetic in plain PyTorch, on materialized
    scores (the recompute of the JAX ``_recompute_p_ds``).

    Arguments as :func:`_flash_fwd_ref` plus the forward's ``out`` and
    fp32 ``lse`` and the output gradient ``do``.  Returns ``(dq, dk, dv,
    dkbias, dbias)``: dq/dk/dv in the inputs' dtypes and layouts (the
    query heads sharing a KV head summed in fp32), ``dkbias`` fp32 ``[B,
    S]`` and ``dbias`` fp32 in ``bias``'s shape, each None without that
    bias.  ``p`` is rounded to dO's dtype before ``p^T dO`` and ``ds`` to
    the input dtype before ``ds K`` and ``ds^T Q``, where the kernels
    round; the bias gradients take the unrounded ``ds / sm_scale``."""
    b, tq, h, d = q.shape
    tk, h_kv = k.shape[1], k.shape[2]
    kr, vr = _repeat_kv(q, k, v)
    s = _scores(q, kr, kbias, bias, sm_scale)
    if causal:
        vis = _visible(tq, tk, q_offset, window, q.device)
        s = torch.where(vis, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - lse[..., None])
    if causal:
        p = torch.where(vis, p, torch.zeros_like(p))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vr.float())
    ds = p * (dp - _delta(do, out)[..., None]) * sm_scale
    dsr = ds.to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", dsr, kr.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", dsr, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dk = dk.reshape(b, tk, h_kv, h // h_kv, d).sum(3)
    dv = dv.reshape(b, tk, h_kv, h // h_kv, d).sum(3)
    dkbias = None if kbias is None else ds.sum(dim=(1, 2)) / sm_scale
    dbias = None
    if bias is not None:
        dbias = (ds.sum(1) if bias.dim() == 3 else ds) / sm_scale
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dkbias, dbias)


# -- CUDA kernels ---------------------------------------------------------------

class _FlashParams(ctypes.Structure):
    """Mirror of ``struct Params`` in ``csrc/flash_attention.cu``."""
    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ("q", "k", "v", "kbias", "bias", "out", "lse", "part_o",
                  "part_ml")]
                + [(n, ctypes.c_int64) for n in
                   ("sq_b", "sq_t", "sq_h", "sk_b", "sk_t", "sk_h",
                    "sv_b", "sv_t", "sv_h", "so_b", "so_t", "so_h",
                    "skb_b", "sb_b", "sb_t")]
                + [(n, ctypes.c_int32) for n in
                   ("B", "H", "Hkv", "tq", "tk", "causal", "q_offset",
                    "window", "d", "vec", "splits", "chunk", "bvec")]
                + [("sm_scale", ctypes.c_float)])


class _FlashBwdParams(ctypes.Structure):
    """Mirror of ``struct BwdParams`` in ``csrc/flash_attention_bwd.cu``."""
    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ("q", "k", "v", "dout", "lse", "delta", "kbias", "bias",
                  "dq", "dk", "dv", "dkbias", "dbias")]
                + [(f"s{n}_{a}", ctypes.c_int64)
                   for n in ("q", "k", "v", "do", "dq", "dk", "dv")
                   for a in "bth"]
                + [(n, ctypes.c_int64) for n in ("skb_b", "sb_b", "sb_t")]
                + [(n, ctypes.c_int32) for n in
                   ("B", "H", "Hkv", "tq", "tk", "causal", "q_offset",
                    "window", "d")]
                + [("sm_scale", ctypes.c_float)])


def _fwd_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_fwd
    fn.argtypes = [ctypes.POINTER(_FlashParams)] + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    check = lib.flash_attention_fwd_check
    check.argtypes = [ctypes.POINTER(_FlashParams)] + [ctypes.c_int] * 4
    check.restype = ctypes.c_int
    return lib


def _wgmma_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_sm90")
    fn = lib.flash_attention_fwd_wgmma
    fn.argtypes = [ctypes.POINTER(_FlashParams)] + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    check = lib.flash_attention_fwd_wgmma_check
    check.argtypes = [ctypes.POINTER(_FlashParams)] + [ctypes.c_int] * 4
    check.restype = ctypes.c_int
    return lib


def _decode_lib() -> ctypes.CDLL:
    lib = _build.load("flash_decode_sm90")
    fn = lib.flash_attention_fwd_decode
    fn.argtypes = [ctypes.POINTER(_FlashParams), ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    check = lib.flash_attention_fwd_decode_check
    check.argtypes = [ctypes.POINTER(_FlashParams), ctypes.c_int,
                      ctypes.c_int]
    check.restype = ctypes.c_int
    rows = lib.flash_attention_fwd_decode_rows
    rows.argtypes = [ctypes.c_int, ctypes.c_int]
    rows.restype = ctypes.c_int
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd")
    for fn in (lib.flash_attention_bwd_dq, lib.flash_attention_bwd_dkv,
               lib.flash_attention_bwd_db2):
        fn.argtypes = [ctypes.POINTER(_FlashBwdParams), ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _bwd_wgmma_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd_sm90")
    for fn in (lib.flash_attention_bwd_dq_wgmma,
               lib.flash_attention_bwd_dkv_wgmma):
        fn.argtypes = [ctypes.POINTER(_FlashBwdParams), ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check_kernel_inputs(q, k, v, kbias, bias, *extra):
    """Validate what every flash kernel takes and bring the biases to
    the fp32 layouts the kernels read; returns ``(kbias, bias)``."""
    b, tq, _, d = q.shape
    tk = k.shape[1]
    _build.dtype_code(q.dtype)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if d < 1:
        raise ValueError(f"flash kernel head_dim must be >= 1, got {d}")
    if tq < 1 or tk < 1:
        raise ValueError("flash kernel needs q_len >= 1 and kv_len >= 1")
    for name, t in (("q", q), ("k", k), ("v", v), *extra):
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
    return kbias, bias


def _strides(**tensors):
    return {f"s{n}_{a}": t.stride(i) for n, t in tensors.items()
            for i, a in enumerate("bth")}


def _common(q, k, kbias, bias, *, sm_scale, causal, q_offset, window):
    return dict(
        kbias=None if kbias is None else kbias.data_ptr(),
        bias=None if bias is None else bias.data_ptr(),
        skb_b=0 if kbias is None else kbias.stride(0),
        sb_b=0 if bias is None else bias.stride(0),
        sb_t=0 if bias is None else bias.stride(1),
        B=q.shape[0], H=q.shape[2], Hkv=k.shape[2], tq=q.shape[1],
        tk=k.shape[1], causal=int(causal), q_offset=int(q_offset),
        window=0 if window is None else int(window), d=q.shape[3],
        sm_scale=float(sm_scale))


def _kernel_dim(d: int) -> int:
    """The instantiated head width a width-``d`` call runs in: the
    widest for a wider head, which its kernels take in slices."""
    return next((w for w in _KERNEL_DIMS if w >= d), _KERNEL_DIMS[-1])


def _vec16(d: int, *tensors) -> int:
    """1 when every row of every tensor starts on a 16-byte boundary and
    ``d`` is a multiple of 8: the 16-byte copies apply."""
    return int(d % 8 == 0 and all(
        t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:-1])
        for t in tensors))


def _tma_ok(d: int, *tensors, bias=None) -> bool:
    """Whether the ``wgmma`` kernel's TMA loads and store can read every
    view in place: ``d`` a multiple of 8 (the contiguous output's rows),
    each of q, k, v and out starting on a 16-byte boundary with every
    stride but the last (of a dimension longer than 1) a nonzero multiple
    of 8 elements (16 bytes), and the fp32 ``[B, T, S]`` bias, when
    there is one, 16-byte aligned with its row stride a nonzero multiple
    of 4 and its batch stride a multiple of 4 (0, a broadcast batch, is
    read as one row of batches).  The routing rule: a call that breaks
    it runs the ``mma.sync`` kernel."""
    if d % 8:
        return False
    for t in tensors:
        if t.data_ptr() % 16:
            return False
        for s, n in zip(t.stride()[:-1], t.shape[:-1]):
            if n > 1 and (s % 8 or not s):
                return False
    if bias is None:
        return True
    return (bias.data_ptr() % 16 == 0
            and (bias.shape[0] == 1 or bias.stride(0) % 4 == 0)
            and (bias.shape[1] == 1 or (bias.stride(1) % 4 == 0
                                        and bias.stride(1) != 0)))


def _route(tq: int, d: int, dtype: torch.dtype, tile, tma: bool) -> str:
    """The kernel a forward call runs (the key of
    ``flash_fwd_kernel.routes`` it counts in).  For ``tq`` < 16:
    ``decode`` (``csrc/flash_decode_sm90.cu``) for bf16 and fp16 at widths
    64 and 128 (heads 33-128) where K and V meet TMA's rules and the
    kernel's check takes the call (``tma``: :func:`_decode_ok` and
    :func:`_decode_route`), else ``split``.  Else ``simt`` for fp32 and
    widths above 128, ``wgmma`` for a tile of ``_WGMMA_TILES`` or, with
    no tile, at widths 64 and 128 where the views meet TMA's rules
    (``tma``, :func:`_tma_ok`), else ``mma``.  On decode the tile is the chunk and
    names no kernel."""
    dk = _kernel_dim(d)
    if tq < _SPLIT_TQ:
        return ("decode" if dtype != torch.float32 and dk in _TUNED_DIMS
                and tma else "split")
    if dtype == torch.float32 or dk > 128:
        return "simt"
    if tile is not None:
        return "wgmma" if _is_wgmma(tile) else "mma"
    return "wgmma" if dk in _TUNED_DIMS and tma else "mma"


def _decode_ok(q, k, v) -> bool:
    """Whether the ``decode`` kernel can read this call's K and V by TMA
    (:func:`_tma_ok` of k and v: q and the output are read and written
    by plain loads and stores) at its width.  The decode routing rule's
    view half (:func:`_decode_route` adds the kernel's own check)."""
    d = q.shape[3]
    return _kernel_dim(d) in _TUNED_DIMS and _tma_ok(d, k, v)


def _bwd_route(d: int, dtype: torch.dtype, tma: bool) -> str:
    """The kernel a dQ or dK/dV call runs (the key of
    ``flash_bwd_dq_kernel.routes`` and ``flash_bwd_dkv_kernel.routes`` it
    counts in): ``simt`` for fp32 and widths above 128, ``wgmma``
    (``csrc/flash_attention_bwd_sm90.cu``) at widths 64 and 128 (heads
    33-128 wide) where every view meets TMA's rules (``tma``,
    :func:`_tma_ok` of q, k, v, do, the outputs and the bias), else
    ``mma`` (``mma.sync``): widths 16 and 32, and views TMA cannot
    read."""
    dk = _kernel_dim(d)
    if dtype == torch.float32 or dk > 128:
        return "simt"
    return "wgmma" if dk in _TUNED_DIMS and tma else "mma"


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _bias_vec(bias) -> int:
    """1 when the fp32 ``[B, T, S]`` bias takes 16-byte copies: S and the
    strides multiples of 4 floats, the start 16-byte aligned."""
    return int(bias is not None and bias.shape[2] % 4 == 0
               and bias.stride(0) % 4 == 0 and bias.stride(1) % 4 == 0
               and bias.data_ptr() % 16 == 0)


def _kv_split(b: int, h: int, tk: int, sms: int) -> Tuple[int, int]:
    """``(splits, chunk)`` for the ``split`` route: enough chunks that
    B * H * splits blocks cover the SMs about four times, each chunk a
    multiple of 32 keys between ``_MIN_CHUNK`` and ``_MAX_CHUNK``."""
    want = max(1, -(-4 * sms // (b * h)))
    chunk = -(-tk // want)
    chunk = min(_MAX_CHUNK, max(_MIN_CHUNK, -(-chunk // 32) * 32))
    return -(-tk // chunk), chunk


def _decode_split(b: int, h_kv: int, rows: int, tk: int, d: int,
                  sms: int) -> Tuple[int, int]:
    """``(splits, chunk)`` for the ``decode`` route, ``rows`` the query
    rows of a KV head (query heads over KV heads x q_len): as many chunks
    as keep the blocks (B x Hkv x row blocks x splits) within
    ``_DECODE_WAVE`` an SM, at most ``_DECODE_CLUSTER``, each a multiple
    of ``_DECODE_BK`` keys up to ``_DECODE_MAX_CHUNK``.  On the H100 at
    serving's B 8, 12 heads of 64: 4 chunks of 256 keys at 1,024 keys,
    of 64 at 256, and 8 of 128 for 4 KV heads (chip_smoke phase 4)."""
    units = b * h_kv * -(-rows // _DECODE_ROWS[_kernel_dim(d)])
    splits = max(1, min(_DECODE_CLUSTER, _DECODE_WAVE * sms // units))
    chunk = -(-tk // splits)
    chunk = -(-chunk // _DECODE_BK) * _DECODE_BK
    chunk = min(_DECODE_MAX_CHUNK, chunk)
    return -(-tk // chunk), chunk


def _decode_scratch(q, k, splits: int, chunk: int):
    """The ``decode`` kernel's fp32 partials ``(part_o, part_ml)`` of a
    call of more than one chunk (``[units][splits][rows][D]`` and
    ``[units][splits][rows][2]``), else ``(None, None)``."""
    if splits == 1:
        return None, None
    d = q.shape[3]
    rows = q.shape[1] * (q.shape[2] // k.shape[2])
    per = _decode_lib().flash_attention_fwd_decode_rows(_kernel_dim(d),
                                                        chunk)
    units = q.shape[0] * k.shape[2] * -(-rows // per)
    n = units * splits * min(rows, per)
    return (torch.empty(n * _kernel_dim(d), dtype=torch.float32,
                        device=q.device),
            torch.empty(n * 2, dtype=torch.float32, device=q.device))


def _pick_fwd_route(route: Optional[str], rule: str) -> str:
    """The forward's route: the rule's, or ``route`` where the call can
    take it: the rule's own, or ``split`` where the rule is ``decode``
    (the comparisons of the card's tests and ``chip_smoke.py``); any
    other raises ``ValueError``."""
    if route is None or route == rule:
        return rule
    if route == "split" and rule == "decode":
        return route
    raise ValueError(f"flash forward route {route!r} cannot serve this "
                     f"call (its rule is {rule!r})")


def flash_fwd_kernel(q, k, v, kbias, bias, *, sm_scale: float,
                     causal: bool, q_offset: int = 0,
                     window: Optional[int] = None,
                     tile: Optional[Tuple[int, int]] = None,
                     route: Optional[str] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA forward kernel: the arguments of
    :func:`_flash_fwd_ref` (a 3-D ``bias`` only), CUDA tensors; returns
    ``(out, lse)``.  ``q_len >= 16`` runs one kernel: the ``wgmma`` one
    for bf16/fp16 at widths 33-128 where TMA can read the views, else
    ``mma.sync`` tensor cores up to width 128, fp32 FMA for fp32 and above
    128 (:func:`_route`).  A shorter call runs the ``decode`` kernel (one
    launch, bf16/fp16 at widths 33-128 where TMA can read K and V,
    :func:`_decode_route`) or else the split-KV kernel and its combine
    (two); :func:`_flash_fwd_split_ref` is the arithmetic of both, with fp32
    scratch allocated here.  ``route="split"`` runs the split-KV kernels
    where the rule is ``decode`` (:func:`_pick_fwd_route`; any other
    route the call cannot take raises ``ValueError``).  ``tile``:
    ``(block_q, block_k)``, None for the rule (:func:`rule_tile`); a
    tensor-core tile names its kernel (a half at -1 is 64), a decode
    route takes a chunk of ``block_k`` keys (:func:`_decode_split` and
    :func:`_kv_split` are the rules), the SIMT kernel none; one the kernel
    refuses (:func:`tile_fits`), or a ``wgmma`` tile on views TMA cannot
    read, raises ``ValueError``.  ``q_offset`` may be any signed value
    (ring attention passes ``q_off - k_off``): a row that sees no key gives
    ``out = 0`` and ``lse = NEG_INF``, and the kernels skip every key tile
    no row of a block sees (chip_smoke phase 36).  Adds one to
    ``flash_fwd_kernel.launches`` and to ``flash_fwd_kernel.routes[route]``
    per call."""
    kbias, bias = _check_kernel_inputs(q, k, v, kbias, bias)
    b, tq, h, d = q.shape
    dk = _kernel_dim(d)
    decode = tq < _SPLIT_TQ
    if tile is not None:
        tile = (int(tile[0]), int(tile[1]))
        if not decode:
            tile = (64 if tile[0] < 0 else tile[0],
                    64 if tile[1] < 0 else tile[1])
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    tma = False
    if decode:
        rule = _decode_route(q, k, v)
    else:
        # TMA's rule is asked only of a call the wgmma kernel could serve
        tma = (q.dtype != torch.float32 and dk in _TUNED_DIMS
               and _tma_ok(d, q, k, v, out, bias=bias))
        rule = _route(tq, d, q.dtype, tile, tma)
    route = _pick_fwd_route(route, rule)
    if tile is not None and not tile_fits(tq, d, q.dtype, tile,
                                          bias is not None, route=route):
        raise ValueError(
            f"flash tile {tile} is not one the forward kernel takes for "
            f"{tq} query rows of width {d}, {q.dtype}"
            f"{' with a bias' if bias is not None else ''}: the "
            f"tensor-core tiles {tiles(d, q.dtype)}, or on decode a chunk "
            f"of 32 keys or a multiple within the kernel's bounds")
    if route == "wgmma" and not tma:
        raise ValueError(
            f"flash tile {tile} is the wgmma kernel's, whose TMA loads "
            f"cannot read these views (16-byte aligned starts, strides "
            f"multiples of 16 bytes, head width a multiple of 8)")
    mma = (-1, -1)
    if route == "wgmma":
        mma = tile or rule_tile(d, q.dtype)
    elif route == "mma" and tile is not None:
        mma = tile
    splits = chunk = 0
    part_o = part_ml = None
    if decode:
        tk, sms = k.shape[1], _sm_count(q.device.index or 0)
        if tile is not None:
            chunk = tile[1]
        elif route == "decode":
            chunk = _decode_split(b, k.shape[2], tq * (h // k.shape[2]), tk,
                                  d, sms)[1]
        else:
            chunk = _kv_split(b, h, tk, sms)[1]
        splits = -(-tk // chunk)
        if route == "decode":
            part_o, part_ml = _decode_scratch(q, k, splits, chunk)
        else:
            part_o = torch.empty((b, h, tq, splits, -(-d // dk) * dk),
                                 dtype=torch.float32, device=q.device)
            part_ml = torch.empty((b, h, tq, splits, 2),
                                  dtype=torch.float32, device=q.device)
    prm = _FlashParams(
        q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(),
        out=out.data_ptr(), lse=lse.data_ptr(),
        part_o=None if part_o is None else part_o.data_ptr(),
        part_ml=None if part_ml is None else part_ml.data_ptr(),
        vec=_vec16(d, q, k, v, out), splits=splits, chunk=chunk,
        bvec=_bias_vec(bias),
        **_strides(q=q, k=k, v=v, o=out),
        **_common(q, k, kbias, bias, sm_scale=sm_scale, causal=causal,
                  q_offset=q_offset, window=window))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = _build.dtype_code(q.dtype)
    with torch.cuda.device(q.device):
        if route == "decode":
            err = _decode_lib().flash_attention_fwd_decode(
                ctypes.byref(prm), dk, code, int(_DECODE_CLUSTER_MERGE),
                stream)
        elif route == "wgmma":
            err = _wgmma_lib().flash_attention_fwd_wgmma(
                ctypes.byref(prm), dk, code, *mma, stream)
        else:
            err = _fwd_lib().flash_attention_fwd(
                ctypes.byref(prm), dk, code, *mma, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd ({route}) launch failed: "
                           f"CUDA error {err}")
    flash_fwd_kernel.launches += 1
    flash_fwd_kernel.routes[route] += 1
    return out, lse


_build.counted(flash_fwd_kernel)
#: the forward's launches by the kernel that served them (:func:`_route`),
#: counted as ``launches`` is (a captured graph's replays included)
flash_fwd_kernel.routes = {"wgmma": 0, "mma": 0, "simt": 0, "split": 0,
                           "decode": 0}


def _launch_bwd(which: str, q, k, v, do, lse, delta, kbias, bias, dq, dk,
                dv, dkbias, kw, dbias=None, route: Optional[str] = None):
    prm = _FlashBwdParams(
        q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), dout=do.data_ptr(),
        lse=lse.data_ptr(), delta=delta.data_ptr(),
        dq=None if dq is None else dq.data_ptr(),
        dk=None if dk is None else dk.data_ptr(),
        dv=None if dv is None else dv.data_ptr(),
        dkbias=None if dkbias is None else dkbias.data_ptr(),
        dbias=None if dbias is None else dbias.data_ptr(),
        **_strides(q=q, k=k, v=v, do=do, dq=q if dq is None else dq,
                   dk=k if dk is None else dk, dv=v if dv is None else dv),
        **_common(q, k, kbias, bias, **kw))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if route == "wgmma":
        name, lib = f"flash_attention_bwd_{which}_wgmma", _bwd_wgmma_lib()
    else:
        name, lib = f"flash_attention_bwd_{which}", _bwd_lib()
    with torch.cuda.device(q.device):
        err = getattr(lib, name)(ctypes.byref(prm), _kernel_dim(q.shape[3]),
                                 _build.dtype_code(q.dtype), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _pick_bwd_route(route: Optional[str], q, k, v, do, bias, *outs) -> str:
    """The route of a dQ or dK/dV call: the rule's (:func:`_bwd_route`,
    TMA's rule asked only of a call the ``wgmma`` kernels could serve), or
    ``route`` where the call can take it: the rule's own, or ``mma`` where
    the rule is ``wgmma`` (the comparisons of the card's tests and
    ``chip_smoke.py``); any other raises ``ValueError``."""
    d = q.shape[3]
    tma = (q.dtype != torch.float32 and _kernel_dim(d) in _TUNED_DIMS
           and _tma_ok(d, q, k, v, do, *outs, bias=bias))
    rule = _bwd_route(d, q.dtype, tma)
    if route is None or route == rule:
        return rule
    if route == "mma" and rule == "wgmma":
        return route
    raise ValueError(f"flash backward route {route!r} cannot serve this "
                     f"call (its rule is {rule!r})")


def _check_bwd_extras(q, do, lse, delta):
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError("do must have q's shape and dtype")
    want = (q.shape[0], q.shape[2], q.shape[1])
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.shape != want or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"{name} must be a contiguous fp32 {want} "
                             f"tensor on q's device")


def flash_bwd_dq_kernel(q, k, v, do, lse, delta, kbias, bias, *,
                        sm_scale: float, causal: bool, q_offset: int = 0,
                        window: Optional[int] = None,
                        route: Optional[str] = None) -> torch.Tensor:
    """Launch the CUDA dQ kernel: the forward's arguments plus the output
    gradient ``do`` (q's shape and dtype), the forward's fp32 ``lse`` and
    ``delta = rowsum(do * out)`` (both ``[B, H, T]`` contiguous); returns
    dq in q's shape and dtype.  One kernel a call (:func:`_bwd_route`,
    dK/dV likewise): bf16/fp16 at widths 33-128 on ``wgmma`` where TMA
    can read the views, else on ``mma.sync`` up to width 128; fp32 and
    wider heads in fp32 FMA loops.  ``route`` runs the kernel it names
    where the call can take it (None: the rule's; :func:`_pick_bwd_route`).
    Adds one to ``flash_bwd_dq_kernel.launches`` and to
    ``flash_bwd_dq_kernel.routes[route]`` per launch."""
    kbias, bias = _check_kernel_inputs(q, k, v, kbias, bias, ("do", do))
    _check_bwd_extras(q, do, lse, delta)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    route = _pick_bwd_route(route, q, k, v, do, bias, dq)
    _launch_bwd("dq", q, k, v, do, lse, delta, kbias, bias, dq, None, None,
                None, dict(sm_scale=sm_scale, causal=causal,
                           q_offset=q_offset, window=window), route=route)
    flash_bwd_dq_kernel.launches += 1
    flash_bwd_dq_kernel.routes[route] += 1
    return dq


_build.counted(flash_bwd_dq_kernel)
#: dQ's launches by the kernel that served them (:func:`_bwd_route`),
#: counted as ``launches`` is (a captured graph's replays included)
flash_bwd_dq_kernel.routes = {"wgmma": 0, "mma": 0, "simt": 0}


def flash_bwd_dkv_kernel(q, k, v, do, lse, delta, kbias, bias, *,
                         sm_scale: float, causal: bool, q_offset: int = 0,
                         window: Optional[int] = None,
                         kbias_grad: bool = False,
                         route: Optional[str] = None):
    """Launch the CUDA dK/dV kernel (arguments and route as
    :func:`flash_bwd_dq_kernel`); returns ``(dk, dv, dkbias_part)``: dk
    and dv in k's shape and dtype (query heads of one KV head summed), and
    with ``kbias_grad`` the fp32 ``[B, H, S]`` column sums of ``ds`` (the
    key-padding-bias gradient before the head sum and the division by
    ``sm_scale``), else None.  Adds one to
    ``flash_bwd_dkv_kernel.launches`` and to
    ``flash_bwd_dkv_kernel.routes[route]`` per launch."""
    kbias, bias = _check_kernel_inputs(q, k, v, kbias, bias, ("do", do))
    _check_bwd_extras(q, do, lse, delta)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    part = None
    if kbias_grad:
        part = torch.empty((q.shape[0], q.shape[2], k.shape[1]),
                           dtype=torch.float32, device=q.device)
    route = _pick_bwd_route(route, q, k, v, do, bias, dk, dv)
    _launch_bwd("dkv", q, k, v, do, lse, delta, kbias, bias, None, dk, dv,
                part, dict(sm_scale=sm_scale, causal=causal,
                           q_offset=q_offset, window=window), route=route)
    flash_bwd_dkv_kernel.launches += 1
    flash_bwd_dkv_kernel.routes[route] += 1
    return dk, dv, part


_build.counted(flash_bwd_dkv_kernel)
#: dK/dV's launches by route, as ``flash_bwd_dq_kernel.routes``
flash_bwd_dkv_kernel.routes = {"wgmma": 0, "mma": 0, "simt": 0}


def flash_bwd_db2_kernel(q, k, v, do, lse, delta, kbias, bias, *,
                         sm_scale: float, causal: bool, q_offset: int = 0,
                         window: Optional[int] = None) -> torch.Tensor:
    """Launch the CUDA bias-gradient kernel (arguments as
    :func:`flash_bwd_dq_kernel`, ``bias`` required): returns the fp32
    ``[B, T, S]`` gradient of the ``[B, T, S]`` bias, ``ds`` summed over
    the query heads and divided by ``sm_scale``, zeros where the causal or
    window band hides a key.  Adds one to
    ``flash_bwd_db2_kernel.launches`` per launch."""
    if bias is None:
        raise ValueError("the bias-gradient kernel needs the [B, T, S] bias")
    kbias, bias = _check_kernel_inputs(q, k, v, kbias, bias, ("do", do))
    _check_bwd_extras(q, do, lse, delta)
    dbias = torch.empty((q.shape[0], q.shape[1], k.shape[1]),
                        dtype=torch.float32, device=q.device)
    _launch_bwd("db2", q, k, v, do, lse, delta, kbias, bias, None, None,
                None, None, dict(sm_scale=sm_scale, causal=causal,
                                 q_offset=q_offset, window=window),
                dbias=dbias)
    flash_bwd_db2_kernel.launches += 1
    return dbias


_build.counted(flash_bwd_db2_kernel)


# -- autograd --------------------------------------------------------------------

def _counted_bwd(walk, ctx, q, k, v, kbias, bias, out, lse, do, kw):
    """The backward under an analytic count: the dQ and dK/dV kernels'
    costs (and db2's when the bias needs a gradient), the plain
    version's arithmetic with its ops hidden."""
    masks = dict(causal=kw["causal"], q_offset=kw["q_offset"],
                 window=kw["window"])
    cost = [_costs.flash_bwd_dq(q, k, v, kbias, bias, **masks),
            _costs.flash_bwd_dkv(q, k, v, kbias, bias,
                                 kbias_grad=ctx.needs_input_grad[3],
                                 **masks)]
    if ctx.needs_input_grad[4]:
        cost.append(_costs.flash_bwd_db2(q, k, v, bias, **masks))
    return walk.kernel(cost, _flash_bwd_ref, q, k, v, kbias, bias, out,
                       lse, do, **kw)


class _FlashAttention(torch.autograd.Function):
    """Forward kernel, saving ``out`` and ``lse``; backward the dQ and
    dK/dV kernels (and the bias-gradient kernel when the ``[B, T, S]``
    bias needs one) on CUDA, the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, kbias, bias, sm_scale, causal, q_offset,
                window, tile):
        kw = dict(sm_scale=sm_scale, causal=causal, q_offset=q_offset,
                  window=window)
        walk = _costs.counting(q)
        if walk is not None:
            out, lse = walk.kernel(
                _costs.flash_fwd(q, k, v, kbias, bias, causal=causal,
                                 q_offset=q_offset, window=window),
                _flash_fwd_ref, q, k, v, kbias, bias, **kw)
        elif q.is_cuda:
            out, lse = flash_fwd_kernel(q, k, v, kbias, bias, tile=tile,
                                        **kw)
        else:
            out, lse = _flash_fwd_ref(q, k, v, kbias, bias, **kw)
        ctx.save_for_backward(q, k, v, kbias, bias, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, kbias, bias, out, lse = ctx.saved_tensors
        kw = ctx.kw
        walk = _costs.counting(q)
        if walk is not None:
            dq, dk, dv, dkb, db = _counted_bwd(walk, ctx, q, k, v, kbias,
                                               bias, out, lse, do, kw)
        elif q.is_cuda:
            do = do if do.stride(-1) == 1 else do.contiguous()
            delta = _delta(do, out)
            dq = flash_bwd_dq_kernel(q, k, v, do, lse, delta, kbias, bias,
                                     **kw)
            dk, dv, part = flash_bwd_dkv_kernel(
                q, k, v, do, lse, delta, kbias, bias,
                kbias_grad=ctx.needs_input_grad[3], **kw)
            dkb = None if part is None else part.sum(1) / kw["sm_scale"]
            db = None
            if ctx.needs_input_grad[4]:
                db = flash_bwd_db2_kernel(q, k, v, do, lse, delta, kbias,
                                          bias, **kw)
        else:
            dq, dk, dv, dkb, db = _flash_bwd_ref(q, k, v, kbias, bias, out,
                                                 lse, do, **kw)
        if dkb is not None:
            dkb = dkb.sum_to_size(kbias.shape).to(kbias.dtype)
        if db is not None:
            db = db.sum_to_size(bias.shape).to(bias.dtype)
        return dq, dk, dv, dkb, db, None, None, None, None, None


# -- public API ---------------------------------------------------------------

def flash_attention(q, k, v, *, causal: bool = False,
                    sm_scale: Optional[float] = None,
                    key_padding_bias=None,
                    bias=None,
                    window: Optional[int] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None):
    """Flash attention.  ``q``: [batch, q_len, heads, head_dim]; ``k, v``:
    [batch, kv_len, kv_heads, head_dim]; returns q's shape and dtype.
    Differentiable in q, k, v, ``key_padding_bias`` and ``bias``.

    ``kv_heads`` may divide ``heads`` (GQA): each KV head serves
    ``heads / kv_heads`` query heads without being repeated on the card.
    ``key_padding_bias``: additive ``[batch, kv_len]`` (0 visible, large
    negative hidden).  ``bias``: additive ``[batch, q_len, kv_len]``
    broadcast over heads (anything broadcastable to it is accepted), or a
    per-head ``[batch, heads, q_len, kv_len]`` bias, which no kernel takes
    (nor in the JAX package): it runs the plain version, differentiable,
    on either device.
    ``window``: sliding-window local attention (needs ``causal``): each
    query sees the last ``window`` keys, itself included.  Causal
    ``q_len < kv_len`` aligns the queries to the END of the keys, the
    KV-cache decode convention.
    ``block_q``/``block_k``: the forward kernel's tile (see the module
    docstring; a missing one is the rule's); left at None, a CUDA call
    consults the tuner's cache, else runs the rule.  An explicit tile
    wins over the cache, as in JAX.  The plain version takes them and
    ignores them.
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
    for name, val in (("block_q", block_q), ("block_k", block_k)):
        if val is not None and (isinstance(val, bool) or int(val) <= 0):
            raise ValueError(f"{name} must be a positive int, got {val!r}")
    has_bias = bias is not None
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

    if per_head_bias is not None:
        # plain torch on either device, as JAX's jnp path: no kernel exists
        out, _ = _flash_fwd_ref(q, k, v, key_padding_bias, per_head_bias,
                                sm_scale=sm_scale, causal=causal,
                                q_offset=q_offset, window=window)
        return out
    tile = None
    if q.is_cuda and _costs.counting(q) is None:
        tile = _pick_tile(q, k, bias, causal, has_bias, window, block_q,
                          block_k, v=v)
    return _FlashAttention.apply(q, k, v, key_padding_bias, bias,
                                 float(sm_scale), bool(causal),
                                 int(q_offset), window, tile)


def _decode_route(q, k, v) -> str:
    """The route the rule gives a decode call (``q_len`` < 16) on these
    CUDA views: ``decode`` where :func:`_route` gives it for the dtype,
    width and views (:func:`_decode_ok`) and the kernel's check takes the
    call at the rule's chunk (:func:`_decode_split`; one ticket a unit of
    several chunks, B x Hkv x row blocks), else ``split``."""
    b, tq, h, d = q.shape
    ok = q.dtype != torch.float32 and _decode_ok(q, k, v)
    if ok:
        chunk = _decode_split(b, k.shape[2], tq * (h // k.shape[2]),
                              k.shape[1], d,
                              _sm_count(q.device.index or 0))[1]
        prm = _FlashParams(B=b, H=h, Hkv=k.shape[2], tq=tq, tk=k.shape[1],
                           chunk=chunk)
        ok = _decode_lib().flash_attention_fwd_decode_check(
            ctypes.byref(prm), _kernel_dim(d),
            _build.dtype_code(q.dtype)) == 0
    return _route(tq, d, q.dtype, None, ok)


def _rule_chunk(q, k, v) -> int:
    """The decode chunk of the rule: :func:`_decode_split`'s where the
    rule runs the ``decode`` kernel, else :func:`_kv_split`'s."""
    b, tq, h, d = q.shape
    sms = _sm_count(q.device.index or 0)
    if _decode_route(q, k, v) == "decode":
        return _decode_split(b, k.shape[2], tq * (h // k.shape[2]),
                             k.shape[1], d, sms)[1]
    return _kv_split(b, h, k.shape[1], sms)[1]


def _tuned_tile(q, k, causal, has_bias, window
                ) -> Optional[Tuple[int, int]]:
    """The consult: the tuned ``(block_q, block_k)`` of this call's
    bucket, or None."""
    shape = (q.shape[1], k.shape[1], q.shape[3], causal, has_bias,
             window is not None)
    cfg = _tuned_config("flash_attention", TUNE_VERSION,
                        lambda: tune_bucket(*shape),
                        params=("block_q", "block_k"), key=shape)
    return (cfg["block_q"], cfg["block_k"]) if cfg else None


def _pick_tile(q, k, bias, causal, has_bias, window, block_q, block_k,
               v=None) -> Optional[Tuple[int, int]]:
    """The forward's tile for a kernel call: the caller's (a missing half
    64 on a tensor-core kernel, the rule's chunk on decode; the SIMT path
    has no tile and takes none), else the tuned config of this shape's
    bucket when the kernel it names takes it for this call
    (:func:`tile_fits`, and for a ``wgmma`` tile :func:`_tma_ok` of q, k,
    ``v`` (k's layout when None) and the bias), else None (the rule).  The
    kernel path only."""
    tq, d = q.shape[1], q.shape[3]
    v = k if v is None else v
    if tq >= _SPLIT_TQ and not tiles(d, q.dtype):
        return None                                   # SIMT: no tile
    if block_q is None and block_k is None:
        tile = _tuned_tile(q, k, causal, has_bias, window)
        route = _decode_route(q, k, v) if tq < _SPLIT_TQ else None
        if tile is None or not tile_fits(tq, d, q.dtype, tile,
                                         bias is not None, route=route):
            return None
        if tq >= _SPLIT_TQ and _is_wgmma(tile) and not _tma_ok(
                d, q, k, v,
                bias=None if bias is None else bias.to(
                    torch.float32).expand(q.shape[0], tq, k.shape[1])):
            return None
        return tile
    if tq < _SPLIT_TQ:
        return (-1, int(block_k or _rule_chunk(q, k, v)))
    return (int(block_q or -1), int(block_k or -1))
