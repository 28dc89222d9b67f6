"""Quantized matmul: quantize x to int8 inside the kernel, an int8 x int8
-> int32 GEMM on the tensor cores, and a dequantize epilogue — the CUDA
kernel of ``csrc/quant.cu`` with its plain PyTorch version beside it.

Counterpart of ``apex_tpu/quant/kernels.py``; the kernel replaces the
Pallas ``_qmm_kernel`` (``apex_tpu/quant/kernels.py:147``, launched by
``_pallas_qmm``).  The numerics are the JAX package's, op for op:

* activations quantize per tensor against a frozen calibration scale,
  weights per output channel from their current values:
  ``q = clip(round(x * (1 / scale)), -127, 127)`` in fp32, the
  reciprocal taken first and ``round`` half to even;
* ``dequant(q) = q * scale`` with ``scale = amax / 127``; a zero-amax
  channel gets scale 1.0, so it quantizes to exact zeros;
* the GEMM sums int8 products in int32 (exact), and the epilogue is
  ``acc.float() * (x_scale * w_scale[n])``, the product of the scales
  first, rounded once to the output dtype.

So the kernel equals :func:`_qmm_ref` bit for bit.  The weight is
quantized per call in plain torch, as the JAX package does outside its
kernel, and laid out ``[N, Kp]`` (K contiguous, zero columns up to
``Kp``, the next multiple of 16) in that same pass
(:func:`weight_layout`), the B operand layout of ``mma.sync``; the kernel
reads x's columns past K as zero, so any K runs and the integer sums are
those of the unpadded product.  :func:`quantized_matmul` prepares the
weight every call; ``QuantDenseGeneral`` (``layers.py``) prepares it
once per weight version when no gradient is recorded and calls
:func:`_quantized_matmul_prepared`.  The backward is the
straight-through estimator in the operands' own precision (``dx = g @
w.T``, ``dw = x.T @ g``, plain ``torch.matmul``), as in JAX: the int8
path never appears in it.

Dispatch is by the tensor's device: a CPU tensor takes :func:`_qmm_ref`,
a CUDA tensor launches a kernel (every shape, decode rows included —
the TPU's ``_JNP_MAX_ELEMENTS`` crossover and VMEM fit gate do not carry
over) or raises.  ``impl="jnp"`` is the caller's explicit request for the
plain version on either device.

Routes (:func:`_route`, counted in ``qmm_kernel.routes``): the prefill and
training rows (M > 64) run ``csrc/quant_sm90.cu`` (``wgmma`` with TMA
loads) where TMA can read x and qw (:func:`_tma_ok`); the decode rows
(M <= 64) run ``csrc/quant.cu``'s split-K kernel (``split``), and a view
TMA cannot read, or a K under one 128-byte step (where ``wgmma`` measured
slower), its ``mma.sync`` kernel (``mma``).  Every route gives the same
bits.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import _build
from ..prof import costs as _costs
from ..tune import space as _space
from ..tune.dispatch import kernel_config as _tuned_config

__all__ = ["amax_to_scale", "quantize", "dequantize", "channel_scale",
           "quantized_matmul", "quantized_matmul_ref", "saturation_count",
           "QMAX", "TUNE_VERSION", "tune_bucket"]

#: symmetric int8 range: quantized values live in [-QMAX, QMAX].
QMAX = 127.0

#: the tuner's config version of this kernel: bump it when a tile's
#: meaning changes, and every cached config of the old one stops matching
#: (2: the tiles of M > 64 name the ``wgmma`` kernel's)
TUNE_VERSION = 2


def tune_bucket(m: int, k: int, n: int, x_itemsize: int) -> str:
    """Config-cache shape bucket (the JAX package's string): K and N
    exact, rows rounded up to a power of two."""
    return f"m{_space.pow2_bucket(m)}_k{k}_n{n}_i{x_itemsize}"


def _wgmma_tiles(x_itemsize: int) -> Tuple[Tuple[int, int], ...]:
    """``csrc/quant_sm90.cu``'s tiles: the wide one (128 x 256; 64 x 256
    for fp32 x), 128 x 128 and 64 x 128."""
    return ((64 if x_itemsize == 4 else 128, 256), (128, 128), (64, 128))


def tiles(x_itemsize: int) -> Tuple[Tuple[int, int], ...]:
    """The ``(block_m, block_n)`` tiles of the kernels for an x of this
    itemsize, the tuner's candidates: ``csrc/quant.cu``'s decode tiles 16
    x 32 and 64 x 32, then the wide tile (128 x 256; 64 x 256 for fp32
    x) and 64 x 128, which both kernels have, and ``wgmma``'s 128 x 128.
    At M > 64 a tile of the ``wgmma`` kernel runs there (:func:`_route`),
    another on ``mma.sync``.  Which of them a call may run is the
    kernels' ``plan()``'s to say (:func:`kernel_tile`)."""
    wide, mid, narrow = _wgmma_tiles(x_itemsize)
    return ((16, 32), (64, 32), wide, narrow, mid)


def _f32(v, device=None) -> torch.Tensor:
    """``v`` as an fp32 tensor (a Python float is rounded to fp32 first,
    as ``jnp.asarray(v, jnp.float32)`` does)."""
    return torch.as_tensor(v, dtype=torch.float32, device=device)


_QMAX_ON: dict = {}


def _qmax_on(device) -> torch.Tensor:
    """``QMAX`` as a 0-dim fp32 tensor on ``device``, made once.  A divisor
    on the dividend's device: on CUDA, division by a Python scalar (or a
    CPU scalar tensor) multiplies by its reciprocal, which is not the
    correctly rounded quotient JAX takes."""
    t = _QMAX_ON.get(device)
    if t is None:
        t = _QMAX_ON[device] = torch.full((), QMAX, dtype=torch.float32,
                                          device=device)
    return t


def amax_to_scale(amax) -> torch.Tensor:
    """``scale = amax / 127`` with the zero-amax guard (scale 1.0 for
    all-zero tensors or channels, so they round-trip as exact zeros)."""
    amax = _f32(amax)
    return torch.where(amax > 0, amax / _qmax_on(amax.device), 1.0)


def channel_scale(w) -> torch.Tensor:
    """Per-output-channel scales ``[N]`` for a ``[K, N]`` weight matrix:
    absmax over each column, through :func:`amax_to_scale`."""
    return amax_to_scale(w.float().abs().amax(dim=0))


def quantize(x, scale) -> torch.Tensor:
    """Symmetric int8 quantization ``clip(round(x * (1 / scale)), ±127)``
    in fp32, rounding half to even; ``scale`` broadcasts against ``x``.
    The one rounding definition the kernel, the plain version and the
    int8 KV cache share."""
    scale = _f32(scale, x.device)
    q = torch.round(x.float() * torch.reciprocal(scale))
    return torch.clamp(q, -QMAX, QMAX).to(torch.int8)


def dequantize(q, scale, dtype=torch.float32) -> torch.Tensor:
    """``q * scale`` back to ``dtype``."""
    return (q.float() * _f32(scale, q.device)).to(dtype)


def saturation_count(x, x_scale) -> torch.Tensor:
    """Elements of ``x`` whose magnitude exceeds the calibrated range
    ``127 * x_scale`` (they clip under :func:`quantize`): an int32 scalar
    on ``x``'s device, for :meth:`Calibration.note_saturation`."""
    limit = QMAX * _f32(x_scale, x.device)
    return (x.float().abs() > limit).sum().to(torch.int32)


# -- the plain version ----------------------------------------------------------

def _qmm_ref(x2d, qw, x_scale, w_scale, out_dtype) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch (JAX ``_matmul_ref``).

    ``x2d`` ``[M, K]`` fp32, bf16 or fp16; ``qw`` the quantized weight
    ``[N, Kp]`` int8 (:func:`weight_layout`: ``Kp >= K``, the columns
    past K zero, which add nothing); ``x_scale`` a 0-dim fp32 tensor;
    ``w_scale`` ``[N]`` fp32.  The int8 products are summed in fp64,
    which is exact (``|sum| <= 127^2 K < 2^53``), so the result equals
    the int32 accumulation."""
    qx = quantize(x2d, x_scale)
    qw = qw[:, :x2d.shape[1]]
    acc = (qx.double() @ qw.double().t()).to(torch.int32)
    out = acc.float() * (x_scale * w_scale)[None, :]
    return out.to(out_dtype)


def quantized_matmul_ref(x, w, *, x_scale, w_scale=None) -> torch.Tensor:
    """Public plain reference of :func:`quantized_matmul` (the test
    oracle): quantize both operands, int8 x int8 -> int32, dequantize."""
    if w_scale is None:
        w_scale = channel_scale(w)
    x_scale = _f32(x_scale, x.device).reshape(())
    w_scale = _f32(w_scale, x.device).reshape(w.shape[1])
    lead = x.shape[:-1]
    out = _qmm_ref(x.reshape(-1, x.shape[-1]), weight_layout(w, w_scale),
                   x_scale, w_scale, x.dtype)
    return out.reshape(*lead, w.shape[-1])


def weight_layout(w2d, w_scale) -> torch.Tensor:
    """The quantized weight as the kernel reads it: ``w2d`` ``[K, N]``
    quantized per column by ``w_scale`` ``[N]``, laid out ``[N, Kp]``
    int8 (K contiguous) with zero columns up to ``Kp``, the next multiple
    of 16 (the K step of ``mma.sync.m16n8k32`` loads; TMA's 16-byte rows
    for ``wgmma``'s K-major operand)."""
    k = w2d.shape[0]
    qw = quantize(w2d, w_scale[None, :]).t()
    pad = -k % 16
    if pad:
        qw = torch.nn.functional.pad(qw, (0, pad))
    return qw.contiguous()


# -- the CUDA kernel --------------------------------------------------------------

def _lib() -> ctypes.CDLL:
    lib = _build.load("quant")
    fn = lib.quant_matmul
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    ws = lib.quant_matmul_workspace
    ws.argtypes = [ctypes.c_int] * 6
    ws.restype = ctypes.c_int64
    tl = lib.quant_matmul_tile
    tl.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
    tl.restype = ctypes.c_int
    return lib


def _sm90_lib() -> ctypes.CDLL:
    lib = _build.load("quant_sm90")
    fn = lib.quant_matmul_sm90
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    tl = lib.quant_matmul_sm90_tile
    tl.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    tl.restype = ctypes.c_int
    return lib


def _tma_ok(x2d, qw) -> bool:
    """Whether the ``wgmma`` kernel's TMA loads can read the row-major x
    the wrapper launches on (``x2d`` itself, or its contiguous copy, which
    starts aligned) and ``qw``: 16-byte aligned starts and rows a multiple
    of 16 bytes (``qw``'s are: Kp is a multiple of 16).  The routing rule:
    a call that breaks it runs ``mma.sync``."""
    aligned = not x2d.is_contiguous() or x2d.data_ptr() % 16 == 0
    return (aligned and qw.data_ptr() % 16 == 0
            and x2d.shape[1] * x2d.element_size() % 16 == 0)


# (M, N, x dtype code, block_m, block_n) -> whether the wgmma kernel has it
_SM90_TILES: dict = {}


def _sm90_tile_ok(m, n, x_code, tile) -> bool:
    key = (m, n, x_code, *tile)
    ok = _SM90_TILES.get(key)
    if ok is None:
        out = (ctypes.c_int * 2)()
        ok = _SM90_TILES[key] = _sm90_lib().quant_matmul_sm90_tile(
            m, n, x_code, *tile, out) == 0
    return ok


#: the least K the rule sends to the wgmma kernel: one full 128-byte K
#: step.  At K 8 and 40 (M 1000-1024) it measured slower than mma.sync
#: (0.0061 / 0.0081 ms against 0.0052 / 0.0063), at K 768 and 3072 faster
#: (H100 80GB HBM3, 700 W; chip_smoke.py phase 16)
_WGMMA_MIN_K = 128


def _route(m: int, k: int, n: int, dtype: torch.dtype,
           tile: Optional[Tuple[int, int]], tma: bool) -> str:
    """The kernel an ``[m, k] x [k, n]`` call of x ``dtype`` runs (the key
    of ``qmm_kernel.routes`` it counts in): ``split`` for the decode rows
    (``m`` <= 64: ``csrc/quant.cu``'s kernel, K split over the SMs); else
    ``wgmma`` (``csrc/quant_sm90.cu``) where TMA can read the operands
    (``tma``, :func:`_tma_ok`) and ``tile`` names one of its tiles (a
    half at -1 matches any) or, with no tile, K is at least
    ``_WGMMA_MIN_K``; else ``mma`` (``csrc/quant.cu``)."""
    del n
    if m <= 64:
        return "split"
    if not tma:
        return "mma"
    if tile is None:
        return "wgmma" if k >= _WGMMA_MIN_K else "mma"
    bm, bn = tile
    return ("wgmma" if any((bm < 0 or bm == a) and (bn < 0 or bn == b)
                           for a, b in _wgmma_tiles(dtype.itemsize))
            else "mma")


def kernel_tile(m: int, k: int, n: int, x_dtype: torch.dtype,
                tile: Tuple[int, int] = (-1, -1),
                tma: Optional[bool] = None) -> Optional[Tuple[int, int]]:
    """The ``(block_m, block_n)`` the kernels' ``plan()`` runs for an
    ``[m, k] x [k, n]`` call naming ``tile`` (a half at -1 is the
    rule's; ``(-1, -1)``: the rule's tile), or None when the call's
    kernel (:func:`_route`; ``tma`` None: an aligned x, whose rows TMA
    reads where ``k * itemsize`` is a multiple of 16) has no such tile.
    Asks the built library, so only on the card."""
    out = (ctypes.c_int * 2)()
    code = _build.dtype_code(x_dtype)
    if tma is None:
        tma = k * x_dtype.itemsize % 16 == 0
    want = None if tuple(tile) == (-1, -1) else tuple(tile)
    if _route(m, k, n, x_dtype, want, tma) == "wgmma":
        err = _sm90_lib().quant_matmul_sm90_tile(m, n, code, *tile, out)
    else:
        err = _lib().quant_matmul_tile(m, n, -(-k // 16) * 16, code, *tile,
                                       out)
    if err != 0:
        return None
    return out[0], out[1]


# (M, N, Kp, x dtype code, block_m, block_n) -> int32 elements, -1 for a
# tile the kernel lacks
_WORKSPACE_INTS: dict = {}
_WORKSPACES: dict = {}       # device -> zeroed int32 buffers, largest last


def _workspace_ints(m, n, kp, x_code, tile) -> int:
    key = (m, n, kp, x_code, *tile)
    ints = _WORKSPACE_INTS.get(key)
    if ints is None:
        ints = _WORKSPACE_INTS[key] = int(
            _lib().quant_matmul_workspace(m, n, kp, x_code, *tile))
    return ints


def _workspace(m, n, kp, x_code, device, tile=(-1, -1)
               ) -> Optional[torch.Tensor]:
    """The zeroed int32 workspace of a split-K call (``None`` without a
    split), one per device, grown as needed; the kernel leaves it
    zeroed.  A grown buffer keeps the smaller ones alive, since a CUDA
    graph may hold their addresses."""
    ints = _workspace_ints(m, n, kp, x_code, tile)
    if ints == 0:
        return None
    bufs = _WORKSPACES.setdefault(device, [])
    if not bufs or bufs[-1].numel() < ints:
        bufs.append(torch.zeros(ints, dtype=torch.int32, device=device))
    return bufs[-1]


def qmm_kernel(x2d, qw, x_scale, w_scale, out_dtype,
               tile: Optional[Tuple[int, int]] = None,
               route: Optional[str] = None) -> torch.Tensor:
    """Launch the CUDA quantized-matmul kernel: arguments as
    :func:`_qmm_ref`, CUDA tensors, ``qw`` ``[N, Kp]`` as
    :func:`weight_layout` gives it (``Kp`` a multiple of 16, at most 15
    past K); returns ``[M, N]`` in ``out_dtype`` (fp32, bf16 or fp16).
    ``tile``: ``(block_m, block_n)``, one of :func:`tiles` (a half at -1
    is the rule's), or None for the rule's tile; a tile the kernel lacks
    raises ``ValueError``.  The route (:func:`_route`) picks the kernel:
    ``csrc/quant_sm90.cu`` for M > 64 and K >= 128 where TMA reads the
    operands, else ``csrc/quant.cu``; ``route`` names one instead (at M >
    64 ``"mma"`` or, where TMA reads the operands, ``"wgmma"``, to compare
    the two), and one the call cannot take raises ``ValueError``.  Every
    route and tile gives the same bits (int32 sums).  Adds one to
    ``qmm_kernel.launches`` and to ``qmm_kernel.routes[route]`` per
    launch."""
    if x2d.dim() != 2 or qw.dim() != 2:
        raise ValueError(f"need x [M, K] and qw [N, Kp]; got "
                         f"{tuple(x2d.shape)} and {tuple(qw.shape)}")
    m, k = x2d.shape
    n, kp = qw.shape
    x_code, out_code = (_build.dtype_code(x2d.dtype),
                        _build.dtype_code(out_dtype))
    if qw.dtype != torch.int8:
        raise TypeError(f"qw must be int8, got {qw.dtype}")
    if kp % 16 or not k <= kp < k + 16:
        raise ValueError(f"qw's K must be x's K={k} padded to a multiple "
                         f"of 16, got {kp}")
    if (x_scale.dtype != torch.float32 or x_scale.numel() != 1
            or w_scale.dtype != torch.float32 or w_scale.shape != (n,)):
        raise ValueError("x_scale must be one fp32 value and w_scale fp32 "
                         f"[N={n}]")
    for name, t in (("x", x2d), ("qw", qw), ("x_scale", x_scale),
                    ("w_scale", w_scale)):
        if not t.is_cuda or t.device != x2d.device:
            raise ValueError(f"{name} must be on x's CUDA device")
    x2d, qw, w_scale = (t.contiguous() for t in (x2d, qw, w_scale))
    if qw.data_ptr() % 16:
        raise ValueError("qw must start on a 16-byte boundary")
    tma = _tma_ok(x2d, qw)
    rule = _route(m, k, n, x2d.dtype, tile, tma)
    takes = ("split",) if m <= 64 else ("wgmma", "mma") if tma else ("mma",)
    if route is not None and route not in takes:
        raise ValueError(
            f"qmm route {route!r} cannot take this call (M={m}, x "
            f"{x2d.dtype}, TMA {'can' if tma else 'cannot'} read the "
            f"operands): its routes are {takes}, the rule's {rule!r}")
    route = route or rule
    tile = (-1, -1) if tile is None else (int(tile[0]), int(tile[1]))
    if (not _sm90_tile_ok(m, n, x_code, tile) if route == "wgmma"
            else _workspace_ints(m, n, kp, x_code, tile) < 0):
        raise ValueError(f"qmm tile {tile} is not one the kernel has for "
                         f"{x2d.dtype} x on the {route} route (-1: a half "
                         f"of the rule's); the tiles are "
                         f"{tiles(x2d.element_size())}")
    out = torch.empty((m, n), dtype=out_dtype, device=x2d.device)
    if m == 0 or n == 0:
        return out
    stream = torch.cuda.current_stream(x2d.device).cuda_stream
    with torch.cuda.device(x2d.device):
        if route == "wgmma":
            err = _sm90_lib().quant_matmul_sm90(
                x2d.data_ptr(), qw.data_ptr(), x_scale.data_ptr(),
                w_scale.data_ptr(), out.data_ptr(), m, n, k, kp, x_code,
                out_code, *tile, stream)
        else:
            vec = int(k % 8 == 0 and x2d.data_ptr() % 16 == 0)
            work = _workspace(m, n, kp, x_code, x2d.device, tile)
            err = _lib().quant_matmul(
                x2d.data_ptr(), qw.data_ptr(), x_scale.data_ptr(),
                w_scale.data_ptr(), out.data_ptr(),
                0 if work is None else work.data_ptr(), m, n, k, kp, vec,
                x_code, out_code, *tile, stream)
    if err != 0:
        raise RuntimeError(f"quant_matmul ({route}) launch failed: CUDA "
                           f"error {err}" + (
                               " (cuTensorMapEncodeTiled refused a tensor map)"
                               if route == "wgmma" else ""))
    qmm_kernel.launches += 1
    qmm_kernel.routes[route] += 1
    return out


_build.counted(qmm_kernel)
#: the launches by the kernel that served them (:func:`_route`), counted
#: as ``launches`` is (a captured graph's replays included)
qmm_kernel.routes = {"wgmma": 0, "mma": 0, "split": 0}


def _tuned_tile(x2d, n: int) -> Optional[Tuple[int, int]]:
    """The consult: the tuned ``(block_m, block_n)`` of this shape's
    bucket, or None."""
    m, k = x2d.shape
    isz = x2d.element_size()
    cfg = _tuned_config("quantized_matmul", TUNE_VERSION,
                        lambda: tune_bucket(m, k, n, isz),
                        params=("block_m", "block_n"), key=(m, k, n, isz))
    return (cfg["block_m"], cfg["block_n"]) if cfg else None


def _pick_tile(x2d, qw, block_m: Optional[int],
               block_n: Optional[int]) -> Optional[Tuple[int, int]]:
    """The tile a kernel call names: the caller's ``block_m``/``block_n``
    (a missing one -1, the rule's; a pair the kernel lacks raises at the
    launch), else the tuned config of this shape's bucket when the
    kernel has it, else None (the rule).  The kernel path only."""
    if block_m is None and block_n is None:
        tile = _tuned_tile(x2d, qw.shape[0])
        m, k = x2d.shape
        if tile is None or kernel_tile(m, k, qw.shape[0], x2d.dtype, tile,
                                       _tma_ok(x2d, qw)) != tile:
            return None
        return tile
    return (int(block_m or -1), int(block_n or -1))


# -- autograd ---------------------------------------------------------------------

class _QuantizedMatmul(torch.autograd.Function):
    """Forward: quantize the weight (plain torch), then the kernel on CUDA
    or :func:`_qmm_ref`; backward: the straight-through estimator in the
    saved operands' own dtypes (JAX ``_qmm_bwd``), zero for the
    scales."""

    @staticmethod
    def forward(ctx, x2d, w2d, x_scale, w_scale, use_kernel, blocks):
        qw = weight_layout(w2d, w_scale)                       # [N, Kp]
        walk = _costs.counting(x2d)
        if use_kernel and walk is not None:
            out = walk.kernel(_costs.qmm(x2d, qw), _qmm_ref, x2d, qw,
                              x_scale, w_scale, x2d.dtype)
        elif use_kernel:
            out = qmm_kernel(x2d, qw, x_scale, w_scale, x2d.dtype,
                             _pick_tile(x2d, qw, *blocks))
        else:
            out = _qmm_ref(x2d, qw, x_scale, w_scale, x2d.dtype)
        ctx.save_for_backward(x2d, w2d)
        ctx.scale_shapes = (x_scale.shape, w_scale.shape, x_scale.device)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x2d, w2d = ctx.saved_tensors
        dx = dw = dxs = dws = None
        if ctx.needs_input_grad[0]:
            dx = (g.to(x2d.dtype) @ w2d.t().to(x2d.dtype)).to(x2d.dtype)
        if ctx.needs_input_grad[1]:
            dw = (x2d.t().to(w2d.dtype) @ g.to(w2d.dtype)).to(w2d.dtype)
        xs_shape, ws_shape, dev = ctx.scale_shapes
        if ctx.needs_input_grad[2]:
            dxs = torch.zeros(xs_shape, device=dev)
        if ctx.needs_input_grad[3]:
            dws = torch.zeros(ws_shape, device=dev)
        return dx, dw, dxs, dws, None, None


def _quantized_matmul_prepared(x2d, qw, w_scale, x_scale,
                               impl: Optional[str] = None, *,
                               block_m: Optional[int] = None,
                               block_n: Optional[int] = None
                               ) -> torch.Tensor:
    """The forward of :func:`quantized_matmul` on a weight already
    prepared (``qw`` ``[N, Kp]`` and ``w_scale`` ``[N]`` as
    :func:`weight_layout` and :func:`channel_scale` give them), for
    callers that record no gradient: the kernel on CUDA, :func:`_qmm_ref`
    on the CPU or for ``impl="jnp"``; ``x2d`` ``[M, K]``, the result in
    its dtype."""
    walk = _costs.counting(x2d)
    if walk is not None and impl != "jnp":
        return walk.kernel(_costs.qmm(x2d, qw), _qmm_ref, x2d, qw, x_scale,
                           w_scale, x2d.dtype)
    if x2d.is_cuda and impl != "jnp":
        return qmm_kernel(x2d, qw, x_scale, w_scale, x2d.dtype,
                          _pick_tile(x2d, qw, block_m, block_n))
    return _qmm_ref(x2d, qw, x_scale, w_scale, x2d.dtype)


def quantized_matmul(x, w, *, x_scale, w_scale=None,
                     impl: Optional[str] = None,
                     interpret: bool = False,
                     block_m: Optional[int] = None,
                     block_n: Optional[int] = None) -> torch.Tensor:
    """int8 quantized matmul ``x @ w`` with a dequantize epilogue.

    ``x``: ``[..., K]`` activations (bf16 or fp32); ``w``: ``[K, N]``
    weights; ``x_scale``: the frozen per-tensor activation scale (``amax
    / 127`` from :mod:`apex_tpu_torch.quant.calibrate`), a float or a
    0-dim fp32 tensor; ``w_scale``: per-channel ``[N]`` weight scales,
    computed from ``w`` when omitted.  Returns ``x.dtype``, ``[..., N]``.
    Differentiable in ``x`` and ``w`` (straight-through); the scales get
    zero gradients.

    ``impl``: ``None`` or ``"pallas"`` dispatch by the tensor's device
    (the kernel on CUDA, the plain version on the CPU); ``"jnp"`` asks
    for the plain version on either device.  ``interpret`` is accepted
    for the JAX signature's sake and ignored: the port has no interpreter
    mode.  ``block_m``/``block_n`` name the kernel's tile (one of
    :func:`tiles`; a missing one is the rule's); left at
    None, the kernel path consults the tuned config of this shape's
    bucket (:mod:`apex_tpu_torch.tune`), else runs the rule's tile.  An
    explicit tile wins over the cache, as in JAX.  Every tile gives the
    same bits.  The plain version takes the arguments and ignores them.
    """
    del interpret
    k = x.shape[-1]
    if w.dim() != 2 or w.shape[0] != k:
        raise ValueError(f"w must be [K={k}, N], got {tuple(w.shape)}")
    if impl not in (None, "pallas", "jnp"):
        raise ValueError(f"impl must be None, 'pallas', or 'jnp'; got "
                         f"{impl!r}")
    for name, v in (("block_m", block_m), ("block_n", block_n)):
        if v is not None and (isinstance(v, bool) or int(v) <= 0):
            raise ValueError(f"{name} must be a positive int, got {v!r}")
    if w_scale is None:
        w_scale = channel_scale(w)
    x_scale = _f32(x_scale, x.device).reshape(())
    w_scale = _f32(w_scale, x.device).reshape(w.shape[1])
    lead = x.shape[:-1]
    x2d = x.reshape(-1, k)
    use_kernel = ((x2d.is_cuda or _costs.counting(x2d) is not None)
                  and impl != "jnp")
    out = _QuantizedMatmul.apply(x2d, w, x_scale, w_scale, use_kernel,
                                 (block_m, block_n))
    return out.reshape(*lead, w.shape[1])
