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
a CUDA tensor launches the kernel (every shape, decode rows included —
the TPU's ``_JNP_MAX_ELEMENTS`` crossover and VMEM fit gate do not carry
over) or raises.  ``impl="jnp"`` is the caller's explicit request for the
plain version on either device.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build
from ..prof import costs as _costs

__all__ = ["amax_to_scale", "quantize", "dequantize", "channel_scale",
           "quantized_matmul", "quantized_matmul_ref", "saturation_count",
           "QMAX"]

#: symmetric int8 range: quantized values live in [-QMAX, QMAX].
QMAX = 127.0


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
    of 16 (the K step of ``mma.sync.m16n8k32`` loads)."""
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
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    ws = lib.quant_matmul_workspace
    ws.argtypes = [ctypes.c_int] * 4
    ws.restype = ctypes.c_int64
    return lib


_WORKSPACE_INTS: dict = {}   # (M, N, Kp, x dtype code) -> int32 elements
_WORKSPACES: dict = {}       # device -> zeroed int32 buffers, largest last


def _workspace(m, n, kp, x_code, device) -> Optional[torch.Tensor]:
    """The zeroed int32 workspace of a split-K call (``None`` without a
    split), one per device, grown as needed; the kernel leaves it
    zeroed.  A grown buffer keeps the smaller ones alive, since a CUDA
    graph may hold their addresses."""
    key = (m, n, kp, x_code)
    ints = _WORKSPACE_INTS.get(key)
    if ints is None:
        ints = _WORKSPACE_INTS[key] = int(
            _lib().quant_matmul_workspace(m, n, kp, x_code))
    if ints == 0:
        return None
    bufs = _WORKSPACES.setdefault(device, [])
    if not bufs or bufs[-1].numel() < ints:
        bufs.append(torch.zeros(ints, dtype=torch.int32, device=device))
    return bufs[-1]


def qmm_kernel(x2d, qw, x_scale, w_scale, out_dtype) -> torch.Tensor:
    """Launch the CUDA quantized-matmul kernel: arguments as
    :func:`_qmm_ref`, CUDA tensors, ``qw`` ``[N, Kp]`` as
    :func:`weight_layout` gives it (``Kp`` a multiple of 16, at most 15
    past K); returns ``[M, N]`` in ``out_dtype`` (fp32, bf16 or fp16).
    Adds one to ``qmm_kernel.launches`` per launch."""
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
    vec = int(k % 8 == 0 and x2d.data_ptr() % 16 == 0)
    out = torch.empty((m, n), dtype=out_dtype, device=x2d.device)
    if m == 0 or n == 0:
        return out
    stream = torch.cuda.current_stream(x2d.device).cuda_stream
    with torch.cuda.device(x2d.device):
        work = _workspace(m, n, kp, x_code, x2d.device)
        err = _lib().quant_matmul(
            x2d.data_ptr(), qw.data_ptr(), x_scale.data_ptr(),
            w_scale.data_ptr(), out.data_ptr(),
            0 if work is None else work.data_ptr(), m, n, k, kp, vec,
            x_code, out_code, stream)
    if err != 0:
        raise RuntimeError(f"quant_matmul launch failed: CUDA error {err}")
    qmm_kernel.launches += 1
    return out


_build.counted(qmm_kernel)


# -- autograd ---------------------------------------------------------------------

class _QuantizedMatmul(torch.autograd.Function):
    """Forward: quantize the weight (plain torch), then the kernel on CUDA
    or :func:`_qmm_ref`; backward: the straight-through estimator in the
    saved operands' own dtypes (JAX ``_qmm_bwd``), zero for the
    scales."""

    @staticmethod
    def forward(ctx, x2d, w2d, x_scale, w_scale, use_kernel):
        qw = weight_layout(w2d, w_scale)                       # [N, Kp]
        walk = _costs.counting(x2d)
        if use_kernel and walk is not None:
            out = walk.kernel(_costs.qmm(x2d, qw), _qmm_ref, x2d, qw,
                              x_scale, w_scale, x2d.dtype)
        else:
            qmm = qmm_kernel if use_kernel else _qmm_ref
            out = qmm(x2d, qw, x_scale, w_scale, x2d.dtype)
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
        return dx, dw, dxs, dws, None


def _quantized_matmul_prepared(x2d, qw, w_scale, x_scale,
                               impl: Optional[str] = None) -> torch.Tensor:
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
        return qmm_kernel(x2d, qw, x_scale, w_scale, x2d.dtype)
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
    mode.  ``block_m``/``block_n`` (tile overrides and the tuner's
    consult) wait for the tuner and raise ``NotImplementedError``.
    """
    del interpret
    k = x.shape[-1]
    if w.dim() != 2 or w.shape[0] != k:
        raise ValueError(f"w must be [K={k}, N], got {tuple(w.shape)}")
    if impl not in (None, "pallas", "jnp"):
        raise ValueError(f"impl must be None, 'pallas', or 'jnp'; got "
                         f"{impl!r}")
    if block_m is not None or block_n is not None:
        raise NotImplementedError("block_m/block_n (and the tuner's "
                                  "consult) are not ported yet (ROADMAP "
                                  "queue 1 item 2, the tune slice)")
    if w_scale is None:
        w_scale = channel_scale(w)
    x_scale = _f32(x_scale, x.device).reshape(())
    w_scale = _f32(w_scale, x.device).reshape(w.shape[1])
    lead = x.shape[:-1]
    x2d = x.reshape(-1, k)
    use_kernel = ((x2d.is_cuda or _costs.counting(x2d) is not None)
                  and impl != "jnp")
    out = _QuantizedMatmul.apply(x2d, w, x_scale, w_scale, use_kernel)
    return out.reshape(*lead, w.shape[1])
