"""NHWC implicit-GEMM convolution — CUDA C++ kernels for Hopper (forward
with the fused BN/ReLU/residual epilogue, dgrad, wgrad), with their plain
PyTorch versions beside them.

Counterpart of ``apex_tpu/ops/conv.py``: the same public ``conv2d(x, w,
*, stride, padding, dilation, groups, mean, invstd, scale, bias, z,
relu)`` in the JAX layouts (``x`` ``[N, H, W, C]``, ``w`` HWIO ``[KH,
KW, C // groups, O]``), with the JAX validation messages, and the
``PallasConv`` module the ResNet ``conv_cls=`` hook takes.  The TPU's
dispatch and tuner knobs (``impl``, ``interpret``, ``block_m``,
``block_n``) and its crossover and VMEM model (``_JNP_MAX_ELEMENTS``,
``_fwd_fits``, ``_dgrad_fits``, ``_wgrad_fits``) do not carry over.

The gradient is a ``torch.autograd.Function`` (the JAX ``custom_vjp``):
the forward kernel saves the pre-activation when an epilogue consumes
it; the backward takes the six epilogue cotangents from the port's
``fused_bn_act._bwd_ref`` on it, as JAX does, then the dgrad kernel
(skipped when the input needs no gradient, as at the ResNet stem) and
the wgrad kernel.  Dispatch is by the tensors' device and nothing else:
CPU tensors take the plain versions (:func:`_raw_conv`, an fp32 upcast
of ``F.conv2d`` on the NCHW view, and its autograd); CUDA tensors launch
the kernels of ``csrc/conv.cu`` at every size, the C = 3 stem included,
or raise.  A grouped conv is outside the kernels' contract, as in JAX,
and takes the plain version on either device.

Kernel notes.  ``conv_fwd_kernel`` replaces the Pallas ``_fwd_kernel``
(``apex_tpu/ops/conv.py:267``, launched by ``_im2col_conv`` for
``_pallas_fwd``), ``conv_dgrad_kernel`` ``_pallas_dgrad`` (``:375``) and
``conv_wgrad_kernel`` ``_wgrad_kernel`` (``:397``).  At ResNet-50 shapes
all three are GEMMs bound by tensor-core operations (M, N, K in the
thousands); the design gathers each operand tile straight from NHWC
(implicit im2col, zero padding by the copy's bounds test, no padded
copy) by 16-byte ``cp.async`` copies into a ring of shared-memory stages,
each tile kept along its channel axis and read into bf16 or fp16
``mma.sync`` fragments by ``ldmatrix`` (``.trans`` where the tile is
K-major), with fp32 accumulators, or a full-fp32 FMA loop for fp32
operands; dgrad gathers the cotangent as a transposed conv (no dilated
tensor), at stride > 1 as one sub-GEMM per parity class of the input
pixels over only the taps that reach it (one launch), so no zero tap
reaches the tensor cores; wgrad splits its pixel sum over a fp32
workspace and reduces the splits in order (deterministic).  The kernels
take channel counts that are multiples of 8: a ragged C or O (the C = 3
stem) is zero-padded to the next multiple here, zero weights included
(:func:`_fwd_layout`, :func:`_dgrad_layout`, :func:`_wgrad_layout`; a
layout pass, not a counted launch), and the padded output channels are
cut off.  The source says more.

:func:`publish_conv_counters` exports the dispatch counters into a
telemetry registry under the JAX package's names.  Not ported yet: the
tuner's ``tune_bucket`` / ``TUNE_VERSION`` (ROADMAP queue 1 item 2, the
``tune`` slice, keyed by the CUDA device name).
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import _build
from .._device import resolve_device
from ..normalization.fused_bn_act import _bwd_ref as _ep_bwd_ref
from ..normalization.fused_bn_act import _fwd_ref as _ep_fwd_ref
from ..normalization.fused_bn_act import bn_act_epilogue_ref

__all__ = ["conv2d", "conv2d_ref", "PallasConv", "conv_dispatch_stats",
           "reset_conv_dispatch_stats", "publish_conv_counters"]

# the kernels' tile, as in csrc/conv.cu: 128 rows, K steps of 32, 128
# columns where the GEMM's N is at least 128, else 64
_BM, _BK = 128, 32
_BN = (64, 128)


def _tile_n(n: int) -> int:
    """The kernels' tile width for a GEMM of N columns."""
    return _BN[1] if n >= _BN[1] else _BN[0]


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, int):
        return (v, v)
    a, b = v
    return (int(a), int(b))


def _norm_padding(padding, h: int, w: int, kh: int, kw: int,
                  sh: int, sw: int, dh: int, dw: int):
    """Normalize ``padding`` to the ``((pt, pb), (pl, pr))`` form (flax
    conventions: ``"SAME"``/``"VALID"``, an int, a pair of ints, or
    explicit per-dim pairs)."""
    if isinstance(padding, str):
        p = padding.upper()
        if p == "VALID":
            return ((0, 0), (0, 0))
        if p == "SAME":
            def same(sz, k, s, d):
                out = -(-sz // s)
                total = max(0, (out - 1) * s + (k - 1) * d + 1 - sz)
                return (total // 2, total - total // 2)
            return (same(h, kh, sh, dh), same(w, kw, sw, dw))
        raise ValueError(f"padding must be 'SAME'/'VALID' or explicit "
                         f"pairs; got {padding!r}")
    if isinstance(padding, int):
        return ((padding, padding), (padding, padding))
    pads = tuple(padding)
    if len(pads) == 2 and all(isinstance(p, int) for p in pads):
        return ((pads[0], pads[0]), (pads[1], pads[1]))
    return tuple((int(a), int(b)) for a, b in pads)


def _out_hw(h: int, w: int, padding, kh: int, kw: int, sh: int, sw: int,
            dh: int, dw: int) -> Tuple[int, int]:
    (pt, pb), (pl_, pr) = padding
    oh = (h + pt + pb - (kh - 1) * dh - 1) // sh + 1
    ow = (w + pl_ + pr - (kw - 1) * dw - 1) // sw + 1
    return oh, ow


# -- plain versions -----------------------------------------------------------

def _raw_conv(x, w, stride, padding, dilation, groups, out_dtype):
    """fp32 NHWC conv through ``F.conv2d`` on the NCHW view (the JAX
    ``_raw_conv``: an explicit upcast, cast back to ``out_dtype``);
    asymmetric padding is applied by ``F.pad`` first."""
    (pt, pb), (pl_, pr) = padding
    xf = x.float().permute(0, 3, 1, 2)
    pad = (0, 0)
    if pt == pb and pl_ == pr and pt >= 0 and pl_ >= 0:
        pad = (pt, pl_)
    else:
        xf = F.pad(xf, (pl_, pr, pt, pb))
    y = F.conv2d(xf, w.float().permute(3, 2, 0, 1), stride=stride,
                 padding=pad, dilation=dilation, groups=groups)
    return y.permute(0, 2, 3, 1).to(out_dtype)


def conv2d_ref(x, w, *, stride=(1, 1), padding="SAME", dilation=(1, 1),
               groups=1, mean=None, invstd=None, scale=None, bias=None,
               z=None, relu=False):
    """Plain reference: :func:`_raw_conv` (fp32 accumulation, cast back)
    followed by the ``bn_act_epilogue_ref`` epilogue when ``mean`` and
    ``invstd`` are given."""
    stride, dilation = _pair(stride), _pair(dilation)
    padding = _norm_padding(padding, x.shape[1], x.shape[2], w.shape[0],
                            w.shape[1], *stride, *dilation)
    y = _raw_conv(x, w, stride, padding, dilation, groups,
                  torch.promote_types(x.dtype, w.dtype))
    if mean is None:
        return y
    return bn_act_epilogue_ref(y, mean, invstd, scale, bias, z, relu)


def _fwd_ref(x, w, stride, padding, dilation, mean=None, invstd=None,
             scale=None, bias=None, z=None, relu=False, want_preact=False):
    """The forward kernel's plain version: ``(out, preact or None)``."""
    y = _raw_conv(x, w, stride, padding, dilation, 1, x.dtype)
    out = y if mean is None else _ep_fwd_ref(y, mean, invstd, scale, bias,
                                             z, relu)
    return out, (y if want_preact else None)


def _dgrad_ref(dy, w, stride, padding, dilation, hw):
    """The dgrad kernel's plain version: the input gradient of
    :func:`_raw_conv` (autograd), in dy's dtype."""
    n, _, _, _ = dy.shape
    x0 = torch.zeros((n, *hw, w.shape[2]), dtype=dy.dtype,
                     device=dy.device, requires_grad=True)
    with torch.enable_grad():
        y = _raw_conv(x0, w.detach(), stride, padding, dilation, 1, dy.dtype)
        return torch.autograd.grad(y, x0, dy)[0]


def _parity_taps(phase: int, pad: int, dil: int, s: int, k: int):
    """The kernel offsets ``kk < k`` whose taps reach input pixels of
    parity ``phase`` along one axis: ``(phase + pad - kk * dil) % s ==
    0``."""
    return [kk for kk in range(k) if (phase + pad - kk * dil) % s == 0]


def _dgrad_parity_ref(dy, w, stride, padding, dilation, hw):
    """The stride > 1 dgrad kernel's arithmetic in plain PyTorch: the
    input gradient computed one parity class at a time.

    Class ``(ph, pw)`` is the input pixels ``(ph + sh i, pw + sw j)``;
    only the taps ``kh`` with ``(ph + pt - kh dh) % sh == 0`` (and likewise
    in w) reach it, each from output pixel ``(i + (ph + pt - kh dh) / sh,
    j + ...)``, read as zero outside ``dy``.  Each class sums ``dy_tap @
    w[kh, kw].T`` over its taps in fp32 and is cast to dy's dtype once;
    a class no tap reaches is zeros."""
    n, oh, ow, o = dy.shape
    kh_, kw_, c, _ = w.shape
    (sh, sw), (dh, dw) = stride, dilation
    (pt, _), (pl_, _) = padding
    h, wd = hw
    dyf, wf = dy.float(), w.float()
    dx = torch.zeros((n, h, wd, c), dtype=torch.float32, device=dy.device)
    for ph in range(min(sh, h)):
        for pw in range(min(sw, wd)):
            hc, wc = len(range(ph, h, sh)), len(range(pw, wd, sw))
            acc = torch.zeros((n, hc, wc, c), dtype=torch.float32,
                              device=dy.device)
            for kh in _parity_taps(ph, pt, dh, sh, kh_):
                oh0 = (ph + pt - kh * dh) // sh
                for kw in _parity_taps(pw, pl_, dw, sw, kw_):
                    ow0 = (pw + pl_ - kw * dw) // sw
                    # output pixel oh0 + i for class row i, zero outside
                    rows = torch.arange(hc, device=dy.device) + oh0
                    cols = torch.arange(wc, device=dy.device) + ow0
                    rok = (rows >= 0) & (rows < oh)
                    cok = (cols >= 0) & (cols < ow)
                    g = dyf[:, rows.clamp(0, oh - 1)][:, :,
                                                      cols.clamp(0, ow - 1)]
                    g = g * (rok[:, None] & cok[None, :])[None, :, :, None]
                    acc = acc + g @ wf[kh, kw].t()
            dx[:, ph::sh, pw::sw] = acc
    return dx.to(dy.dtype)


def _wgrad_ref(x, dy, stride, padding, dilation, kernel_size):
    """The wgrad kernel's plain version: the weight gradient of
    :func:`_raw_conv` (autograd), in x's dtype."""
    w0 = torch.zeros((*kernel_size, x.shape[3], dy.shape[3]),
                     dtype=x.dtype, device=x.device, requires_grad=True)
    with torch.enable_grad():
        y = _raw_conv(x.detach(), w0, stride, padding, dilation, 1, x.dtype)
        return torch.autograd.grad(y, w0, dy)[0]


# -- CUDA kernels ---------------------------------------------------------------

class _ConvParams(ctypes.Structure):
    """Mirror of ``struct ConvParams`` in ``csrc/conv.cu``."""
    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ("a", "b", "out", "aux", "preact", "mean", "invstd",
                  "scale", "bias", "z")]
                + [(n, ctypes.c_int32) for n in
                   ("N", "H", "W", "C", "O", "OH", "OW", "KH", "KW", "sh",
                    "sw", "dh", "dw", "pt", "pl", "relu", "epilogue",
                    "k_per_split")])


def _lib() -> ctypes.CDLL:
    lib = _build.load("conv")
    for fn in (lib.conv_fwd, lib.conv_dgrad):
        fn.argtypes = [ctypes.POINTER(_ConvParams), ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.conv_wgrad.argtypes = [ctypes.POINTER(_ConvParams), ctypes.c_int,
                               ctypes.c_int, ctypes.c_void_p]
    lib.conv_wgrad.restype = ctypes.c_int
    return lib


def _check_operands(acts, vecs=()):
    """What the kernels take: contiguous 4-D CUDA tensors of one float
    type (fp32, bf16 or fp16) on one device, under 2**31 elements each, and
    contiguous fp32 per-channel vectors there."""
    ref = acts[0][1]
    _build.dtype_code(ref.dtype)
    for name, t in acts:
        if t is None:
            continue
        if not t.is_cuda or t.device != ref.device:
            raise ValueError(f"{name} must be a CUDA tensor on "
                             f"{ref.device}")
        if t.dtype != ref.dtype:
            raise TypeError(f"{name} must be {ref.dtype}, got {t.dtype}")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 4-D tensor; got "
                             f"shape {tuple(t.shape)}")
        if t.numel() == 0 or t.numel() >= 2 ** 31:
            raise ValueError(f"{name} must hold 1 to 2**31 - 1 elements; "
                             f"got {t.numel()}")
    for name, t, c in vecs:
        if t is not None and (t.shape != (c,) or t.device != ref.device
                              or t.dtype != torch.float32
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous fp32 [{c}] "
                             f"tensor on {ref.device}")


def _pad8(t, dim: int):
    """``t`` with dimension ``dim`` zero-padded to a multiple of 8 and its
    data 16-byte aligned (the kernels' 16-byte copies); ``t`` itself when
    it already is; None stays None."""
    if t is None:
        return None
    r = -t.shape[dim] % 8
    if r:
        t = F.pad(t, [0, 0] * (t.dim() - 1 - dim % t.dim()) + [0, r])
        if t.numel() >= 2 ** 31:
            raise ValueError(f"a tensor padded to {tuple(t.shape)} holds "
                             f"2**31 elements or more")
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _fwd_layout(x, w, mean=None, invstd=None, scale=None, bias=None,
                z=None):
    """The forward kernel's operands: C (``x``'s and ``w``'s) and O
    (``w``'s, the epilogue vectors' and ``z``'s) zero-padded to multiples
    of 8.  The pad's weights are zero, so the padded conv's first O
    channels are the conv's."""
    w = _pad8(_pad8(w, 2), 3)
    return (_pad8(x, 3), w, *(_pad8(t, 0) for t in (mean, invstd, scale,
                                                     bias)), _pad8(z, 3))


def _dgrad_layout(dy, w):
    """The dgrad kernel's operands: O (``dy``'s, ``w``'s) and C (``w``'s)
    zero-padded to multiples of 8; dx's first C channels are the
    input gradient."""
    return _pad8(dy, 3), _pad8(_pad8(w, 2), 3)


def _wgrad_layout(x, dy):
    """The wgrad kernel's operands: C (``x``'s) and O (``dy``'s)
    zero-padded to multiples of 8; dw's first C x O block is the weight
    gradient."""
    return _pad8(x, 3), _pad8(dy, 3)


def _params(x_shape, w_shape, oh, ow, stride, padding, dilation,
            **ptrs) -> _ConvParams:
    n, h, wi, c = x_shape
    kh, kw, _, o = w_shape
    (pt, _), (pl_, _) = padding
    return _ConvParams(
        **{k: (None if v is None else v.data_ptr()) for k, v in ptrs.items()},
        N=n, H=h, W=wi, C=c, O=o, OH=oh, OW=ow, KH=kh, KW=kw, sh=stride[0],
        sw=stride[1], dh=dilation[0], dw=dilation[1], pt=pt, pl=pl_)


def _launch(name, prm, dtype, device, *extra):
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = getattr(_lib(), name)(ctypes.byref(prm),
                                    _build.dtype_code(dtype), *extra,
                                    stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _geometry(x_shape, w_shape, stride, padding, dilation):
    """``(oh, ow)``; raises on an empty output or a kernel wider than its
    padded input."""
    kh, kw = w_shape[:2]
    oh, ow = _out_hw(x_shape[1], x_shape[2], padding, kh, kw, *stride,
                     *dilation)
    if oh < 1 or ow < 1:
        raise ValueError(f"conv output would be empty: {oh} x {ow}")
    return oh, ow


def conv_fwd_kernel(x, w, stride, padding, dilation, mean=None, invstd=None,
                    scale=None, bias=None, z=None, relu=False,
                    want_preact=False):
    """Launch the CUDA forward kernel: ``x`` ``[N, H, W, C]`` and ``w``
    ``[KH, KW, C, O]`` contiguous CUDA tensors of one type, ``stride`` and
    ``dilation`` pairs, ``padding`` ``((pt, pb), (pl, pr))``; with
    ``mean``/``invstd`` (fp32 ``[O]``) the epilogue ``relu((y - mean) *
    invstd * scale + bias + z)``.  Returns ``(out, preact)``, ``preact``
    (the conv result before the epilogue) only with ``want_preact``.  Adds
    one to ``conv_fwd_kernel.launches`` per launch."""
    if w.dim() != 4 or x.dim() != 4 or w.shape[2] != x.shape[3]:
        raise ValueError(f"conv kernel wants NHWC x and HWIO w with equal "
                         f"channels; got {tuple(x.shape)} / "
                         f"{tuple(w.shape)}")
    oh, ow = _geometry(x.shape, w.shape, stride, padding, dilation)
    o = w.shape[3]
    given = [t is not None for t in (mean, invstd, scale, bias, z)]
    if given[0] != given[1] or given[2] != given[3] or (
            not given[0] and any(given[2:])):
        raise ValueError("the epilogue takes mean and invstd together, "
                         "scale and bias together, and z only with them")
    out_shape = (x.shape[0], oh, ow, o)
    if z is not None and tuple(z.shape) != out_shape:
        raise ValueError(f"z must have the output shape {out_shape}")
    _check_operands((("x", x), ("w", w), ("z", z)),
                    (("mean", mean, o), ("invstd", invstd, o),
                     ("scale", scale, o), ("bias", bias, o)))
    x, w, mean, invstd, scale, bias, z = _fwd_layout(x, w, mean, invstd,
                                                     scale, bias, z)
    op = w.shape[3]
    out = torch.empty((*out_shape[:3], op), dtype=x.dtype, device=x.device)
    preact = torch.empty_like(out) if want_preact else None
    prm = _params(x.shape, w.shape, oh, ow, stride, padding, dilation,
                  a=x, b=w, out=out, preact=preact, mean=mean, invstd=invstd,
                  scale=scale, bias=bias, z=z)
    prm.relu, prm.epilogue = int(bool(relu)), int(mean is not None)
    _launch("conv_fwd", prm, x.dtype, x.device)
    conv_fwd_kernel.launches += 1
    if op != o:
        out = out[..., :o].contiguous()
        preact = None if preact is None else preact[..., :o].contiguous()
    return out, preact


_build.counted(conv_fwd_kernel)


def conv_dgrad_kernel(dy, w, stride, padding, dilation, hw):
    """Launch the CUDA dgrad kernel: the input gradient ``[N, H, W, C]``
    (``hw = (H, W)``) of the conv of :func:`conv_fwd_kernel`'s arguments,
    from the output gradient ``dy`` ``[N, OH, OW, O]``; in dy's type.  At
    stride 1 one GEMM over every pixel (:func:`_dgrad_ref`); at stride > 1
    one launch of all the parity classes' sub-GEMMs
    (:func:`_dgrad_parity_ref` is their arithmetic).  Adds one to
    ``conv_dgrad_kernel.launches`` per launch."""
    n = dy.shape[0]
    x_shape = (n, *hw, w.shape[2])
    oh, ow = _geometry(x_shape, w.shape, stride, padding, dilation)
    if tuple(dy.shape) != (n, oh, ow, w.shape[3]):
        raise ValueError(f"dy must have the output shape "
                         f"{(n, oh, ow, w.shape[3])}; got {tuple(dy.shape)}")
    _check_operands((("dy", dy), ("w", w)))
    c = w.shape[2]
    dy, w = _dgrad_layout(dy, w)
    x_shape = (*x_shape[:3], w.shape[2])
    dx = torch.empty(x_shape, dtype=dy.dtype, device=dy.device)
    prm = _params(x_shape, w.shape, oh, ow, stride, padding, dilation,
                  a=dy, b=w, out=dx)
    _launch("conv_dgrad", prm, dy.dtype, dy.device)
    conv_dgrad_kernel.launches += 1
    return dx if w.shape[2] == c else dx[..., :c].contiguous()


_build.counted(conv_dgrad_kernel)


def _wgrad_splits(m: int, n: int, k: int, sms: int) -> Tuple[int, int]:
    """``(splits, pixels per split)`` for wgrad's K (the pixels): enough
    blocks of the kernels' tile (:func:`_tile_n`) for ~4 a streaming
    multiprocessor, each split at least 8 K steps; a multiple of the K
    step per split."""
    tiles = -(-m // _BM) * -(-n // _tile_n(n))
    k_steps = -(-k // _BK)
    splits = max(1, min(max(1, k_steps // 8), -(-4 * sms // tiles)))
    per = -(-k_steps // splits) * _BK
    return -(-k // per), per


def conv_wgrad_kernel(x, dy, stride, padding, dilation, kernel_size):
    """Launch the CUDA wgrad kernels (the split GEMM, then the reduce of
    its fp32 workspace in split order): the weight gradient ``[KH, KW, C,
    O]`` of the conv of ``x`` from the output gradient ``dy``; in x's
    type.  Adds one to ``conv_wgrad_kernel.launches`` per call (the
    reduce pass is counted within it)."""
    kh, kw = kernel_size
    w_shape = (kh, kw, x.shape[3], dy.shape[3])
    oh, ow = _geometry(x.shape, w_shape, stride, padding, dilation)
    if tuple(dy.shape) != (x.shape[0], oh, ow, dy.shape[3]):
        raise ValueError(f"dy must have the output shape "
                         f"{(x.shape[0], oh, ow, dy.shape[3])}; got "
                         f"{tuple(dy.shape)}")
    _check_operands((("x", x), ("dy", dy)))
    x, dy = _wgrad_layout(x, dy)
    wp_shape = (kh, kw, x.shape[3], dy.shape[3])
    m, n = kh * kw * x.shape[3], dy.shape[3]
    k = x.shape[0] * oh * ow
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits, per = _wgrad_splits(m, n, k, sms)
    ws = torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
    dw = torch.empty(wp_shape, dtype=x.dtype, device=x.device)
    prm = _params(x.shape, wp_shape, oh, ow, stride, padding, dilation,
                  a=x, b=dy, out=ws, aux=dw)
    prm.k_per_split = per
    _launch("conv_wgrad", prm, x.dtype, x.device, splits)
    conv_wgrad_kernel.launches += 1
    if wp_shape != w_shape:
        dw = dw[:, :, :w_shape[2], :w_shape[3]].contiguous()
    return dw


_build.counted(conv_wgrad_kernel)


# -- autograd --------------------------------------------------------------------

class _Conv(torch.autograd.Function):
    """The forward kernel (saving the pre-activation when the epilogue
    consumes it); backward the epilogue's plain cotangents, then the
    dgrad and wgrad kernels.  CPU tensors and grouped convs take the
    plain versions."""

    @staticmethod
    def forward(ctx, x, w, mean, invstd, scale, bias, z, relu, stride,
                padding, dilation, groups):
        epilogue = mean is not None
        kernel = x.is_cuda and groups == 1
        if kernel:
            x, w = x.contiguous(), w.contiguous()
            z = None if z is None else z.contiguous()
            out, y = conv_fwd_kernel(x, w, stride, padding, dilation, mean,
                                     invstd, scale, bias, z, relu,
                                     want_preact=epilogue)
        else:
            y = _raw_conv(x, w, stride, padding, dilation, groups, x.dtype)
            out = (_ep_fwd_ref(y, mean, invstd, scale, bias, z, relu)
                   if epilogue else y)
        ctx.save_for_backward(x, w, mean, invstd, scale, bias, z,
                              y if epilogue else None)
        ctx.conf = (relu, stride, padding, dilation, groups, kernel)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, w, mean, invstd, scale, bias, z, y = ctx.saved_tensors
        relu, stride, padding, dilation, groups, kernel = ctx.conf
        if mean is not None:
            dy, d_mean, d_invstd, d_scale, d_bias, dz = _ep_bwd_ref(
                g, y, mean, invstd, scale, bias, z, relu)
        else:
            dy, d_mean, d_invstd, d_scale, d_bias, dz = (g, None, None,
                                                         None, None, None)
        need_dx, need_dw = ctx.needs_input_grad[:2]
        dx = dw = None
        if kernel:
            dy = dy.contiguous()
            if need_dx:
                dx = conv_dgrad_kernel(dy, w, stride, padding, dilation,
                                       x.shape[1:3])
            if need_dw:
                dw = conv_wgrad_kernel(x, dy, stride, padding, dilation,
                                       w.shape[:2])
        elif need_dx or need_dw:
            xx = x.detach().requires_grad_(need_dx)
            ww = w.detach().requires_grad_(need_dw)
            with torch.enable_grad():
                out = _raw_conv(xx, ww, stride, padding, dilation, groups,
                                x.dtype)
                grads = torch.autograd.grad(
                    out, [t for t in (xx, ww) if t.requires_grad], dy)
            grads = list(grads)
            dx = grads.pop(0) if need_dx else None
            dw = grads.pop(0) if need_dw else None
        return (dx, dw, d_mean, d_invstd, d_scale, d_bias, dz, None, None,
                None, None, None)


# -- public op -------------------------------------------------------------------

def conv2d(x, w, *, stride=(1, 1), padding="SAME", dilation=(1, 1),
           groups: int = 1, mean=None, invstd=None, scale=None, bias=None,
           z=None, relu: bool = False):
    """NHWC 2-D convolution with an optional fused BN/ReLU/residual
    epilogue: ``relu((conv(x, w) - mean) * invstd * scale + bias + z)``.

    ``x``: ``[N, H, W, C]``; ``w``: ``[KH, KW, C // groups, O]`` (the
    flax HWIO layout).  ``stride``/``dilation`` are ints or pairs;
    ``padding`` is ``"SAME"``, ``"VALID"``, an int, or explicit ``((pt,
    pb), (pl, pr))`` pairs.  Accumulation is fp32; the result is cast to
    the operands' promoted dtype.

    The epilogue (active when ``mean``/``invstd`` are given) is the
    ``bn_relu_residual`` contract with the conv output as its input:
    per-channel fp32 ``mean``/``invstd`` and optional affine
    ``scale``/``bias``, an optional residual ``z`` of the output's shape
    added before the ReLU.  Every operand is differentiable, and the fused
    path is gradient-exact against the explicit ``conv2d`` ->
    ``bn_relu_residual`` chain.

    CUDA tensors run the kernels (a grouped conv excepted); CPU tensors
    the plain version.
    """
    stride, dilation = _pair(stride), _pair(dilation)
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"conv2d wants NHWC x and HWIO w; got "
                         f"{tuple(x.shape)} / {tuple(w.shape)}")
    n, h, w_in, cin = x.shape
    kh, kw, wc, o = w.shape
    if wc * groups != cin:
        raise ValueError(f"w in-channels {wc} x groups {groups} != input "
                         f"channels {cin}")
    if (mean is None) != (invstd is None):
        raise ValueError("mean and invstd must be given together")
    if mean is None and (scale is not None or z is not None or relu):
        raise ValueError("scale/bias, z and relu belong to the fused "
                         "epilogue — pass mean/invstd to enable it")
    if (scale is None) != (bias is None):
        raise ValueError("scale and bias must be given together")
    dt = torch.promote_types(x.dtype, w.dtype)
    x = x.to(dt)
    w = w.to(dt)
    padding = _norm_padding(padding, h, w_in, kh, kw, *stride, *dilation)
    oh, ow = _out_hw(h, w_in, padding, kh, kw, *stride, *dilation)
    if mean is not None:
        def vec(v):
            return torch.as_tensor(v, dtype=torch.float32,
                                   device=x.device).reshape(-1).contiguous()
        mean, invstd = vec(mean), vec(invstd)
        if scale is not None:
            scale, bias = vec(scale), vec(bias)
        if z is not None:
            if tuple(z.shape) != (n, oh, ow, o):
                raise ValueError(f"z must have the output shape "
                                 f"{(n, oh, ow, o)}; got {tuple(z.shape)}")
            z = z.to(dt)
    return _Conv.apply(x, w, mean, invstd, scale, bias, z, bool(relu),
                       stride, padding, dilation, int(groups))


# -- module + per-site dispatch stats ------------------------------------------

_DISPATCH_COUNTS: Dict[str, int] = {"pallas": 0, "fallback": 0}
_FALLBACK_REASONS: Dict[str, int] = {}


def conv_dispatch_stats() -> Dict[str, Any]:
    """:class:`PallasConv` dispatch counters: how many conv calls went
    through :func:`conv2d` (``pallas_sites``: the kernels on CUDA, the
    plain version on the CPU) and how many fell back to the plain conv,
    and why (``groups``).  Counted per call, not per trace as in JAX, and
    the C = 3 stem is a kernel site here (JAX sends it to XLA as
    ``"vmem"``; the TPU's ``"small"`` crossover does not carry over)."""
    return {"pallas_sites": _DISPATCH_COUNTS["pallas"],
            "fallback_sites": _DISPATCH_COUNTS["fallback"],
            "fallback_reasons": dict(_FALLBACK_REASONS)}


def reset_conv_dispatch_stats() -> None:
    _DISPATCH_COUNTS["pallas"] = _DISPATCH_COUNTS["fallback"] = 0
    _FALLBACK_REASONS.clear()


def publish_conv_counters(registry) -> Dict[str, Any]:
    """Export the dispatch counters into a telemetry
    :class:`~apex_tpu_torch.telemetry.MetricsRegistry` as the counters
    ``conv_pallas_sites``, ``conv_fallback_sites`` and
    ``conv_fallback_<reason>`` (the JAX package's names), each bumped by
    how much its count grew since the last publish, so repeated calls
    stay monotonic.  Returns :func:`conv_dispatch_stats`."""
    stats = conv_dispatch_stats()
    flat = {"conv_pallas_sites": stats["pallas_sites"],
            "conv_fallback_sites": stats["fallback_sites"]}
    for reason, n in stats["fallback_reasons"].items():
        flat[f"conv_fallback_{reason}"] = int(n)
    for name, total in flat.items():
        c = registry.counter(name)
        delta = total - (c.value or 0)
        if delta > 0:
            c.inc(delta)
    return stats


class PallasConv(nn.Module):
    """Drop-in for the port's ``models.resnet.Conv`` routing through
    :func:`conv2d`: the same constructor (``in_features, features,
    kernel_size, strides, padding, dtype, device, generator``), the same
    ``kernel`` ``[KH, KW, Cin // groups, Cout]`` drawn lecun-normal from
    the same generator, so ``conv_cls=PallasConv`` changes no parameter.
    It also takes ``use_bias`` (default False, as the ResNet builds its
    convs; the bias is zeros), ``kernel_dilation`` and
    ``feature_group_count``; a grouped conv falls back to the plain conv
    and is counted in :func:`conv_dispatch_stats`."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Sequence[int], strides: Sequence[int] = (1, 1),
                 padding: Any = "SAME", dtype: torch.dtype = torch.float32,
                 *, use_bias: bool = False, kernel_dilation: Any = 1,
                 feature_group_count: int = 1, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        from ..models.bert import lecun_normal_
        kh, kw = _pair(kernel_size)
        groups = int(feature_group_count)
        self.kernel_size = (kh, kw)
        self.strides = _pair(strides if strides is not None else 1)
        self.dilation = _pair(kernel_dilation
                              if kernel_dilation is not None else 1)
        self.padding = padding
        self.groups = groups
        self.dtype = dtype
        dev = resolve_device(device)
        cin = in_features // groups
        kernel = lecun_normal_(torch.empty(kh, kw, cin, features),
                               kh * kw * cin, generator)
        self.kernel = nn.Parameter(kernel.to(dev))
        self.bias = (nn.Parameter(torch.zeros(features, device=dev))
                     if use_bias else None)

    def forward(self, x):
        x = x.to(self.dtype)
        kernel = self.kernel.to(self.dtype)
        padding = _norm_padding(self.padding, x.shape[1], x.shape[2],
                                *self.kernel_size, *self.strides,
                                *self.dilation)
        if self.groups == 1:
            _DISPATCH_COUNTS["pallas"] += 1
            y = conv2d(x, kernel, stride=self.strides, padding=padding,
                       dilation=self.dilation)
        else:
            _DISPATCH_COUNTS["fallback"] += 1
            _FALLBACK_REASONS["groups"] = _FALLBACK_REASONS.get("groups",
                                                                0) + 1
            y = _raw_conv(x, kernel, self.strides, padding, self.dilation,
                          self.groups, self.dtype)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y

