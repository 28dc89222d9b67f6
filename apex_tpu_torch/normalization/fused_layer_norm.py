"""FusedLayerNorm — Triton kernels for Hopper (forward and input
gradient), with their plain PyTorch versions beside them.

Counterpart of ``apex_tpu/normalization/fused_layer_norm.py``: the input
splits into ``(n1, n2)`` = (rows, normalized elements), statistics are
fp32 whatever the input dtype, and the forward returns the output in the
input dtype plus fp32 ``mean`` and ``invvar`` per row.  Parameters are
fp32 and named ``scale`` / ``bias``, as in flax.  The gradient is a
``torch.autograd.Function`` (the JAX ``custom_vjp``): ``dx`` comes from
the backward kernel, ``dgamma`` and ``dbeta`` are plain fp32 column sums,
as in the JAX backward rule.

Dispatch is by the tensor's device and nothing else: a CPU tensor takes
:func:`_fwd_ref` (the JAX ``_fwd_ref`` math, single-pass variance
``E[x^2] - mean^2``) and :func:`_bwd_input_ref`; a CUDA tensor launches
:func:`layer_norm_fwd_kernel` and :func:`layer_norm_bwd_kernel` at every
size, or raises.

Kernel notes.  The forward replaces the Pallas ``_fwd_kernel`` (launched
by ``_pallas_fwd``, ``apex_tpu/normalization/fused_layer_norm.py:206``).
One Triton program per row holds the whole row in one power-of-two block
(768 -> 1024, masked), reduces it in fp32 with ``tl.sum`` (the
warp-shuffle tree a CUDA kernel would write by hand) and writes the
affine output.  It is bound by memory on the H100: each element is read
once and written once and costs a handful of fp32 operations, so the
design keeps the row in registers and touches device memory exactly
once each way.  The variance is JAX's single-pass ``E[x^2] - mean^2``
in fp32 (``apex_tpu/normalization/fused_layer_norm.py:146, 211``), the
formula of the plain version: a row whose mean is large against its
spread loses digits to the cancellation in both alike, so the kernel
follows them rather than a two-pass variance that would part from them
there.

The backward replaces the Pallas ``_bwd_kernel`` (launched by
``_pallas_bwd_input``, ``:223``): ``dx = (g*w - mean(g*w) - xhat *
mean(g*w*xhat)) * invvar`` per row.  Also bound by memory: one program
per row reads g and x once, keeps the row in registers for its two
``tl.sum`` reductions and writes dx once.

The tile.  ``row_block`` (JAX's name) is the rows a program handles, one
after another, each with the same vector, warps and reductions as a
program of one row, so every ``row_block`` gives the same bits; the rule
is 1.  ``fused_layer_norm(row_block=)`` sets it; left at None, a CUDA
call consults the tuner's cache for this shape's bucket
(:func:`tune_bucket`, the JAX package's string, :data:`TUNE_VERSION`).
"""

from __future__ import annotations

import functools
import math
import numbers
from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from .. import _build
from ..prof import costs as _costs
from .._device import resolve_device
from ..tune import space as _space
from ..tune.dispatch import kernel_config as _tuned_config

#: the tuner's config version of the LayerNorm kernels
TUNE_VERSION = 1
#: the most rows a program handles (the tuner's largest candidate)
_MAX_ROWS = 64


def tune_bucket(n1: int, n2: int, itemsize: int) -> str:
    """Config-cache shape bucket (the JAX package's string): rows round
    up to a power of two, width and itemsize exact."""
    return f"r{_space.pow2_bucket(n1)}_w{n2}_i{itemsize}"


def rows_per_program(n1: int, row_block: Optional[int]) -> int:
    """The rows a program handles for a ``row_block``: a power of two
    (a cached 100 runs 64), at most :data:`_MAX_ROWS` and no more than
    the power of two that covers ``n1``; 1 (the rule) for None."""
    if row_block is None:
        return 1
    return _space.pick_rows(n1, 1, 1, row_block=min(int(row_block),
                                                    _MAX_ROWS))


def _normalize_shape(normalized_shape) -> Tuple[int, ...]:
    if isinstance(normalized_shape, numbers.Integral):
        return (int(normalized_shape),)
    return tuple(int(s) for s in normalized_shape)


def _compute_n1_n2(shape, normalized_shape):
    """Split an input shape into outer rows n1 and normalized cols n2."""
    ns = _normalize_shape(normalized_shape)
    if tuple(shape[len(shape) - len(ns):]) != ns:
        raise ValueError(
            "Expected the trailing dims of input shape {} to equal "
            "normalized_shape {}".format(tuple(shape), ns))
    n2 = math.prod(ns) if ns else 1
    n1 = math.prod(shape) // n2
    return n1, n2


# -- plain version ------------------------------------------------------------

def _fwd_ref(x2d, weight, bias, eps):
    xf = x2d.float()
    mean = xf.mean(dim=1, keepdim=True)
    var = (xf * xf).mean(dim=1, keepdim=True) - mean * mean
    invvar = torch.rsqrt(var + eps)
    out = (xf - mean) * invvar
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x2d.dtype), mean[:, 0], invvar[:, 0]


def _bwd_input_ref(g2d, x2d, mean, invvar, weight):
    """Gradient with respect to the input (the JAX ``_bwd_input_ref``,
    reference ``cuComputeGradInput``), in the input's dtype."""
    n2 = x2d.shape[1]
    gf = g2d.float()
    if weight is not None:
        gf = gf * weight.float()
    xhat = (x2d.float() - mean[:, None]) * invvar[:, None]
    sum_g = gf.sum(dim=1, keepdim=True)
    sum_gx = (gf * xhat).sum(dim=1, keepdim=True)
    dx = (gf - sum_g / n2 - xhat * sum_gx / n2) * invvar[:, None]
    return dx.to(x2d.dtype)


# -- Triton kernels -----------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _triton_kernel():
    """Compile-on-first-use Triton forward kernel (``triton`` is imported
    here, never at module import: CPU-only hosts have none)."""
    import triton
    import triton.language as tl

    @triton.jit
    def ln_fwd(x_ptr, w_ptr, b_ptr, out_ptr, mean_ptr, invvar_ptr,
               stride_x, stride_out, n1, n2, eps,
               HAS_W: tl.constexpr, HAS_B: tl.constexpr,
               BLOCK: tl.constexpr, ROWS: tl.constexpr):
        cols = tl.arange(0, BLOCK)
        for r in tl.static_range(ROWS):     # rows one after another
            row = tl.program_id(0) * ROWS + r
            live = cols < n2
            if ROWS > 1:                    # the last program's tail
                live = live & (row < n1)
            x = tl.load(x_ptr + row * stride_x + cols, mask=live,
                        other=0.0).to(tl.float32)
            mean = tl.sum(x, axis=0) / n2
            var = tl.sum(x * x, axis=0) / n2 - mean * mean
            xc = tl.where(live, x - mean, 0.0)
            invvar = 1.0 / tl.sqrt(var + eps)
            y = xc * invvar
            if HAS_W:
                y = y * tl.load(w_ptr + cols, mask=live, other=0.0).to(
                    tl.float32)
            if HAS_B:
                y = y + tl.load(b_ptr + cols, mask=live, other=0.0).to(
                    tl.float32)
            tl.store(out_ptr + row * stride_out + cols,
                     y.to(out_ptr.dtype.element_ty), mask=live)
            if ROWS > 1:
                tl.store(mean_ptr + row, mean, mask=row < n1)
                tl.store(invvar_ptr + row, invvar, mask=row < n1)
            else:
                tl.store(mean_ptr + row, mean)
                tl.store(invvar_ptr + row, invvar)

    return ln_fwd


def _check_kernel_rows(x2d, n2_tensors, rows=()):
    """What the kernels take: CUDA float ``[n1, n2]`` inputs with unit
    column stride, contiguous ``[n2]`` vectors and contiguous fp32
    ``[n1]`` row statistics, all on one device."""
    if not x2d.is_cuda or x2d.dim() != 2 or x2d.stride(1) != 1:
        raise ValueError("layer_norm kernel takes a CUDA [n1, n2] tensor "
                         "with unit column stride")
    if not x2d.dtype.is_floating_point:
        raise TypeError(f"layer_norm kernel takes floats, got {x2d.dtype}")
    n1, n2 = x2d.shape
    for name, t, shape in ([(n, t, (n2,)) for n, t in n2_tensors]
                           + [(n, t, (n1,)) for n, t in rows]):
        if t is not None and (t.device != x2d.device or t.shape != shape
                              or t.stride(0) != 1):
            raise ValueError(f"{name} must be a contiguous {list(shape)} "
                             f"tensor on {x2d.device}")
    for name, t in rows:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be fp32")


def layer_norm_fwd_kernel(x2d, weight, bias, eps, row_block=None):
    """Launch the Triton forward kernel on a CUDA ``[n1, n2]`` input with
    unit column stride; returns ``(out, mean, invvar)``.  ``row_block``:
    the rows a program handles (:func:`rows_per_program`), None for the
    rule's one.  Adds one to ``layer_norm_fwd_kernel.launches`` per
    launch."""
    _check_kernel_rows(x2d, (("weight", weight), ("bias", bias)))
    n1, n2 = x2d.shape
    out = torch.empty_like(x2d, memory_format=torch.contiguous_format)
    mean = torch.empty((n1,), dtype=torch.float32, device=x2d.device)
    invvar = torch.empty((n1,), dtype=torch.float32, device=x2d.device)
    if n1 == 0:
        return out, mean, invvar
    block = 1 << max(0, n2 - 1).bit_length()     # next power of two
    rows = rows_per_program(n1, row_block)
    kernel = _triton_kernel()
    with torch.cuda.device(x2d.device):
        kernel[(-(-n1 // rows),)](
            x2d, weight if weight is not None else x2d,
            bias if bias is not None else x2d, out, mean, invvar,
            x2d.stride(0), out.stride(0), n1, n2, float(eps),
            HAS_W=weight is not None, HAS_B=bias is not None, BLOCK=block,
            ROWS=rows, num_warps=min(16, max(4, block // 256)),
            enable_fp_fusion=False)   # mean * mean rounded, as in JAX
    layer_norm_fwd_kernel.launches += 1
    return out, mean, invvar


_build.counted(layer_norm_fwd_kernel)


@functools.lru_cache(maxsize=None)
def _triton_bwd_kernel():
    """Compile-on-first-use Triton backward (input-gradient) kernel."""
    import triton
    import triton.language as tl

    @triton.jit
    def ln_bwd(g_ptr, x_ptr, mean_ptr, invvar_ptr, w_ptr, dx_ptr,
               stride_g, stride_x, stride_dx, n1, n2,
               HAS_W: tl.constexpr, BLOCK: tl.constexpr,
               ROWS: tl.constexpr):
        cols = tl.arange(0, BLOCK)
        for r in tl.static_range(ROWS):     # rows one after another
            row = tl.program_id(0) * ROWS + r
            live = cols < n2
            if ROWS > 1:                    # the last program's tail
                live = live & (row < n1)
            g = tl.load(g_ptr + row * stride_g + cols, mask=live,
                        other=0.0).to(tl.float32)
            if HAS_W:
                g = g * tl.load(w_ptr + cols, mask=live, other=0.0).to(
                    tl.float32)
            x = tl.load(x_ptr + row * stride_x + cols, mask=live,
                        other=0.0).to(tl.float32)
            if ROWS > 1:
                mean = tl.load(mean_ptr + row, mask=row < n1, other=0.0)
                invvar = tl.load(invvar_ptr + row, mask=row < n1,
                                 other=0.0)
            else:
                mean = tl.load(mean_ptr + row)
                invvar = tl.load(invvar_ptr + row)
            xhat = tl.where(live, (x - mean) * invvar, 0.0)
            sum_g = tl.sum(g, axis=0) / n2
            sum_gx = tl.sum(g * xhat, axis=0) / n2
            dx = (g - sum_g - xhat * sum_gx) * invvar
            tl.store(dx_ptr + row * stride_dx + cols,
                     dx.to(dx_ptr.dtype.element_ty), mask=live)

    return ln_bwd


def layer_norm_bwd_kernel(g2d, x2d, mean, invvar, weight, row_block=None):
    """Launch the Triton backward kernel: the output gradient ``g2d`` and
    the forward's input ``x2d`` (CUDA ``[n1, n2]``, unit column stride,
    one dtype), its fp32 ``mean`` and ``invvar`` ``[n1]`` and the weight
    ``[n2]`` or None; returns ``dx`` in x's dtype.  ``row_block`` as the
    forward's.  Adds one to ``layer_norm_bwd_kernel.launches`` per
    launch."""
    _check_kernel_rows(x2d, (("weight", weight),),
                       (("mean", mean), ("invvar", invvar)))
    if g2d.shape != x2d.shape or g2d.device != x2d.device \
            or g2d.stride(1) != 1:
        raise ValueError("g must be x's shape on x's device, with unit "
                         "column stride")
    n1, n2 = x2d.shape
    dx = torch.empty_like(x2d, memory_format=torch.contiguous_format)
    if n1 == 0:
        return dx
    block = 1 << max(0, n2 - 1).bit_length()
    rows = rows_per_program(n1, row_block)
    kernel = _triton_bwd_kernel()
    with torch.cuda.device(x2d.device):
        kernel[(-(-n1 // rows),)](
            g2d, x2d, mean, invvar, weight if weight is not None else x2d,
            dx, g2d.stride(0), x2d.stride(0), dx.stride(0), n1, n2,
            HAS_W=weight is not None, BLOCK=block, ROWS=rows,
            num_warps=min(16, max(4, block // 256)))
    layer_norm_bwd_kernel.launches += 1
    return dx


_build.counted(layer_norm_bwd_kernel)


def _row_block(x2d, row_block):
    """The caller's ``row_block``, else the tuned config of this shape's
    bucket, else None (the rule): the kernel path's consult."""
    if row_block is not None:
        return row_block
    shape = (*x2d.shape, x2d.element_size())
    cfg = _tuned_config("fused_layer_norm", TUNE_VERSION,
                        lambda: tune_bucket(*shape), params=("row_block",),
                        key=shape)
    return cfg["row_block"] if cfg else None


def layer_norm_fwd(x2d, weight, bias, eps, row_block=None):
    """``(out, mean, invvar)`` of a ``[n1, n2]`` input, no gradient: the
    kernel for a CUDA tensor (``row_block`` its rows a program, None: the
    cache's or the rule's), the plain version for a CPU one."""
    walk = _costs.counting(x2d)
    if walk is not None:
        return walk.kernel(_costs.layer_norm_fwd(x2d, weight, bias),
                           _fwd_ref, x2d, weight, bias, eps)
    if not x2d.is_cuda:
        return _fwd_ref(x2d, weight, bias, eps)
    return layer_norm_fwd_kernel(x2d.contiguous(), weight, bias, eps,
                                 _row_block(x2d, row_block))


def layer_norm_bwd_input(g2d, x2d, mean, invvar, weight, row_block=None):
    """``dx`` of a ``[n1, n2]`` input: the kernel for a CUDA tensor, the
    plain version for a CPU one."""
    walk = _costs.counting(x2d)
    if walk is not None:
        return walk.kernel(_costs.layer_norm_bwd(g2d, x2d, weight),
                           _bwd_input_ref, g2d, x2d, mean, invvar, weight)
    if not x2d.is_cuda:
        return _bwd_input_ref(g2d, x2d, mean, invvar, weight)
    return layer_norm_bwd_kernel(g2d.contiguous(), x2d, mean, invvar,
                                 weight, _row_block(x2d, row_block))


class _LayerNorm(torch.autograd.Function):
    """Forward kernel, saving ``x2d``, ``w``, ``mean`` and ``invvar``;
    backward the input-gradient kernel plus fp32 column sums for
    ``dgamma`` and ``dbeta`` (``fused_layer_norm.py:318-334``)."""

    @staticmethod
    def forward(ctx, x2d, weight, bias, eps, row_block):
        x2d = x2d.contiguous()
        out, mean, invvar = layer_norm_fwd(x2d, weight, bias, eps,
                                           row_block)
        ctx.save_for_backward(x2d, weight, mean, invvar)
        ctx.bias_dtype = None if bias is None else bias.dtype
        ctx.row_block = row_block
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x2d, weight, mean, invvar = ctx.saved_tensors
        dx = layer_norm_bwd_input(g, x2d, mean, invvar, weight,
                                  ctx.row_block)
        dw = db = None
        if weight is not None and ctx.needs_input_grad[1]:
            xhat = (x2d.float() - mean[:, None]) * invvar[:, None]
            dw = (g.float() * xhat).sum(0).to(weight.dtype)
        if ctx.bias_dtype is not None and ctx.needs_input_grad[2]:
            db = g.float().sum(0).to(ctx.bias_dtype)
        return dx, dw, db, None, None


# -- public functional API ----------------------------------------------------

def fused_layer_norm(x, normalized_shape, weight=None, bias=None, eps=1e-5,
                     row_block: Optional[int] = None):
    """Functional fused layer norm over the trailing ``normalized_shape``
    dims; the output has ``x``'s shape and dtype.  ``row_block``: the
    kernels' rows a program (the module docstring); left at None, a CUDA
    call consults the tuner's cache, else runs the rule.  An explicit
    value wins over the cache, as in JAX; the plain version ignores
    it."""
    if row_block is not None and (isinstance(row_block, bool)
                                  or int(row_block) <= 0):
        raise ValueError(f"row_block must be a positive int, got "
                         f"{row_block!r}")
    n1, n2 = _compute_n1_n2(x.shape, normalized_shape)
    x2d = x.reshape(n1, n2)
    w = weight.reshape(n2) if weight is not None else None
    b = bias.reshape(n2) if bias is not None else None
    return _LayerNorm.apply(x2d, w, b, float(eps),
                            row_block).reshape(x.shape)


def fused_layer_norm_affine(x, weight, bias, normalized_shape, eps=1e-5,
                            row_block: Optional[int] = None):
    return fused_layer_norm(x, normalized_shape, weight, bias, eps,
                            row_block)


class FusedLayerNorm(nn.Module):
    """``nn.LayerNorm`` semantics backed by the kernel.  Parameters are
    fp32 ``scale`` (ones) and ``bias`` (zeros), as the flax module
    creates them; inputs of any float dtype get fp32 statistics."""

    def __init__(self, normalized_shape: Union[int, Sequence[int]],
                 eps: float = 1e-5, elementwise_affine: bool = True, *,
                 device=None):
        super().__init__()
        self.normalized_shape = _normalize_shape(normalized_shape)
        self.eps = float(eps)
        self.elementwise_affine = elementwise_affine
        if elementwise_affine:
            dev = resolve_device(device)
            self.scale = nn.Parameter(torch.ones(self.normalized_shape,
                                                 device=dev))
            self.bias = nn.Parameter(torch.zeros(self.normalized_shape,
                                                 device=dev))
        else:
            self.scale = self.bias = None

    def forward(self, x):
        return fused_layer_norm(x, self.normalized_shape, self.scale,
                                self.bias, self.eps)
