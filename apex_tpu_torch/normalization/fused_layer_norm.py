"""FusedLayerNorm forward — Triton kernel for Hopper, with its plain
PyTorch version beside it.

Counterpart of ``apex_tpu/normalization/fused_layer_norm.py``: the input
splits into ``(n1, n2)`` = (rows, normalized elements), statistics are
fp32 whatever the input dtype, and the forward returns the output in the
input dtype plus fp32 ``mean`` and ``invvar`` per row.  Parameters are
fp32 and named ``scale`` / ``bias``, as in flax.

Dispatch is by the tensor's device and nothing else: a CPU tensor takes
:func:`_fwd_ref` (the JAX ``_fwd_ref`` math, single-pass variance
``E[x^2] - mean^2``); a CUDA tensor launches :func:`layer_norm_fwd_kernel`
at every size, or raises.  Forward only: a CUDA call that needs a
gradient raises ``NotImplementedError`` (the backward kernel comes with
the training slice).

Kernel note.  Replaces the Pallas ``_fwd_kernel`` (launched by
``_pallas_fwd``, ``apex_tpu/normalization/fused_layer_norm.py:206``).
One Triton program per row holds the whole row in one power-of-two block
(768 -> 1024, masked), reduces it in fp32 with ``tl.sum`` (the
warp-shuffle tree a CUDA kernel would write by hand) and writes the
affine output.  It is bound by memory on the H100: each element is read
once and written once and costs a handful of fp32 operations, so the
design keeps the row in registers and touches device memory exactly
once each way.  The variance is two-pass in registers (``mean((x -
mean)^2)``), which is no extra traffic and avoids the cancellation of
the single-pass form; it agrees with the plain version to ~1e-6.
"""

from __future__ import annotations

import functools
import math
import numbers
from typing import Sequence, Tuple, Union

import torch
from torch import nn

from .._device import resolve_device


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


# -- Triton kernel ------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _triton_kernel():
    """Compile-on-first-use Triton kernel (``triton`` is imported here,
    never at module import: CPU-only hosts have none)."""
    import triton
    import triton.language as tl

    @triton.jit
    def ln_fwd(x_ptr, w_ptr, b_ptr, out_ptr, mean_ptr, invvar_ptr,
               stride_x, stride_out, n2, eps,
               HAS_W: tl.constexpr, HAS_B: tl.constexpr,
               BLOCK: tl.constexpr):
        row = tl.program_id(0)
        cols = tl.arange(0, BLOCK)
        live = cols < n2
        x = tl.load(x_ptr + row * stride_x + cols, mask=live,
                    other=0.0).to(tl.float32)
        mean = tl.sum(x, axis=0) / n2
        xc = tl.where(live, x - mean, 0.0)
        var = tl.sum(xc * xc, axis=0) / n2
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
        tl.store(mean_ptr + row, mean)
        tl.store(invvar_ptr + row, invvar)

    return ln_fwd


def layer_norm_fwd_kernel(x2d, weight, bias, eps):
    """Launch the Triton kernel on a CUDA ``[n1, n2]`` input with unit
    column stride; returns ``(out, mean, invvar)``.  Adds one to
    ``layer_norm_fwd_kernel.launches`` per launch."""
    if not x2d.is_cuda or x2d.dim() != 2 or x2d.stride(1) != 1:
        raise ValueError("layer_norm kernel takes a CUDA [n1, n2] tensor "
                         "with unit column stride")
    if not x2d.dtype.is_floating_point:
        raise TypeError(f"layer_norm kernel takes floats, got {x2d.dtype}")
    n1, n2 = x2d.shape
    for name, t in (("weight", weight), ("bias", bias)):
        if t is not None and (t.device != x2d.device or t.shape != (n2,)
                              or t.stride(0) != 1):
            raise ValueError(f"{name} must be a contiguous [{n2}] tensor on "
                             f"{x2d.device}")
    out = torch.empty_like(x2d, memory_format=torch.contiguous_format)
    mean = torch.empty((n1,), dtype=torch.float32, device=x2d.device)
    invvar = torch.empty((n1,), dtype=torch.float32, device=x2d.device)
    if n1 == 0:
        return out, mean, invvar
    block = 1 << max(0, n2 - 1).bit_length()     # next power of two
    kernel = _triton_kernel()
    with torch.cuda.device(x2d.device):
        kernel[(n1,)](
            x2d, weight if weight is not None else x2d,
            bias if bias is not None else x2d, out, mean, invvar,
            x2d.stride(0), out.stride(0), n2, float(eps),
            HAS_W=weight is not None, HAS_B=bias is not None, BLOCK=block,
            num_warps=min(16, max(4, block // 256)))
    layer_norm_fwd_kernel.launches += 1
    return out, mean, invvar


layer_norm_fwd_kernel.launches = 0


def layer_norm_fwd(x2d, weight, bias, eps):
    """``(out, mean, invvar)`` of a ``[n1, n2]`` input: the kernel for a
    CUDA tensor, the plain version for a CPU one."""
    if not x2d.is_cuda:
        return _fwd_ref(x2d, weight, bias, eps)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x2d, weight, bias)):
        raise NotImplementedError(
            "the LayerNorm backward kernel is not ported yet; run the CUDA "
            "forward under torch.no_grad() or inference_mode()")
    return layer_norm_fwd_kernel(x2d.contiguous(), weight, bias, eps)


# -- public functional API ----------------------------------------------------

def fused_layer_norm(x, normalized_shape, weight=None, bias=None, eps=1e-5):
    """Functional fused layer norm over the trailing ``normalized_shape``
    dims; the output has ``x``'s shape and dtype."""
    n1, n2 = _compute_n1_n2(x.shape, normalized_shape)
    x2d = x.reshape(n1, n2)
    w = weight.reshape(n2) if weight is not None else None
    b = bias.reshape(n2) if bias is not None else None
    out, _, _ = layer_norm_fwd(x2d, w, b, float(eps))
    return out.reshape(x.shape)


def fused_layer_norm_affine(x, weight, bias, normalized_shape, eps=1e-5):
    return fused_layer_norm(x, normalized_shape, weight, bias, eps)


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
