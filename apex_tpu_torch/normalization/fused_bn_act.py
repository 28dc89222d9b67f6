"""Fused conv-side BN epilogue — Triton kernels for Hopper (forward and
activation gradient), with their plain PyTorch versions beside them.

Counterpart of ``apex_tpu/normalization/fused_bn_act.py``::

    y = relu((x - mean) * invstd * scale + bias [+ z])

``x`` (and the residual ``z``) are channels-last, viewed as ``[rows =
N*H*W, C]``; ``mean``, ``invstd`` and the optional affine ``scale`` and
``bias`` are fp32 ``[C]``.  Arithmetic is fp32, the output is in x's
dtype.  The gradient is a ``torch.autograd.Function`` (the JAX
``custom_vjp``) that treats ``mean`` and ``invstd`` as inputs of their
own: it returns cotangents for ``x``, ``mean``, ``invstd``, ``scale``,
``bias`` and ``z``, so statistics computed outside by plain torch ops
that autograd tracks get the whole BatchNorm's exact gradient.  The
activation-sized outputs (``dx``, ``dz``) come from the backward
kernel; the per-channel sums (``d_mean``, ``d_invstd``, ``d_scale``,
``d_bias``) are plain fp32 column sums, as the JAX backward computes
them outside its Pallas kernel.

Dispatch is by the tensor's device and nothing else: a CPU tensor takes
:func:`_fwd_ref` / :func:`_bwd_ref` (the JAX functions op for op;
:func:`_bwd_act_ref` is the backward kernel's part of it); a CUDA
tensor launches :func:`bn_act_fwd_kernel` and :func:`bn_act_bwd_kernel`
at every size, or raises.

Kernel notes.  The forward replaces the Pallas ``_fwd_kernel``
(launched by ``_pallas_fwd``, ``apex_tpu/normalization/fused_bn_act.py:
148``); the backward the Pallas ``_bwd_kernel`` (``_pallas_bwd``,
``:161``).  Both are elementwise passes with a per-channel broadcast and
a few fp32 operations per element, so they are bound by memory on the
H100 (~0.6 operations a byte): the forward moves ``rows * C`` elements
of x in and out (and z in), the backward g and x in (z too under ReLU)
and dx out (and dz).  The design is a 2-D grid of row blocks by channel
blocks; a program loads its channels' four fp32 vectors once, then
streams a ``[BLOCK_R, BLOCK_C]`` tile whose rows are contiguous in
memory, touching each activation element exactly once each way.  The
kernels are compiled without fused multiply-adds, so each element goes
through the plain version's roundings, one operation at a time: the
outputs equal the plain version's bit for bit (with an FMA, a result
near zero after ``* scale + bias`` can land on another bf16 value, and
the ReLU mask of the backward can flip at ``pre == 0``).  Each
variant (affine or not, with or without ``z``, ReLU or not) is its own
compiled kernel: no dummy ``z`` is read, and the backward writes ``dz``
only when there is a ``z`` (the Pallas kernel ships a ``[1, C]`` dummy
and writes a zero ``dz``: TPU layout artefacts).

The tile.  ``row_block`` (JAX's name) is ``BLOCK_R``, the rows of a
program's tile; the rule makes tiles of 8192 elements (64 rows of 128
channels).  Each element's arithmetic is the same in any tile, so every
``row_block`` gives the same bits.  ``bn_relu_residual(row_block=)``
sets it (rounded to a power of two within :mod:`apex_tpu_torch.tune.
space`'s register budget); left at None, a CUDA call consults the
tuner's cache for this shape's bucket (:func:`tune_bucket`, the JAX
package's string, :data:`TUNE_VERSION`).
"""

from __future__ import annotations

import functools

import torch

from typing import Optional

from .. import _build
from ..prof import costs as _costs
from ..tune import space as _space
from ..tune.dispatch import kernel_config as _tuned_config

__all__ = ["bn_relu_residual", "bn_act_epilogue_ref", "TUNE_VERSION",
           "tune_bucket"]

#: the tuner's config version of the BN epilogue kernels
TUNE_VERSION = 1
#: fp32 working bytes of a tile element: x, z and the pre-activation
#: live at once
_TILE_BYTES_PER_ELEM = 12


def tune_bucket(n_rows: int, c: int, itemsize: int, has_z: bool) -> str:
    """Config-cache shape bucket (the JAX package's string): rows round
    to a power of two; channels, itemsize and the residual flag exact."""
    return f"r{_space.pow2_bucket(n_rows)}_c{c}_i{itemsize}_z{int(has_z)}"


# -- plain version ------------------------------------------------------------

def _fwd_ref(x, mean, invstd, scale, bias, z, relu):
    out = (x.float() - mean) * invstd
    if scale is not None:
        out = out * scale + bias
    if z is not None:
        out = out + z.float()
    if relu:
        out = torch.relu(out)
    return out.to(x.dtype)


def bn_act_epilogue_ref(x, mean, invstd, scale=None, bias=None, z=None,
                        relu=True):
    """Public alias of the plain epilogue (the test oracle)."""
    return _fwd_ref(x, mean, invstd, scale, bias, z, relu)


def _masked_cotangent(g, x, mean, invstd, scale, bias, z, relu):
    """fp32 ``g'``: ``g`` where the pre-activation is positive (under
    ReLU), ``g`` otherwise."""
    gf = g.float()
    if relu:
        pre = (x.float() - mean) * invstd
        if scale is not None:
            pre = pre * scale + bias
        if z is not None:
            pre = pre + z.float()
        gf = torch.where(pre > 0, gf, 0.0)
    return gf


def _channel_sums(gf, x, mean, invstd, scale, bias):
    """``(d_mean, d_invstd, d_scale, d_bias)``, fp32 ``[C]`` column sums
    of ``[..., C]`` operands (the JAX ``_bwd_ref``'s reductions)."""
    red = tuple(range(x.dim() - 1))
    s = scale if scale is not None else 1.0
    xmu = x.float() - mean
    d_scale = (gf * xmu * invstd).sum(red) if scale is not None else None
    d_bias = gf.sum(red) if bias is not None else None
    d_mean = -(gf * s).sum(red) * invstd
    d_invstd = (gf * s * xmu).sum(red)
    return d_mean, d_invstd, d_scale, d_bias


def _act_grads(gf, x, invstd, scale, z):
    """``(dx, dz)`` from ``g'``: ``dx = g' * scale * invstd`` in x's
    dtype, ``dz = g'`` in z's (None without a z)."""
    s = scale if scale is not None else 1.0
    dx = (gf * s * invstd).to(x.dtype)
    return dx, (gf.to(z.dtype) if z is not None else None)


def _bwd_act_ref(g, x, mean, invstd, scale, bias, z, relu):
    """The backward kernel's plain version: ``(dx, dz)``."""
    gf = _masked_cotangent(g, x, mean, invstd, scale, bias, z, relu)
    return _act_grads(gf, x, invstd, scale, z)


def _bwd_ref(g, x, mean, invstd, scale, bias, z, relu):
    """Activation-sized grads and the per-channel sums, in the JAX order
    ``(dx, d_mean, d_invstd, d_scale, d_bias, dz)``."""
    gf = _masked_cotangent(g, x, mean, invstd, scale, bias, z, relu)
    dx, dz = _act_grads(gf, x, invstd, scale, z)
    return (dx, *_channel_sums(gf, x, mean, invstd, scale, bias), dz)


# -- Triton kernels -----------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _triton_kernels():
    """Compile-on-first-use Triton kernels (``triton`` is imported here,
    never at module import: CPU-only hosts have none)."""
    import triton
    import triton.language as tl

    @triton.jit
    def _tile(pid_r, pid_c, n_rows, n_ch, BLOCK_R: tl.constexpr,
              BLOCK_C: tl.constexpr):
        rows = pid_r * BLOCK_R + tl.arange(0, BLOCK_R)
        cols = pid_c * BLOCK_C + tl.arange(0, BLOCK_C)
        ch_live = cols < n_ch
        offs = rows.to(tl.int64)[:, None] * n_ch + cols[None, :]
        live = (rows < n_rows)[:, None] & ch_live[None, :]
        return cols, ch_live, offs, live

    @triton.jit
    def bn_fwd(x_ptr, mean_ptr, invstd_ptr, w_ptr, b_ptr, z_ptr, out_ptr,
               n_rows, n_ch, AFFINE: tl.constexpr, HAS_Z: tl.constexpr,
               RELU: tl.constexpr, BLOCK_R: tl.constexpr,
               BLOCK_C: tl.constexpr):
        cols, ch_live, offs, live = _tile(tl.program_id(0), tl.program_id(1),
                                          n_rows, n_ch, BLOCK_R, BLOCK_C)
        mean = tl.load(mean_ptr + cols, mask=ch_live, other=0.0)
        inv = tl.load(invstd_ptr + cols, mask=ch_live, other=0.0)
        x = tl.load(x_ptr + offs, mask=live, other=0.0).to(tl.float32)
        out = (x - mean[None, :]) * inv[None, :]
        if AFFINE:
            w = tl.load(w_ptr + cols, mask=ch_live, other=0.0)
            b = tl.load(b_ptr + cols, mask=ch_live, other=0.0)
            out = out * w[None, :] + b[None, :]
        if HAS_Z:
            out = out + tl.load(z_ptr + offs, mask=live, other=0.0).to(
                tl.float32)
        if RELU:       # a NaN passes, as through torch.relu
            out = tl.where(out < 0.0, 0.0, out)
        tl.store(out_ptr + offs, out.to(out_ptr.dtype.element_ty),
                 mask=live)

    @triton.jit
    def bn_bwd(g_ptr, x_ptr, mean_ptr, invstd_ptr, w_ptr, b_ptr, z_ptr,
               dx_ptr, dz_ptr, n_rows, n_ch, AFFINE: tl.constexpr,
               HAS_Z: tl.constexpr, RELU: tl.constexpr,
               BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
        cols, ch_live, offs, live = _tile(tl.program_id(0), tl.program_id(1),
                                          n_rows, n_ch, BLOCK_R, BLOCK_C)
        inv = tl.load(invstd_ptr + cols, mask=ch_live, other=0.0)
        g = tl.load(g_ptr + offs, mask=live, other=0.0).to(tl.float32)
        if AFFINE:
            w = tl.load(w_ptr + cols, mask=ch_live, other=0.0)
        if RELU:
            mean = tl.load(mean_ptr + cols, mask=ch_live, other=0.0)
            x = tl.load(x_ptr + offs, mask=live, other=0.0).to(tl.float32)
            pre = (x - mean[None, :]) * inv[None, :]
            if AFFINE:
                b = tl.load(b_ptr + cols, mask=ch_live, other=0.0)
                pre = pre * w[None, :] + b[None, :]
            if HAS_Z:
                pre = pre + tl.load(z_ptr + offs, mask=live, other=0.0).to(
                    tl.float32)
            g = tl.where(pre > 0, g, 0.0)
        if AFFINE:
            dx = g * w[None, :] * inv[None, :]
        else:
            dx = g * inv[None, :]
        tl.store(dx_ptr + offs, dx.to(dx_ptr.dtype.element_ty), mask=live)
        if HAS_Z:
            tl.store(dz_ptr + offs, g.to(dz_ptr.dtype.element_ty),
                     mask=live)

    return bn_fwd, bn_bwd


def _grid(n_rows: int, n_ch: int, row_block: Optional[int] = None):
    """``(grid, BLOCK_R, BLOCK_C)``: channel blocks of up to 128; row
    blocks of ``row_block`` (:func:`apex_tpu_torch.tune.space.pick_rows`:
    a power of two within the register budget), else the rule's tiles of
    8192 elements."""
    block_c = min(128, 1 << max(0, n_ch - 1).bit_length())
    if row_block is None:
        block_r = 8192 // block_c
    else:
        block_r = _space.pick_rows(n_rows, block_c, _TILE_BYTES_PER_ELEM,
                                   row_block=row_block)
    return ((-(-n_rows // block_r), -(-n_ch // block_c)), block_r, block_c)


def _check(x2d, acts, vecs):
    """What the kernels take: contiguous CUDA float ``[rows, C]``
    activations of one shape on one device, and contiguous fp32 ``[C]``
    per-channel vectors there."""
    if not x2d.is_cuda or x2d.dim() != 2 or not x2d.is_contiguous():
        raise ValueError("bn epilogue kernel takes a contiguous CUDA "
                         "[rows, C] tensor")
    if not x2d.dtype.is_floating_point:
        raise TypeError(f"bn epilogue kernel takes floats, got {x2d.dtype}")
    for name, t in acts:
        if t is not None and (t.shape != x2d.shape or t.device != x2d.device
                              or not t.is_contiguous()
                              or not t.dtype.is_floating_point):
            raise ValueError(f"{name} must be a contiguous float "
                             f"{list(x2d.shape)} tensor on {x2d.device}")
    c = x2d.shape[1]
    for name, t in vecs:
        if t is not None and (t.shape != (c,) or t.device != x2d.device
                              or t.dtype != torch.float32
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous fp32 [{c}] "
                             f"tensor on {x2d.device}")


def bn_act_fwd_kernel(x2d, mean, invstd, scale, bias, z2d, relu,
                      row_block=None):
    """Launch the Triton forward kernel on a contiguous CUDA ``[rows,
    C]`` input (``z2d`` the same shape, or None; ``scale`` and ``bias``
    both fp32 ``[C]`` or both None); returns the output in x's dtype.
    ``row_block``: the tile's rows (:func:`_grid`), None for the rule.
    Adds one to ``bn_act_fwd_kernel.launches`` per launch."""
    _check(x2d, (("z", z2d),), (("mean", mean), ("invstd", invstd),
                                ("scale", scale), ("bias", bias)))
    out = torch.empty_like(x2d)
    if x2d.numel() == 0:
        return out
    grid, block_r, block_c = _grid(*x2d.shape, row_block)
    kernel, _ = _triton_kernels()
    affine = scale is not None
    with torch.cuda.device(x2d.device):
        kernel[grid](x2d, mean, invstd, scale if affine else mean,
                     bias if affine else mean,
                     z2d if z2d is not None else x2d, out, *x2d.shape,
                     AFFINE=affine, HAS_Z=z2d is not None, RELU=bool(relu),
                     BLOCK_R=block_r, BLOCK_C=block_c, num_warps=8,
                     enable_fp_fusion=False)
    bn_act_fwd_kernel.launches += 1
    return out


_build.counted(bn_act_fwd_kernel)


def bn_act_bwd_kernel(g2d, x2d, mean, invstd, scale, bias, z2d, relu,
                      row_block=None):
    """Launch the Triton backward kernel: ``g2d`` the output gradient
    (x's shape), the forward's operands; returns ``(dx, dz)`` in x's and
    z's dtypes, ``dz`` None without a ``z``.  ``row_block`` as the
    forward's.  Adds one to ``bn_act_bwd_kernel.launches`` per launch."""
    _check(x2d, (("g", g2d), ("z", z2d)),
           (("mean", mean), ("invstd", invstd), ("scale", scale),
            ("bias", bias)))
    dx = torch.empty_like(x2d)
    dz = torch.empty_like(z2d) if z2d is not None else None
    if x2d.numel() == 0:
        return dx, dz
    grid, block_r, block_c = _grid(*x2d.shape, row_block)
    _, kernel = _triton_kernels()
    affine = scale is not None
    with torch.cuda.device(x2d.device):
        kernel[grid](g2d, x2d, mean, invstd, scale if affine else mean,
                     bias if affine else mean,
                     z2d if z2d is not None else x2d, dx,
                     dz if dz is not None else dx, *x2d.shape,
                     AFFINE=affine, HAS_Z=z2d is not None, RELU=bool(relu),
                     BLOCK_R=block_r, BLOCK_C=block_c, num_warps=8,
                     enable_fp_fusion=False)
    bn_act_bwd_kernel.launches += 1
    return dx, dz


_build.counted(bn_act_bwd_kernel)


class _Epilogue(torch.autograd.Function):
    """Forward kernel, saving its operands; backward the ``dx``/``dz``
    kernel plus plain per-channel sums (``fused_bn_act.py:281-311``)."""

    @staticmethod
    def forward(ctx, x2d, mean, invstd, scale, bias, z2d, relu, row_block):
        walk = _costs.counting(x2d)
        if walk is not None:
            out = walk.kernel(_costs.bn_act_fwd(x2d, z2d), _fwd_ref, x2d,
                              mean, invstd, scale, bias, z2d, relu)
        elif x2d.is_cuda:
            if row_block is None:
                row_block = _tuned_rows(x2d, z2d)
            out = bn_act_fwd_kernel(x2d, mean, invstd, scale, bias, z2d,
                                    relu, row_block)
        else:
            out = _fwd_ref(x2d, mean, invstd, scale, bias, z2d, relu)
        ctx.save_for_backward(x2d, mean, invstd, scale, bias, z2d)
        ctx.relu, ctx.row_block = relu, row_block
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x2d, mean, invstd, scale, bias, z2d = ctx.saved_tensors
        relu = ctx.relu
        walk = _costs.counting(x2d)
        if not x2d.is_cuda and walk is None:
            dx, d_mean, d_invstd, d_scale, d_bias, dz = _bwd_ref(
                g, x2d, mean, invstd, scale, bias, z2d, relu)
        else:
            # under a count, the card's split: the kernel's (dx, dz) by
            # its formula, the channel sums as the ops they are
            if walk is not None:
                dx, dz = walk.kernel(
                    _costs.bn_act_bwd(x2d, z2d, relu), _bwd_act_ref, g, x2d,
                    mean, invstd, scale, bias, z2d, relu)
            else:
                dx, dz = bn_act_bwd_kernel(g.contiguous(), x2d, mean,
                                           invstd, scale, bias, z2d, relu,
                                           ctx.row_block)
            gf = _masked_cotangent(g, x2d, mean, invstd, scale, bias, z2d,
                                   relu)
            d_mean, d_invstd, d_scale, d_bias = _channel_sums(
                gf, x2d, mean, invstd, scale, bias)
        return dx, d_mean, d_invstd, d_scale, d_bias, dz, None, None


def _tuned_rows(x2d, z2d) -> Optional[int]:
    """The kernel path's consult: the tuned ``row_block`` of this
    shape's bucket, or None (the rule)."""
    shape = (*x2d.shape, x2d.element_size(), z2d is not None)
    cfg = _tuned_config("bn_relu_residual", TUNE_VERSION,
                        lambda: tune_bucket(*shape), params=("row_block",),
                        key=shape)
    return cfg["row_block"] if cfg else None


def bn_relu_residual(x, mean, invstd, scale=None, bias=None, z=None,
                     relu=True, row_block: Optional[int] = None):
    """Fused BN epilogue ``relu((x - mean) * invstd * scale + bias + z)``.

    ``x`` is channels-last (``[..., C]``); ``mean``/``invstd`` and the
    optional affine ``scale``/``bias`` hold ``C`` values (any shape, fp32
    or cast to it); ``z`` is an optional residual of x's shape, added
    before the ReLU.  Returns x's shape and dtype.  Differentiable in
    ``x``, ``mean``, ``invstd``, ``scale``, ``bias`` and ``z``.
    ``row_block``: the kernels' tile rows (the module docstring); left at
    None, a CUDA call consults the tuner's cache, else runs the rule.  An
    explicit value wins over the cache, as in JAX; the plain version
    ignores it.
    """
    if row_block is not None and (isinstance(row_block, bool)
                                  or int(row_block) <= 0):
        raise ValueError(f"row_block must be a positive int, got "
                         f"{row_block!r}")
    c = x.shape[-1]
    x2d = x.reshape(-1, c).contiguous()
    z2d = z.reshape(-1, c).contiguous() if z is not None else None

    def vec(v):
        return None if v is None else v.reshape(c).float().contiguous()

    out = _Epilogue.apply(x2d, vec(mean), vec(invstd), vec(scale), vec(bias),
                          z2d, bool(relu), row_block)
    return out.reshape(x.shape)
