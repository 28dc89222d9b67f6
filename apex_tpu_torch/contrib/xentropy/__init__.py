"""Fused label-smoothing softmax cross-entropy — Triton kernels for
Hopper (forward and backward), with their plain PyTorch versions beside
them.

Counterpart of ``apex_tpu/contrib/xentropy/__init__.py``::

    loss = mlse - (1 - s) * x[label] - s * mean(x)     (mlse = logsumexp(x))
    dx   = g * (softmax(x) - (1 - s) * onehot(label) - s / V)

The forward returns per-row fp32 ``losses`` and saves only the fp32
``max_log_sum_exp`` per row for the backward, which recomputes the
softmax from the logits.  Rows whose label equals ``padding_idx`` get a
zero loss and a zero incoming gradient (the wrapper masks both, as the
JAX custom VJP does).  Losses are fp32 whatever the logits' dtype
(``half_to_float`` is accepted and ignored); ``dx`` is in the logits'
dtype.  A label outside ``[0, V)`` (``padding_idx=-1`` rows) picks no
logit, as the TPU kernel's iota compare picks none.

Dispatch is by the tensor's device and nothing else: a CPU tensor takes
:func:`_fwd_ref` / :func:`_bwd_ref` (the JAX ``_fwd_ref`` / ``_bwd_ref``
op for op); a CUDA tensor launches :func:`xentropy_fwd_kernel` and
:func:`xentropy_bwd_kernel` at every size, or raises.

Kernel notes.  The forward replaces the Pallas ``_fwd_kernel`` (launched
by ``_fwd_pallas``, ``apex_tpu/contrib/xentropy/__init__.py:109``), which
holds a whole ``[R, V]`` row block in VMEM.  On Hopper a 50257-wide fp32
row (201 KB) does not fit a block's registers, so one Triton program per
row streams it in chunks of up to 4096 columns with an online max and
sum-exp (each chunk rescales the running sum by ``exp(m_old - m_new)``),
picks the label's logit by comparing the column index, and keeps the row
sum for ``mean(x)``.  It is bound by memory: the logits are read exactly
once (``N * V`` elements) and 8 bytes a row are written, so the design
touches each logit once and keeps everything else in registers.

The backward replaces the Pallas ``_bwd_kernel`` (``_bwd_pallas``,
``:123``): a 2-D grid of rows by column chunks, each program reading
its chunk of logits once and writing ``dx`` once, with the row's
``mlse``, ``g`` and label as scalars.  Bound by memory: ``N * V``
elements read and written.  Both compile without fused multiply-adds
and take ``exp`` and ``log`` from libdevice (the CUDA math library's,
as torch's kernels do, not Triton's faster approximations), rounding
one operation at a time as the plain version does: near
``softmax == s / V`` the backward's difference cancels, and an
approximate ``exp`` would move a small ``dx`` by many bf16 ulps.

The tile.  The JAX kernel's ``row_block`` has no meaning here (one row a
program); the card's knobs are the column chunk a program holds
(``col_block``, a power of two; the rule: the row's next power of two,
at most 4096) and the program's warps (``num_warps``; the rule: chunk /
512 within [4, 8]), both forward and backward.  The chunk and the warps
change the order of the forward's row reductions, so another config's
loss and ``mlse`` (and through ``mlse`` the backward) agree with the
rule's to a tolerance, not bit for bit.  A CUDA call consults the
tuner's cache for this shape's bucket (:func:`tune_bucket`, the JAX
package's string, :data:`TUNE_VERSION`); the JAX API has no tile
argument, nor has this one.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from ... import _build
from ...prof import costs as _costs
from ...tune import space as _space
from ...tune.dispatch import kernel_config as _tuned_config

__all__ = ["SoftmaxCrossEntropyLoss", "softmax_cross_entropy_loss",
           "TUNE_VERSION", "tune_bucket"]

_MAX_BLOCK = 4096          # columns a program holds at once (the rule)
#: the widest chunk and the most warps the tuner may name
_MAX_TUNED_BLOCK, _MAX_WARPS = 16384, 16

#: the tuner's config version of the xentropy kernels
TUNE_VERSION = 1


def tune_bucket(n: int, h: int) -> str:
    """Config-cache shape bucket (the JAX package's string): vocabulary
    width exact, rows rounded to a power of two."""
    return f"r{_space.pow2_bucket(n)}_h{h}"


def config_legal(n_cols: int, col_block: int, num_warps: int) -> bool:
    """Whether ``(col_block, num_warps)`` is a launch the kernels take:
    a power-of-two chunk of 128 to 16384 columns, no wider than the
    row's power of two (a wider one only masks), and a warp count of
    :data:`apex_tpu_torch.tune.space.NUM_WARPS` up to 16 that leaves
    every thread at least one column."""
    cover = 1 << max(0, n_cols - 1).bit_length()
    return (128 <= col_block <= min(_MAX_TUNED_BLOCK, max(128, cover))
            and not col_block & (col_block - 1)
            and num_warps in _space.NUM_WARPS
            and num_warps <= _MAX_WARPS and 32 * num_warps <= col_block)


# -- plain version ------------------------------------------------------------

def _picked(xf, labels):
    """``x[label]`` per row, 0 where the label is outside ``[0, V)``
    (the kernels' column-index compare matches no column there)."""
    h = xf.shape[-1]
    inside = (labels >= 0) & (labels < h)
    idx = torch.where(inside, labels, 0).to(torch.long)
    return torch.where(inside, xf.gather(-1, idx[:, None])[:, 0], 0.0)


def _fwd_ref(logits, labels, smoothing):
    xf = logits.float()
    m = xf.max(dim=-1).values
    mlse = m + torch.log(torch.exp(xf - m[:, None]).sum(dim=-1))
    label_logit = _picked(xf, labels)
    mean_logit = xf.mean(dim=-1)
    losses = mlse - (1.0 - smoothing) * label_logit - smoothing * mean_logit
    return losses, mlse


def _bwd_ref(g, logits, mlse, labels, smoothing):
    xf = logits.float()
    h = xf.shape[-1]
    soft = torch.exp(xf - mlse[:, None])
    onehot = (torch.arange(h, device=xf.device)[None, :]
              == labels[:, None]).float()
    dx = g[:, None] * (soft - (1.0 - smoothing) * onehot - smoothing / h)
    return dx.to(logits.dtype)


# -- Triton kernels -----------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _triton_kernels():
    """Compile-on-first-use Triton kernels (``triton`` is imported here,
    never at module import: CPU-only hosts have none)."""
    import triton
    import triton.language as tl
    from triton.language.extra import libdevice

    @triton.jit
    def xent_fwd(x_ptr, lab_ptr, loss_ptr, mlse_ptr, stride_x, n_cols,
                 one_minus_s, smoothing, BLOCK: tl.constexpr):
        row = tl.program_id(0)
        base = x_ptr + row.to(tl.int64) * stride_x
        label = tl.load(lab_ptr + row)
        cols = tl.arange(0, BLOCK)
        # the first chunk seeds the running max, sum-exp, row sum and
        # picked logit (every chunk holds at least one live column)
        live = cols < n_cols
        x = tl.load(base + cols, mask=live, other=-float("inf")).to(
            tl.float32)
        m = tl.max(x, axis=0)
        s = tl.sum(libdevice.exp(x - m), axis=0)
        tot = tl.sum(tl.where(live, x, 0.0), axis=0)
        picked = tl.sum(tl.where(cols == label, x, 0.0), axis=0)
        for start in range(BLOCK, n_cols, BLOCK):
            c = start + cols
            live = c < n_cols
            x = tl.load(base + c, mask=live, other=-float("inf")).to(
                tl.float32)
            m_new = tl.maximum(m, tl.max(x, axis=0))
            s = (s * libdevice.exp(m - m_new)
                 + tl.sum(libdevice.exp(x - m_new), axis=0))
            m = m_new
            tot += tl.sum(tl.where(live, x, 0.0), axis=0)
            picked += tl.sum(tl.where(c == label, x, 0.0), axis=0)
        mlse = m + libdevice.log(s)
        loss = mlse - one_minus_s * picked - smoothing * (tot / n_cols)
        tl.store(loss_ptr + row, loss)
        tl.store(mlse_ptr + row, mlse)

    @triton.jit
    def xent_bwd(g_ptr, x_ptr, mlse_ptr, lab_ptr, dx_ptr, stride_x,
                 stride_dx, n_cols, one_minus_s, s_over_v,
                 BLOCK: tl.constexpr):
        row = tl.program_id(0)
        c = tl.program_id(1) * BLOCK + tl.arange(0, BLOCK)
        live = c < n_cols
        x = tl.load(x_ptr + row.to(tl.int64) * stride_x + c, mask=live,
                    other=0.0).to(tl.float32)
        g = tl.load(g_ptr + row)
        mlse = tl.load(mlse_ptr + row)
        label = tl.load(lab_ptr + row)
        onehot = tl.where(c == label, 1.0, 0.0)
        dx = g * (libdevice.exp(x - mlse) - one_minus_s * onehot
                  - s_over_v)
        tl.store(dx_ptr + row.to(tl.int64) * stride_dx + c,
                 dx.to(dx_ptr.dtype.element_ty), mask=live)

    return xent_fwd, xent_bwd


def _block(n_cols: int) -> int:
    return min(_MAX_BLOCK, 1 << max(0, n_cols - 1).bit_length())


def rule_config(n_cols: int) -> Tuple[int, int]:
    """``(col_block, num_warps)`` of the rule for rows of ``n_cols``."""
    block = _block(n_cols)
    return block, min(8, max(4, block // 512))


def _launch_config(n_cols: int, config: Optional[Tuple[int, int]]
                   ) -> Tuple[int, int]:
    if config is None:
        return rule_config(n_cols)
    block, warps = (int(c) for c in config)
    if not config_legal(n_cols, block, warps):
        raise ValueError(f"xentropy config (col_block {block}, num_warps "
                         f"{warps}) is not a launch the kernels take for "
                         f"rows of {n_cols}")
    return block, warps


def _check(logits, rows):
    """What the kernels take: CUDA float ``[N, V]`` logits with unit
    column stride, and contiguous ``[N]`` row vectors on their device
    (int32 labels, fp32 otherwise)."""
    if not logits.is_cuda or logits.dim() != 2 or logits.stride(1) != 1:
        raise ValueError("xentropy kernel takes CUDA [N, V] logits with "
                         "unit column stride")
    if not logits.dtype.is_floating_point:
        raise TypeError(f"xentropy kernel takes float logits, got "
                        f"{logits.dtype}")
    n = logits.shape[0]
    for name, t, dtype in rows:
        if (t.device != logits.device or t.shape != (n,) or t.dtype != dtype
                or (n and t.stride(0) != 1)):
            raise ValueError(f"{name} must be a contiguous {dtype} [{n}] "
                             f"tensor on {logits.device}")


def xentropy_fwd_kernel(logits, labels, smoothing, config=None):
    """Launch the Triton forward kernel on CUDA ``[N, V]`` logits and
    int32 ``[N]`` labels; returns fp32 ``(losses, mlse)``, unmasked.
    ``config``: ``(col_block, num_warps)`` (:func:`config_legal`), None
    for the rule.  Adds one to ``xentropy_fwd_kernel.launches`` per
    launch."""
    _check(logits, (("labels", labels, torch.int32),))
    n, v = logits.shape
    losses = torch.empty((n,), dtype=torch.float32, device=logits.device)
    mlse = torch.empty((n,), dtype=torch.float32, device=logits.device)
    if n == 0:
        return losses, mlse
    block, warps = _launch_config(v, config)
    kernel, _ = _triton_kernels()
    with torch.cuda.device(logits.device):
        kernel[(n,)](logits, labels, losses, mlse, logits.stride(0), v,
                     1.0 - smoothing, float(smoothing), BLOCK=block,
                     num_warps=warps, enable_fp_fusion=False)
    xentropy_fwd_kernel.launches += 1
    return losses, mlse


_build.counted(xentropy_fwd_kernel)


def xentropy_bwd_kernel(g, logits, mlse, labels, smoothing, config=None):
    """Launch the Triton backward kernel: fp32 ``g`` and ``mlse`` and
    int32 ``labels`` (``[N]``, contiguous) with the CUDA ``[N, V]``
    logits; returns ``dx`` in the logits' dtype.  ``config`` as the
    forward's.  Adds one to ``xentropy_bwd_kernel.launches`` per
    launch."""
    _check(logits, (("g", g, torch.float32), ("mlse", mlse, torch.float32),
                    ("labels", labels, torch.int32)))
    n, v = logits.shape
    dx = torch.empty((n, v), dtype=logits.dtype, device=logits.device)
    if n == 0:
        return dx
    block, warps = _launch_config(v, config)
    _, kernel = _triton_kernels()
    with torch.cuda.device(logits.device):
        kernel[(n, -(-v // block))](
            g, logits, mlse, labels, dx, logits.stride(0), dx.stride(0), v,
            1.0 - smoothing, smoothing / v, BLOCK=block, num_warps=warps,
            enable_fp_fusion=False)
    xentropy_bwd_kernel.launches += 1
    return dx


_build.counted(xentropy_bwd_kernel)


def _tuned(logits) -> Optional[Tuple[int, int]]:
    """The kernel path's consult: the tuned ``(col_block, num_warps)``
    of this shape's bucket when the kernels take it, else None (the
    rule)."""
    n, v = logits.shape
    cfg = _tuned_config("xentropy", TUNE_VERSION, lambda: tune_bucket(n, v),
                        params=("col_block", "num_warps"), key=(n, v))
    if cfg and config_legal(v, cfg["col_block"], cfg["num_warps"]):
        return cfg["col_block"], cfg["num_warps"]
    return None


class _SoftmaxXentropy(torch.autograd.Function):
    """Forward kernel, saving the logits, ``mlse`` and the int32 labels;
    backward the ``dx`` kernel on the padding-masked incoming gradient
    (the JAX ``_fwd_vjp`` / ``_bwd_vjp``)."""

    @staticmethod
    def forward(ctx, logits, labels, smoothing, padding_idx):
        labels = labels.to(torch.int32).contiguous()
        walk = _costs.counting(logits)
        if walk is not None:
            losses, mlse = walk.kernel(
                _costs.xentropy_fwd(logits), _fwd_ref, logits, labels,
                smoothing)
        elif logits.is_cuda:
            if logits.stride(1) != 1:
                logits = logits.contiguous()
            config = _tuned(logits)
            losses, mlse = xentropy_fwd_kernel(logits, labels, smoothing,
                                               config)
        else:
            losses, mlse = _fwd_ref(logits, labels, smoothing)
        losses = torch.where(labels == padding_idx, 0.0, losses)
        ctx.save_for_backward(logits, mlse, labels)
        ctx.smoothing, ctx.padding_idx = smoothing, padding_idx
        ctx.config = config if logits.is_cuda and walk is None else None
        return losses

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        logits, mlse, labels = ctx.saved_tensors
        g = torch.where(labels == ctx.padding_idx, 0.0, g.float())
        walk = _costs.counting(logits)
        if walk is not None:
            dx = walk.kernel(_costs.xentropy_bwd(logits), _bwd_ref, g, logits,
                             mlse, labels, ctx.smoothing)
        elif logits.is_cuda:
            dx = xentropy_bwd_kernel(g, logits, mlse, labels, ctx.smoothing,
                                     ctx.config)
        else:
            dx = _bwd_ref(g, logits, mlse, labels, ctx.smoothing)
        return dx, None, None, None


def softmax_cross_entropy_loss(logits, labels, smoothing=0.0, padding_idx=0,
                               half_to_float=False):
    """Per-example label-smoothing cross entropy of ``[N, V]`` logits and
    ``[N]`` integer labels, fp32 ``[N]``, padding rows zero.
    ``half_to_float`` is kept for the reference signature: losses are
    always fp32."""
    return _SoftmaxXentropy.apply(logits, labels, float(smoothing),
                                  int(padding_idx))


class SoftmaxCrossEntropyLoss:
    """Reference-compatible callable (``SoftmaxCrossEntropyLoss.apply``)."""

    @staticmethod
    def apply(logits, labels, smoothing=0.0, padding_idx=0,
              half_to_float=False):
        return softmax_cross_entropy_loss(logits, labels, smoothing,
                                          padding_idx, half_to_float)

    def __call__(self, logits, labels, smoothing=0.0, padding_idx=0,
                 half_to_float=False):
        return self.apply(logits, labels, smoothing, padding_idx,
                          half_to_float)
