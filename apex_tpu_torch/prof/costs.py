"""The analytic cost of each hand-written kernel's call, and the hook by
which a kernel's entry point reports it to an active count.

The kernels are ``ctypes`` or Triton launches, which no dispatch mode
sees.  Each function below gives the work one call needs, from the
shapes (and, where a mask leaves keys hidden, the data) of its
operands: a :class:`KernelCost` of the floating (or integer) operations
it does and the bytes it must move, each input read once and each
output written once.  ``chip_smoke.py`` divides these by the card's
peaks for every kernel's ``bound_ms`` (:func:`bound`), and the analytic
walk (:func:`apex_tpu_torch.prof.analysis.profile_function`) records
them as the kernel's one :class:`~apex_tpu_torch.prof.analysis.OpRecord`,
so the roofline ledger and the kernel table count the same work.

:func:`counting` is the hook.  A kernel's entry point calls it once
per call on its main operand.  It returns the walk that counts the
call: the innermost counting mode on this thread's dispatch-mode stack
(which autograd's threads inherit), and only while that operand is a
fake tensor.  The entry point then hands its cost and its plain
version to the walk's ``kernel`` method, which records the cost and
runs the plain version with its aten ops hidden from the walk, so the
kernel is counted once, by its formula, on either device, and a fake
tensor never reaches a launch.  A real tensor is never counted,
whatever walk is open on this thread or another: it launches its
kernel on the card, or runs its plain version on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

__all__ = ["KernelCost", "HBM_BYTES_PER_S", "PEAK_OPS", "bound",
           "visible_pairs", "layer_norm_fwd", "layer_norm_bwd",
           "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_db2",
           "bn_act_fwd", "bn_act_bwd", "xentropy_fwd", "xentropy_bwd",
           "conv_fwd", "conv_dgrad", "conv_wgrad", "qmm", "active_count",
           "counting"]

#: the H100 SXM data sheet's memory rate (bytes/s)
HBM_BYTES_PER_S = 3.35e12
#: its dense peak rates by operand type (operations/s): tensor cores for
#: bf16, fp16 and int8, fp32 outside them
PEAK_OPS = {torch.bfloat16: 989e12,
            torch.float16: 989e12,
            torch.float32: 67e12,
            torch.int8: 1979e12}

class KernelCost(NamedTuple):
    """One kernel call's work: ``flops`` operations of type ``dtype``
    (the peak they are held to) and ``bytes`` moved."""
    name: str
    flops: float
    bytes: float
    dtype: torch.dtype


def bound(cost: KernelCost) -> tuple:
    """``(bound_ms, bound_by)``: the least time for the bytes over the
    memory rate and for the operations over the peak rate of their
    type, whichever is larger."""
    t_bytes = cost.bytes / HBM_BYTES_PER_S * 1e3
    t_ops = cost.flops / PEAK_OPS[cost.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import is_fake
    return is_fake(t)


def active_count():
    """The innermost counting mode on this thread's dispatch-mode stack
    (an analytic walk), or None."""
    if torch._C._len_torch_dispatch_stack() == 0:
        return None
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if getattr(mode, "counts_kernels", False):
            return mode
    return None


def counting(t):
    """The walk that counts a kernel call on ``t``, or None: the active
    count (:func:`active_count`) when ``t`` is a fake tensor."""
    if torch._C._len_torch_dispatch_stack() == 0 or not _is_fake(t):
        return None
    return active_count()


def visible_pairs(b, tq, tk, causal, q_offset, window, kbias) -> int:
    """Query-key pairs the masks of a flash call leave visible, summed
    over the batch (per head): the work these inputs need.  A key-padding
    bias (decode) is read for its live keys; a fake one (no data) counts
    every key."""
    if kbias is not None and not _is_fake(kbias):
        return int((kbias == 0).sum().item()) * tq
    if kbias is not None or not causal:
        return b * tq * tk
    n = np.minimum(q_offset + np.arange(tq) + 1, tk)
    if window is not None:
        n = np.minimum(n, window)
    return b * int(n.sum())


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


# -- LayerNorm (kernels 8-9) --------------------------------------------------

def layer_norm_fwd(x2d, weight, bias) -> KernelCost:
    """x read, out written, weight and bias read, mean and invvar (fp32)
    written; 8 operations an element."""
    rows, n = x2d.shape
    return KernelCost("layer_norm_fwd", 8.0 * rows * n,
                      2 * _nbytes(x2d) + _nbytes(weight, bias) + 2 * rows * 4,
                      torch.float32)


def layer_norm_bwd(g2d, x2d, weight) -> KernelCost:
    """g and x read, dx written, mean and invvar read, weight read; 10
    operations an element."""
    rows, n = x2d.shape
    return KernelCost("layer_norm_bwd", 10.0 * rows * n,
                      3 * _nbytes(x2d) + 2 * rows * 4 + _nbytes(weight),
                      torch.float32)


# -- flash attention (kernels 10-13) ------------------------------------------

def _flash_dims(q, k):
    b, tq, h, d = q.shape
    return b, tq, k.shape[1], h, d


def flash_fwd(q, k, v, kbias, bias, *, causal, q_offset, window
              ) -> KernelCost:
    """q, k, v read, out and the fp32 lse written, the biases read; two
    products of 2 x head_dim operations a visible pair and head."""
    b, tq, tk, h, d = _flash_dims(q, k)
    pairs = visible_pairs(b, tq, tk, causal, q_offset, window, kbias)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() \
        + b * h * tq * 4 + _nbytes(bias, kbias)
    return KernelCost("flash_attention_fwd", 4.0 * h * d * pairs, nbytes,
                      q.dtype)


def flash_bwd_dq(q, k, v, kbias, bias, *, causal, q_offset, window
                 ) -> KernelCost:
    """q, k, v and dO read, dQ written, lse and delta read, the biases
    read; three products a visible pair and head."""
    b, tq, tk, h, d = _flash_dims(q, k)
    pairs = visible_pairs(b, tq, tk, causal, q_offset, window, None) * h
    nbytes = (3 * q.numel() + k.numel() + v.numel()) * q.element_size() \
        + 2 * b * h * tq * 4 + _nbytes(kbias, bias)
    return KernelCost("flash_attention_bwd_dq", 2.0 * 3 * d * pairs, nbytes,
                      q.dtype)


def flash_bwd_dkv(q, k, v, kbias, bias, *, causal, q_offset, window,
                  kbias_grad=False) -> KernelCost:
    """q, k, v and dO read, dK and dV written, lse and delta read, the
    biases read, the key-bias partials written when they need a
    gradient; four products a visible pair and head."""
    b, tq, tk, h, d = _flash_dims(q, k)
    pairs = visible_pairs(b, tq, tk, causal, q_offset, window, None) * h
    nbytes = (2 * q.numel() + 2 * k.numel() + 2 * v.numel()) \
        * q.element_size() + 2 * b * h * tq * 4 \
        + (b * h * tk * 4 if kbias_grad else 0) + _nbytes(kbias, bias)
    return KernelCost("flash_attention_bwd_dkv", 2.0 * 4 * d * pairs,
                      nbytes, q.dtype)


def flash_bwd_db2(q, k, v, bias, *, causal, q_offset, window
                  ) -> KernelCost:
    """q, k, v and dO read, lse and delta read, the fp32 ``[B, T, S]``
    bias read where the band leaves a key visible and its gradient
    written whole; two products a visible pair and head."""
    b, tq, tk, h, d = _flash_dims(q, k)
    pairs = visible_pairs(b, tq, tk, causal, q_offset, window, None)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() \
        + pairs * 4 + b * tq * tk * 4 + 2 * b * h * tq * 4
    return KernelCost("flash_attention_bwd_db2", 4.0 * d * pairs * h,
                      nbytes, q.dtype)


# -- the BN epilogue (kernels 4-5) --------------------------------------------

def bn_act_fwd(x2d, z2d) -> KernelCost:
    """x (and z) read, out written, four fp32 channel vectors read; 6
    operations an element."""
    n, c = x2d.numel(), x2d.shape[-1]
    acts = 2 if z2d is not None else 1
    return KernelCost("bn_act_fwd", 6.0 * n,
                      (acts + 1) * n * x2d.element_size() + 4 * c * 4,
                      torch.float32)


def bn_act_bwd(x2d, z2d, relu) -> KernelCost:
    """g read and dx written; x (and z) read only under ReLU; dz written
    with a z; four fp32 channel vectors read; 8 operations an element."""
    n, c = x2d.numel(), x2d.shape[-1]
    has_z = z2d is not None
    acts = 2 + bool(relu) + (bool(relu) and has_z) + has_z
    return KernelCost("bn_act_bwd", 8.0 * n,
                      acts * n * x2d.element_size() + 4 * c * 4,
                      torch.float32)


# -- cross-entropy (kernels 6-7) ----------------------------------------------

def xentropy_fwd(logits) -> KernelCost:
    """The logits read, the fp32 losses and max-log-sum-exp written, the
    labels read; 5 operations a logit."""
    n, v = logits.shape
    return KernelCost("xentropy_fwd", 5.0 * n * v,
                      n * v * logits.element_size() + 3 * n * 4,
                      torch.float32)


def xentropy_bwd(logits) -> KernelCost:
    """The logits read and dx written, g, mlse and the labels read; 5
    operations a logit."""
    n, v = logits.shape
    return KernelCost("xentropy_bwd", 5.0 * n * v,
                      2 * n * v * logits.element_size() + 3 * n * 4,
                      torch.float32)


# -- the conv (kernels 1-3) ---------------------------------------------------

def _conv_macs(x, w, out_hw) -> int:
    kh, kw, cin, o = w.shape
    return x.shape[0] * out_hw[0] * out_hw[1] * o * kh * kw * cin


def conv_fwd(x, w, out_hw, epilogue: bool = False) -> KernelCost:
    """NHWC x and HWIO w read, the output written (and with the fused BN
    epilogue the pre-activation too, and four fp32 channel vectors
    read); 2 operations a multiply-add."""
    o = w.shape[3]
    n_y = x.shape[0] * out_hw[0] * out_hw[1] * o
    nbytes = (x.numel() + w.numel() + n_y * (2 if epilogue else 1)) \
        * x.element_size() + (4 * o * 4 if epilogue else 0)
    return KernelCost("conv_fwd", 2.0 * _conv_macs(x, w, out_hw), nbytes,
                      x.dtype)


def conv_dgrad(dy, w, x_shape) -> KernelCost:
    """dy and w read, dx written; the forward's multiply-adds."""
    n_x = int(np.prod(x_shape))
    macs = x_shape[0] * dy.shape[1] * dy.shape[2] * int(np.prod(w.shape))
    return KernelCost("conv_dgrad", 2.0 * macs,
                      (dy.numel() + w.numel() + n_x) * dy.element_size(),
                      dy.dtype)


def conv_wgrad(x, dy, w_shape) -> KernelCost:
    """x and dy read, dw written; the forward's multiply-adds."""
    macs = x.shape[0] * dy.shape[1] * dy.shape[2] * int(np.prod(w_shape))
    return KernelCost("conv_wgrad", 2.0 * macs,
                      (x.numel() + dy.numel() + int(np.prod(w_shape)))
                      * x.element_size(), x.dtype)


# -- the int8 quantized matmul (kernel 14) ------------------------------------

def qmm(x2d, qw, out_dtype: Optional[torch.dtype] = None) -> KernelCost:
    """x read, the int8 ``[N, Kp]`` weight read, its fp32 scales and the
    activation scale read, the output written; 2 int8 operations a
    multiply-add."""
    m, k = x2d.shape
    n = qw.shape[0]
    osz = torch.empty((), dtype=out_dtype or x2d.dtype).element_size()
    nbytes = m * k * x2d.element_size() + n * qw.shape[1] + 4 * n + 4 \
        + m * n * osz
    return KernelCost("qmm", 2.0 * m * n * k, nbytes, torch.int8)
