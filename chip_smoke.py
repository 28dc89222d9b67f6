#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``apex_tpu_torch``) on one NVIDIA
GPU: builds the port's kernels from this checkout, holds each against its
plain PyTorch version at the shapes of the serving and training paths,
serves GPT-2 small through the paged-KV engine, trains it for ten steps
through the LM trainer, trains ResNet-50 for ten steps through the
ImageNet trainer (its default, every convolution in the port's conv
kernels; then with ``--no-pallas-conv``), serves and trains GPT-2 small
at amp O4 through the int8 quantized-matmul kernel, drives the
``[B, T, S]`` bias gradient through ``flash_attention``, and checks the
card's answers against the CPU's.

    python3 chip_smoke.py [--out results.json]

Phases (any failure ends the run with a non-zero exit and no result
line):

1. the card's name and power limit (``nvidia-smi``); TF32 off, so fp32
   products are fp32;
2. build the four CUDA libraries (flash forward; flash dQ, dK/dV and the
   bias gradient; the conv forward, dgrad and wgrad; the int8 quantized
   matmul: one ``nvcc`` each) and compile the Triton kernels (LayerNorm,
   BN epilogue and cross-entropy, forward and backward, one after
   another), the five concurrently, time each and print ``ptxas``'s
   registers and spills;
3. LayerNorm kernel vs plain at ``[1024, 768]`` and ``[8, 768]``, bf16
   and fp32, and rows of mean 100 (the kernel's single-pass variance
   follows the plain version's, not the two-pass one);
4. flash kernel vs plain at gpt2_small shapes: prefill with a
   ``[B, T, S]`` bias, full causal, decode (``q_len = 1``, key padding
   bias: the split-KV path), GQA (12 query heads over 4 KV heads), a
   256-key window, fp32, the LM's B 8, T 1023 causal call, fp16 (prefill
   and decode), and head widths 16, 48 and 256.  ``library_ms`` times one
   PyTorch call computing the same function (``F.layer_norm``,
   ``F.scaled_dot_product_attention``) as a yardstick only; the port
   never calls it;
5. serving: gpt2_small in bf16, buckets (256, 1024), page 16, 8 slots,
   16 requests of 32-900 prompt tokens and 32 new tokens, with every
   launch counter set to 0 just before and read just after; then a
   256-token prefill's logits on the card against the CPU port in fp32,
   and gpt_tiny served in fp32 on the card and on the CPU with equal
   greedy tokens (a mismatch is allowed only where the CPU's top-2 logit
   gap at that step is below 1e-4);
6. where the time goes: one serving run traced with ``torch.profiler``
   (device busy and idle share, host and device time per prefill and
   decode step, device time by kernel kind);
7. LayerNorm backward kernel vs plain at ``[8184, 768]`` (8 x 1023
   training rows) and ``[8, 768]``, bf16 and fp32; ``library_ms`` is one
   ``aten.native_layer_norm_backward`` call computing dx;
8. flash dQ and dK/dV kernels vs plain at gpt2_small training shapes (B
   8, T 1023, 12 heads of 64, causal, bf16), GQA 12/4, a 256-key window,
   fp32, a key-padding bias that needs a gradient, fp16, head widths 16,
   48, 128 and 256, a ``[B, T, S]`` bias, and causal cross attention (q_len
   333, kv_len 1021: the queries the suffix of the keys); ``library_ms``
   is the backward of one SDPA call, timed eagerly (autograd cannot be
   captured in a CUDA graph);
9. training: the LM trainer (``apex_tpu_torch.examples.lm.main_amp``)
   on GPT-2 small, bf16 O2, Adam lr 3e-4, weight decay 0.1, static loss
   scale 1.0, the fused loss, B 8, seq_len 1024, 10 steps, every launch
   counter set to 0 just before and read just after (25 LN forward and
   backward, 12 flash forward, dQ and dK/dV, 1 cross-entropy forward and
   backward per step, nothing else); losses finite and falling; step ms,
   tokens/s, peak memory; then two steps traced with ``torch.profiler``
   (device time by kind, idle share);
10. training correctness: gpt_tiny O0 fp32 three steps on the card and
   on the CPU from the same weights; gpt2_small fp32 gradients at B 1, T
   256 card vs CPU; gpt_tiny O2 with a dynamic scale and an injected inf
   (the step is skipped, the scale halves, the next step applies); the
   fused LM loss equal to the ``--no-fused-loss`` composition on the
   card;
11. BN epilogue forward and backward kernels vs plain at ResNet-50 B 128
   shapes (``[1605632, 64]``, ``[401408, 256]`` with a residual,
   ``[6272, 2048]`` without ReLU, bf16; one fp32 case): bf16 within one
   ulp, fp32 within 1e-6; ``library_ms`` is ``F.batch_norm(training=
   False)`` and its backward where it computes the same function;
12. cross-entropy forward and backward kernels vs plain at
   ``[8184, 50257]`` (smoothing 0 and 0.1, padding rows; fp32 and bf16)
   and ``[128, 1000]``; ``library_ms`` is ``F.cross_entropy`` and its
   backward;
13. ResNet-50 training: the ImageNet trainer
   (``apex_tpu_torch.examples.imagenet.main_amp``), B 128, 224 x 224,
   bf16 O2, SGD, its defaults ``--pallas-conv --fused-bn --fused-loss``,
   10 steps, every launch counter set to 0 just before and read just
   after (53 conv forward, 52 dgrad (the stem's input needs no gradient)
   and 53 wgrad, 53 BN forward and backward, 1 cross-entropy forward and
   backward per step, nothing else); losses finite; step ms, images/s,
   peak memory; two steps traced (device time by kind, idle share);
   13b. the same with ``--no-pallas-conv`` (cuDNN convs), 5 steps, no
   conv kernel launched, also traced;
14. ResNet correctness: a small bottleneck ResNet at O0 fp32, three SGD
   steps on the card and on the CPU (losses rtol 1e-4, parameters and
   running statistics atol 1e-4), with ``Conv`` and with ``PallasConv``
   (the conv kernels); an O2 dynamic-scale step with an injected inf
   skipped with the parameters bit-identical and the running statistics
   advanced, with both; conv outputs contiguous NHWC;
15. conv kernels vs plain at ResNet-50 B 128 shapes (the stem, a stage-1
   3x3, a stride-2 3x3 with flax's ``(0, 1)`` pads, two stage-3/4 1x1s,
   the stage-1 1x1 expansion with the fused epilogue; bf16), one fp32
   3x3 at B 32, fp16 (a 3x3/1, the 3x3/2, the epilogue), and the dgrad
   alone at the other four stride-2 sites of a step (the per-parity
   path): forward, dgrad (not for the stem) and wgrad, fp32 within 1e-4
   of max |plain|, fp16 within one fp16 ulp of max |plain|, bf16 within
   one ulp of max |plain| with 99.9% of
   elements within one ulp of their plain value (wgrad: of the fp64 sum,
   since its fp32 plain sum over up to 1.6 M products misses by more on
   elements near zero), the epilogue equal to the kernel's conv
   followed by the plain epilogue bit for bit; ``library_ms`` is cuDNN
   (``F.conv2d`` channels-last, ``aten.convolution_backward``);
16. the int8 quantized-matmul kernel vs plain, bit for bit, at the O4
   path's shapes: serving prefill M 1024 (768->768, 768->3072,
   3072->768), decode M 8 (768->768, 3072->768), training M 8184
   (768->3072), an fp32 case, a zero-amax weight column, ragged M 1000 /
   N 130, fp16, and K = 8 and K = 40 (the weight padded to a multiple of
   16); ``library_ms`` ``torch._int_mm`` on the quantized operands where
   it takes the shape, beside the bf16 matmul of O2;
17. O4 serving: gpt2_small bf16 calibrated in observe mode on 4 batches
   (frozen with "max"), rebuilt with the frozen scales, serving phase
   5's load with an int8 KV cache (72 qmm, 25 LN and 12 flash launches a
   forward, nothing else), traced as in phase 6; O4 with an empty
   calibration equal to O2 bit for bit and O4 vs O2 prefill logits;
   gpt_tiny fp32 O4 with an int8 KV cache on the card and on the CPU
   with equal greedy tokens (a mismatch allowed only where the CPU
   engine's top-2 logit gap at that step is below ``O4_TINY_GAP``);
18. O4 training: ``make_train_step(opt_level="O4")`` on the calibrated
   gpt2_small, Adam, B 8, seq_len 1024, the fused loss, 10 steps (72 qmm
   a step beside phase 9's kernels), losses finite and falling, beside
   phase 9's O2 numbers; two steps traced;
19. the ``[B, T, S]`` bias-gradient kernel at B 8, T = S = 1024, 12 heads
   of 64 (full, causal, GQA 12/4, a 256-key window, fp32, fp16), of 16
   and of 256: through
   ``flash_attention`` under autograd (one db2 launch per backward, dq,
   dk, dv unchanged against the run without a bias gradient), then
   against ``_flash_bwd_ref``'s dbias within 1e-4 of max |dbias|;
   ``library_ms`` SDPA's backward with the bias expanded to heads.

The line before the last two is one JSON object describing every kernel
(time, bound, launches on its path: the LN and flash forward kernels' on
the serving run, their backward kernels' on the LM training run, the BN
and cross-entropy kernels' and the conv kernels' on the ResNet-50
run, the qmm kernel's on the O4 serving run, the bias-gradient kernel's
on phase 19's backward passes); then the ``nvidia-smi`` line;
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import importlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
PEAK_OPS = {torch.bfloat16: 989e12,  # dense tensor-core bf16
            torch.float16: 989e12,   # dense tensor-core fp16
            torch.float32: 67e12,    # fp32 outside the tensor cores
            torch.int8: 1979e12}     # dense tensor-core int8

# kernel launches per serving forward (prefill or decode step)
SERVE_PER_FORWARD = {"layer_norm_fwd": 25, "flash_attention_fwd": 12}
# the same at O4: the 72 q/k/v/out/mlp_up/mlp_down projections
O4_SERVE_PER_FORWARD = dict(SERVE_PER_FORWARD, qmm=72)
# kernel launches per LM training step (O2; O4 adds the 72 qmm)
LM_PER_STEP = {"layer_norm_fwd": 25, "layer_norm_bwd": 25,
               "flash_attention_fwd": 12, "flash_attention_bwd_dq": 12,
               "flash_attention_bwd_dkv": 12, "xentropy_fwd": 1,
               "xentropy_bwd": 1}

FAILURES = []


def check(ok: bool, what: str) -> None:
    print(("ok    " if ok else "FAIL  ") + what, flush=True)
    if not ok:
        FAILURES.append(what)


def time_ms(fn, iters: int = 20) -> float:
    """Device milliseconds per call: ``iters`` calls captured in one CUDA
    graph and replayed between two CUDA events, so the host's launch cost
    is left out (inputs stay warm in L2 where they fit its 50 MB, as they
    do when the previous layer has just written them)."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    return _events_ms(graph.replay) / iters


def eager_ms(fn, iters: int = 20) -> float:
    """Milliseconds per call of ``iters`` eager calls back to back: what
    the eager serving path pays, host launch cost included.  Each result
    is dropped before the next call, as a caller's would be, so the
    caching allocator reuses its memory (a list of all the results made
    every large call allocate afresh)."""
    fn()

    def run():
        for _ in range(iters):
            fn()
    return _events_ms(run) / iters


def _events_ms(run) -> float:
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop)


def bound(nbytes: float, ops: float, dtype) -> tuple:
    """(bound_ms, bound_by): the least time for the bytes over the memory
    rate and for the operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


# -- phase 3: LayerNorm ---------------------------------------------------------

def layer_norm_cases(fln, dev):
    rng = np.random.RandomState(0)
    w = torch.from_numpy((1 + 0.1 * rng.randn(768)).astype(np.float32)).to(dev)
    b = torch.from_numpy((0.1 * rng.randn(768)).astype(np.float32)).to(dev)
    cases = []
    for rows in (1024, 8):
        for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-5)):
            x = torch.from_numpy(rng.randn(rows, 768).astype(np.float32)).to(
                dev, dtype)
            got = fln.layer_norm_fwd_kernel(x, w, b, 1e-5)
            want = fln._fwd_ref(x, w, b, 1e-5)
            torch.cuda.synchronize()
            err = max(max_err(g, t) for g, t in zip(got, want))
            name = f"layer_norm [{rows}, 768] {str(dtype)[6:]}"
            check(err <= tol, f"{name}: max_abs_err {err:.3g} <= {tol}")
            isz = x.element_size()
            nbytes = 2 * rows * 768 * isz + 2 * 768 * 4 + 2 * rows * 4
            bms, by = bound(nbytes, 8 * rows * 768, torch.float32)
            case = dict(
                case=name, max_abs_err=err,
                ms=time_ms(lambda: fln.layer_norm_fwd_kernel(x, w, b, 1e-5)),
                eager_ms=eager_ms(
                    lambda: fln.layer_norm_fwd_kernel(x, w, b, 1e-5)),
                plain_ms=time_ms(lambda: fln._fwd_ref(x, w, b, 1e-5)),
                library_ms=time_ms(lambda: F.layer_norm(x, (768,), w.to(dtype),
                                                        b.to(dtype), 1e-5)),
                bound_ms=bms, bound_by=by)
            print(f"      {name}: kernel {case['ms']:.4f} ms (eager "
                  f"{case['eager_ms']:.4f}), plain "
                  f"{case['plain_ms']:.4f} ms, library {case['library_ms']:.4f}"
                  f" ms, bound {bms:.4f} ms ({by})", flush=True)
            cases.append(case)
    cases.append(layer_norm_large_mean(fln, dev))
    return cases


def layer_norm_large_mean(fln, dev):
    """Rows of mean ~100 and spread ~1 built from quarters, so every sum
    of x and x*x is exact in fp32 and JAX's single-pass variance E[x^2] -
    mean^2 parts from the two-pass one only by the rounding of mean^2: the
    kernel must follow the plain version (within two fp32 ulps of invvar)
    ten times closer than the two-pass formula does."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy((100.0 + rng.randint(-8, 9, (1024, 64)) / 4.0)
                         .astype(np.float32)).to(dev)
    got = fln.layer_norm_fwd_kernel(x, None, None, 1e-5)
    want = fln._fwd_ref(x, None, None, 1e-5)
    xc = x - x.mean(1, keepdim=True)
    two_pass = torch.rsqrt((xc * xc).mean(1) + 1e-5)
    torch.cuda.synchronize()
    kern_err, two_err = max_err(got[2], want[2]), max_err(two_pass, want[2])
    err = max(max_err(g, t) for g, t in zip(got, want))
    name = "layer_norm [1024, 64] mean 100 fp32"
    check(kern_err <= 2 * 2.0 ** -23 * want[2].abs().max().item()
          and two_err > 10 * kern_err and err <= 1e-5,
          f"{name}: invvar err {kern_err:.3g} (two-pass formula "
          f"{two_err:.3g}), max_abs_err {err:.3g} <= 1e-5")
    bms, by = bound(2 * x.numel() * 4 + 2 * 1024 * 4, 8 * x.numel(),
                    torch.float32)
    case = dict(case=name, max_abs_err=err, invvar_err=kern_err,
                two_pass_invvar_err=two_err,
                ms=time_ms(lambda: fln.layer_norm_fwd_kernel(x, None, None,
                                                             1e-5)),
                eager_ms=eager_ms(lambda: fln.layer_norm_fwd_kernel(
                    x, None, None, 1e-5)),
                plain_ms=time_ms(lambda: fln._fwd_ref(x, None, None, 1e-5)),
                library_ms=time_ms(lambda: F.layer_norm(x, (64,), eps=1e-5)),
                bound_ms=bms, bound_by=by)
    print(f"      {name}: kernel {case['ms']:.4f} ms, invvar err "
          f"{kern_err:.3g}, two-pass formula {two_err:.3g}", flush=True)
    return case


# -- phase 4: flash attention --------------------------------------------------

def _visible_pairs(b, tq, tk, causal, q_offset, window, kbias):
    """Query-key pairs the masks of this call leave visible, summed over
    batch (per head): the work these inputs need."""
    if kbias is not None:                 # decode: the live cache keys
        return int((kbias == 0).sum().item()) * tq
    if not causal:
        return b * tq * tk
    n = np.minimum(q_offset + np.arange(tq) + 1, tk)
    if window is not None:
        n = np.minimum(n, window)
    return b * int(n.sum())


def flash_cases(fa, dev):
    rng = np.random.RandomState(1)
    t, h = 1024, 12

    def qkv(b, tq, tk, h_kv, d, dtype):
        return [torch.from_numpy(rng.randn(b, n, hh, d).astype(np.float32))
                .to(dev, dtype) for n, hh in ((tq, h), (tk, h_kv), (tk, h_kv))]

    key = torch.arange(t, device=dev)
    # the engine's prefill bias: causal visibility of a 1024 bucket
    prefill_bias = torch.where(key[None, None, :] <= key[None, :, None],
                               0.0, -1e9)
    lengths = torch.from_numpy(rng.randint(32, t, 8)).to(dev)
    decode_kb = torch.where(key[None, :] <= lengths[:, None], 0.0, -1e9)
    band = ((key[:, None] >= key[None, :])
            & (key[:, None] - key[None, :] < 256))
    bf16, fp16 = torch.bfloat16, torch.float16
    specs = [
        # name, b, tq, tk, h_kv, head_dim, dtype, causal, window, kbias,
        # bias, sdpa kwargs
        ("prefill bias [1,1024,1024]", 1, t, t, h, 64, bf16, False, None,
         None, prefill_bias, dict(attn_mask=prefill_bias[:, None])),
        ("causal 1024", 1, t, t, h, 64, bf16, True, None, None, None,
         dict(is_causal=True)),
        ("decode b8 tq1 tk1024", 8, 1, t, h, 64, bf16, True, None,
         decode_kb, None, dict(attn_mask=decode_kb[:, None, None, :])),
        ("gqa 12/4 causal 1024", 1, t, t, 4, 64, bf16, True, None, None,
         None, dict(is_causal=True)),
        ("window 256 causal 1024", 1, t, t, h, 64, bf16, True, 256, None,
         None, dict(attn_mask=band)),
        ("fp32 causal 1024", 1, t, t, h, 64, torch.float32, True, None, None,
         None, dict(is_causal=True)),
        # the LM's training call, 12 a forward
        ("lm causal b8 t1023", 8, 1023, 1023, h, 64, bf16, True, None, None,
         None, dict(is_causal=True)),
        ("fp16 causal 1024", 1, t, t, h, 64, fp16, True, None, None, None,
         dict(is_causal=True)),
        ("fp16 decode b8 tq1 tk1024", 8, 1, t, h, 64, fp16, True, None,
         decode_kb, None, dict(attn_mask=decode_kb[:, None, None, :])),
        ("head_dim 16 causal 1024", 1, t, t, h, 16, bf16, True, None, None,
         None, dict(is_causal=True)),
        ("head_dim 48 causal 1024", 1, t, t, h, 48, bf16, True, None, None,
         None, dict(is_causal=True)),
        ("head_dim 256 causal 1024", 1, t, t, h, 256, bf16, True, None, None,
         None, dict(is_causal=True)),
    ]
    cases = []
    for (name, b, tq, tk, h_kv, d, dtype, causal, window, kb, bias,
         sdpa) in specs:
        q, k, v = qkv(b, tq, tk, h_kv, d, dtype)
        kw = dict(sm_scale=d ** -0.5, causal=causal, q_offset=tk - tq,
                  window=window)
        out, lse = fa.flash_fwd_kernel(q, k, v, kb, bias, **kw)
        want_out, want_lse = fa._flash_fwd_ref(q, k, v, kb, bias, **kw)
        torch.cuda.synchronize()
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        err = max_err(out, want_out)
        lse_err = max_err(lse, want_lse)
        check(err <= tol and lse_err <= 1e-3,
              f"flash {name}: max_abs_err {err:.3g} <= {tol}, lse "
              f"{lse_err:.3g} <= 1e-3")
        isz = q.element_size()
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * isz \
            + lse.numel() * 4
        if bias is not None:
            nbytes += bias.numel() * 4
        if kb is not None:
            nbytes += kb.numel() * 4
        pairs = _visible_pairs(b, tq, tk, causal, tk - tq, window, kb)
        ops = 4.0 * h * d * pairs
        bms, by = bound(nbytes, ops, dtype)
        # the library call gets KV heads repeated up front (untimed)
        qt, kt, vt = (x.repeat_interleave(h // x.shape[2], dim=2)
                      .transpose(1, 2) for x in (q, k, v))
        lib = {**sdpa}
        if "attn_mask" in lib and lib["attn_mask"].dtype != torch.bool:
            lib["attn_mask"] = lib["attn_mask"].to(dtype)
        case = dict(
            case=name, max_abs_err=err, lse_max_abs_err=lse_err,
            ms=time_ms(lambda: fa.flash_fwd_kernel(q, k, v, kb, bias, **kw)),
            eager_ms=eager_ms(
                lambda: fa.flash_fwd_kernel(q, k, v, kb, bias, **kw)),
            plain_ms=time_ms(lambda: fa._flash_fwd_ref(q, k, v, kb, bias,
                                                       **kw)),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, scale=d ** -0.5, **lib)),
            bound_ms=bms, bound_by=by)
        print(f"      flash {name}: kernel {case['ms']:.4f} ms (eager "
              f"{case['eager_ms']:.4f}), plain "
              f"{case['plain_ms']:.4f} ms, library {case['library_ms']:.4f} "
              f"ms, bound {bms:.4f} ms ({by})", flush=True)
        cases.append(case)
    return cases


# -- phase 7: LayerNorm backward --------------------------------------------------

def layer_norm_bwd_cases(fln, dev):
    """The input-gradient kernel against its plain version at the
    training step's rows (8 x 1023) and at 8 rows."""
    rng = np.random.RandomState(7)
    w = torch.from_numpy((1 + 0.1 * rng.randn(768)).astype(np.float32)).to(dev)
    cases = []
    for rows, dtypes in ((8184, (torch.bfloat16, torch.float32)),
                         (8, (torch.bfloat16, torch.float32))):
        for dtype in dtypes:
            tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
            x, g = (torch.from_numpy(rng.randn(rows, 768).astype(np.float32))
                    .to(dev, dtype) for _ in range(2))
            _, mean, invvar = fln.layer_norm_fwd_kernel(x, w, None, 1e-5)
            got = fln.layer_norm_bwd_kernel(g, x, mean, invvar, w)
            want = fln._bwd_input_ref(g, x, mean, invvar, w)
            torch.cuda.synchronize()
            err = max_err(got, want)
            name = f"layer_norm_bwd [{rows}, 768] {str(dtype)[6:]}"
            check(err <= tol, f"{name}: max_abs_err {err:.3g} <= {tol}")
            isz = x.element_size()
            nbytes = 3 * rows * 768 * isz + 2 * rows * 4 + 768 * 4
            bms, by = bound(nbytes, 10 * rows * 768, torch.float32)
            wd = w.to(dtype)
            m2, r2 = mean[:, None], invvar[:, None]
            case = dict(
                case=name, max_abs_err=err,
                ms=time_ms(lambda: fln.layer_norm_bwd_kernel(
                    g, x, mean, invvar, w)),
                eager_ms=eager_ms(lambda: fln.layer_norm_bwd_kernel(
                    g, x, mean, invvar, w)),
                plain_ms=time_ms(lambda: fln._bwd_input_ref(
                    g, x, mean, invvar, w)),
                library_ms=time_ms(
                    lambda: torch.ops.aten.native_layer_norm_backward(
                        g, x, [768], m2, r2, wd, None,
                        [True, False, False])),
                bound_ms=bms, bound_by=by)
            print(f"      {name}: kernel {case['ms']:.4f} ms (eager "
                  f"{case['eager_ms']:.4f}), plain {case['plain_ms']:.4f} "
                  f"ms, library {case['library_ms']:.4f} ms, bound "
                  f"{bms:.4f} ms ({by})", flush=True)
            cases.append(case)
    return cases


# -- phase 8: flash backward ------------------------------------------------------

def flash_bwd_cases(fa, dev):
    """dQ and dK/dV against their plain version at gpt2_small training
    shapes (B 8, T 1023, 12 heads of 64).  ``plain_ms`` and
    ``library_ms`` are each one call computing dq, dk and dv together
    (``_flash_bwd_ref``; the backward of one SDPA call), so both kernels
    carry the same two numbers."""
    rng = np.random.RandomState(8)
    b, t, h = 8, 1023, 12
    bf16 = torch.bfloat16
    specs = [
        # name, h_kv, dtype, causal, window, kbias needs grad, head_dim,
        # [B, T, S] bias, (q_len, kv_len)
        ("causal b8 t1023", h, bf16, True, None, False, 64, False, (t, t)),
        ("gqa 12/4", 4, bf16, True, None, False, 64, False, (t, t)),
        ("window 256", h, bf16, True, 256, False, 64, False, (t, t)),
        ("fp32 causal", h, torch.float32, True, None, False, 64, False,
         (t, t)),
        ("key bias grad, full", h, bf16, False, None, True, 64, False,
         (t, t)),
        ("fp16 causal", h, torch.float16, True, None, False, 64, False,
         (t, t)),
        ("head_dim 16 causal", h, bf16, True, None, False, 16, False, (t, t)),
        ("head_dim 48 causal", h, bf16, True, None, False, 48, False, (t, t)),
        ("head_dim 128 causal", h, bf16, True, None, False, 128, False,
         (t, t)),
        ("head_dim 256 causal", h, bf16, True, None, False, 256, False,
         (t, t)),
        ("[B,T,S] bias, full", h, bf16, False, None, False, 64, True, (t, t)),
        # queries the suffix of the keys, neither length a tile multiple
        ("cross causal tq 333 tk 1021", h, bf16, True, None, False, 64,
         False, (333, 1021)),
    ]
    dq_cases, dkv_cases = [], []
    for (name, h_kv, dtype, causal, window, kgrad, d, with_bias,
         (tq, tk)) in specs:
        q, do = (torch.from_numpy(rng.randn(b, tq, h, d).astype(np.float32))
                 .to(dev, dtype) for _ in range(2))
        k, v = (torch.from_numpy(rng.randn(b, tk, h_kv, d).astype(np.float32))
                .to(dev, dtype) for _ in range(2))
        kb = bias = None
        if kgrad:
            kb = torch.from_numpy(
                (0.5 * rng.randn(b, tk)).astype(np.float32)).to(dev)
        if with_bias:
            bias = torch.from_numpy(
                (0.5 * rng.randn(b, tq, tk)).astype(np.float32)).to(dev)
        q_offset = tk - tq if causal else 0
        kw = dict(sm_scale=d ** -0.5, causal=causal, q_offset=q_offset,
                  window=window)
        out, lse = fa.flash_fwd_kernel(q, k, v, kb, bias, **kw)
        delta = fa._delta(do, out)

        def run_dq():
            return fa.flash_bwd_dq_kernel(q, k, v, do, lse, delta, kb, bias,
                                          **kw)

        def run_dkv():
            return fa.flash_bwd_dkv_kernel(q, k, v, do, lse, delta, kb, bias,
                                           kbias_grad=kgrad, **kw)

        def run_plain():
            return fa._flash_bwd_ref(q, k, v, kb, bias, out, lse, do, **kw)

        dq = run_dq()
        dk, dv, part = run_dkv()
        want = run_plain()
        torch.cuda.synchronize()
        tol = 1e-4 if dtype == torch.float32 else 3e-2
        errs = dict(dq=max_err(dq, want[0]), dk=max_err(dk, want[1]),
                    dv=max_err(dv, want[2]))
        if kgrad:
            errs["dkbias"] = max_err(part.sum(1) / kw["sm_scale"], want[3])
        check(all(e <= tol for e in errs.values()),
              f"flash bwd {name}: max_abs_err "
              + ", ".join(f"{k_} {e:.3g}" for k_, e in errs.items())
              + f" <= {tol} (max |dq| {dq.float().abs().max().item():.3g},"
              f" |dk| {dk.float().abs().max().item():.3g})")
        del want
        isz = q.element_size()
        pairs = _visible_pairs(b, tq, tk, causal, q_offset, window, None) * h
        rows_bytes = 2 * b * h * tq * 4                     # lse, delta
        dq_bytes = (3 * q.numel() + k.numel() + v.numel()) * isz + rows_bytes
        dkv_bytes = (2 * q.numel() + 2 * k.numel() + 2 * v.numel()) * isz \
            + rows_bytes + (b * h * tk * 4 if kgrad else 0)
        for extra in (kb, bias):
            if extra is not None:
                dq_bytes += extra.numel() * 4
                dkv_bytes += extra.numel() * 4
        plain_ms = time_ms(run_plain, iters=3)
        # the library yardstick: SDPA's backward on a retained graph,
        # KV heads repeated up front (untimed)
        qt, kt, vt = (x.repeat_interleave(h // x.shape[2], dim=2)
                      .transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        lib = dict(is_causal=True) if causal and window is None else {}
        if window is not None or (causal and tq != tk):
            lib = dict(attn_mask=fa._visible(tq, tk, q_offset, window, dev))
        if kb is not None:
            lib = dict(attn_mask=kb[:, None, None, :].to(dtype))
        if bias is not None:
            lib = dict(attn_mask=bias[:, None].to(dtype))
        lout = F.scaled_dot_product_attention(qt, kt, vt, scale=d ** -0.5,
                                              **lib)
        dot = do.transpose(1, 2)
        # (autograd's backward cannot be captured in a CUDA graph: timed
        # eagerly; its host cost is small beside milliseconds of work)
        library_ms = eager_ms(lambda: torch.autograd.grad(
            lout, (qt, kt, vt), dot, retain_graph=True), iters=5)
        for cases, fn, n_mm, nbytes, keys in (
                (dq_cases, run_dq, 3, dq_bytes, ("dq",)),
                (dkv_cases, run_dkv, 4, dkv_bytes,
                 ("dk", "dv", "dkbias"))):
            bms, by = bound(nbytes, 2.0 * n_mm * d * pairs, dtype)
            case = dict(case=name, max_abs_err=max(
                            e for k_, e in errs.items() if k_ in keys),
                        ms=time_ms(fn, iters=5),
                        eager_ms=eager_ms(fn, iters=5),
                        plain_ms=plain_ms, library_ms=library_ms,
                        bound_ms=bms, bound_by=by)
            cases.append(case)
            print(f"      flash bwd {fn.__name__[4:]} {name}: kernel "
                  f"{case['ms']:.4f} ms (eager {case['eager_ms']:.4f}), "
                  f"plain (dq+dk+dv) {plain_ms:.4f} ms, library (dq+dk+dv) "
                  f"{library_ms:.4f} ms, bound {bms:.4f} ms ({by})",
                  flush=True)
        del lout, qt, kt, vt
    return dq_cases, dkv_cases


# -- phase 5: serving ------------------------------------------------------------

def _pct(values, q):
    values = sorted(values)
    return values[min(len(values) - 1, int(q * (len(values) - 1)))] * 1e3


def serve_gpt2_small(model, engine_mod, counters, dev, per_forward,
                     cache_dtype=None):
    """The phase-5 load (16 requests of 32-900 prompt tokens, 32 new
    tokens, buckets (256, 1024), page 16, 8 slots) through
    ``ServingEngine``: every launch counter set to 0 just before and read
    just after, each equal to ``per_forward`` x the forwards run (0 where
    it is not named)."""
    rng = np.random.RandomState(2)
    eng = engine_mod.ServingEngine(model, buckets=(256, 1024), page_size=16,
                                   max_seqs=8, cache_dtype=cache_dtype,
                                   device=dev)
    t0 = time.perf_counter()
    eng.warmup()
    warm_s = time.perf_counter() - t0
    prompts = [rng.randint(1, model.vocab_size, (int(n),))
               for n in rng.randint(32, 901, 16)]
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    results = eng.generate(prompts, max_new_tokens=32)
    wall = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    st = eng.stats
    tag = eng.kv_cache_dtype
    eng.close()
    forwards = st["prefills"] + st["decode_steps"]
    check(all(r.ok and len(r.tokens) == 32 for r in results),
          f"gpt2_small ({tag} KV): {sum(r.ok for r in results)}/16 "
          f"requests served")
    check(all(launches[n] == per_forward.get(n, 0) * forwards
              for n in launches),
          f"gpt2_small ({tag} KV): launches {launches} = {per_forward} x "
          f"{forwards} forwards (no other kernel)")
    ok = [r for r in results if r.ok]
    res = dict(
        kv_cache_dtype=tag, kv_bytes_per_token=st["kv_bytes_per_token"],
        warmup_s=warm_s, wall_s=wall, tokens_out=st["tokens_out"],
        tokens_per_s=st["tokens_out"] / wall, prefills=st["prefills"],
        decode_steps=st["decode_steps"],
        prefill_ms_mean=st["prefill_s"] / max(1, st["prefills"]) * 1e3,
        decode_step_ms_mean=st["decode_s"] / max(1, st["decode_steps"]) * 1e3,
        ttft_p50_ms=_pct([r.timings["ttft_s"] for r in ok], 0.5),
        ttft_p99_ms=_pct([r.timings["ttft_s"] for r in ok], 0.99),
        tpot_p50_ms=_pct([r.timings["tpot_s"] for r in ok], 0.5),
        tpot_p99_ms=_pct([r.timings["tpot_s"] for r in ok], 0.99),
        max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
        buckets=sorted({r.bucket for r in ok}),
        launches={n: v for n, v in launches.items() if v})
    print(f"      served 16 requests ({tag} KV, {res['kv_bytes_per_token']} "
          f"B/token), {res['tokens_out']} tokens in "
          f"{wall:.3f} s ({res['tokens_per_s']:.1f} tok/s); ttft p50 "
          f"{res['ttft_p50_ms']:.2f} / p99 {res['ttft_p99_ms']:.2f} ms; tpot "
          f"p50 {res['tpot_p50_ms']:.2f} / p99 {res['tpot_p99_ms']:.2f} ms; "
          f"prefill {res['prefill_ms_mean']:.2f} ms, decode step "
          f"{res['decode_step_ms_mean']:.2f} ms (means); peak memory "
          f"{res['max_memory_allocated_bytes'] / 2**30:.2f} GiB; warmup "
          f"{warm_s:.1f} s", flush=True)
    return res


_KERNEL_KINDS = (("qmm", ("qmm_kernel",)),
                 ("flash", ("flash_fwd_",)), ("layer_norm", ("ln_fwd",)),
                 ("gemm", ("gemm", "nvjet", "xmma", "cutlass")),
                 ("index", ("index", "gather", "scatter")))


def _kind(name: str) -> str:
    low = name.lower()
    for kind, keys in _KERNEL_KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def where_time_goes(model, engine_mod, dev, cache_dtype=None):
    """One traced serving run (8 prompts of 600-900 tokens, 16 new tokens
    each: prefills and decode steps at the 1024 bucket) under
    ``torch.profiler``: device busy share of the wall time, and per step
    kind (the engine's ``prefill[b]`` / ``decode[b]`` ranges) the host
    time, the device time and the device time by kernel kind.  Each step
    ends in a host sync, so a kernel belongs to the last range that began
    before it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.RandomState(5)
    eng = engine_mod.ServingEngine(model, buckets=(256, 1024), page_size=16,
                                   max_seqs=8, cache_dtype=cache_dtype,
                                   device=dev).warmup()
    prompts = [rng.randint(1, model.vocab_size, (int(n),))
               for n in rng.randint(600, 901, 8)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.generate(prompts, max_new_tokens=16)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    eng.close()
    events = prof.events()
    is_range = lambda n: n.startswith(("prefill[", "decode["))  # noqa: E731
    ranges = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in events
                    if e.device_type == DeviceType.CPU and is_range(e.name))
    kernels = sorted((e.time_range.start, e.time_range.end, e.name)
                     for e in events
                     if e.device_type == DeviceType.CUDA
                     and not is_range(e.name))
    starts = [r[0] for r in ranges]
    steps = {}
    for lo, hi, name in ranges:
        st = steps.setdefault(name, {"count": 0, "host_us": 0.0,
                                     "device_us": 0.0, "kinds_us": {}})
        st["count"] += 1
        st["host_us"] += hi - lo
    busy, edge = 0.0, None
    for lo, hi, name in kernels:
        lo2 = lo if edge is None else max(lo, edge)
        busy += max(0.0, hi - lo2)
        edge = hi if edge is None else max(edge, hi)
        i = int(np.searchsorted(starts, lo, side="right")) - 1
        if i < 0:
            continue
        st = steps[ranges[i][2]]
        st["device_us"] += hi - lo
        st["kinds_us"][_kind(name)] = (st["kinds_us"].get(_kind(name), 0.0)
                                       + hi - lo)
    res = dict(profile_wall_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
               device_idle_share=1 - busy / wall_us if wall_us else None,
               kernels_traced=len(kernels), steps={})
    for name, st in sorted(steps.items()):
        n = st["count"]
        res["steps"][name] = dict(
            count=n, host_ms=st["host_us"] / n / 1e3,
            device_ms=st["device_us"] / n / 1e3,
            device_ms_by_kind={k: v / n / 1e3
                               for k, v in sorted(st["kinds_us"].items())})
        kinds = ", ".join(f"{k} {v / n / 1e3:.3f}"
                          for k, v in sorted(st["kinds_us"].items()))
        print(f"      {name} x{n}: host {st['host_us'] / n / 1e3:.2f} ms, "
              f"device {st['device_us'] / n / 1e3:.3f} ms per step "
              f"({kinds})", flush=True)
    print(f"      traced run: wall {wall_us / 1e3:.1f} ms, device busy "
          f"{busy / 1e3:.1f} ms, idle share {res['device_idle_share']:.3f}, "
          f"{len(kernels)} kernels", flush=True)
    check(len(kernels) > 0, "profiler traced device kernels")
    return res


def prefill_logits(models, dev):
    """A 256-token prefill through the engine's incremental forward, on
    the card (bf16 and fp32 weights) and on the CPU (fp32), same seed."""
    ids = np.random.RandomState(3).randint(1, 50257, (1, 256))

    def run(dtype, device):
        m = models.gpt2_small(dtype=dtype, device=device, seed=0)
        with torch.inference_mode():
            caches = models.init_cache(m, 1, cache_len=256)
            logits, _ = m(torch.from_numpy(ids).to(device), kv_caches=caches,
                          positions=torch.zeros((1,), dtype=torch.long,
                                                device=device))
        return logits.float().cpu()

    want = run(torch.float32, "cpu")
    res = {}
    for dtype, tol in ((torch.float32, 2e-3), (torch.bfloat16, 0.25)):
        err = max_err(run(dtype, dev), want)
        name = str(dtype)[6:]
        check(err <= tol, f"gpt2_small 256-token prefill logits, card "
              f"{name} vs CPU fp32: max_abs_err {err:.3g} <= {tol}")
        res[f"logits_{name}_vs_cpu_fp32_max_abs_err"] = err
    return res


def tiny_tokens(models, engine_mod, dev):
    """gpt_tiny served in fp32 on the card and on the CPU: equal greedy
    tokens, except after a step whose CPU top-2 logit gap is < 1e-4."""
    rng = np.random.RandomState(4)
    prompts = [rng.randint(1, 1024, (int(n),))
               for n in rng.randint(4, 200, 12)]
    toks = {}
    for device in (dev, "cpu"):
        m = models.gpt_tiny(dtype=torch.float32, device=device, seed=1)
        eng = engine_mod.ServingEngine(m, buckets=(128, 256), page_size=16,
                                       max_seqs=4, device=device)
        toks[str(device)] = [r.tokens for r in eng.generate(prompts, 24)]
        eng.close()
    cpu_model = models.gpt_tiny(dtype=torch.float32, device="cpu", seed=1)
    mismatched, ties = 0, []
    for p, a, b in zip(prompts, toks[str(dev)], toks["cpu"]):
        if np.array_equal(a, b):
            continue
        mismatched += 1
        j = int(np.argmax(a != b))       # first divergent step
        with torch.inference_mode():
            ids = torch.from_numpy(np.concatenate([p, b[:j]]))[None]
            top2 = cpu_model(ids)[0, -1].topk(2).values
        ties.append(float(top2[0] - top2[1]))
    gap_ok = all(g < 1e-4 for g in ties)
    check(gap_ok, f"gpt_tiny fp32 tokens card vs CPU: {12 - mismatched}/12 "
          f"identical; top-2 gaps at divergence {ties}")
    return dict(tiny_identical=12 - mismatched, tiny_divergence_gaps=ties)


# -- phase 9: training ------------------------------------------------------------

TRAIN_ARGS = ["--synthetic", "-b", "8", "--seq-len", "1024", "--vocab",
              "50257", "--hidden", "768", "--layers", "12", "--heads", "12",
              "--opt-level", "O2", "--lr", "3e-4", "--weight-decay", "0.1"]

_TRAIN_KINDS = (("qmm", ("qmm_kernel",)),
                ("flash_fwd", ("flash_fwd_",)),
                ("flash_bwd", ("flash_bwd_",)),
                ("layer_norm", ("ln_fwd", "ln_bwd")),
                ("loss", ("xent_",)),
                ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "cublas")),
                ("optimizer", ("foreach", "multi_tensor")))


def train_gpt2_small(main_amp, counters, steps=10):
    """The LM trainer's entry point at GPT-2 small, bf16 O2, Adam: every
    launch counter set to 0 just before and read just after."""
    args = main_amp.parse(TRAIN_ARGS + ["--steps", str(steps)])
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    res = main_amp.train(args, log=lambda line: print("      " + line,
                                                      flush=True))
    launches = {name: c.launches for name, c in counters.items()}
    per_step = LM_PER_STEP
    check(all(launches[n] == per_step.get(n, 0) * steps for n in launches),
          f"gpt2_small training: launches {launches} = "
          f"{per_step} x {steps} steps")
    losses = res["losses"]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"gpt2_small training: losses finite, step {steps} "
          f"{losses[-1]:.4f} < step 1 {losses[0]:.4f}")
    step_ms = float(np.median(res["step_s"][2:])) * 1e3
    out = dict(losses=losses, step_ms_all=[x * 1e3 for x in res["step_s"]],
               step_ms_median_3_10=step_ms,
               tokens_per_s=res["tokens_per_step"] / step_ms * 1e3,
               max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
               launches=launches)
    print(f"      gpt2_small O2 B8 T1023: step {step_ms:.2f} ms (median of "
          f"steps 3-{steps}), {out['tokens_per_s']:.0f} tok/s, peak memory "
          f"{out['max_memory_allocated_bytes'] / 2**30:.2f} GiB", flush=True)
    return out


def trace_training(trainer, argv, kinds=_TRAIN_KINDS):
    """Two training steps of ``trainer`` (an example module with
    ``parse`` and ``build``) under ``torch.profiler``: device time by
    kind and the device's idle share of the wall time."""
    return trace_steps(*trainer.build(trainer.parse(argv)), kinds)


def trace_steps(state, step_fn, batch, kinds=_TRAIN_KINDS):
    """One warm step, then two steps of ``step_fn`` under
    ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    state, m = step_fn(state, batch)          # warm: compiles, allocates
    m["loss"].item()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            state, m = step_fn(state, batch)
            m["loss"].item()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = sorted((e.time_range.start, e.time_range.end, e.name)
                     for e in prof.events()
                     if e.device_type == DeviceType.CUDA)
    busy, edge, by_kind, by_name = 0.0, None, {}, {}
    for lo, hi, name in kernels:
        lo2 = lo if edge is None else max(lo, edge)
        busy += max(0.0, hi - lo2)
        edge = hi if edge is None else max(edge, hi)
        low = name.lower()
        kind = next((k for k, keys in kinds
                     if any(key in low for key in keys)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + (hi - lo)
        by_name[name] = by_name.get(name, 0.0) + (hi - lo)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    res = dict(wall_ms_per_step=wall_us / 2e3,
               device_busy_ms_per_step=busy / 2e3,
               device_idle_share=1 - busy / wall_us,
               device_ms_per_step_by_kind={k: v / 2e3 for k, v in
                                           sorted(by_kind.items())},
               top_kernels_ms_per_step=[(n[:100], v / 2e3) for n, v in top],
               kernels_per_step=len(kernels) / 2)
    print(f"      traced training step: wall {res['wall_ms_per_step']:.2f} "
          f"ms, device busy {res['device_busy_ms_per_step']:.2f} ms, idle "
          f"share {res['device_idle_share']:.3f}, "
          f"{res['kernels_per_step']:.0f} kernels; by kind (ms) "
          + ", ".join(f"{k} {v:.2f}" for k, v in
                      res["device_ms_per_step_by_kind"].items()),
          flush=True)
    for n, v in res["top_kernels_ms_per_step"]:
        print(f"        {v:8.3f} ms  {n}", flush=True)
    check(len(kernels) > 0, "profiler traced the training step's kernels")
    return res


# -- phase 10: training correctness ------------------------------------------------

def _lm_step(main_amp, training, model, opt_level, loss_scale=None,
             inject=False):
    def loss_fn(p, batch):
        loss = main_amp.lm_loss(torch.func.functional_call(
            model, p, (batch[0],)), batch[1], fused=True)
        return loss * batch[2] if inject else loss
    return training.make_train_step(loss_fn, training.adam(1e-3,
                                                           weight_decay=0.1),
                                    opt_level=opt_level,
                                    loss_scale=loss_scale)


def _zero_grad_leaf(name):
    # the key projection's bias: its gradient is zero in exact arithmetic
    # (a shift of a whole score row, which the softmax cancels)
    return name.endswith("attention.key.bias")


def training_correctness(models, main_amp, training, dev):
    res = {}
    # (a) gpt_tiny O0 fp32, three steps on the card and on the CPU
    states, losses = {}, {}
    for device in (dev, "cpu"):
        m = models.gpt_tiny(dtype=torch.float32, device="cpu", seed=1).to(
            device)
        init, step = _lm_step(main_amp, training, m, "O0")
        st = init(m.state_dict())
        x, y = main_amp.synthetic_batch(4, 129, 1024, device)
        losses[str(device)] = []
        for _ in range(3):
            st, met = step(st, (x, y))
            losses[str(device)].append(met["loss"].item())
        states[str(device)] = st.params
    lerr = max(abs(a - b) / abs(b) for a, b in
               zip(losses[str(dev)], losses["cpu"]))
    perr = max(max_err(states[str(dev)][k].cpu(), v)
               for k, v in states["cpu"].items() if not _zero_grad_leaf(k))
    check(lerr <= 1e-4 and perr <= 1e-4,
          f"gpt_tiny O0 3 steps card vs CPU: loss rel err {lerr:.3g} <= "
          f"1e-4, params max_abs_err {perr:.3g} <= 1e-4")
    res.update(tiny_o0_losses_card=losses[str(dev)],
               tiny_o0_losses_cpu=losses["cpu"], tiny_o0_loss_rel_err=lerr,
               tiny_o0_param_max_abs_err=perr)

    # (b) gpt2_small fp32, one forward and backward at B 1, T 256
    ids = torch.from_numpy(np.random.RandomState(9).randint(
        1, 50257, (1, 257)))
    grads = {}
    for device in (dev, "cpu"):
        m = models.gpt2_small(dtype=torch.float32, device="cpu",
                              seed=0).to(device)
        params = {k: v.detach().requires_grad_(True)
                  for k, v in m.state_dict().items()}
        b = ids.to(device)
        loss = main_amp.lm_loss(torch.func.functional_call(
            m, params, (b[:, :-1],)), b[:, 1:])
        grads[str(device)] = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
    rel = {k: max_err(grads[str(dev)][k].cpu(), g)
           / max(g.abs().max().item(), 1e-30)
           for k, g in grads["cpu"].items() if not _zero_grad_leaf(k)}
    worst = max(rel, key=rel.get)
    check(rel[worst] <= 1e-3,
          f"gpt2_small fp32 grads card vs CPU: max relative error "
          f"{rel[worst]:.3g} ({worst}) <= 1e-3")
    res.update(small_grad_max_rel_err=rel[worst], small_grad_worst=worst)

    # (c) gpt_tiny O2, dynamic scale, an inf injected into the loss
    m = models.gpt_tiny(dtype=torch.bfloat16, device=dev, seed=2)
    init, step = _lm_step(main_amp, training, m, "O2", "dynamic",
                          inject=True)
    st = init(m.state_dict())
    x, y = main_amp.synthetic_batch(4, 129, 1024, dev)
    before = {k: v.clone() for k, v in st.params.items()}
    st, met = step(st, (x, y, torch.tensor(float("inf"), device=dev)))
    skipped = (bool(met["overflow"]) and int(st.opt_state.step) == 0
               and all(torch.equal(st.params[k], v)
                       for k, v in before.items()))
    scale1 = met["loss_scale"].item()
    st, met = step(st, (x, y, torch.tensor(1.0, device=dev)))
    applied = (not bool(met["overflow"]) and int(st.opt_state.step) == 1
               and not torch.equal(st.params["wte"], before["wte"]))
    check(skipped and scale1 == 2.0 ** 15 and applied,
          f"gpt_tiny O2 dynamic: inf step skipped {skipped}, scale "
          f"{scale1:.0f} == 32768, next step applied {applied}")
    res.update(o2_dynamic_skip_ok=skipped and applied, o2_scale=scale1)
    return res


# -- phase 11: BN epilogue ---------------------------------------------------------

def _bf16_ordered(t):
    """bf16 bit patterns as integers ordered like the values."""
    i = t.contiguous().view(torch.int16).int()
    return torch.where(i < 0, -(i & 0x7FFF), i)


def bf16_ulps(a, b) -> int:
    """Largest distance between two bf16 tensors in units in the last
    place."""
    return int((_bf16_ordered(a) - _bf16_ordered(b)).abs().max().item())


def _kernel_err(got, want):
    """(max_abs_err, max bf16 ulps or None, within tolerance): bf16 within
    one ulp, fp32 within 1e-6."""
    err = max_err(got, want)
    if got.dtype == torch.bfloat16:
        ulps = bf16_ulps(got, want)
        return err, ulps, ulps <= 1
    return err, None, err <= 1e-6


BN_CASES = [
    # name, rows, channels, dtype, relu, residual z
    ("[1605632, 64] bf16 relu", 1605632, 64, torch.bfloat16, True, False),
    ("[401408, 256] bf16 relu +z", 401408, 256, torch.bfloat16, True, True),
    ("[6272, 2048] bf16 no relu", 6272, 2048, torch.bfloat16, False, False),
    ("[401408, 256] fp32 relu +z", 401408, 256, torch.float32, True, True),
]


def bn_epilogue_cases(fba, dev):
    """Kernels 4 (forward) and 5 (dx/dz) against their plain versions at
    ResNet-50 B 128 shapes (bn_init, a stage-1 bn3, a stage-4
    downsample_bn, and an fp32 case).  ``library_ms`` is one
    ``F.batch_norm(training=False)`` call (forward) and the backward of
    one (dx), where it computes the same function: no z, no ReLU."""
    gen = torch.Generator(device=dev).manual_seed(11)
    fwd_cases, bwd_cases = [], []
    for name, rows, c, dtype, relu, has_z in BN_CASES:
        def rnd(*shape):
            return torch.randn(*shape, device=dev, generator=gen)
        x, g = rnd(rows, c).to(dtype), rnd(rows, c).to(dtype)
        z = rnd(rows, c).to(dtype) if has_z else None
        mean, w, b = 0.3 * rnd(c), 1 + 0.2 * rnd(c), 0.2 * rnd(c)
        invstd = rnd(c).abs() + 0.5

        def run_fwd():
            return fba.bn_act_fwd_kernel(x, mean, invstd, w, b, z, relu)

        def run_bwd():
            return fba.bn_act_bwd_kernel(g, x, mean, invstd, w, b, z, relu)
        out, (dx, dz) = run_fwd(), run_bwd()
        want_dx, want_dz = fba._bwd_act_ref(g, x, mean, invstd, w, b, z,
                                            relu)
        torch.cuda.synchronize()
        f_err, f_ulps, f_ok = _kernel_err(
            out, fba._fwd_ref(x, mean, invstd, w, b, z, relu))
        b_err, b_ulps, b_ok = _kernel_err(dx, want_dx)
        if has_z:
            z_err, z_ulps, z_ok = _kernel_err(dz, want_dz)
            b_err, b_ok = max(b_err, z_err), b_ok and z_ok
            b_ulps = None if b_ulps is None else max(b_ulps, z_ulps)
        check(f_ok and b_ok and (dz is None) == (z is None),
              f"bn epilogue {name}: fwd max_abs_err {f_err:.3g} (ulps "
              f"{f_ulps}), bwd {b_err:.3g} (ulps {b_ulps}); bf16 <= 1 ulp, "
              f"fp32 <= 1e-6")
        isz, n = x.element_size(), rows * c
        acts_in = 2 if has_z else 1
        # each input read once, each output written once: forward x (z)
        # in, out; backward g in, dx out, x (and z) in only under ReLU,
        # dz out with a z
        fwd_bytes = (acts_in + 1) * n * isz + 4 * c * 4
        bwd_acts = 2 + relu + (relu and has_z) + has_z
        bwd_bytes = bwd_acts * n * isz + 4 * c * 4
        lib_fwd = lib_bwd = None
        if not relu and not has_z:
            var = 1.0 / invstd ** 2 - 1e-5
            lib_fwd = time_ms(lambda: F.batch_norm(x, mean, var, w, b, False,
                                                   0.0, 1e-5))
            xr = x.detach().requires_grad_(True)
            lout = F.batch_norm(xr, mean, var, w, b, False, 0.0, 1e-5)
            lib_bwd = eager_ms(lambda: torch.autograd.grad(
                lout, xr, g, retain_graph=True), iters=10)
            del lout, xr
        for cases, fn, plain, nbytes, ops, err, ulps, lib in (
                (fwd_cases, run_fwd,
                 lambda: fba._fwd_ref(x, mean, invstd, w, b, z, relu),
                 fwd_bytes, 6 * n, f_err, f_ulps, lib_fwd),
                (bwd_cases, run_bwd,
                 lambda: fba._bwd_act_ref(g, x, mean, invstd, w, b, z, relu),
                 bwd_bytes, 8 * n, b_err, b_ulps, lib_bwd)):
            bms, by = bound(nbytes, ops, torch.float32)
            case = dict(case=name, max_abs_err=err, max_bf16_ulps=ulps,
                        ms=time_ms(fn), eager_ms=eager_ms(fn),
                        plain_ms=time_ms(plain, iters=5), library_ms=lib,
                        bound_ms=bms, bound_by=by)
            cases.append(case)
            lib_s = "n/a" if lib is None else f"{lib:.4f} ms"
            print(f"      bn {'fwd' if cases is fwd_cases else 'bwd'} "
                  f"{name}: kernel {case['ms']:.4f} ms (eager "
                  f"{case['eager_ms']:.4f}), plain {case['plain_ms']:.4f} "
                  f"ms, library {lib_s}, bound {bms:.4f} ms ({by})",
                  flush=True)
        del x, g, z, out, dx, dz, want_dx, want_dz
    return fwd_cases, bwd_cases


# -- phase 12: softmax cross-entropy ------------------------------------------------

XENT_CASES = [
    # name, rows, vocabulary, dtype, smoothing, padding_idx
    ("[8184, 50257] fp32 s0", 8184, 50257, torch.float32, 0.0, 0),
    ("[8184, 50257] fp32 s0.1", 8184, 50257, torch.float32, 0.1, 0),
    ("[128, 1000] fp32", 128, 1000, torch.float32, 0.0, -1),
    ("[8184, 50257] bf16 s0.1", 8184, 50257, torch.bfloat16, 0.1, 0),
]


def xentropy_cases(xent, dev):
    """Kernels 6 (losses, mlse) and 7 (dx) against their plain versions
    at the LM step's ``[8184, 50257]`` (every 10th label the padding
    index) and the ResNet step's ``[128, 1000]``.  ``library_ms`` is one
    ``F.cross_entropy(reduction="none")`` call and the backward of one
    (eager), computing the same function."""
    gen = torch.Generator(device=dev).manual_seed(12)
    fwd_cases, bwd_cases = [], []
    for name, n, v, dtype, smoothing, pad in XENT_CASES:
        x = (2 * torch.randn(n, v, device=dev, generator=gen)).to(dtype)
        labels = torch.randint(1, v, (n,), device=dev, generator=gen,
                               dtype=torch.int32)
        if pad >= 0:
            labels[::10] = pad
        g = torch.where(labels == pad, 0.0, 1.0 / n)

        def run_fwd():
            return xent.xentropy_fwd_kernel(x, labels, smoothing)
        loss, mlse = run_fwd()

        def run_bwd():
            return xent.xentropy_bwd_kernel(g, x, mlse, labels, smoothing)
        dx = run_bwd()
        want_loss, want_mlse = xent._fwd_ref(x, labels, smoothing)
        # the backward kernel and its plain version on the same inputs
        # (the kernel's mlse)
        want_dx = xent._bwd_ref(g, x, mlse, labels, smoothing)
        torch.cuda.synchronize()
        f_err = max(max_err(loss, want_loss), max_err(mlse, want_mlse))
        b_err = max_err(dx, want_dx)
        ulps = bf16_ulps(dx, want_dx) if dtype == torch.bfloat16 else None
        b_ok = ulps <= 1 if ulps is not None else b_err <= 1e-5
        check(f_err <= 1e-4 and b_ok,
              f"xentropy {name}: losses/mlse max_abs_err {f_err:.3g} <= "
              f"1e-4, dx {b_err:.3g} (ulps {ulps}); fp32 <= 1e-5, bf16 <= "
              f"1 ulp")
        isz = x.element_size()
        lab64 = labels.long()
        xr = x.detach().requires_grad_(True)
        lout = F.cross_entropy(xr, lab64, reduction="none",
                               label_smoothing=smoothing, ignore_index=pad)
        lib_bwd = eager_ms(lambda: torch.autograd.grad(
            lout, xr, g.to(lout.dtype), retain_graph=True), iters=5)
        del lout, xr
        lib_fwd = time_ms(lambda: F.cross_entropy(
            x, lab64, reduction="none", label_smoothing=smoothing,
            ignore_index=pad), iters=5)
        for cases, fn, plain, nbytes, ops, err, lib in (
                (fwd_cases, run_fwd,
                 lambda: xent._fwd_ref(x, labels, smoothing),
                 n * v * isz + 3 * n * 4, 5 * n * v, f_err, lib_fwd),
                (bwd_cases, run_bwd,
                 lambda: xent._bwd_ref(g, x, mlse, labels, smoothing),
                 2 * n * v * isz + 3 * n * 4, 5 * n * v, b_err, lib_bwd)):
            bms, by = bound(nbytes, ops, torch.float32)
            case = dict(case=name, max_abs_err=err,
                        max_bf16_ulps=ulps if cases is bwd_cases else None,
                        ms=time_ms(fn, iters=10), eager_ms=eager_ms(fn),
                        plain_ms=time_ms(plain, iters=3), library_ms=lib,
                        bound_ms=bms, bound_by=by)
            cases.append(case)
            print(f"      xentropy {'fwd' if cases is fwd_cases else 'bwd'} "
                  f"{name}: kernel {case['ms']:.4f} ms (eager "
                  f"{case['eager_ms']:.4f}), plain {case['plain_ms']:.4f} "
                  f"ms, library {lib:.4f} ms, bound {bms:.4f} ms ({by})",
                  flush=True)
        del x, dx, want_dx
    return fwd_cases, bwd_cases


# -- phase 15: conv kernels ------------------------------------------------------

CONV_CASES = [
    # name, x shape, w shape, stride, flax padding, dtype, epilogue
    ("stem [128,224,224,3] 7x7/2", (128, 224, 224, 3), (7, 7, 3, 64), 2,
     ((3, 3), (3, 3)), torch.bfloat16, False),
    ("[128,56,56,64] 3x3/1", (128, 56, 56, 64), (3, 3, 64, 64), 1, "SAME",
     torch.bfloat16, False),
    ("[128,56,56,128] 3x3/2 pad (0,1)", (128, 56, 56, 128),
     (3, 3, 128, 128), 2, "SAME", torch.bfloat16, False),
    ("[128,14,14,1024] 1x1 ->256", (128, 14, 14, 1024), (1, 1, 1024, 256),
     1, "SAME", torch.bfloat16, False),
    ("[128,14,14,1024] 1x1/2 ->2048", (128, 14, 14, 1024),
     (1, 1, 1024, 2048), 2, "SAME", torch.bfloat16, False),
    ("fp32 [32,56,56,64] 3x3/1", (32, 56, 56, 64), (3, 3, 64, 64), 1,
     "SAME", torch.float32, False),
    ("[128,56,56,64] 1x1 ->256 +bn,z,relu", (128, 56, 56, 64),
     (1, 1, 64, 256), 1, "SAME", torch.bfloat16, True),
    ("fp16 [128,56,56,64] 3x3/1", (128, 56, 56, 64), (3, 3, 64, 64), 1,
     "SAME", torch.float16, False),
    ("fp16 [128,56,56,128] 3x3/2 pad (0,1)", (128, 56, 56, 128),
     (3, 3, 128, 128), 2, "SAME", torch.float16, False),
    ("fp16 [128,56,56,64] 1x1 ->256 +bn,z,relu", (128, 56, 56, 64),
     (1, 1, 64, 256), 1, "SAME", torch.float16, True, ("conv_fwd",)),
    # the other stride-2 dgrad sites of a ResNet-50 step
    ("[128,56,56,256] 1x1/2 ->512", (128, 56, 56, 256), (1, 1, 256, 512),
     2, "SAME", torch.bfloat16, False, ("conv_dgrad",)),
    ("[128,28,28,256] 3x3/2 pad (0,1)", (128, 28, 28, 256),
     (3, 3, 256, 256), 2, "SAME", torch.bfloat16, False, ("conv_dgrad",)),
    ("[128,28,28,512] 1x1/2 ->1024", (128, 28, 28, 512), (1, 1, 512, 1024),
     2, "SAME", torch.bfloat16, False, ("conv_dgrad",)),
    ("[128,14,14,512] 3x3/2 pad (0,1)", (128, 14, 14, 512),
     (3, 3, 512, 512), 2, "SAME", torch.bfloat16, False, ("conv_dgrad",)),
]


def _within_1ulp(got, want) -> float:
    """Share of bf16 elements within one ulp of ``want``'s."""
    dist = (_bf16_ordered(got) - _bf16_ordered(want)).abs()
    return (dist <= 1).float().mean().item()


def _conv_err(got, want, exact=None):
    """(max_abs_err, share of elements within one bf16 ulp or None, ok):
    fp32 within 1e-4 of max |plain|; fp16 within one fp16 ulp of max
    |plain| (2**-10 of it); bf16 within one ulp of max |plain| (2**-7 of
    it) and 99.9% of elements within one ulp of their own value: the
    plain one, or ``exact`` where given (wgrad)."""
    err = max_err(got, want)
    scale = want.float().abs().max().item()
    if got.dtype == torch.float16:
        return err, None, err <= 2.0 ** -10 * scale
    if got.dtype != torch.bfloat16:
        return err, None, err <= 1e-4 * scale
    within = _within_1ulp(got, want if exact is None else exact)
    return err, within, err <= 2.0 ** -7 * scale and within >= 0.999


def _wgrad_fp64(x, dy, stride, padding, kernel_size):
    """The weight gradient summed in fp64 and rounded once to x's type:
    wgrad's sums run over N*OH*OW (up to 1.6 M) products, where the plain
    fp32 sum itself misses by more than a bf16 ulp on elements near zero
    (0.2% of them at ``[128,56,56,64]`` 3x3), so a kernel's per-element
    share is taken against the exact value."""
    (pt, pb), (pl_, pr) = padding
    xd = F.pad(x.double().permute(0, 3, 1, 2), (pl_, pr, pt, pb))
    dyd = dy.double().permute(0, 3, 1, 2).contiguous()
    wd = torch.zeros((dy.shape[3], x.shape[3], *kernel_size),
                     dtype=torch.float64, device=x.device)
    dw = torch.ops.aten.convolution_backward(
        dyd, xd.contiguous(), wd, None, list(stride), [0, 0], [1, 1], False,
        [0, 0], 1, [False, True, False])[1]
    return dw.permute(2, 3, 1, 0).to(x.dtype)


def conv_cases(cv, fba, dev):
    """Kernels 1-3 against their plain versions at ResNet-50 B 128 shapes
    (cuDNN TF32 off, so the fp32 plain conv is full fp32).  ``library_ms``
    is cuDNN on the same inputs, channels-last: ``F.conv2d`` (an
    asymmetric pad applied to its input beforehand, untimed) and
    ``aten.convolution_backward`` with the matching output mask; none for
    the epilogue case.  The bound counts each conv's multiply-adds twice
    (the dgrad kernel's zero taps at stride 2 are not work) over the
    type's peak, and each input and output once."""
    gen = torch.Generator(device=dev).manual_seed(15)
    out = {"conv_fwd": [], "conv_dgrad": [], "conv_wgrad": []}
    for name, xs, ws, s, pad, dtype, ep, *only in CONV_CASES:
        stride, dil = (s, s), (1, 1)
        padding = cv._norm_padding(pad, xs[1], xs[2], ws[0], ws[1], s, s, 1,
                                   1)
        oh, ow = cv._out_hw(xs[1], xs[2], padding, ws[0], ws[1], s, s, 1, 1)
        x = torch.randn(xs, device=dev, generator=gen).to(dtype)
        w = (torch.randn(ws, device=dev, generator=gen)
             / (ws[0] * ws[1] * ws[2]) ** 0.5).to(dtype)
        dy = torch.randn((xs[0], oh, ow, ws[3]), device=dev,
                         generator=gen).to(dtype)
        o = ws[3]
        epi = ()
        if ep:
            epi = (0.3 * torch.randn(o, device=dev, generator=gen),
                   torch.rand(o, device=dev, generator=gen) + 0.5,
                   1 + 0.2 * torch.randn(o, device=dev, generator=gen),
                   0.2 * torch.randn(o, device=dev, generator=gen),
                   torch.randn((xs[0], oh, ow, o), device=dev,
                               generator=gen).to(dtype), True)
        macs = xs[0] * oh * ow * o * ws[0] * ws[1] * ws[2]
        isz = x.element_size()
        n_x, n_w, n_y = x.numel(), w.numel(), dy.numel()
        # library operands: the NCHW views of the NHWC tensors (channels-
        # last memory), the weights made channels-last, pads applied
        (pt, pb), (pl_, pr) = padding
        xl = F.pad(x.permute(0, 3, 1, 2), (pl_, pr, pt, pb))
        xl = xl.contiguous(memory_format=torch.channels_last)
        wl = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        dyl = dy.permute(0, 3, 1, 2)

        def lib_fwd():
            return F.conv2d(xl, wl, stride=stride)

        def lib_bwd(mask):
            return torch.ops.aten.convolution_backward(
                dyl, xl, wl, None, list(stride), [0, 0], [1, 1], False,
                [0, 0], 1, mask)

        def run_fwd():
            return cv.conv_fwd_kernel(x, w, stride, padding, dil, *epi)[0]

        def run_dgrad():
            return cv.conv_dgrad_kernel(dy, w, stride, padding, dil, xs[1:3])

        def run_wgrad():
            return cv.conv_wgrad_kernel(x, dy, stride, padding, dil, ws[:2])

        def plain_fwd():
            return cv._fwd_ref(x, w, stride, padding, dil, *epi)[0]
        phases = [("conv_fwd", run_fwd, plain_fwd, lib_fwd, time_ms,
                   (n_x + n_w + n_y * (2 if ep else 1)) * isz
                   + (4 * o * 4 if ep else 0))]
        if xs[3] != 3:                 # the stem's input needs no dx
            phases.append((
                "conv_dgrad", run_dgrad,
                lambda: cv._dgrad_ref(dy, w, stride, padding, dil, xs[1:3]),
                lambda: lib_bwd([True, False, False]), eager_ms,
                (n_y + n_w + n_x) * isz))
        phases.append((
            "conv_wgrad", run_wgrad,
            lambda: cv._wgrad_ref(x, dy, stride, padding, dil, ws[:2]),
            lambda: lib_bwd([False, True, False]), eager_ms,
            (n_x + n_y + n_w) * isz))
        if only:
            phases = [ph for ph in phases if ph[0] in only[0]]
        for kname, fn, plain, lib, lib_timer, nbytes in phases:
            got = fn()
            want = plain()
            exact = plain_within = None
            if kname == "conv_wgrad" and dtype == torch.bfloat16:
                exact = _wgrad_fp64(x, dy, stride, padding, ws[:2])
                plain_within = _within_1ulp(want, exact)
            torch.cuda.synchronize()
            err, within, ok = _conv_err(got, want, exact)
            msg = (f"{kname} {name}: max_abs_err {err:.3g} (max |plain| "
                   f"{want.float().abs().max().item():.3g}), within 1 ulp "
                   f"{within}")
            if exact is not None:
                msg += (f" of the fp64 sum (the plain fp32 version: "
                        f"{plain_within})")
            if ep and kname == "conv_fwd":
                y, _ = cv.conv_fwd_kernel(x, w, stride, padding, dil)
                exact = torch.equal(got, fba._fwd_ref(y, *epi))
                ok = ok and exact
                msg += f", equals conv -> plain epilogue bit for bit {exact}"
            check(ok, msg)
            del got, want, exact
            bms, by = bound(nbytes, 2.0 * macs, dtype)
            case = dict(case=name, max_abs_err=err, within_1ulp=within,
                        plain_within_1ulp_of_fp64=plain_within,
                        ms=time_ms(fn, iters=10), eager_ms=eager_ms(fn,
                                                                    iters=5),
                        plain_ms=(time_ms(plain, iters=3)
                                  if kname == "conv_fwd"
                                  else eager_ms(plain, iters=3)),
                        library_ms=(None if ep else lib_timer(lib, iters=5)),
                        bound_ms=bms, bound_by=by)
            case["tflops"] = 2.0 * macs / case["ms"] / 1e9
            out[kname].append(case)
            lib_s = ("n/a" if case["library_ms"] is None
                     else f"{case['library_ms']:.4f} ms")
            print(f"      {kname} {name}: kernel {case['ms']:.4f} ms (eager "
                  f"{case['eager_ms']:.4f}, {case['tflops']:.1f} TFLOP/s), "
                  f"plain {case['plain_ms']:.4f} ms, library {lib_s}, bound "
                  f"{bms:.4f} ms ({by})", flush=True)
        del x, w, dy, xl, wl, dyl, epi
    return out


# -- phase 13: ResNet-50 training ------------------------------------------------------

IMAGENET_ARGS = ["--synthetic", "--arch", "resnet50", "-b", "128",
                 "--opt-level", "O2", "--print-freq", "1"]

_RESNET_KINDS = (("conv_kernels", ("conv_gemm_kernel", "wgrad_reduce")),
                 ("bn_epilogue", ("bn_fwd", "bn_bwd")),
                 ("loss", ("xent_",)),
                 ("conv", ("conv", "cudnn", "fprop", "dgrad", "wgrad",
                           "implicit", "xmma")),
                 ("gemm", ("gemm", "nvjet", "cutlass", "cublas")),
                 ("optimizer", ("foreach", "multi_tensor")),
                 ("reduce", ("reduce",)))


def train_resnet50(imagenet, counters, steps=10, pallas_conv=True):
    """The ImageNet trainer's entry point at ResNet-50, B 128, 224 x
    224, bf16 O2, SGD, with its default ``--pallas-conv`` (the conv
    kernels) or ``--no-pallas-conv`` (cuDNN): every launch counter set to
    0 just before and read just after."""
    flag = "--pallas-conv" if pallas_conv else "--no-pallas-conv"
    args = imagenet.parse(IMAGENET_ARGS + ["--prof", str(steps), flag])
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    res = imagenet.train(args, log=lambda line: print("      " + line,
                                                      flush=True))
    launches = {name: c.launches for name, c in counters.items()}
    per_step = {"bn_act_fwd": 53, "bn_act_bwd": 53, "xentropy_fwd": 1,
                "xentropy_bwd": 1}
    if pallas_conv:
        # 53 convs a step; the stem's input (the images) needs no dx
        per_step.update(conv_fwd=53, conv_dgrad=52, conv_wgrad=53)
    check(all(launches[n] == per_step.get(n, 0) * steps for n in launches),
          f"resnet50 training {flag}: launches {launches} = {per_step} x "
          f"{steps} steps (no other kernel)")
    losses = res["losses"]
    check(all(np.isfinite(losses)),
          f"resnet50 training {flag}: losses finite ({losses[0]:.4f} -> "
          f"{losses[-1]:.4f})")
    step_ms = float(np.median(res["step_s"][2:])) * 1e3
    out = dict(losses=losses, step_ms_all=[x * 1e3 for x in res["step_s"]],
               step_ms_median_3_10=step_ms,
               images_per_s=res["images_per_step"] / step_ms * 1e3,
               max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
               launches=launches)
    print(f"      resnet50 O2 B128 224 {flag}: step {step_ms:.2f} ms "
          f"(median of steps 3-{steps}), {out['images_per_s']:.1f} "
          f"images/s, peak "
          f"memory {out['max_memory_allocated_bytes'] / 2**30:.2f} GiB",
          flush=True)
    return out


# -- phase 14: ResNet correctness ---------------------------------------------------------

def resnet_correctness(imagenet, training, dev):
    """(a) a small ResNet-50-shaped network (bottleneck blocks, 8
    filters, 1000 classes, 32 x 32, B 8) at O0 fp32, three SGD steps on
    the card and on the CPU; (b) O2 with a dynamic scale and an inf
    injected into the loss on the card; both with ``Conv`` (cuDNN) and
    with ``PallasConv`` (the conv kernels, fp32 FMA path at O0); (c) conv
    outputs are contiguous NHWC (no copy before the epilogue)."""
    from apex_tpu_torch.amp import convert_params
    from apex_tpu_torch.contrib.groupbn import BatchNorm2d_NHWC
    from apex_tpu_torch.models.resnet import BottleneckBlock, Conv, ResNet
    from apex_tpu_torch.ops import conv as cv
    res = {}

    def small(dtype, device, conv_cls):
        return ResNet(stage_sizes=[1, 1, 1, 1], block_cls=BottleneckBlock,
                      num_filters=8, dtype=dtype, norm_cls=BatchNorm2d_NHWC,
                      conv_cls=conv_cls, device="cpu", seed=3).to(device)

    def steps_of(m, opt_level, loss_scale=None, inject=False):
        def loss_fn(p, ms, batch):
            logits, new_ms = m.apply(p, ms, batch[0])
            loss = imagenet.image_loss(logits, batch[1])
            return (loss * batch[2] if inject else loss), new_ms
        init, step = training.make_train_step(
            loss_fn, training.sgd(0.02, momentum=0.9, weight_decay=1e-4),
            opt_level=opt_level, loss_scale=loss_scale,
            has_model_state=True)
        params, stats = m.variables()
        return init({k: v.detach() for k, v in params.items()},
                    {k: v.clone() for k, v in stats.items()}), step

    for tag, conv_cls in (("conv", None), ("pallas_conv", cv.PallasConv)):
        # (a)
        states, losses = {}, {}
        launches = cv.conv_fwd_kernel.launches
        for device in (dev, "cpu"):
            st, step = steps_of(small(torch.float32, device, conv_cls), "O0")
            x, y = imagenet.synthetic_batch(8, 32, device)
            losses[str(device)] = []
            for _ in range(3):
                st, met = step(st, (x, y))
                losses[str(device)].append(met["loss"].item())
            states[str(device)] = st
        ran = cv.conv_fwd_kernel.launches - launches
        lerr = max(abs(a - b) / abs(b) for a, b in
                   zip(losses[str(dev)], losses["cpu"]))
        perr = max(max_err(states[str(dev)].params[k].cpu(), v)
                   for k, v in states["cpu"].params.items())
        serr = max(max_err(states[str(dev)].model_state[k].cpu(), v)
                   for k, v in states["cpu"].model_state.items())
        check(lerr <= 1e-4 and perr <= 1e-4 and serr <= 1e-4
              and (ran == 3 * 17) == (conv_cls is not None),
              f"small resnet ({tag}) O0 3 SGD steps card vs CPU: loss rel "
              f"err {lerr:.3g} <= 1e-4, params max_abs_err {perr:.3g}, "
              f"running stats {serr:.3g} <= 1e-4; conv kernel launches "
              f"{ran}")
        res.update({f"small_o0_{tag}_losses_card": losses[str(dev)],
                    f"small_o0_{tag}_losses_cpu": losses["cpu"],
                    f"small_o0_{tag}_loss_rel_err": lerr,
                    f"small_o0_{tag}_param_max_abs_err": perr,
                    f"small_o0_{tag}_stats_max_abs_err": serr})

        # (b)
        m = small(torch.bfloat16, dev, conv_cls)
        st, step = steps_of(m, "O2", "dynamic", inject=True)
        x, y = imagenet.synthetic_batch(8, 32, dev)
        before = {k: v.clone() for k, v in st.params.items()}
        with torch.no_grad():
            _, want_stats = m.apply(convert_params(st.params, torch.bfloat16),
                                    st.model_state, x)
        st, met = step(st, (x, y, torch.tensor(float("inf"), device=dev)))
        kept = all(torch.equal(st.params[k], v) for k, v in before.items())
        stats_err = max(max_err(st.model_state[k], v)
                        for k, v in want_stats.items())
        skipped = (bool(met["overflow"]) and kept
                   and not bool(st.opt_state.initialized)
                   and met["loss_scale"].item() == 2.0 ** 15)
        check(skipped and stats_err <= 1e-6,
              f"small resnet ({tag}) O2 dynamic, inf injected: skipped with "
              f"params bit-identical {skipped}, running stats advanced as "
              f"in JAX (max_abs_err vs the step's forward {stats_err:.3g} "
              f"<= 1e-6)")
        res.update({f"o2_{tag}_skip_ok": skipped,
                    f"o2_{tag}_skip_stats_err": stats_err})

    # (c)
    xin = torch.randn(8, 56, 56, 64, device=dev, dtype=torch.bfloat16)
    layout = {}
    for name, k, s_ in (("3x3 s2", (3, 3), (2, 2)), ("1x1 s1", (1, 1),
                                                     (1, 1)),
                        ("3x3 s1", (3, 3), (1, 1))):
        for cls in (Conv, cv.PallasConv):
            conv = cls(64, 128, k, s_, dtype=torch.bfloat16, device=dev)
            with torch.no_grad():
                layout[f"{cls.__name__} {name}"] = conv(xin).is_contiguous()
    check(all(layout.values()),
          f"conv outputs are contiguous NHWC: {layout}")
    res["conv_outputs_contiguous"] = layout
    return res


def lm_fused_vs_plain_loss(models, main_amp, dev):
    """The LM loss on the card: the fused kernels against the
    ``--no-fused-loss`` composition on the same logits (gpt2_small bf16,
    B 2, T 256, every 16th label padding)."""
    ids = torch.from_numpy(np.random.RandomState(10).randint(
        1, 50257, (2, 257))).to(dev)
    labels = ids[:, 1:].clone()
    labels[:, ::16] = 0
    m = models.gpt2_small(dtype=torch.bfloat16, device=dev, seed=0)
    with torch.no_grad():
        logits = m(ids[:, :-1])
        fused = main_amp.lm_loss(logits, labels, 0.1, fused=True).item()
        plain = main_amp.lm_loss(logits, labels, 0.1, fused=False).item()
    rel = abs(fused - plain) / abs(plain)
    check(rel <= 1e-4, f"gpt2_small LM loss on the card: fused {fused:.6f} "
          f"vs --no-fused-loss {plain:.6f}, rel err {rel:.3g} <= 1e-4")
    return dict(lm_fused_loss=fused, lm_plain_loss=plain,
                lm_fused_vs_plain_rel_err=rel)


# -- phase 16: the quantized matmul --------------------------------------------------

QMM_CASES = [
    # name, M, K, N, dtype, a zero-amax weight column
    ("prefill M1024 768->768", 1024, 768, 768, torch.bfloat16, False),
    ("prefill M1024 768->3072", 1024, 768, 3072, torch.bfloat16, False),
    ("prefill M1024 3072->768", 1024, 3072, 768, torch.bfloat16, False),
    ("decode M8 768->768", 8, 768, 768, torch.bfloat16, False),
    ("decode M8 3072->768", 8, 3072, 768, torch.bfloat16, False),
    ("training M8184 768->3072", 8184, 768, 3072, torch.bfloat16, False),
    ("fp32 M1024 768->768", 1024, 768, 768, torch.float32, False),
    ("zero-amax column M256 768->768", 256, 768, 768, torch.bfloat16, True),
    ("ragged M1000 768->130", 1000, 768, 130, torch.bfloat16, False),
    ("fp16 M1024 768->3072", 1024, 768, 3072, torch.float16, False),
    ("K8 M1024 8->768", 1024, 8, 768, torch.bfloat16, False),
    ("K40 fp16 M1000 40->130", 1000, 40, 130, torch.float16, False),
]


def qmm_cases(qk, dev):
    """Kernel 14 against ``_qmm_ref`` at the O4 path's shapes, bit for
    bit.  ``library_ms`` is ``torch._int_mm`` on the pre-quantized
    operands where it takes the shape (the int8 GEMM alone: a lower bound
    on the same product); ``o2_matmul_ms`` the bf16 ``torch.matmul`` the
    O2 path runs at the same shape (what O4 competes with).  The bound
    counts x, qw, the scales and the output once, and 2 M N K operations
    at the int8 peak."""
    gen = torch.Generator(device=dev).manual_seed(16)
    cases = []
    for name, m, k, n, dtype, zero_col in QMM_CASES:
        x = (2 * torch.randn(m, k, device=dev, generator=gen)).to(dtype)
        w = torch.randn(k, n, device=dev, generator=gen) / k ** 0.5
        if zero_col:
            w[:, n // 3] = 0.0
        w = w.to(dtype)
        ws = qk.channel_scale(w)
        qw = qk.weight_layout(w, ws)            # [N, K padded to 16]
        xs = torch.tensor(x.float().abs().max().item() / 127.0 * 0.9,
                          device=dev)

        def run():
            return qk.qmm_kernel(x, qw, xs, ws, dtype)

        def plain():
            return qk._qmm_ref(x, qw, xs, ws, dtype)
        got, want = run(), plain()
        torch.cuda.synchronize()
        exact = torch.equal(got, want)
        if zero_col:
            exact = exact and not got[:, n // 3].any()
        check(exact, f"qmm {name}: equals the plain version bit for bit "
              f"{exact} (max_abs_err {max_err(got, want):.3g})")
        isz = x.element_size()
        nbytes = m * k * isz + n * qw.shape[1] + 4 * n + 4 + m * n * isz
        bms, by = bound(nbytes, 2.0 * m * n * k, torch.int8)
        lib = None
        qx, qkn = qk.quantize(x, xs), qw[:, :k].t()
        try:
            lib = time_ms(lambda: torch._int_mm(qx, qkn))
        except RuntimeError as e:          # shapes _int_mm refuses
            print(f"      qmm {name}: torch._int_mm refused "
                  f"({str(e).splitlines()[0][:80]})", flush=True)
        xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
        case = dict(case=name, max_abs_err=max_err(got, want),
                    bit_exact=exact, ms=time_ms(run), eager_ms=eager_ms(run),
                    plain_ms=time_ms(plain, iters=3), library_ms=lib,
                    o2_matmul_ms=time_ms(lambda: xb @ wb),
                    bound_ms=bms, bound_by=by)
        case["tops"] = 2.0 * m * n * k / case["ms"] / 1e9
        lib_s = "n/a" if lib is None else f"{lib:.4f} ms"
        print(f"      qmm {name}: kernel {case['ms']:.4f} ms (eager "
              f"{case['eager_ms']:.4f}, {case['tops']:.1f} TOP/s), plain "
              f"{case['plain_ms']:.4f} ms, _int_mm {lib_s}, bf16 matmul "
              f"{case['o2_matmul_ms']:.4f} ms, bound {bms:.4f} ms ({by})",
              flush=True)
        cases.append(case)
        del x, w, qw, got, want, qx, xb, wb
    return cases


# -- phase 17: O4 serving ---------------------------------------------------------------

def calibrate_gpt2_small(models, quant, dev, n_batches=4):
    """The JAX recipe's observation phase on GPT-2 small bf16: 4 synthetic
    batches (B 2, T 1024, ids from RandomState(17)) through the
    observe-mode model, each batch's absmax of every site harvested, the
    history frozen with "max"."""
    obs = models.gpt2_small(dtype=torch.bfloat16, device=dev, seed=0,
                            quant=quant.QuantConfig.observe())
    cal = quant.Calibrator()
    rng = np.random.RandomState(17)
    with torch.no_grad():
        for _ in range(n_batches):
            obs(torch.from_numpy(rng.randint(1, 50257, (2, 1024))).to(dev))
            cal.harvest(quant.quant_stats(obs))
    calib = cal.freeze("max")
    check(len(calib) == 72 and all(a > 0 for a in calib.amax.values()),
          f"gpt2_small calibration: {len(calib)} sites (72), amax "
          f"{min(calib.amax.values()):.3g}-{max(calib.amax.values()):.3g}")
    return calib


def _prefill_logits(model, ids, dev):
    from apex_tpu_torch.models import init_cache
    with torch.inference_mode():
        logits, _ = model(ids.to(dev), kv_caches=init_cache(
            model, ids.shape[0], cache_len=ids.shape[1]),
            positions=torch.zeros((ids.shape[0],), dtype=torch.long,
                                  device=dev))
    return logits.float()


def o4_prefill_checks(models, quant, calib, dev):
    """A 256-token prefill of gpt2_small bf16: O4 with an empty
    calibration bit for bit O2, and the relative RMS error of O4 (the
    frozen calibration) against O2."""
    ids = torch.from_numpy(np.random.RandomState(3).randint(1, 50257,
                                                            (1, 256)))
    o2 = _prefill_logits(models.gpt2_small(dtype=torch.bfloat16, device=dev,
                                           seed=0), ids, dev)
    empty = _prefill_logits(models.gpt2_small(
        dtype=torch.bfloat16, device=dev, seed=0,
        quant=quant.QuantConfig("quant", scales={})), ids, dev)
    o4 = _prefill_logits(models.gpt2_small(
        dtype=torch.bfloat16, device=dev, seed=0,
        quant=quant.QuantConfig.frozen(calib)), ids, dev)
    same = torch.equal(empty, o2)
    rel = ((o4 - o2).pow(2).mean().sqrt() / o2.pow(2).mean().sqrt()).item()
    agree = (o4.argmax(-1) == o2.argmax(-1)).float().mean().item()
    check(same and np.isfinite(rel),
          f"gpt2_small O4 with an empty calibration equals O2 bit for bit "
          f"{same}; O4 vs O2 256-token prefill logits relative RMS error "
          f"{rel:.4g}, top-1 agreement {agree:.3f}")
    return dict(o4_empty_equals_o2=same, o4_vs_o2_logits_rel_rms=rel,
                o4_vs_o2_top1_agreement=agree)


#: a card-vs-CPU token mismatch of the int8 gpt_tiny is allowed only
#: where the CPU's top-2 logit gap at that step is below this: one fp32
#: rounding difference that lands on an int8 rounding boundary moves a
#: quantized value by a whole step (1/127 of its site's or row's amax),
#: and all of quantization together moves gpt_tiny's logits by 0.04-0.07
O4_TINY_GAP = 1e-2


def tiny_tokens_o4(models, quant, engine_mod, dev):
    """gpt_tiny fp32 with a frozen calibration (observed on the CPU) and an
    int8 KV cache, served on the card and on the CPU: equal greedy tokens
    except after a step whose top-2 logit gap on the CPU engine is below
    ``O4_TINY_GAP`` (the gap read from a one-slot CPU rerun of that
    request, whose logits a forward hook records)."""
    rng = np.random.RandomState(4)
    obs = models.gpt_tiny(dtype=torch.float32, device="cpu", seed=1,
                          quant=quant.QuantConfig.observe())
    cal = quant.Calibrator()
    with torch.no_grad():
        for _ in range(3):
            obs(torch.from_numpy(rng.randint(1, 1024, (2, 128))))
            cal.harvest(quant.quant_stats(obs))
    cfg = quant.QuantConfig.frozen(cal.freeze())
    prompts = [rng.randint(1, 1024, (int(n),))
               for n in rng.randint(4, 200, 12)]

    def engine(device, slots):
        m = models.gpt_tiny(dtype=torch.float32, device=device, seed=1,
                            quant=cfg)
        return m, engine_mod.ServingEngine(
            m, buckets=(128, 256), page_size=16, max_seqs=slots,
            cache_dtype=torch.int8, device=device)
    toks = {}
    for device in (dev, "cpu"):
        _, eng = engine(device, 4)
        toks[str(device)] = [r.tokens for r in eng.generate(prompts, 24)]
        eng.close()
    mismatched, gaps = 0, []
    for p, a, b in zip(prompts, toks[str(dev)], toks["cpu"]):
        if np.array_equal(a, b):
            continue
        mismatched += 1
        j = int(np.argmax(a != b))       # first divergent step
        m, eng = engine("cpu", 1)
        seen = []
        hook = m.register_forward_hook(
            lambda mod, inp, out: seen.append(out[0].detach()))
        eng.generate([p], 24)
        eng.close()
        hook.remove()
        step = seen[0][0, len(p) - 1] if j == 0 else seen[j][0, -1]
        top2 = step.topk(2).values
        gaps.append(float(top2[0] - top2[1]))
    check(all(g < O4_TINY_GAP for g in gaps),
          f"gpt_tiny fp32 O4 + int8 KV tokens card vs CPU: "
          f"{12 - mismatched}/12 identical; top-2 gaps at divergence "
          f"{gaps} < {O4_TINY_GAP}")
    return dict(o4_tiny_identical=12 - mismatched,
                o4_tiny_divergence_gaps=gaps)


# -- phase 18: O4 training --------------------------------------------------------------

def train_o4(models, quant, main_amp, training, counters, calib, dev,
             steps=10):
    """``make_train_step(opt_level="O4")`` on the calibrated GPT-2 small
    (the LM trainer's model, loss and batch: Adam lr 3e-4, weight decay
    0.1, B 8, seq_len 1024, the fused loss): every launch counter set to
    0 just before and read just after."""
    model = models.GPT(vocab_size=50257, hidden_size=768, num_layers=12,
                       num_heads=12, mlp_dim=3072, max_len=1024,
                       dtype=torch.bfloat16, attention_impl="flash",
                       device=dev, seed=0,
                       quant=quant.QuantConfig.frozen(calib))

    def loss_fn(params, batch):
        return main_amp.lm_loss(torch.func.functional_call(
            model, params, (batch[0],)), batch[1], 0.0, True)
    init, step = training.make_train_step(
        loss_fn, training.adam(3e-4, weight_decay=0.1), opt_level="O4")
    state = init(model.state_dict())
    batch = main_amp.synthetic_batch(8, 1024, 50257, dev)
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    losses, step_s = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, met = step(state, batch)
        losses.append(met["loss"].item())
        step_s.append(time.perf_counter() - t0)
    launches = {n: c.launches for n, c in counters.items()}
    per_step = dict(LM_PER_STEP, qmm=72)
    check(all(launches[n] == per_step.get(n, 0) * steps for n in launches),
          f"gpt2_small O4 training: launches {launches} = {per_step} x "
          f"{steps} steps (the qmm backward launches nothing)")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"gpt2_small O4 training: losses finite, step {steps} "
          f"{losses[-1]:.4f} < step 1 {losses[0]:.4f}")
    step_ms = float(np.median(step_s[2:])) * 1e3
    out = dict(losses=losses, step_ms_all=[x * 1e3 for x in step_s],
               step_ms_median_3_10=step_ms,
               tokens_per_s=8 * 1023 / step_ms * 1e3,
               max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
               launches={n: v for n, v in launches.items() if v})
    print(f"      gpt2_small O4 B8 T1023: step {step_ms:.2f} ms (median of "
          f"steps 3-{steps}), {out['tokens_per_s']:.0f} tok/s, peak memory "
          f"{out['max_memory_allocated_bytes'] / 2**30:.2f} GiB; losses "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}", flush=True)
    out["profile"] = trace_steps(state, step, batch)
    return out


# -- phase 19: the [B, T, S] bias gradient ------------------------------------------------

DB2_CASES = [
    # name, kv heads, dtype, causal, window, head_dim
    ("full", 12, torch.bfloat16, False, None, 64),
    ("causal", 12, torch.bfloat16, True, None, 64),
    ("gqa 12/4 causal", 4, torch.bfloat16, True, None, 64),
    ("window 256", 12, torch.bfloat16, True, 256, 64),
    ("fp32 causal", 12, torch.float32, True, None, 64),
    ("fp16 causal", 12, torch.float16, True, None, 64),
    ("head_dim 16 causal", 12, torch.bfloat16, True, None, 16),
    ("head_dim 256 causal", 12, torch.bfloat16, True, None, 256),
]


def db2_cases(fa, counters, dev):
    """Kernel 13 at GPT-2 small's attention shapes (B 8, T = S = 1024, 12
    heads of 64) with a learnable fp32 ``[B, T, S]`` bias.  First the
    public op under autograd, every counter set to 0 just before and
    read just after: one forward, dQ, dK/dV and db2 launch per backward
    that needs the bias gradient, none of db2 without it, and dq/dk/dv
    equal between the two.  Then the kernel against
    ``_flash_bwd_ref``'s dbias on the same inputs, within 1e-4 of max
    |dbias| (fp32 sums over 12 heads in another order), zero where the
    band hides a key.  ``library_ms``: the eager backward of SDPA with
    the bias expanded to ``[B, H, T, S]`` and needing a gradient (the
    band folded into it as -inf), where a backend takes it."""
    rng = np.random.RandomState(19)
    b, t, h = 8, 1024, 12
    cases, db2_launches = [], 0
    for name, h_kv, dtype, causal, window, d in DB2_CASES:
        q, do = (torch.from_numpy(rng.randn(b, t, h, d).astype(np.float32))
                 .to(dev, dtype) for _ in range(2))
        k, v = (torch.from_numpy(rng.randn(b, t, h_kv, d).astype(np.float32))
                .to(dev, dtype) for _ in range(2))
        bias = torch.from_numpy(
            (0.5 * rng.randn(b, t, t)).astype(np.float32)).to(dev)
        kw = dict(sm_scale=d ** -0.5, causal=causal, q_offset=0,
                  window=window)
        for c in counters.values():
            c.launches = 0
        grads = {}
        for learn in (True, False):
            leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
            bl = bias.detach().requires_grad_(learn)
            out = fa.flash_attention(*leaves, bias=bl, causal=causal,
                                     window=window)
            grads[learn] = torch.autograd.grad(
                out, leaves + ([bl] if learn else []), do)
        launched = {n: c.launches for n, c in counters.items()
                    if c.launches}
        db2_launches += launched.get("flash_attention_bwd_db2", 0)
        want_l = {"flash_attention_fwd": 2, "flash_attention_bwd_dq": 2,
                  "flash_attention_bwd_dkv": 2, "flash_attention_bwd_db2": 1}
        same = all(torch.equal(a, b_) for a, b_ in
                   zip(grads[True][:3], grads[False]))
        check(launched == want_l and same,
              f"flash bias grad {name}: launches {launched} = {want_l}; "
              f"dq/dk/dv equal to the run without a bias gradient {same}")

        out, lse = fa.flash_fwd_kernel(q, k, v, None, bias, **kw)
        delta = fa._delta(do, out)

        def run():
            return fa.flash_bwd_db2_kernel(q, k, v, do, lse, delta, None,
                                           bias, **kw)

        def plain():
            return fa._flash_bwd_ref(q, k, v, None, bias, out, lse, do,
                                     **kw)[4]
        got, want = run(), plain()
        torch.cuda.synchronize()
        err, scale = max_err(got, want), want.abs().max().item()
        zeros = True
        if causal:
            vis = fa._visible(t, t, 0, window, dev)
            zeros = not got[:, ~vis].any()
        op_same = torch.equal(grads[True][3], got)
        check(err <= 1e-4 * scale and zeros and op_same,
              f"flash db2 {name}: max_abs_err {err:.3g} <= 1e-4 x max "
              f"|dbias| {scale:.3g}; hidden keys zero {zeros}; the op's "
              f"dbias equals the kernel's {op_same}")
        del grads
        isz = q.element_size()
        # the bias is read where the band leaves a key visible; dbias is
        # written whole (its hidden entries are zeros)
        pairs = _visible_pairs(b, t, t, causal, 0, window, None)
        nbytes = ((q.numel() + k.numel() + v.numel() + do.numel()) * isz
                  + pairs * 4 + bias.numel() * 4 + 2 * b * h * t * 4)
        bms, by = bound(nbytes, 4.0 * d * pairs * h, dtype)
        lib = None
        try:
            qt, kt, vt = (x.repeat_interleave(h // x.shape[2], dim=2)
                          .transpose(1, 2).detach().requires_grad_(True)
                          for x in (q, k, v))
            lb = bias
            if causal:
                lb = torch.where(fa._visible(t, t, 0, window, dev), bias,
                                 float("-inf"))
            lb = lb.to(dtype)[:, None].expand(b, h, t, t).requires_grad_(True)
            lout = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=lb,
                                                  scale=d ** -0.5)
            dot = do.transpose(1, 2)
            lib = eager_ms(lambda: torch.autograd.grad(
                lout, (qt, kt, vt, lb), dot, retain_graph=True), iters=3)
            del lout, qt, kt, vt, lb
        except RuntimeError as e:
            print(f"      flash db2 {name}: no SDPA backend takes a bias "
                  f"gradient ({str(e).splitlines()[0][:80]})", flush=True)
        case = dict(case=name, max_abs_err=err, max_abs_dbias=scale,
                    ms=time_ms(run, iters=5), eager_ms=eager_ms(run, iters=5),
                    plain_ms=time_ms(plain, iters=2), library_ms=lib,
                    bound_ms=bms, bound_by=by)
        lib_s = "n/a" if lib is None else f"{lib:.4f} ms"
        print(f"      flash db2 {name}: kernel {case['ms']:.4f} ms (eager "
              f"{case['eager_ms']:.4f}), plain {case['plain_ms']:.4f} ms, "
              f"SDPA backward with a bias gradient {lib_s}, bound "
              f"{bms:.4f} ms ({by})", flush=True)
        cases.append(case)
        del q, k, v, do, bias, out, lse, delta, got, want
    return cases, {"flash_attention_bwd_db2": db2_launches}


# -- main ---------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    fln = importlib.import_module(
        "apex_tpu_torch.normalization.fused_layer_norm")
    fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
    fba = importlib.import_module("apex_tpu_torch.normalization.fused_bn_act")
    xent = importlib.import_module("apex_tpu_torch.contrib.xentropy")
    cv = importlib.import_module("apex_tpu_torch.ops.conv")
    models = importlib.import_module("apex_tpu_torch.models")
    engine_mod = importlib.import_module("apex_tpu_torch.serving.engine")
    build = importlib.import_module("apex_tpu_torch._build")
    training = importlib.import_module("apex_tpu_torch.training")
    main_amp = importlib.import_module("apex_tpu_torch.examples.lm.main_amp")
    imagenet = importlib.import_module(
        "apex_tpu_torch.examples.imagenet.main_amp")
    quant = importlib.import_module("apex_tpu_torch.quant")
    qk = importlib.import_module("apex_tpu_torch.quant.kernels")
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # phase 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)} ({smi})", flush=True)

    # phase 2: every kernel built at once, one nvcc per CUDA source; the
    # Triton kernels compile one after another in a fourth thread
    def timed(fn):
        def run():
            t0 = time.perf_counter()
            fn()
            return time.perf_counter() - t0
        return run

    def build_triton():
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.ones((16, 768), device=dev, dtype=dtype)
            w = torch.ones((768,), device=dev)
            _, mean, invvar = fln.layer_norm_fwd_kernel(x, w, w, 1e-5)
            fln.layer_norm_bwd_kernel(x, x, mean, invvar, w)
            c = torch.ones((64,), device=dev)
            for relu, z in ((True, None), (True, x[:, :64].contiguous()),
                            (False, None)):
                xc = x[:, :64].contiguous()
                fba.bn_act_fwd_kernel(xc, c, c, c, c, z, relu)
                fba.bn_act_bwd_kernel(xc, xc, c, c, c, c, z, relu)
            labels = torch.zeros((16,), device=dev, dtype=torch.int32)
            _, mlse = xent.xentropy_fwd_kernel(x, labels, 0.0)
            xent.xentropy_bwd_kernel(mlse, x, mlse, labels, 0.0)
        torch.cuda.synchronize()

    jobs = {"flash_attention_nvcc_s": lambda: build.load("flash_attention"),
            "flash_attention_bwd_nvcc_s":
                lambda: build.load("flash_attention_bwd"),
            "conv_nvcc_s": lambda: build.load("conv"),
            "quant_nvcc_s": lambda: build.load("quant"),
            "triton_s": build_triton}
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futures = {k: pool.submit(timed(fn)) for k, fn in jobs.items()}
        build_s = {k: f.result() for k, f in futures.items()}
    print(f"      build: {build_s}", flush=True)
    for name in ("flash_attention", "flash_attention_bwd", "conv", "quant"):
        report = [ln for ln in build.ptxas_report(name).splitlines()
                  if "registers" in ln or "spill" in ln]
        print(f"      ptxas {name}: "
              + " | ".join(r.strip() for r in report[:36]), flush=True)

    counters = {
        "layer_norm_fwd": fln.layer_norm_fwd_kernel,
        "layer_norm_bwd": fln.layer_norm_bwd_kernel,
        "flash_attention_fwd": fa.flash_fwd_kernel,
        "flash_attention_bwd_dq": fa.flash_bwd_dq_kernel,
        "flash_attention_bwd_dkv": fa.flash_bwd_dkv_kernel,
        "bn_act_fwd": fba.bn_act_fwd_kernel,
        "bn_act_bwd": fba.bn_act_bwd_kernel,
        "xentropy_fwd": xent.xentropy_fwd_kernel,
        "xentropy_bwd": xent.xentropy_bwd_kernel,
        "conv_fwd": cv.conv_fwd_kernel,
        "conv_dgrad": cv.conv_dgrad_kernel,
        "conv_wgrad": cv.conv_wgrad_kernel,
        "qmm": qk.qmm_kernel,
        "flash_attention_bwd_db2": fa.flash_bwd_db2_kernel}
    ln_cases = layer_norm_cases(fln, dev)          # phase 3
    fa_cases = flash_cases(fa, dev)                # phase 4
    model = models.gpt2_small(dtype=torch.bfloat16, device=dev, seed=0)
    serving = serve_gpt2_small(model, engine_mod, counters, dev,   # 5
                               SERVE_PER_FORWARD)
    serving.update(prefill_logits(models, dev))
    serving.update(tiny_tokens(models, engine_mod, dev))
    profile_res = where_time_goes(model, engine_mod, dev)          # 6
    del model
    ln_bwd_cases = layer_norm_bwd_cases(fln, dev)                  # 7
    dq_cases, dkv_cases = flash_bwd_cases(fa, dev)                 # 8
    trained = train_gpt2_small(main_amp, counters)                 # 9
    trained["profile"] = trace_training(main_amp,
                                        TRAIN_ARGS + ["--steps", "1"])
    trained.update(training_correctness(models, main_amp, training,
                                        dev))                      # 10
    trained.update(lm_fused_vs_plain_loss(models, main_amp, dev))
    bn_fwd_cases, bn_bwd_cases = bn_epilogue_cases(fba, dev)       # 11
    xent_fwd_cases, xent_bwd_cases = xentropy_cases(xent, dev)     # 12
    resnet = train_resnet50(imagenet, counters)                    # 13
    resnet["profile"] = trace_training(imagenet,
                                       IMAGENET_ARGS + ["--prof", "1"],
                                       _RESNET_KINDS)
    resnet["no_pallas_conv"] = train_resnet50(imagenet, counters,  # 13b
                                              pallas_conv=False)
    resnet["no_pallas_conv"]["profile"] = trace_training(
        imagenet, IMAGENET_ARGS + ["--prof", "1", "--no-pallas-conv"],
        _RESNET_KINDS)
    resnet.update(resnet_correctness(imagenet, training, dev))     # 14
    conv = conv_cases(cv, fba, dev)                                # 15
    qmm = qmm_cases(qk, dev)                                       # 16
    calib = calibrate_gpt2_small(models, quant, dev)               # 17
    o4_model = models.gpt2_small(dtype=torch.bfloat16, device=dev, seed=0,
                                 quant=quant.QuantConfig.frozen(calib))
    o4_serving = serve_gpt2_small(o4_model, engine_mod, counters, dev,
                                  O4_SERVE_PER_FORWARD,
                                  cache_dtype=torch.int8)
    o4_serving["profile"] = where_time_goes(o4_model, engine_mod, dev,
                                            cache_dtype=torch.int8)
    del o4_model
    o4_serving.update(o4_prefill_checks(models, quant, calib, dev))
    o4_serving.update(tiny_tokens_o4(models, quant, engine_mod, dev))
    o4_serving["bf16_kv_o2"] = {k: serving[k] for k in (
        "tokens_per_s", "ttft_p50_ms", "ttft_p99_ms", "tpot_p50_ms",
        "tpot_p99_ms", "kv_bytes_per_token", "max_memory_allocated_bytes")}
    o4_train = train_o4(models, quant, main_amp, training, counters,  # 18
                        calib, dev)
    o4_train["o2"] = {k: trained[k] for k in (
        "step_ms_median_3_10", "tokens_per_s", "max_memory_allocated_bytes")}
    db2, db2_launches = db2_cases(fa, counters, dev)               # 19
    paths = {"serving": serving["launches"], "training": trained["launches"],
             "resnet_training": resnet["launches"],
             "o4_serving": o4_serving["launches"],
             "o4_training": o4_train["launches"],
             "bias_grad": db2_launches}

    def entry(name, route, source, replaces, cases, main_case, path):
        rep = cases[main_case]
        launches = {p: counts.get(name) for p, counts in paths.items()}
        return dict(
            name=name, route=route, source=source, replaces=replaces,
            launches=launches[path],
            launches_by_path={k: v for k, v in launches.items()
                              if v is not None},
            max_abs_err=max(c["max_abs_err"] for c in cases),
            ms=rep["ms"], plain_ms=rep["plain_ms"], bound_ms=rep["bound_ms"],
            bound_by=rep["bound_by"], library_ms=rep["library_ms"],
            shape=rep["case"], cases=cases)

    kernels = [
        entry("layer_norm_fwd", "triton",
              "apex_tpu_torch/normalization/fused_layer_norm.py",
              "apex_tpu/normalization/fused_layer_norm.py:206", ln_cases, 0,
              "serving"),
        entry("layer_norm_bwd", "triton",
              "apex_tpu_torch/normalization/fused_layer_norm.py",
              "apex_tpu/normalization/fused_layer_norm.py:223", ln_bwd_cases,
              0, "training"),
        entry("flash_attention_fwd", "cuda",
              "apex_tpu_torch/csrc/flash_attention.cu",
              "apex_tpu/ops/flash_attention.py:238", fa_cases, 0, "serving"),
        entry("flash_attention_bwd_dq", "cuda",
              "apex_tpu_torch/csrc/flash_attention_bwd.cu",
              "apex_tpu/ops/flash_attention.py:440", dq_cases, 0,
              "training"),
        entry("flash_attention_bwd_dkv", "cuda",
              "apex_tpu_torch/csrc/flash_attention_bwd.cu",
              "apex_tpu/ops/flash_attention.py:478", dkv_cases, 0,
              "training"),
        # the BN rows show the stage-4 downsample_bn case, the one with a
        # library call computing the same function; every case is in
        # --out
        entry("bn_act_fwd", "triton",
              "apex_tpu_torch/normalization/fused_bn_act.py",
              "apex_tpu/normalization/fused_bn_act.py:148", bn_fwd_cases, 2,
              "resnet_training"),
        entry("bn_act_bwd", "triton",
              "apex_tpu_torch/normalization/fused_bn_act.py",
              "apex_tpu/normalization/fused_bn_act.py:161", bn_bwd_cases, 2,
              "resnet_training"),
        entry("xentropy_fwd", "triton",
              "apex_tpu_torch/contrib/xentropy/__init__.py",
              "apex_tpu/contrib/xentropy/__init__.py:109", xent_fwd_cases,
              2, "resnet_training"),
        entry("xentropy_bwd", "triton",
              "apex_tpu_torch/contrib/xentropy/__init__.py",
              "apex_tpu/contrib/xentropy/__init__.py:123", xent_bwd_cases,
              2, "resnet_training"),
        # the conv rows show the stage-1 3x3 case; every case is in --out
        entry("conv_fwd", "cuda", "apex_tpu_torch/csrc/conv.cu",
              "apex_tpu/ops/conv.py:267", conv["conv_fwd"], 1,
              "resnet_training"),
        entry("conv_dgrad", "cuda", "apex_tpu_torch/csrc/conv.cu",
              "apex_tpu/ops/conv.py:375", conv["conv_dgrad"], 0,
              "resnet_training"),
        entry("conv_wgrad", "cuda", "apex_tpu_torch/csrc/conv.cu",
              "apex_tpu/ops/conv.py:397", conv["conv_wgrad"], 1,
              "resnet_training"),
        # the qmm row shows the prefill 768->3072 case, the db2 row the
        # causal one; every case is in --out
        entry("qmm", "cuda", "apex_tpu_torch/csrc/quant.cu",
              "apex_tpu/quant/kernels.py:147", qmm, 1, "o4_serving"),
        entry("flash_attention_bwd_db2", "cuda",
              "apex_tpu_torch/csrc/flash_attention_bwd.cu",
              "apex_tpu/ops/flash_attention.py:562", db2, 1, "bias_grad"),
    ]
    elapsed = time.perf_counter() - t_start
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(gpu=smi, torch=torch.__version__, build=build_s,
                           kernels=kernels, serving=serving,
                           profile=profile_res, training=trained,
                           resnet_training=resnet, o4_serving=o4_serving,
                           o4_training=o4_train,
                           o4_calibration=calib.state_dict(),
                           elapsed_s=elapsed, failures=FAILURES), f,
                      indent=1)
    print(f"      elapsed {elapsed:.1f} s", flush=True)
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed",
              file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [{k: v for k, v in e.items()
                                   if k != "cases"} for e in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
