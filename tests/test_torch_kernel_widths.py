"""The plain versions of the port's redesigned and widened kernels
against the JAX package, on the CPU.

* ``_flash_fwd_split_ref`` (the split-KV decode kernels' arithmetic:
  keys in chunks, each chunk's fp32 ``(m, l, acc)``, merged in chunk
  order) against JAX ``flash_attention`` with the Pallas kernel in
  interpret mode, at head widths 16 and 48 (the card runs 48 in its 64
  instantiation), bf16 and fp16, causal, a window that leaves whole
  chunks masked, a key-padding bias, a ``[B, T, S]`` bias, GQA and a
  decode row.  Tolerances: bf16 2e-2 and fp16 5e-3 of the outputs, both
  rounded to their type (p is rounded to the value type against each
  chunk's own maximum, JAX's against its running one); lse 1e-3 against
  the unsplit plain version.
* Flash at head widths 160 and 256 (the card runs both in its 256
  kernels) and 257, 320 and 512 (the card runs them in the 256 kernels,
  in 256-wide column slices): forward and gradients of
  ``flash_attention`` against JAX's with the Pallas kernels in interpret
  mode, at the tolerances of ``test_torch_flash_attention.py``.
* ``_dgrad_parity_ref`` (the stride > 1 dgrad kernel's arithmetic: one
  dense sub-GEMM per parity class of the input pixels) against the JAX
  Pallas dgrad in interpret mode and the plain ``_dgrad_ref``: fp32 at
  1e-5 (summation order only), bf16 within one bf16 ulp of max |dx|.
* The quantized weight laid out ``[N, Kp]`` with zero columns up to a
  multiple of 16 (``weight_layout``), through ``_qmm_ref``, against JAX's
  ``quantized_matmul`` in interpret mode, bit for bit, at K = 8 (the JAX
  test's) and other K that are no multiple of 16.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu import quant as jquant
from apex_tpu.ops import conv as jconv
from apex_tpu.ops.flash_attention import flash_attention as jflash
from apex_tpu_torch.ops import conv as tconv
from apex_tpu_torch.quant import kernels as K

fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")

# -- the split-KV forward ------------------------------------------------------

FLASH_CASES = {
    # b, tq, tk, h, h_kv, kwargs of both functions
    "causal": (2, 32, 32, 4, 4, dict(causal=True)),
    "window": (2, 32, 32, 4, 4, dict(causal=True, window=8)),
    "key_bias": (2, 32, 32, 4, 4, dict(causal=False, kbias=True)),
    "bts_bias": (2, 32, 32, 4, 4, dict(causal=False, bias=True)),
    "gqa": (2, 32, 32, 4, 2, dict(causal=True)),
    "decode": (3, 1, 40, 4, 2, dict(causal=True, kbias=True)),
}
FLASH_TOL = {"bfloat16": 2e-2, "float16": 5e-3}


def _flash_inputs(case, d, seed):
    b, tq, tk, h, h_kv, kw = FLASH_CASES[case]
    rng = np.random.RandomState(seed)
    q = rng.randn(b, tq, h, d).astype(np.float32)
    k = rng.randn(b, tk, h_kv, d).astype(np.float32)
    v = rng.randn(b, tk, h_kv, d).astype(np.float32)
    kw = dict(kw)
    arrays = {}
    if kw.pop("kbias", False):
        live = np.arange(tk)[None] < rng.randint(tk // 2, tk + 1, (b, 1))
        arrays["key_padding_bias"] = np.where(live, 0.0, -1e9).astype(
            np.float32)
    if kw.pop("bias", False):
        arrays["bias"] = rng.randn(b, tq, tk).astype(np.float32)
    return q, k, v, kw, arrays


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
@pytest.mark.parametrize("d", [16, 48])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_split_kv_plain_version_matches_jax(case, d, dtype):
    q, k, v, kw, arrays = _flash_inputs(case, d, seed=60 + d)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    blocks = ({} if q.shape[1] == 1
              else dict(block_q=16, block_k=16))
    want = jflash(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                  **{n: jnp.asarray(a) for n, a in arrays.items()},
                  interpret=True, **blocks, **kw)
    tq_, tk_, tv_ = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    tq, tk = q.shape[1], k.shape[1]
    kb = arrays.get("key_padding_bias")
    bias = arrays.get("bias")
    fkw = dict(sm_scale=d ** -0.5, causal=kw["causal"],
               q_offset=tk - tq if kw["causal"] else 0,
               window=kw.get("window"))
    args = (tq_, tk_, tv_, None if kb is None else torch.from_numpy(kb),
            None if bias is None else torch.from_numpy(bias))
    out, lse = fa._flash_fwd_split_ref(*args, chunk=8, **fkw)
    assert out.dtype == tdt and out.shape == q.shape
    tol = FLASH_TOL[dtype]
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)
    _, want_lse = fa._flash_fwd_ref(*args, **fkw)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), atol=1e-3,
                               rtol=1e-3)


def test_split_kv_wholly_masked_chunks_and_rows():
    """A window of 4 over chunks of 8: most chunks of a late row hold no
    visible key and must add nothing; rows placed before the first key (a
    negative offset) see nothing at all: out 0, lse NEG_INF."""
    q, k, v, _, _ = _flash_inputs("causal", 16, seed=70)
    tq_, tk_, tv_ = (torch.from_numpy(a) for a in (q, k, v))
    kw = dict(sm_scale=0.25, causal=True, window=4)
    out, lse = fa._flash_fwd_split_ref(tq_, tk_, tv_, None, None, chunk=8,
                                       **kw)
    want_out, want_lse = fa._flash_fwd_ref(tq_, tk_, tv_, None, None, **kw)
    torch.testing.assert_close(out, want_out, atol=2e-6, rtol=2e-6)
    torch.testing.assert_close(lse, want_lse, atol=2e-6, rtol=2e-6)
    out, lse = fa._flash_fwd_split_ref(tq_[:, :2], tk_, tv_, None, None,
                                       chunk=8, sm_scale=0.25, causal=True,
                                       q_offset=-2)
    assert not out.any() and (lse == fa.NEG_INF).all()


def test_kv_split_covers_the_card_and_the_keys():
    """The wrapper's chunking: B * H * splits at least 2 blocks an SM
    where the keys allow, chunks multiples of 32 within their bounds,
    every key in exactly one chunk."""
    for b, h, tk in ((8, 12, 1024), (1, 12, 1024), (3, 12, 1000),
                     (64, 16, 4096), (1, 1, 20)):
        splits, chunk = fa._kv_split(b, h, tk, 132)
        assert chunk % 32 == 0
        assert fa._MIN_CHUNK <= chunk <= fa._MAX_CHUNK
        assert (splits - 1) * chunk < tk <= splits * chunk
        assert b * h * splits >= min(2 * 132, b * h * -(-tk // 64))


# -- flash head widths above 128 -------------------------------------------------

WIDE_CASES = {
    # h_kv, kwargs of both functions; "kbias" / "bias" make a learnable one
    "causal": (4, dict(causal=True)),
    "gqa_window": (2, dict(causal=True, window=8)),
    "kbias_grad": (4, dict(causal=False, kbias=True)),
    "bias_grad": (4, dict(causal=False, bias=True)),
}


@pytest.mark.parametrize("case", sorted(WIDE_CASES))
@pytest.mark.parametrize("d", [160, 256])
def test_wide_heads_match_jax_pallas_interpret(case, d):
    """Forward and gradients at head width 256 (the widest kernel) and
    160 (run on the card in the 256 kernel): the port's CPU path against
    JAX ``flash_attention`` with the Pallas kernels in interpret mode (B
    1, T 32, blocks of 16): forward 2e-5, gradients (dq, dk, dv and the
    learnable bias's) 5e-4, as ``test_torch_flash_attention.py`` holds
    them at narrower widths."""
    _check_wide_head(case, d)


@pytest.mark.parametrize("case", sorted(WIDE_CASES))
@pytest.mark.parametrize("d", [257, 320, 512])
def test_heads_above_256_match_jax_pallas_interpret(case, d):
    """Widths above the widest kernel, which the card runs in the 256
    kernels in 256-wide column slices (the JAX package takes any width):
    the kernel path's validation takes them (here it refuses the tensors
    only for lying on the CPU), and forward and gradients match JAX's
    Pallas kernels in interpret mode at the tolerances above."""
    assert fa._kernel_dim(d) == fa._kernel_dim(129) == 256
    assert fa._kernel_dim(128) == 128
    wide = torch.zeros((1, 8, 2, d))
    with pytest.raises(ValueError, match="CUDA device"):
        fa._check_kernel_inputs(wide, wide, wide, None, None)
    _check_wide_head(case, d)


def _check_wide_head(case, d):
    h_kv, kw = WIDE_CASES[case]
    kw = dict(kw)
    rng = np.random.RandomState(100 + d)
    q = rng.randn(1, 32, 4, d).astype(np.float32)
    k, v = (rng.randn(1, 32, h_kv, d).astype(np.float32) for _ in range(2))
    g = rng.randn(1, 32, 4, d).astype(np.float32)
    leaves, names = [q, k, v], ["dq", "dk", "dv"]
    if kw.pop("kbias", False):
        leaves.append((0.5 * rng.randn(1, 32)).astype(np.float32))
        names.append("key_padding_bias")
    if kw.pop("bias", False):
        leaves.append(rng.randn(1, 32, 32).astype(np.float32))
        names.append("bias")

    def extra(xs):
        return dict(zip(names[3:], xs[3:]))

    def jloss(*xs):
        out = jflash(*xs[:3], **extra(xs), block_q=16, block_k=16,
                     interpret=True, **kw)
        return jnp.sum(out * g), out

    (_, jout), want = jax.value_and_grad(
        jloss, argnums=tuple(range(len(leaves))), has_aux=True)(
            *(jnp.asarray(x) for x in leaves))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in leaves]
    out = fa.flash_attention(*ts[:3], **extra(ts), **kw)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=2e-5, rtol=2e-5)
    got = torch.autograd.grad((out * torch.from_numpy(g)).sum(), ts)
    for name, gt, wt in zip(names, got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt), err_msg=name,
                                   atol=5e-4, rtol=5e-4)


# -- the per-parity dgrad ------------------------------------------------------

PARITY_CASES = {
    # x shape, w shape, stride, padding, dilation
    "3x3_s2_same_even": ((2, 8, 8, 8), (3, 3, 8, 16), (2, 2),
                         ((0, 1), (0, 1)), (1, 1)),
    "3x3_s2_odd_hw": ((2, 9, 7, 8), (3, 3, 8, 16), (2, 2), ((1, 1), (1, 1)),
                      (1, 1)),
    "1x1_s2": ((2, 8, 8, 8), (1, 1, 8, 16), (2, 2), ((0, 0), (0, 0)),
               (1, 1)),
    "1x1_s2_odd_hw": ((2, 7, 9, 8), (1, 1, 8, 16), (2, 2), ((0, 0), (0, 0)),
                      (1, 1)),
    "7x7_s2_stem": ((1, 14, 14, 3), (7, 7, 3, 8), (2, 2), ((3, 3), (3, 3)),
                    (1, 1)),
    "3x3_s2_dilated": ((2, 12, 12, 8), (3, 3, 8, 16), (2, 2),
                       ((1, 2), (1, 2)), (2, 2)),
    "3x2_s3x2_mixed": ((2, 10, 9, 5), (3, 2, 5, 8), (3, 2), ((1, 1), (0, 1)),
                       (1, 2)),
}


def _parity_inputs(case, seed):
    xs, ws, stride, padding, dilation = PARITY_CASES[case]
    oh, ow = tconv._out_hw(xs[1], xs[2], padding, ws[0], ws[1], *stride,
                           *dilation)
    rs = np.random.RandomState(seed)
    w = (rs.randn(*ws) / np.sqrt(ws[0] * ws[1] * ws[2])).astype(np.float32)
    dy = rs.randn(xs[0], oh, ow, ws[3]).astype(np.float32)
    return dy, w, stride, padding, dilation, xs[1:3]


@pytest.mark.parametrize("case", sorted(PARITY_CASES))
def test_dgrad_parity_plain_version_matches_jax_pallas(case):
    dy, w, stride, padding, dilation, hw = _parity_inputs(case, 80)
    want = jconv._pallas_dgrad(jnp.asarray(dy), jnp.asarray(w), stride,
                               padding, dilation, hw, (None, None), True)
    got = tconv._dgrad_parity_ref(torch.from_numpy(dy), torch.from_numpy(w),
                                  stride, padding, dilation, hw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    plain = tconv._dgrad_ref(torch.from_numpy(dy), torch.from_numpy(w),
                             stride, padding, dilation, hw)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("case", ["3x3_s2_same_even", "1x1_s2",
                                  "7x7_s2_stem"])
def test_dgrad_parity_plain_version_bf16(case):
    """bf16 operands: fp32 sums cast once, within one bf16 ulp of max
    |dx| of the plain dgrad; no tap reaches the odd pixels of a 1x1/2
    conv, which stay exactly zero."""
    dy, w, stride, padding, dilation, hw = _parity_inputs(case, 81)
    tdy, tw = (torch.from_numpy(a).bfloat16() for a in (dy, w))
    got = tconv._dgrad_parity_ref(tdy, tw, stride, padding, dilation, hw)
    want = tconv._dgrad_ref(tdy, tw, stride, padding, dilation, hw)
    assert got.dtype == torch.bfloat16
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2.0 ** -7 * want.float().abs().max().item()
    if w.shape[0] == 1:
        assert not got[:, 1::2].any() and not got[:, :, 1::2].any()


# -- the qmm weight layout -----------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("m,k,n", [(8, 8, 8), (16, 8, 24), (17, 40, 33),
                                   (5, 100, 16)])
def test_qmm_padded_weight_layout_equals_jax(dtype, m, k, n):
    """``weight_layout`` pads qw's K to the next multiple of 16 with zero
    columns; through ``_qmm_ref`` (the kernel's arithmetic, which reads x
    past K as zero) the result equals JAX's Pallas kernel bit for bit."""
    rs = np.random.RandomState(90 + k)
    x = (rs.randn(m, k) * 2).astype(np.float32)
    w = (rs.randn(k, n) / np.sqrt(k)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    xs = float(np.abs(np.asarray(jx, np.float32)).max()) / 127.0 * 0.8
    want = np.asarray(jquant.quantized_matmul(jx, jw, x_scale=xs,
                                              interpret=True), np.float32)
    tx, tw = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    ws = K.channel_scale(tw)
    qw = K.weight_layout(tw, ws)
    kp = -(-k // 16) * 16
    assert qw.shape == (n, kp) and qw.dtype == torch.int8
    assert not qw[:, k:].any()
    got = K._qmm_ref(tx, qw, torch.tensor(xs, dtype=torch.float32), ws, tdt)
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(
        K.quantized_matmul(tx, tw, x_scale=xs).float().numpy(), want)
