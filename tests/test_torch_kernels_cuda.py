"""The port's kernels against their plain versions, on the card.

Imports neither JAX nor the test conftest's JAX set-up, so it runs on a
GPU host without JAX:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Every test is marked ``cuda`` and skips (inside its fixture) where no
CUDA device is visible.
"""

import json
import importlib

import numpy as np
import pytest
import torch

# the packages re-export the functions under the modules' names
fln = importlib.import_module("apex_tpu_torch.normalization.fused_layer_norm")
fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on "
                    "the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("rows", [1024, 8])
def test_layer_norm_kernel_matches_plain(cuda_device, dtype, atol, rows):
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(rows, 768).astype(np.float32)).to(
        cuda_device, dtype)
    w = torch.from_numpy(1 + 0.1 * rng.randn(768).astype(np.float32)).to(
        cuda_device)
    b = torch.from_numpy(0.1 * rng.randn(768).astype(np.float32)).to(
        cuda_device)
    before = fln.layer_norm_fwd_kernel.launches
    got = fln.layer_norm_fwd_kernel(x, w, b, 1e-5)
    torch.cuda.synchronize()
    assert fln.layer_norm_fwd_kernel.launches == before + 1
    want = fln._fwd_ref(x, w, b, 1e-5)
    for g, wnt in zip(got, want):
        torch.testing.assert_close(g.float(), wnt.float(), atol=atol,
                                   rtol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["causal", "bias", "decode", "gqa",
                                  "window"])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
def test_flash_kernel_matches_plain(cuda_device, case, dtype, atol):
    """Ragged lengths (200 is no multiple of the 64-key tile), all three
    query-block sizes (q_len 200 and 1), GQA, window and both biases."""
    tq = 1 if case == "decode" else 200
    h_kv = 2 if case == "gqa" else 4
    rng = np.random.RandomState(12)
    q, k, v = (torch.from_numpy(rng.randn(2, n, hh, 64).astype(np.float32))
               .to(cuda_device, dtype)
               for n, hh in ((tq, 4), (200, h_kv), (200, h_kv)))
    kw = dict(sm_scale=0.125, causal=case != "bias", q_offset=200 - tq,
              window=64 if case == "window" else None)
    bias = kb = None
    if case == "bias":
        bias = torch.randn(2, tq, 200, device=cuda_device)
    if case == "decode":
        kb = torch.where(torch.arange(200, device=cuda_device) < 150,
                         0.0, -1e9)[None].expand(2, 200)
    before = fa.flash_fwd_kernel.launches
    out, lse = fa.flash_fwd_kernel(q, k, v, kb, bias, **kw)
    torch.cuda.synchronize()
    assert fa.flash_fwd_kernel.launches == before + 1
    want_out, want_lse = fa._flash_fwd_ref(q, k, v, kb, bias, **kw)
    torch.testing.assert_close(out.float(), want_out.float(), atol=atol,
                               rtol=atol)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_cuda_calls_needing_grad_raise(cuda_device):
    """Gradients go through the backward kernels: a [B, T, S] bias that
    needs a gradient launches the bias-gradient kernel once, and a
    per-head bias (no kernel, here or in JAX) runs the plain version,
    differentiable, on the card."""
    x = torch.randn(4, 64, device=cuda_device, requires_grad=True)
    before = fln.layer_norm_bwd_kernel.launches
    fln.fused_layer_norm(x, 64).sum().backward()
    assert fln.layer_norm_bwd_kernel.launches == before + 1
    q = torch.randn(1, 8, 2, 32, device=cuda_device, requires_grad=True)
    before = fa.flash_bwd_dq_kernel.launches, fa.flash_bwd_dkv_kernel.launches
    fa.flash_attention(q, q, q, causal=True).sum().backward()
    assert (fa.flash_bwd_dq_kernel.launches,
            fa.flash_bwd_dkv_kernel.launches) == (before[0] + 1,
                                                  before[1] + 1)
    bias = torch.zeros(1, 8, 8, device=cuda_device, requires_grad=True)
    before = fa.flash_bwd_db2_kernel.launches
    fa.flash_attention(q, q, q, bias=bias).sum().backward()
    assert fa.flash_bwd_db2_kernel.launches == before + 1
    assert bias.grad.shape == (1, 8, 8)
    b4 = torch.randn(1, 2, 8, 8, device=cuda_device, requires_grad=True)
    before = fa.flash_fwd_kernel.launches
    out = fa.flash_attention(q, q, q, bias=b4, causal=True)
    assert fa.flash_fwd_kernel.launches == before
    got = torch.autograd.grad(out.sum(), (q, b4))
    cpu = [t.detach().cpu().requires_grad_(True) for t in (q, b4)]
    want = torch.autograd.grad(fa.flash_attention(
        cpu[0], cpu[0], cpu[0], bias=cpu[1], causal=True).sum(), cpu)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_.cpu(), w_, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", [32, 128])
@pytest.mark.parametrize("tq", [1, 20, 70])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
def test_flash_kernel_head_dims(cuda_device, head_dim, tq, dtype, atol):
    """The other two head-dim instantiations, causal with suffix
    alignment, at a decode length and at ragged lengths for each of the
    three query-block sizes."""
    rng = np.random.RandomState(13)
    q, k, v = (torch.from_numpy(rng.randn(3, n, 4, head_dim)
                                .astype(np.float32)).to(cuda_device, dtype)
               for n in (tq, 130, 130))
    kw = dict(sm_scale=head_dim ** -0.5, causal=True, q_offset=130 - tq)
    out, lse = fa.flash_fwd_kernel(q, k, v, None, None, **kw)
    want_out, want_lse = fa._flash_fwd_ref(q, k, v, None, None, **kw)
    torch.testing.assert_close(out.float(), want_out.float(), atol=atol,
                               rtol=atol)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)


# -- backward kernels ---------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("rows,n2,affine", [(1023, 768, True),
                                             (8, 768, True),
                                             (37, 200, False)])
def test_layer_norm_bwd_kernel_matches_plain(cuda_device, dtype, atol, rows,
                                             n2, affine):
    rng = np.random.RandomState(5)
    x, g = (torch.from_numpy(rng.randn(rows, n2).astype(np.float32)).to(
        cuda_device, dtype) for _ in range(2))
    w = None
    if affine:
        w = torch.from_numpy(1 + 0.1 * rng.randn(n2).astype(np.float32)).to(
            cuda_device)
    _, mean, invvar = fln._fwd_ref(x, w, None, 1e-5)
    before = fln.layer_norm_bwd_kernel.launches
    got = fln.layer_norm_bwd_kernel(g, x, mean, invvar, w)
    torch.cuda.synchronize()
    assert fln.layer_norm_bwd_kernel.launches == before + 1
    want = fln._bwd_input_ref(g, x, mean, invvar, w)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=atol)


@pytest.mark.cuda
def test_layer_norm_grads_match_autograd_of_plain_forward(cuda_device):
    """fp32 dx, dgamma, dbeta of the Function on the card against torch
    autograd through the plain forward on the card."""
    rng = np.random.RandomState(6)
    x0 = torch.from_numpy(rng.randn(64, 96).astype(np.float32)).to(
        cuda_device)
    w0 = torch.from_numpy(1 + 0.1 * rng.randn(96).astype(np.float32)).to(
        cuda_device)
    b0 = torch.from_numpy(0.1 * rng.randn(96).astype(np.float32)).to(
        cuda_device)
    g = torch.from_numpy(rng.randn(64, 96).astype(np.float32)).to(
        cuda_device)
    grads = []
    for fwd in (lambda x, w, b: fln.fused_layer_norm(x, 96, w, b),
                lambda x, w, b: fln._fwd_ref(x, w, b, 1e-5)[0]):
        leaves = [t.clone().requires_grad_(True) for t in (x0, w0, b0)]
        grads.append(torch.autograd.grad((fwd(*leaves) * g).sum(), leaves))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def _bwd_case(dev, dtype, *, b=2, tq=200, tk=200, h=4, h_kv=4, d=64,
              causal=True, window=None, kbias=False, bias=False, seed=14):
    rng = np.random.RandomState(seed)
    q, do = (torch.from_numpy(rng.randn(b, tq, h, d).astype(np.float32))
             .to(dev, dtype) for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(b, tk, h_kv, d).astype(np.float32))
            .to(dev, dtype) for _ in range(2))
    kb = bs = None
    if kbias:
        kb = torch.from_numpy(np.where(
            np.arange(tk)[None] < rng.randint(tk // 2, tk, (b, 1)), 0.0,
            -1e9).astype(np.float32) + 0.3 * rng.randn(b, tk).astype(
                np.float32)).to(dev)
    if bias:
        bs = torch.from_numpy(rng.randn(b, tq, tk).astype(np.float32)).to(dev)
    kw = dict(sm_scale=d ** -0.5, causal=causal,
              q_offset=tk - tq if causal else 0, window=window)
    return q, k, v, do, kb, bs, kw


def _check_bwd_kernels(q, k, v, do, kb, bs, kw, atol):
    out, lse = fa._flash_fwd_ref(q, k, v, kb, bs, **kw)
    delta = fa._delta(do, out)
    before = (fa.flash_bwd_dq_kernel.launches,
              fa.flash_bwd_dkv_kernel.launches)
    dq = fa.flash_bwd_dq_kernel(q, k, v, do, lse, delta, kb, bs, **kw)
    dk, dv, part = fa.flash_bwd_dkv_kernel(q, k, v, do, lse, delta, kb, bs,
                                           kbias_grad=kb is not None, **kw)
    torch.cuda.synchronize()
    assert (fa.flash_bwd_dq_kernel.launches,
            fa.flash_bwd_dkv_kernel.launches) == (before[0] + 1,
                                                  before[1] + 1)
    want = fa._flash_bwd_ref(q, k, v, kb, bs, out, lse, do, **kw)
    for name, got, wnt in (("dq", dq, want[0]), ("dk", dk, want[1]),
                           ("dv", dv, want[2])):
        assert got.dtype == q.dtype and got.shape == wnt.shape, name
        torch.testing.assert_close(got.float(), wnt.float(), atol=atol,
                                   rtol=atol, msg=name)
    if kb is not None:
        torch.testing.assert_close(part.sum(1) / kw["sm_scale"], want[3],
                                   atol=atol, rtol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["causal", "full", "gqa4_2", "mqa4_1",
                                  "window", "cross", "kbias", "bias",
                                  "q_tail", "k_tail"])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 3e-2)])
def test_flash_bwd_kernels_match_plain(cuda_device, case, dtype, atol):
    """dQ and dK/dV against the plain version: ragged lengths (200 is no
    multiple of the 64-row tiles), GQA and MQA, window, cross-length
    causal, both biases, and a ragged q tail and k tail on their own."""
    kw = dict(causal=case not in ("full", "bias"))
    kw.update({"gqa4_2": dict(h_kv=2), "mqa4_1": dict(h_kv=1),
               "window": dict(window=50), "cross": dict(tq=70, tk=200),
               "kbias": dict(kbias=True, causal=False),
               "bias": dict(bias=True, kbias=True),
               "q_tail": dict(tq=130, tk=256, causal=False),
               "k_tail": dict(tq=128, tk=190, causal=False)}.get(case, {}))
    _check_bwd_kernels(*_bwd_case(cuda_device, dtype, **kw), atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", [32, 64, 128])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 3e-2)])
def test_flash_bwd_kernels_head_dims(cuda_device, head_dim, dtype, atol):
    _check_bwd_kernels(*_bwd_case(cuda_device, dtype, d=head_dim, tq=100,
                                  tk=150, h=4, h_kv=2, seed=15),
                       atol=atol)


def _check_db2_kernel(q, k, v, do, kb, bs, kw):
    """The bias-gradient kernel against ``_flash_bwd_ref``'s dbias:
    within 1e-4 of max |dbias| (fp32 sums over the heads in another
    order), zeros where the band hides a key."""
    out, lse = fa._flash_fwd_ref(q, k, v, kb, bs, **kw)
    delta = fa._delta(do, out)
    before = fa.flash_bwd_db2_kernel.launches
    got = fa.flash_bwd_db2_kernel(q, k, v, do, lse, delta, kb, bs, **kw)
    torch.cuda.synchronize()
    assert fa.flash_bwd_db2_kernel.launches == before + 1
    want = fa._flash_bwd_ref(q, k, v, kb, bs, out, lse, do, **kw)[4]
    assert got.dtype == torch.float32 and got.shape == want.shape
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-4 * scale
    if kw["causal"]:
        vis = fa._visible(q.shape[1], k.shape[1], kw["q_offset"],
                          kw["window"], q.device)
        assert not got[:, ~vis].any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["full", "causal", "gqa4_2", "window",
                                  "cross", "kbias", "q_tail"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_db2_kernel_matches_plain(cuda_device, case, dtype):
    """Ragged lengths (200), GQA, a window, cross-length causal, a key
    bias beside the [B, T, S] bias, a ragged q tail."""
    kw = dict(bias=True, causal=case not in ("full", "kbias", "q_tail"))
    kw.update({"gqa4_2": dict(h_kv=2), "window": dict(window=50),
               "cross": dict(tq=70, tk=200),
               "kbias": dict(kbias=True),
               "q_tail": dict(tq=130, tk=256)}.get(case, {}))
    _check_db2_kernel(*_bwd_case(cuda_device, dtype, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", [32, 128])
def test_flash_db2_kernel_head_dims(cuda_device, head_dim):
    _check_db2_kernel(*_bwd_case(cuda_device, torch.bfloat16, d=head_dim,
                                 tq=100, tk=150, h=4, h_kv=2, bias=True,
                                 seed=17))


@pytest.mark.cuda
def test_flash_bias_grad_matches_autograd_of_plain_forward(cuda_device):
    """fp32 gradients of q, k, v and a broadcast [B, 1, S] bias through
    the Function on the card against autograd through the plain forward
    on the card."""
    rng = np.random.RandomState(18)
    b, t, h, d = 2, 77, 4, 32
    leaves = [torch.from_numpy(rng.randn(*s).astype(np.float32)).to(
        cuda_device) for s in ((b, t, h, d), (b, t, h, d), (b, t, h, d),
                               (b, 1, t))]
    g = torch.from_numpy(rng.randn(b, t, h, d).astype(np.float32)).to(
        cuda_device)
    grads = []
    for use_kernel in (True, False):
        xs = [x.clone().requires_grad_(True) for x in leaves]
        if use_kernel:
            out = fa.flash_attention(*xs[:3], bias=xs[3], causal=True)
        else:
            out, _ = fa._flash_fwd_ref(*xs[:3], None,
                                       xs[3].expand(b, t, t),
                                       sm_scale=d ** -0.5, causal=True)
        grads.append(torch.autograd.grad((out * g).sum(), xs))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_flash_bwd_fully_masked_rows(cuda_device):
    """Rows whose keys are all hidden by the key-padding bias and rows
    past a window: p must be zero where the band hides a key."""
    q, k, v, do, kb, bs, kw = _bwd_case(cuda_device, torch.float32, tq=96,
                                        tk=96, window=1)
    _check_bwd_kernels(q, k, v, do, kb, bs, kw, atol=1e-4)
    kb = torch.full((2, 96), -1e9, device=cuda_device)
    kw = dict(kw, causal=False, window=None)
    _check_bwd_kernels(q, k, v, do, kb, None, kw, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["causal_gqa", "kbias_window"])
def test_flash_grads_match_autograd_of_plain_forward(cuda_device, case):
    """fp32 gradients of q, k, v (and the key-padding bias) through the
    Function on the card against torch autograd through the plain
    forward on the card, gradcheck-style."""
    rng = np.random.RandomState(16)
    b, t, h, h_kv, d = 2, 77, 4, 2, 32
    leaves = [torch.from_numpy(rng.randn(b, t, n, d).astype(np.float32))
              .to(cuda_device) for n in (h, h_kv, h_kv)]
    g = torch.from_numpy(rng.randn(b, t, h, d).astype(np.float32)).to(
        cuda_device)
    kw = dict(causal=True, window=None)
    if case == "kbias_window":
        leaves.append(torch.from_numpy(
            0.5 * rng.randn(b, t).astype(np.float32)).to(cuda_device))
        kw["window"] = 20
    grads = []
    for use_kernel in (True, False):
        xs = [x.clone().requires_grad_(True) for x in leaves]
        kb = xs[3] if len(xs) > 3 else None
        if use_kernel:
            out = fa.flash_attention(*xs[:3], key_padding_bias=kb, **kw)
        else:
            out, _ = fa._flash_fwd_ref(*xs[:3], kb, None, sm_scale=d ** -0.5,
                                       q_offset=0, **kw)
        grads.append(torch.autograd.grad((out * g).sum(), xs))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


# -- BN epilogue (kernels 4, 5) ------------------------------------------------

fba = importlib.import_module("apex_tpu_torch.normalization.fused_bn_act")
xent = importlib.import_module("apex_tpu_torch.contrib.xentropy")

BN_VARIANTS = [(a, z, r) for a in (True, False) for z in (True, False)
               for r in (True, False)]


def _assert_kernel_close(got, want, dtype, atol):
    """fp32 within ``atol``; bf16 within one bf16 ulp of the plain value
    (2**-7 relative): fp32 sums that differ in their last bit may round
    to neighbouring bf16 values."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), atol=0,
                                   rtol=2 ** -7)
    else:
        torch.testing.assert_close(got, want, atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("affine,with_z,relu", BN_VARIANTS)
@pytest.mark.parametrize("rows,c", [(1000, 64), (333, 200), (77, 2048)])
def test_bn_epilogue_kernels_match_plain(cuda_device, dtype, affine, with_z,
                                         relu, rows, c):
    """Forward and dx/dz kernels against the plain version: ragged row
    blocks (1000, 333 and 77 rows), a channel count that is not a power
    of two with a ragged channel block (200 = 128 + 72), and every
    affine / residual / ReLU variant."""
    rng = np.random.RandomState(20)

    def arr(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy((rng.randn(*shape) * scale + shift)
                                .astype(np.float32)).to(cuda_device)
    x, z, g = (arr(rows, c).to(dtype) for _ in range(3))
    mean, b = arr(c, scale=0.3), arr(c, scale=0.2)
    w = arr(c, scale=0.2, shift=1.0)
    invstd = arr(c).abs() + 0.5
    w, b = (w, b) if affine else (None, None)
    z = z if with_z else None
    before = (fba.bn_act_fwd_kernel.launches, fba.bn_act_bwd_kernel.launches)
    out = fba.bn_act_fwd_kernel(x, mean, invstd, w, b, z, relu)
    dx, dz = fba.bn_act_bwd_kernel(g, x, mean, invstd, w, b, z, relu)
    torch.cuda.synchronize()
    assert (fba.bn_act_fwd_kernel.launches,
            fba.bn_act_bwd_kernel.launches) == (before[0] + 1, before[1] + 1)
    want_dx, *_, want_dz = fba._bwd_ref(g, x, mean, invstd, w, b, z, relu)
    _assert_kernel_close(out, fba._fwd_ref(x, mean, invstd, w, b, z, relu),
                         dtype, 1e-6)
    _assert_kernel_close(dx, want_dx, dtype, 1e-6)
    assert (dz is None) == (z is None)
    if z is not None:
        _assert_kernel_close(dz, want_dz, dtype, 0)


@pytest.mark.cuda
def test_batchnorm_grads_match_autograd_of_plain_forward(cuda_device):
    """fp32 gradients of the whole BatchNorm (statistics tracked by
    autograd, the epilogue's Function with its kernels and channel sums)
    against autograd through the plain epilogue, on the card."""
    from apex_tpu_torch.parallel.sync_batchnorm import _global_moments
    rng = np.random.RandomState(21)
    x0, z0, g = (torch.from_numpy(rng.randn(4, 9, 9, 40).astype(np.float32))
                 .to(cuda_device) for _ in range(3))
    w0 = torch.from_numpy(1 + 0.2 * rng.randn(40).astype(np.float32)).to(
        cuda_device)
    b0 = torch.from_numpy(0.2 * rng.randn(40).astype(np.float32)).to(
        cuda_device)
    grads = []
    for epilogue in (fba.bn_relu_residual,
                     lambda *a, z, relu: fba._fwd_ref(*a, z, relu)):
        leaves = [t.clone().requires_grad_(True) for t in (x0, w0, b0, z0)]
        x, w, b, z = leaves
        mean, var, _ = _global_moments(x, (0, 1, 2))
        y = epilogue(x, mean, torch.rsqrt(var + 1e-5), w, b, z=z, relu=True)
        grads.append(torch.autograd.grad((y * g).sum(), leaves))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


# -- softmax cross-entropy (kernels 6, 7) -----------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("n,v,dtype", [(37, 1000, torch.float32),
                                       (6, 50257, torch.float32),
                                       (9, 4097, torch.float32),
                                       (37, 1000, torch.bfloat16),
                                       (6, 50257, torch.bfloat16)])
def test_xentropy_kernels_match_plain(cuda_device, smoothing, n, v, dtype):
    """Losses, ``mlse`` and ``dx`` against the plain version: one chunk
    (V 1000), a one-column tail chunk (4097 = 4096 + 1), the LM vocabulary
    (50257 = 12 x 4096 + 1105), padding rows (label -1 picks no logit,
    zero g), bf16 logits."""
    rng = np.random.RandomState(22)
    x = torch.from_numpy((3 * rng.randn(n, v)).astype(np.float32)).to(
        cuda_device, dtype)
    labels = torch.from_numpy(rng.randint(0, v, n).astype(np.int32)).to(
        cuda_device)
    labels[::4] = -1
    g = torch.from_numpy(rng.rand(n).astype(np.float32)).to(cuda_device)
    g = torch.where(labels == -1, 0.0, g)
    before = (xent.xentropy_fwd_kernel.launches,
              xent.xentropy_bwd_kernel.launches)
    loss, mlse = xent.xentropy_fwd_kernel(x, labels, smoothing)
    dx = xent.xentropy_bwd_kernel(g, x, mlse, labels, smoothing)
    torch.cuda.synchronize()
    assert (xent.xentropy_fwd_kernel.launches,
            xent.xentropy_bwd_kernel.launches) == (before[0] + 1,
                                                   before[1] + 1)
    want_loss, want_mlse = xent._fwd_ref(x, labels, smoothing)
    torch.testing.assert_close(loss, want_loss, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(mlse, want_mlse, atol=1e-4, rtol=1e-5)
    want_dx = xent._bwd_ref(g, x, mlse, labels, smoothing)
    if dtype == torch.bfloat16:
        torch.testing.assert_close(dx.float(), want_dx.float(), atol=1e-6,
                                   rtol=2 ** -7)
    else:
        torch.testing.assert_close(dx, want_dx, atol=1e-5, rtol=0)
    assert not dx[::4].any()


@pytest.mark.cuda
def test_xentropy_function_grads_match_autograd_of_plain(cuda_device):
    rng = np.random.RandomState(23)
    x0 = torch.from_numpy(rng.randn(50, 300).astype(np.float32)).to(
        cuda_device)
    labels = torch.from_numpy(rng.randint(0, 300, 50)).to(cuda_device)
    labels[::7] = 0
    got_x = x0.clone().requires_grad_(True)
    losses = xent.softmax_cross_entropy_loss(got_x, labels, 0.1, 0)
    losses.mean().backward()
    want_x = x0.clone().requires_grad_(True)
    logp = torch.log_softmax(want_x, dim=-1)
    want = -(0.9 * logp.gather(1, labels[:, None])[:, 0]
             + 0.1 * logp.mean(-1))
    want = torch.where(labels == 0, 0.0, want)
    want.mean().backward()
    torch.testing.assert_close(losses.detach(), want.detach(), atol=1e-5,
                               rtol=1e-5)
    torch.testing.assert_close(got_x.grad, want_x.grad, atol=1e-6,
                               rtol=1e-5)


# -- NHWC implicit-GEMM conv (kernels 1-3) -----------------------------------------

cv = importlib.import_module("apex_tpu_torch.ops.conv")


@pytest.fixture
def conv_device(cuda_device):
    """The card, with cuDNN's TF32 off while the test runs: the plain
    fp32 conv is then full fp32, like the kernel's FMA path."""
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield cuda_device
    torch.backends.cudnn.allow_tf32 = tf32

CONV_CASES = {
    # x shape, w shape, stride, padding ((pt, pb), (pl, pr)), dilation
    "3x3_s1": ((4, 14, 14, 64), (3, 3, 64, 64), (1, 1), ((1, 1), (1, 1)),
               (1, 1)),
    "3x3_s2_same_even": ((4, 14, 14, 32), (3, 3, 32, 64), (2, 2),
                         ((0, 1), (0, 1)), (1, 1)),
    "1x1_s2": ((4, 14, 14, 64), (1, 1, 64, 128), (2, 2), ((0, 0), (0, 0)),
               (1, 1)),
    "stem_c3": ((2, 32, 32, 3), (7, 7, 3, 64), (2, 2), ((3, 3), (3, 3)),
                (1, 1)),
    "ragged_c5_o8": ((3, 9, 7, 5), (3, 3, 5, 8), (2, 1), ((1, 1), (0, 2)),
                     (1, 1)),
    "dilated": ((2, 12, 12, 16), (3, 3, 16, 24), (1, 1), ((0, 0), (0, 0)),
                (2, 2)),
    "wgrad_many_splits": ((8, 28, 28, 16), (3, 3, 16, 16), (1, 1),
                          ((1, 1), (1, 1)), (1, 1)),
    # M, N and K all ragged against the 128 x 128 tile and K step of 32
    "ragged_c40_o130": ((3, 11, 9, 40), (3, 3, 40, 130), (1, 1),
                        ((1, 1), (1, 1)), (1, 1)),
}


def _conv_tol_ok(got, want, dtype):
    """fp32: within 1e-4 of max |plain| (summation order only); bf16:
    within one bf16 ulp of max |plain| (2**-7 of it)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    tol = (2.0 ** -7 if dtype == torch.bfloat16 else 1e-4) * scale
    assert err <= tol, (err, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv_kernels_match_plain(conv_device, case, dtype):
    """Forward, dgrad and wgrad against their plain versions: channels
    multiples of 8 and ragged ones the wrapper pads (C = 3, C = 5 / O = 8,
    C = 40 / O = 130 with M and K ragged too), asymmetric and dilated
    taps, a wgrad split many ways."""
    xs, ws, stride, padding, dilation = CONV_CASES[case]
    gen = torch.Generator(device=conv_device).manual_seed(30)
    x = torch.randn(xs, device=conv_device, generator=gen).to(dtype)
    w = (torch.randn(ws, device=conv_device, generator=gen)
         / (ws[0] * ws[1] * ws[2]) ** 0.5).to(dtype)
    oh, ow = cv._out_hw(xs[1], xs[2], padding, ws[0], ws[1], *stride,
                        *dilation)
    dy = torch.randn((xs[0], oh, ow, ws[3]), device=conv_device,
                     generator=gen).to(dtype)
    counters = (cv.conv_fwd_kernel, cv.conv_dgrad_kernel,
                cv.conv_wgrad_kernel)
    before = [c.launches for c in counters]
    out, pre = cv.conv_fwd_kernel(x, w, stride, padding, dilation)
    dx = cv.conv_dgrad_kernel(dy, w, stride, padding, dilation, xs[1:3])
    dw = cv.conv_wgrad_kernel(x, dy, stride, padding, dilation, ws[:2])
    torch.cuda.synchronize()
    assert pre is None
    assert [c.launches for c in counters] == [b + 1 for b in before]
    _conv_tol_ok(out, cv._fwd_ref(x, w, stride, padding, dilation)[0], dtype)
    _conv_tol_ok(dx, cv._dgrad_ref(dy, w, stride, padding, dilation,
                                   xs[1:3]), dtype)
    _conv_tol_ok(dw, cv._wgrad_ref(x, dy, stride, padding, dilation,
                                   ws[:2]), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("affine,with_z,relu", BN_VARIANTS)
def test_conv_epilogue_equals_conv_then_plain_epilogue(conv_device, dtype,
                                                       affine, with_z, relu):
    """The fused epilogue equals the kernel's own conv followed by the
    plain ``fused_bn_act._fwd_ref``, bit for bit, and the pre-activation
    equals that conv."""
    fba_ = importlib.import_module("apex_tpu_torch.normalization.fused_bn_act")
    gen = torch.Generator(device=conv_device).manual_seed(31)
    xs, ws = (2, 10, 10, 32), (3, 3, 32, 40)
    pads = ((1, 1), (1, 1))
    x = torch.randn(xs, device=conv_device, generator=gen).to(dtype)
    w = (0.1 * torch.randn(ws, device=conv_device, generator=gen)).to(dtype)
    mean = 0.3 * torch.randn(40, device=conv_device, generator=gen)
    invstd = torch.rand(40, device=conv_device, generator=gen) + 0.5
    scale = 1 + 0.2 * torch.randn(40, device=conv_device, generator=gen)
    bias = 0.2 * torch.randn(40, device=conv_device, generator=gen)
    z = torch.randn((2, 10, 10, 40), device=conv_device,
                    generator=gen).to(dtype)
    scale, bias = (scale, bias) if affine else (None, None)
    z = z if with_z else None
    y, _ = cv.conv_fwd_kernel(x, w, (1, 1), pads, (1, 1))
    out, pre = cv.conv_fwd_kernel(x, w, (1, 1), pads, (1, 1), mean, invstd,
                                  scale, bias, z, relu, want_preact=True)
    torch.cuda.synchronize()
    assert torch.equal(pre, y)
    assert torch.equal(out, fba_._fwd_ref(y, mean, invstd, scale, bias, z,
                                          relu))


@pytest.mark.cuda
def test_conv_function_grads_match_cpu(conv_device):
    """fp32 ``conv2d`` with an epilogue through autograd on the card (the
    three kernels) against the CPU's plain path; an input that needs no
    gradient launches no dgrad kernel."""
    rng = np.random.RandomState(32)
    arrs = [rng.randn(*s).astype(np.float32) for s in
            ((2, 9, 9, 16), (3, 3, 16, 24), (24,), (24,), (24,), (24,),
             (2, 5, 5, 24))]
    arrs[1] /= 12.0
    arrs[3] = np.abs(arrs[3]) + 0.5
    res = {}
    for dev in (conv_device, torch.device("cpu")):
        ts = [torch.from_numpy(a).to(dev).requires_grad_(True) for a in arrs]
        x, w, mean, invstd, scale, bias, z = ts
        out = cv.conv2d(x, w, stride=2, mean=mean, invstd=invstd,
                        scale=scale, bias=bias, z=z, relu=True)
        res[dev.type] = [out] + list(torch.autograd.grad(
            torch.sin(out).sum(), ts))
    for got, want in zip(res["cuda"], res["cpu"]):
        scale_ = want.abs().max().item()
        err = (got.detach().cpu() - want.detach()).abs().max().item()
        assert err <= 1e-4 * max(scale_, 1.0), (err, scale_)
    before = cv.conv_dgrad_kernel.launches, cv.conv_wgrad_kernel.launches
    x = torch.from_numpy(arrs[0]).to(conv_device)
    w = torch.from_numpy(arrs[1]).to(conv_device).requires_grad_(True)
    torch.autograd.grad(cv.conv2d(x, w).sum(), w)
    assert (cv.conv_dgrad_kernel.launches,
            cv.conv_wgrad_kernel.launches) == (before[0], before[1] + 1)


# every distinct conv site of ResNet-50 (224 x 224, stride on the 3x3 and
# the projection, flax 'SAME' pads): x shape at B 2, w shape, stride
RESNET50_SITES = {
    "stem": ((2, 224, 224, 3), (7, 7, 3, 64), 2),
    "s1_1x1_64": ((2, 56, 56, 64), (1, 1, 64, 64), 1),
    "s1_3x3": ((2, 56, 56, 64), (3, 3, 64, 64), 1),
    "s1_1x1_256": ((2, 56, 56, 64), (1, 1, 64, 256), 1),
    "s1_1x1_in256": ((2, 56, 56, 256), (1, 1, 256, 64), 1),
    "s2_1x1_in": ((2, 56, 56, 256), (1, 1, 256, 128), 1),
    "s2_3x3_s2": ((2, 56, 56, 128), (3, 3, 128, 128), 2),
    "s2_1x1_512": ((2, 28, 28, 128), (1, 1, 128, 512), 1),
    "s2_proj": ((2, 56, 56, 256), (1, 1, 256, 512), 2),
    "s2_1x1_in512": ((2, 28, 28, 512), (1, 1, 512, 128), 1),
    "s2_3x3": ((2, 28, 28, 128), (3, 3, 128, 128), 1),
    "s3_1x1_in": ((2, 28, 28, 512), (1, 1, 512, 256), 1),
    "s3_3x3_s2": ((2, 28, 28, 256), (3, 3, 256, 256), 2),
    "s3_1x1_1024": ((2, 14, 14, 256), (1, 1, 256, 1024), 1),
    "s3_proj": ((2, 28, 28, 512), (1, 1, 512, 1024), 2),
    "s3_1x1_in1024": ((2, 14, 14, 1024), (1, 1, 1024, 256), 1),
    "s3_3x3": ((2, 14, 14, 256), (3, 3, 256, 256), 1),
    "s4_1x1_in": ((2, 14, 14, 1024), (1, 1, 1024, 512), 1),
    "s4_3x3_s2": ((2, 14, 14, 512), (3, 3, 512, 512), 2),
    "s4_1x1_2048": ((2, 7, 7, 512), (1, 1, 512, 2048), 1),
    "s4_proj": ((2, 14, 14, 1024), (1, 1, 1024, 2048), 2),
    "s4_1x1_in2048": ((2, 7, 7, 2048), (1, 1, 2048, 512), 1),
    "s4_3x3": ((2, 7, 7, 512), (3, 3, 512, 512), 1),
}


def _bf16_ordered(t):
    """bf16 bit patterns mapped to integers that order like the values."""
    i = t.contiguous().view(torch.int16).to(torch.int32)
    return torch.where(i < 0, -(i & 0x7FFF), i)


def _wgrad_fp64(x, dy, stride, padding, kernel_size):
    """The weight gradient summed in fp64, rounded once to x's type."""
    (pt, pb), (pl_, pr) = padding
    xd = torch.nn.functional.pad(x.double().permute(0, 3, 1, 2),
                                 (pl_, pr, pt, pb))
    dyd = dy.double().permute(0, 3, 1, 2).contiguous()
    wd = torch.zeros((dy.shape[3], x.shape[3], *kernel_size),
                     dtype=torch.float64, device=x.device)
    dw = torch.ops.aten.convolution_backward(
        dyd, xd.contiguous(), wd, None, list(stride), [0, 0], [1, 1], False,
        [0, 0], 1, [False, True, False])[1]
    return dw.permute(2, 3, 1, 0).to(x.dtype)


def _conv_err_ok(got, want, exact=None):
    """The smoke run's conv tolerance: fp16 within one fp16 ulp of max
    |plain|; bf16 within one bf16 ulp of max |plain| and 99.9% of the
    elements within one ulp of their own value, the plain one or
    ``exact`` where given (wgrad: the fp64 sum)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    if got.dtype == torch.float16:
        assert err <= 2.0 ** -10 * scale, (err, scale)
        return
    assert err <= 2.0 ** -7 * scale, (err, scale)
    ref = want if exact is None else exact
    within = ((_bf16_ordered(got) - _bf16_ordered(ref)).abs() <= 1).float()
    assert within.mean().item() >= 0.999, within.mean().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("site", sorted(RESNET50_SITES))
def test_conv_kernels_resnet50_sites(conv_device, site, dtype):
    """Forward, dgrad (not at the stem, whose input needs none) and wgrad
    at every distinct ResNet-50 conv site, B 2: both tile widths, the
    padded C = 3 stem, the stride-2 parity dgrad; within one ulp of max
    |plain| and 99.9% of bf16 elements within one ulp (wgrad: of the
    fp64 sum)."""
    xs, ws, s = RESNET50_SITES[site]
    stride, dil = (s, s), (1, 1)
    padding = cv._norm_padding("SAME" if ws[0] != 7 else ((3, 3), (3, 3)),
                               xs[1], xs[2], ws[0], ws[1], s, s, 1, 1)
    gen = torch.Generator(device=conv_device).manual_seed(36)
    x = torch.randn(xs, device=conv_device, generator=gen).to(dtype)
    w = (torch.randn(ws, device=conv_device, generator=gen)
         / (ws[0] * ws[1] * ws[2]) ** 0.5).to(dtype)
    oh, ow = cv._out_hw(xs[1], xs[2], padding, ws[0], ws[1], s, s, 1, 1)
    dy = torch.randn((xs[0], oh, ow, ws[3]), device=conv_device,
                     generator=gen).to(dtype)
    out, _ = cv.conv_fwd_kernel(x, w, stride, padding, dil)
    _conv_err_ok(out, cv._fwd_ref(x, w, stride, padding, dil)[0])
    if xs[3] != 3:
        dx = cv.conv_dgrad_kernel(dy, w, stride, padding, dil, xs[1:3])
        _conv_err_ok(dx, cv._dgrad_ref(dy, w, stride, padding, dil,
                                       xs[1:3]))
    dw = cv.conv_wgrad_kernel(x, dy, stride, padding, dil, ws[:2])
    _conv_err_ok(dw, cv._wgrad_ref(x, dy, stride, padding, dil, ws[:2]),
                 _wgrad_fp64(x, dy, stride, padding, ws[:2]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_conv_epilogue_wide_tile_equals_conv_then_plain_epilogue(
        conv_device, dtype):
    """The epilogue at O = 256 (the 128-wide tile; the ResNet expansion
    1x1 with BN, residual and ReLU) and at a ragged O = 130 (padded to
    136 by the wrapper): bit for bit the kernel's conv followed by the
    plain ``fused_bn_act._fwd_ref``."""
    fba_ = importlib.import_module("apex_tpu_torch.normalization.fused_bn_act")
    gen = torch.Generator(device=conv_device).manual_seed(37)
    for xs, ws in (((2, 12, 12, 64), (1, 1, 64, 256)),
                   ((2, 9, 9, 24), (3, 3, 24, 130))):
        o = ws[3]
        pads = ((ws[0] // 2,) * 2,) * 2
        x = torch.randn(xs, device=conv_device, generator=gen).to(dtype)
        w = (0.1 * torch.randn(ws, device=conv_device, generator=gen)).to(
            dtype)
        mean = 0.3 * torch.randn(o, device=conv_device, generator=gen)
        invstd = torch.rand(o, device=conv_device, generator=gen) + 0.5
        scale = 1 + 0.2 * torch.randn(o, device=conv_device, generator=gen)
        bias = 0.2 * torch.randn(o, device=conv_device, generator=gen)
        z = torch.randn((*xs[:3], o), device=conv_device,
                        generator=gen).to(dtype)
        y, _ = cv.conv_fwd_kernel(x, w, (1, 1), pads, (1, 1))
        out, pre = cv.conv_fwd_kernel(x, w, (1, 1), pads, (1, 1), mean,
                                      invstd, scale, bias, z, True,
                                      want_preact=True)
        torch.cuda.synchronize()
        assert out.shape == y.shape == (*xs[:3], o)
        assert torch.equal(pre, y)
        assert torch.equal(out, fba_._fwd_ref(y, mean, invstd, scale, bias,
                                              z, True))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_kernels_bit_stable(conv_device, dtype):
    """Two runs of each kernel on the same inputs give the same bits:
    wgrad split over many blocks and reduced in order, no atomics."""
    gen = torch.Generator(device=conv_device).manual_seed(38)
    x = torch.randn((16, 28, 28, 64), device=conv_device,
                    generator=gen).to(dtype)
    w = (torch.randn((3, 3, 64, 128), device=conv_device, generator=gen)
         / 24.0).to(dtype)
    dy = torch.randn((16, 14, 14, 128), device=conv_device,
                     generator=gen).to(dtype)
    args = ((2, 2), ((0, 1), (0, 1)), (1, 1))
    runs = [(cv.conv_fwd_kernel(x, w, *args)[0],
             cv.conv_dgrad_kernel(dy, w, *args, (28, 28)),
             cv.conv_wgrad_kernel(x, dy, *args, (3, 3))) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_conv_kernels_refuse_what_they_do_not_take(conv_device):
    x = torch.randn((2, 8, 8, 16), device=conv_device)
    w = torch.randn((3, 3, 16, 16), device=conv_device)
    pads = ((1, 1), (1, 1))
    with pytest.raises(TypeError):
        cv.conv_fwd_kernel(x, w.to(torch.bfloat16), (1, 1), pads, (1, 1))
    with pytest.raises(ValueError, match="contiguous"):
        cv.conv_fwd_kernel(x.transpose(1, 2), w, (1, 1), pads, (1, 1))
    with pytest.raises(TypeError):
        cv.conv_fwd_kernel(x.double(), w.double(), (1, 1), pads, (1, 1))
    with pytest.raises(ValueError, match="output shape"):
        cv.conv_dgrad_kernel(x[:, :4], w, (1, 1), pads, (1, 1), (8, 8))


# -- int8 quantized matmul (kernel 14) ----------------------------------------------

qk = importlib.import_module("apex_tpu_torch.quant.kernels")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(32, 64, 48), (17, 96, 130), (8, 16, 8),
                                   (200, 768, 300), (64, 3072, 96),
                                   (65, 48, 129)])
def test_qmm_kernel_equals_plain_bit_for_bit(cuda_device, dtype, m, k, n):
    """The kernel against ``_qmm_ref`` on the same inputs, bit for bit:
    ragged M and N (both tile configurations: M <= 64 and above), a K
    tail of 32 and of 48 bytes, a zero-amax weight column, bf16 and fp32
    in and out."""
    rng = np.random.RandomState(40)
    x = torch.from_numpy((rng.randn(m, k) * 2).astype(np.float32)).to(
        cuda_device, dtype)
    w = torch.from_numpy((rng.randn(k, n) / np.sqrt(k)).astype(np.float32))
    w[:, n // 2] = 0.0
    w = w.to(cuda_device, dtype)
    ws = qk.channel_scale(w)
    qw = qk.quantize(w, ws[None, :]).t().contiguous()
    # a scale below the absmax, so some elements clip
    xs = torch.tensor(x.float().abs().max().item() / 127.0 * 0.8,
                      device=cuda_device)
    for out_dtype in (dtype, torch.float32):
        before = qk.qmm_kernel.launches
        got = qk.qmm_kernel(x, qw, xs, ws, out_dtype)
        torch.cuda.synchronize()
        assert qk.qmm_kernel.launches == before + 1
        want = qk._qmm_ref(x, qw, xs, ws, out_dtype)
        assert got.dtype == out_dtype and got.shape == (m, n)
        assert torch.equal(got, want)
    assert not got[:, n // 2].any()


@pytest.mark.cuda
def test_quantized_matmul_on_card_equals_cpu(cuda_device):
    """The public op on CUDA (the kernel) equals the CPU's (the plain
    version) bit for bit, and its straight-through gradients run plain
    matmuls: one kernel launch for forward and backward together."""
    rng = np.random.RandomState(41)
    x = torch.from_numpy(rng.randn(3, 40, 64).astype(np.float32))
    w = torch.from_numpy((rng.randn(64, 80) / 8).astype(np.float32))
    outs = {}
    for dev in (cuda_device, torch.device("cpu")):
        xd = x.to(dev, torch.bfloat16).requires_grad_(True)
        wd = w.to(dev, torch.bfloat16).requires_grad_(True)
        before = qk.qmm_kernel.launches
        out = qk.quantized_matmul(xd, wd, x_scale=0.03)
        out.float().sum().backward()
        outs[dev.type] = (out.detach().cpu(), xd.grad.cpu(), wd.grad.cpu(),
                          qk.qmm_kernel.launches - before)
    assert torch.equal(outs["cuda"][0], outs["cpu"][0])
    assert outs["cuda"][3] == 1 and outs["cpu"][3] == 0
    for g_, w_ in zip(outs["cuda"][1:3], outs["cpu"][1:3]):
        torch.testing.assert_close(g_.float(), w_.float(), atol=0,
                                   rtol=2 ** -7)
    ref = qk.quantized_matmul(x.to(cuda_device, torch.bfloat16),
                              w.to(cuda_device, torch.bfloat16),
                              x_scale=0.03, impl="jnp")
    assert torch.equal(ref.cpu(), outs["cpu"][0])


@pytest.mark.cuda
def test_qmm_kernel_refuses_what_it_does_not_take(cuda_device):
    x = torch.zeros((4, 24), device=cuda_device)
    qw = torch.zeros((8, 24), dtype=torch.int8, device=cuda_device)
    xs, ws = torch.ones((), device=cuda_device), torch.ones(8,
                                                            device=cuda_device)
    with pytest.raises(ValueError, match="multiple of 16"):
        qk.qmm_kernel(x, qw, xs, ws, torch.float32)
    with pytest.raises(TypeError):
        qk.qmm_kernel(x[:, :16].double(), qw[:, :16], xs, ws, torch.float32)
    with pytest.raises(ValueError, match="16-byte"):
        qk.qmm_kernel(x[:, :16].contiguous(),
                      torch.zeros(144, dtype=torch.int8,
                                  device=cuda_device)[2:130].view(8, 16),
                      xs, ws, torch.float32)


# -- head widths, fp16 and the LayerNorm variance -------------------------------

@pytest.mark.cuda
def test_layer_norm_kernel_takes_jax_single_pass_variance(cuda_device):
    """Rows of mean ~100 and spread ~1 built from quarters, so every sum
    of x and of x*x is exact in fp32 and the single-pass variance
    E[x^2] - mean^2 differs from the two-pass one only by the rounding of
    mean^2.  The kernel follows the plain version (and JAX) to within two
    fp32 ulps of invvar (rsqrt against 1 / sqrt), ten times closer than
    the two-pass formula comes."""
    rng = np.random.RandomState(5)
    x = torch.from_numpy((100.0 + rng.randint(-8, 9, (64, 64)) / 4.0)
                         .astype(np.float32)).to(cuda_device)
    out, mean, invvar = fln.layer_norm_fwd_kernel(x, None, None, 1e-5)
    want_out, want_mean, want_inv = fln._fwd_ref(x, None, None, 1e-5)
    xc = x - x.mean(1, keepdim=True)
    two_pass = torch.rsqrt((xc * xc).mean(1) + 1e-5)
    kern_err = (invvar - want_inv).abs().max().item()
    two_err = (two_pass - want_inv).abs().max().item()
    assert torch.equal(mean, want_mean)
    assert kern_err <= 2 * 2.0 ** -23 * want_inv.abs().max().item()
    assert two_err > 10 * kern_err, (two_err, kern_err)
    torch.testing.assert_close(out, want_out, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", [16, 48, 160, 200, 256, 257, 320,
                                      512, 576])
@pytest.mark.parametrize("tq", [1, 5, 20, 130])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2),
                                        (torch.float16, 2e-2)])
def test_flash_kernel_other_widths_and_fp16(cuda_device, head_dim, tq,
                                            dtype, atol):
    """Head widths 16 (its own instantiation), 48 (run in the 64 one, the
    missing columns read as zero and never stored), 160, 200, 256 (the
    256 instantiation: the SIMT kernel in every dtype) and 257, 320, 512,
    576 (the 256 kernels in 256-wide column slices), at decode lengths
    (the split-KV path, q_len < 16) and prefill lengths (the tensor-core
    path up to 128), with GQA, a key bias and a [B, T, S] bias; fp16 held
    as bf16 is."""
    rng = np.random.RandomState(19)
    q, k, v = (torch.from_numpy(rng.randn(2, n, hh, head_dim)
                                .astype(np.float32)).to(cuda_device, dtype)
               for n, hh in ((tq, 4), (150, 2), (150, 2)))
    kb = torch.from_numpy(np.where(np.arange(150)[None] < [[120], [150]],
                                   0.0, -1e9).astype(np.float32)).to(
        cuda_device)
    bias = torch.from_numpy(rng.randn(2, tq, 150).astype(np.float32)).to(
        cuda_device)
    for kw, kbias, bs in ((dict(causal=True, q_offset=150 - tq), kb, None),
                          (dict(causal=False), None, bias)):
        kw = dict(kw, sm_scale=head_dim ** -0.5)
        out, lse = fa.flash_fwd_kernel(q, k, v, kbias, bs, **kw)
        want_out, want_lse = fa._flash_fwd_ref(q, k, v, kbias, bs, **kw)
        assert out.dtype == dtype and out.shape == q.shape
        torch.testing.assert_close(out.float(), want_out.float(), atol=atol,
                                   rtol=atol)
        torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_kernel_lm_shape(cuda_device, dtype):
    """The LM's training call: B 8, T 1023 (no multiple of the 64-row
    tile), 12 heads of 64, causal: out within 2e-2, lse within 1e-3."""
    gen = torch.Generator(device=cuda_device).manual_seed(20)
    q, k, v = (torch.randn((8, 1023, 12, 64), device=cuda_device,
                           generator=gen).to(dtype) for _ in range(3))
    kw = dict(sm_scale=0.125, causal=True)
    out, lse = fa.flash_fwd_kernel(q, k, v, None, None, **kw)
    want_out, want_lse = fa._flash_fwd_ref(q, k, v, None, None, **kw)
    torch.testing.assert_close(out.float(), want_out.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("tk,window,q_offset", [(1000, None, None),
                                                (777, 64, None),
                                                (300, None, -3)])
def test_flash_split_kv_decode(cuda_device, tk, window, q_offset):
    """The split-KV path (``route="split"``: the rule runs these bf16
    calls on the decode kernel) against the plain version and against its
    own plain arithmetic (``_flash_fwd_split_ref`` at the wrapper's
    chunk): kv_len no multiple of the chunk, a window that leaves most
    chunks wholly masked, and rows that see no key at all (a negative
    offset: out 0, lse NEG_INF).  One call counts one launch."""
    rng = np.random.RandomState(21)
    tq = 2
    q = torch.from_numpy(rng.randn(3, tq, 12, 64).astype(np.float32)).to(
        cuda_device, torch.bfloat16)
    k, v = (torch.from_numpy(rng.randn(3, tk, 12, 64).astype(np.float32))
            .to(cuda_device, torch.bfloat16) for _ in range(2))
    kb = torch.from_numpy(np.where(np.arange(tk)[None] < [[tk // 3], [tk],
                                                           [tk - 7]],
                                   0.0, -1e9).astype(np.float32)).to(
        cuda_device)
    kw = dict(sm_scale=0.125, causal=True, window=window,
              q_offset=tk - tq if q_offset is None else q_offset)
    before = fa.flash_fwd_kernel.launches
    split_before = fa.flash_fwd_kernel.routes["split"]
    out, lse = fa.flash_fwd_kernel(q, k, v, kb, None, route="split", **kw)
    torch.cuda.synchronize()
    assert fa.flash_fwd_kernel.launches == before + 1
    assert fa.flash_fwd_kernel.routes["split"] == split_before + 1
    splits, chunk = fa._kv_split(3, 12, tk, fa._sm_count(0))
    assert splits > 1 and tk % chunk != 0
    for ref in (fa._flash_fwd_ref(q, k, v, kb, None, **kw),
                fa._flash_fwd_split_ref(q, k, v, kb, None, chunk=chunk,
                                        **kw)):
        torch.testing.assert_close(out.float(), ref[0].float(), atol=2e-2,
                                   rtol=2e-2)
        torch.testing.assert_close(lse, ref[1], atol=1e-3, rtol=1e-3)
    if q_offset is not None:
        assert not out[:, :-q_offset].any()
        assert (lse[..., :-q_offset] == fa.NEG_INF).all()


#: the decode kernel's cases: (batch, q_len, kv_len, heads, kv heads,
#: width, dtype, window, q_offset (None: kv_len - q_len), chunk (None:
#: the rule's))
DECODE_CASES = {
    # serving's step: 4 chunks merged in a cluster
    "serving_b8_tk1024": (8, 1, 1024, 12, 12, 64, torch.bfloat16, None,
                          None, None),
    "serving_b8_tk256": (8, 1, 256, 12, 12, 64, torch.bfloat16, None, None,
                         None),
    # GQA 12/4: 3 rows a block, 8 chunks in a cluster
    "gqa12_4_tk1024": (8, 1, 1024, 12, 4, 64, torch.bfloat16, None, None,
                       None),
    # kv_len no multiple of a 32-key stage, width 128, fp16
    "ragged_d128_fp16": (3, 1, 1000, 12, 12, 128, torch.float16, None,
                         None, None),
    # kv_len below one stage: one chunk, written directly
    "below_one_stage": (2, 1, 20, 4, 2, 64, torch.bfloat16, None, None,
                        None),
    # 32 chunks: the ticket's merge
    "ticket_32_chunks": (2, 3, 1000, 8, 8, 64, torch.bfloat16, None, None,
                         32),
    # 45 rows a block (q_len 15 x 3 heads): the general PV pass, the ticket
    "tq15_gqa": (2, 15, 300, 12, 4, 64, torch.bfloat16, None, None, None),
    # 45 rows past width 128's 32 a block: two row blocks
    "tq15_gqa_d128": (2, 15, 300, 12, 4, 128, torch.float16, None, None,
                      None),
    # width 48 in the 64 kernel, a window leaving early chunks empty
    "window_d48": (2, 4, 777, 12, 4, 48, torch.bfloat16, 64, None, None),
    # rows that see no key (a negative offset): out 0, lse NEG_INF
    "no_visible_key": (3, 2, 300, 12, 12, 64, torch.bfloat16, None, -3,
                       None),
    # one KV head for 32 query heads at q_len 15: 30 row blocks
    "mqa_480_rows": (2, 15, 512, 32, 1, 64, torch.bfloat16, None, None,
                     512),
}


def _decode_inputs(dev, case, seed=31):
    b, tq, tk, h, h_kv, d, dtype, window, q_offset, chunk = \
        DECODE_CASES[case]
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.randn(b, tq, h, d).astype(np.float32)).to(
        dev, dtype)
    k, v = (torch.from_numpy(rng.randn(b, tk, h_kv, d).astype(np.float32))
            .to(dev, dtype) for _ in range(2))
    lens = rng.randint(max(1, tk // 3), tk + 1, b)
    kb = torch.from_numpy(np.where(np.arange(tk)[None] < lens[:, None],
                                   0.0, -1e9).astype(np.float32)).to(dev)
    kw = dict(sm_scale=d ** -0.5, causal=True, window=window,
              q_offset=tk - tq if q_offset is None else q_offset)
    return q, k, v, kb, kw, chunk


@pytest.mark.cuda
@pytest.mark.parametrize("merge", ["cluster", "ticket"])
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_flash_decode_kernel_matches_plain(cuda_device, case, merge,
                                           monkeypatch):
    """The decode kernel (csrc/flash_decode_sm90.cu) against the plain
    version and against its own arithmetic (``_flash_fwd_split_ref`` at
    the call's chunk): serving's shapes, GQA, width 128 and 48, fp16, a
    kv_len below one stage and no multiple of it, many rows and row
    blocks, a window and rows that see no key; a call of 2-8 chunks
    merged in a cluster or, with the cluster merge off, through the
    ticket (as every call of more chunks is).  The rule routes each call
    to the decode kernel; one call counts one launch; the split-KV kernel
    on the same inputs is within the same tolerance."""
    monkeypatch.setattr(fa, "_DECODE_CLUSTER_MERGE", merge == "cluster")
    q, k, v, kb, kw, chunk = _decode_inputs(cuda_device, case)
    tile = None if chunk is None else (-1, chunk)
    before = dict(fa.flash_fwd_kernel.routes)
    out, lse = fa.flash_fwd_kernel(q, k, v, kb, None, tile=tile, **kw)
    torch.cuda.synchronize()
    moved = {r: n - before[r] for r, n in fa.flash_fwd_kernel.routes.items()
             if n != before[r]}
    assert moved == {"decode": 1}
    chunk = chunk or fa._rule_chunk(q, k, v)
    for ref in (fa._flash_fwd_ref(q, k, v, kb, None, **kw),
                fa._flash_fwd_split_ref(q, k, v, kb, None, chunk=chunk,
                                        **kw)):
        torch.testing.assert_close(out.float(), ref[0].float(), atol=2e-2,
                                   rtol=2e-2)
        torch.testing.assert_close(lse, ref[1], atol=1e-3, rtol=1e-3)
    so, sl = fa.flash_fwd_kernel(q, k, v, kb, None, route="split", **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), so.float(), atol=2e-2,
                               rtol=2e-2)
    if kw["q_offset"] < 0:
        assert not out[:, :-kw["q_offset"]].any()
        assert (lse[..., :-kw["q_offset"]] == fa.NEG_INF).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["serving_b8_tk1024", "ticket_32_chunks",
                                  "tq15_gqa"])
def test_flash_decode_bits_stable_eager_and_replayed(cuda_device, case):
    """The merge's order is fixed and its ticket returns to 0 within the
    call: two eager calls in a row, a CUDA graph of the call replayed 3
    times and a call on another stream give the same bits."""
    q, k, v, kb, kw, chunk = _decode_inputs(cuda_device, case, seed=32)
    tile = None if chunk is None else (-1, chunk)

    def call():
        return fa.flash_fwd_kernel(q, k, v, kb, None, tile=tile, **kw)
    want = call()
    again = call()
    torch.cuda.synchronize()
    assert torch.equal(want[0], again[0]) and torch.equal(want[1], again[1])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = call()
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with torch.cuda.stream(side):
        other = call()
    side.synchronize()
    assert torch.equal(other[0], want[0]) and torch.equal(other[1], want[1])


@pytest.mark.cuda
def test_flash_decode_routes_refuse_and_scratch(cuda_device):
    """The scratch of a call of several chunks holds a partial of the
    library's rows a block for every chunk of every unit; a chunk the
    decode kernel refuses (no multiple of 32, past 1,024) raises before
    any launch; a route the call cannot take raises; fp32, a view TMA
    cannot read and more units than the kernel's tickets run split-KV by
    the rule."""
    lib = fa._decode_lib()
    for b, tq, h, h_kv, d, chunk in ((8, 1, 12, 12, 64, 256),
                                     (2, 15, 32, 1, 64, 512),
                                     (2, 15, 12, 4, 128, 96)):
        q = torch.empty(b, tq, h, d, dtype=torch.bfloat16,
                        device=cuda_device)
        k = torch.empty(b, 1, h_kv, d, dtype=torch.bfloat16,
                        device=cuda_device)
        per = lib.flash_attention_fwd_decode_rows(fa._kernel_dim(d), chunk)
        rows = tq * (h // h_kv)
        assert 8 <= per <= fa._DECODE_ROWS[fa._kernel_dim(d)]
        part_o, part_ml = fa._decode_scratch(q, k, 3, chunk)
        n = b * h_kv * -(-rows // per) * 3 * min(rows, per)
        assert part_o.numel() == n * fa._kernel_dim(d)
        assert part_ml.numel() == 2 * n
        assert fa._decode_scratch(q, k, 1, chunk) == (None, None)
    # the kernel's 2^18 tickets, one a unit of a call of several chunks:
    # q_len 15 x 32 heads over one KV head at 2,048 keys takes 60 row
    # blocks of 8 rows at the rule's 1,024-key chunks, so 2^10 batches fit
    # and 2^14 run split-KV (views that overlap: the rule reads shapes and
    # strides only)
    for b, want in ((1 << 10, "decode"), (1 << 14, "split")):
        q = torch.empty(1, 1, 1, 64, dtype=torch.bfloat16,
                        device=cuda_device).expand(b, 15, 32, 64)
        kv = torch.empty(b * 128 + 2048 * 64, dtype=torch.bfloat16,
                         device=cuda_device).as_strided(
                             (b, 2048, 1, 64), (128, 64, 64, 1))
        assert fa._decode_route(q, kv, kv) == want
    q, k, v, kb, kw, _ = _decode_inputs(cuda_device, "serving_b8_tk256")
    for chunk in (48, 2048):
        assert not fa.tile_fits(1, 64, torch.bfloat16, (-1, chunk))
        with pytest.raises(ValueError, match="tile"):
            fa.flash_fwd_kernel(q, k, v, kb, None, tile=(-1, chunk), **kw)
    for route in ("wgmma", "mma", "simt"):
        with pytest.raises(ValueError, match="route"):
            fa.flash_fwd_kernel(q, k, v, kb, None, route=route, **kw)
    before = dict(fa.flash_fwd_kernel.routes)
    fa.flash_fwd_kernel(q.float(), k.float(), v.float(), kb, None, **kw)
    odd = torch.empty(k.numel() + 1, dtype=k.dtype,
                      device=cuda_device)[1:].view(k.shape)
    odd.copy_(k)
    fa.flash_fwd_kernel(q, odd, v, kb, None, **kw)
    torch.cuda.synchronize()
    assert fa.flash_fwd_kernel.routes["split"] == before["split"] + 2
    assert fa.flash_fwd_kernel.routes["decode"] == before["decode"]


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", [16, 48, 64, 128, 160, 200, 256,
                                      257, 320, 512, 576])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 3e-2),
                                        (torch.float16, 3e-2)])
def test_flash_bwd_kernels_other_widths_and_fp16(cuda_device, head_dim,
                                                 dtype, atol):
    """dQ, dK/dV and the [B, T, S] bias gradient at every instantiated
    width and at widths run in the next one (48 in 64; 160 and 200 in
    256) or in 256-wide slices of the 256 one (257, 320, 512, 576), GQA
    with a key-padding bias that needs a gradient, in fp32, bf16 and
    fp16."""
    case = _bwd_case(cuda_device, dtype, d=head_dim, tq=100, tk=150, h=4,
                     h_kv=2, kbias=True, seed=22)
    _check_bwd_kernels(*case, atol=atol)
    _check_db2_kernel(*_bwd_case(cuda_device, dtype, d=head_dim, tq=100,
                                 tk=150, h=4, h_kv=2, bias=True, seed=23))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv_kernels_match_plain_fp16(conv_device, case):
    """Forward, dgrad and wgrad in fp16 against their plain versions,
    within one fp16 ulp of max |plain| (2**-10 of it)."""
    xs, ws, stride, padding, dilation = CONV_CASES[case]
    gen = torch.Generator(device=conv_device).manual_seed(33)
    x = torch.randn(xs, device=conv_device, generator=gen).half()
    w = (torch.randn(ws, device=conv_device, generator=gen)
         / (ws[0] * ws[1] * ws[2]) ** 0.5).half()
    oh, ow = cv._out_hw(xs[1], xs[2], padding, ws[0], ws[1], *stride,
                        *dilation)
    dy = torch.randn((xs[0], oh, ow, ws[3]), device=conv_device,
                     generator=gen).half()
    out, _ = cv.conv_fwd_kernel(x, w, stride, padding, dilation)
    dx = cv.conv_dgrad_kernel(dy, w, stride, padding, dilation, xs[1:3])
    dw = cv.conv_wgrad_kernel(x, dy, stride, padding, dilation, ws[:2])
    for got, want in (
            (out, cv._fwd_ref(x, w, stride, padding, dilation)[0]),
            (dx, cv._dgrad_ref(dy, w, stride, padding, dilation, xs[1:3])),
            (dw, cv._wgrad_ref(x, dy, stride, padding, dilation, ws[:2]))):
        assert got.dtype == torch.float16 and got.shape == want.shape
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 2.0 ** -10 * want.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("affine,with_z,relu", BN_VARIANTS)
def test_conv_epilogue_fp16_equals_conv_then_plain_epilogue(conv_device,
                                                            affine, with_z,
                                                            relu):
    fba_ = importlib.import_module("apex_tpu_torch.normalization.fused_bn_act")
    gen = torch.Generator(device=conv_device).manual_seed(34)
    x = torch.randn((2, 10, 10, 32), device=conv_device, generator=gen).half()
    w = (0.1 * torch.randn((3, 3, 32, 40), device=conv_device,
                           generator=gen)).half()
    mean = 0.3 * torch.randn(40, device=conv_device, generator=gen)
    invstd = torch.rand(40, device=conv_device, generator=gen) + 0.5
    scale = 1 + 0.2 * torch.randn(40, device=conv_device, generator=gen)
    bias = 0.2 * torch.randn(40, device=conv_device, generator=gen)
    z = torch.randn((2, 10, 10, 40), device=conv_device, generator=gen).half()
    scale, bias = (scale, bias) if affine else (None, None)
    z = z if with_z else None
    pads = ((1, 1), (1, 1))
    y, _ = cv.conv_fwd_kernel(x, w, (1, 1), pads, (1, 1))
    out, pre = cv.conv_fwd_kernel(x, w, (1, 1), pads, (1, 1), mean, invstd,
                                  scale, bias, z, relu, want_preact=True)
    torch.cuda.synchronize()
    assert torch.equal(pre, y)
    assert torch.equal(out, fba_._fwd_ref(y, mean, invstd, scale, bias, z,
                                          relu))


# the six stride-2 dgrad sites of ResNet-50 (flax 'SAME': (0, 1) pads for
# the 3x3/2, none for the 1x1/2), at B 8: x shape, w shape, padding
RESNET_S2 = {
    "s2_3x3": ((8, 56, 56, 128), (3, 3, 128, 128), ((0, 1), (0, 1))),
    "s2_1x1": ((8, 56, 56, 256), (1, 1, 256, 512), ((0, 0), (0, 0))),
    "s3_3x3": ((8, 28, 28, 256), (3, 3, 256, 256), ((0, 1), (0, 1))),
    "s3_1x1": ((8, 28, 28, 512), (1, 1, 512, 1024), ((0, 0), (0, 0))),
    "s4_3x3": ((8, 14, 14, 512), (3, 3, 512, 512), ((0, 1), (0, 1))),
    "s4_1x1": ((8, 14, 14, 1024), (1, 1, 1024, 2048), ((0, 0), (0, 0))),
}


@pytest.mark.cuda
@pytest.mark.parametrize("site", sorted(RESNET_S2))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_conv_dgrad_resnet_stride2_sites(conv_device, site, dtype):
    """The per-parity dgrad at every ResNet-50 stride-2 shape against the
    plain dgrad and against its own plain arithmetic
    (``_dgrad_parity_ref``), within one ulp of max |plain|; the odd pixels
    of a 1x1/2 site, which no tap reaches, exactly zero."""
    xs, ws, pads = RESNET_S2[site]
    gen = torch.Generator(device=conv_device).manual_seed(35)
    w = (torch.randn(ws, device=conv_device, generator=gen)
         / (ws[0] * ws[1] * ws[2]) ** 0.5).to(dtype)
    oh, ow = cv._out_hw(xs[1], xs[2], pads, ws[0], ws[1], 2, 2, 1, 1)
    dy = torch.randn((xs[0], oh, ow, ws[3]), device=conv_device,
                     generator=gen).to(dtype)
    before = cv.conv_dgrad_kernel.launches
    dx = cv.conv_dgrad_kernel(dy, w, (2, 2), pads, (1, 1), xs[1:3])
    torch.cuda.synchronize()
    assert cv.conv_dgrad_kernel.launches == before + 1
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -10
    for want in (cv._dgrad_ref(dy, w, (2, 2), pads, (1, 1), xs[1:3]),
                 cv._dgrad_parity_ref(dy, w, (2, 2), pads, (1, 1),
                                      xs[1:3])):
        err = (dx.float() - want.float()).abs().max().item()
        assert err <= ulp * want.float().abs().max().item()
    if ws[0] == 1:
        assert not dx[:, 1::2].any() and not dx[:, :, 1::2].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("m,k,n", [(16, 8, 24), (33, 8, 130), (70, 40, 65),
                                   (9, 100, 48), (130, 776, 96)])
def test_qmm_kernel_any_k_and_fp16_bit_for_bit(cuda_device, dtype, m, k, n):
    """K = 8 (the JAX test's), K no multiple of 8 (element loads of x)
    and fp16 in and out: the weight padded to Kp by ``weight_layout``,
    the kernel equal to ``_qmm_ref`` bit for bit."""
    rng = np.random.RandomState(42)
    x = torch.from_numpy((rng.randn(m, k) * 2).astype(np.float32)).to(
        cuda_device, dtype)
    w = torch.from_numpy((rng.randn(k, n) / np.sqrt(k)).astype(
        np.float32)).to(cuda_device, dtype)
    ws = qk.channel_scale(w)
    qw = qk.weight_layout(w, ws)
    assert qw.shape == (n, -(-k // 16) * 16)
    xs = torch.tensor(x.float().abs().max().item() / 127.0 * 0.8,
                      device=cuda_device)
    for out_dtype in (dtype, torch.float32):
        got = qk.qmm_kernel(x, qw, xs, ws, out_dtype)
        want = qk._qmm_ref(x, qw, xs, ws, out_dtype)
        assert got.dtype == out_dtype and torch.equal(got, want)


# -- flash backward on the tensor cores -----------------------------------------

# dQ and dK/dV in bf16 and fp16 (the mma.sync kernels up to width 128):
# keyword arguments of _bwd_case
TC_BWD_CASES = {
    "causal": dict(),
    "full_kbias_grad": dict(causal=False, kbias=True),
    "bts_bias": dict(causal=False, bias=True),
    "causal_bts_bias_kbias": dict(bias=True, kbias=True),
    "gqa12_4": dict(h=12, h_kv=4),
    "mqa4_1": dict(h_kv=1),
    "window": dict(window=50),
    "q_offset": dict(tq=70, tk=200),
    "q_offset_window": dict(tq=90, tk=333, window=100),
    "ragged1023": dict(b=1, tq=1023, tk=1023, h=2, h_kv=2),
    "ragged17": dict(tq=17, tk=17),
    "ragged17_full": dict(tq=17, tk=40, causal=False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(TC_BWD_CASES))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_bwd_tensor_core_kernels_match_plain(cuda_device, case, dtype):
    """dQ and dK/dV on the tensor cores against the plain version within
    3e-2: causal and full, a key-padding bias that needs a gradient, a
    [B, T, S] bias, GQA 12/4 and MQA, a window, queries that are the
    suffix of the keys (q_offset > 0), and ragged lengths (1023, 200, 17:
    none a multiple of the 64-row tiles)."""
    _check_bwd_kernels(*_bwd_case(cuda_device, dtype, seed=24,
                                  **TC_BWD_CASES[case]), atol=3e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_bwd_tensor_core_fully_masked_rows(cuda_device, dtype):
    """Rows past a window of 1 and rows whose keys the key-padding bias
    hides everywhere: p zero where the band hides a key (lse is NEG_INF
    on a row the band hides entirely)."""
    q, k, v, do, kb, bs, kw = _bwd_case(cuda_device, dtype, tq=96, tk=96,
                                        window=1, seed=27)
    _check_bwd_kernels(q, k, v, do, kb, bs, kw, atol=3e-2)
    kb = torch.full((2, 96), -1e9, device=cuda_device)
    kw = dict(kw, causal=False, window=None)
    _check_bwd_kernels(q, k, v, do, kb, None, kw, atol=3e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_bwd_kernels_bit_stable(cuda_device, head_dim, dtype):
    """No atomics: dQ, dK/dV and the key-bias partial sums are equal bit
    for bit from run to run (GQA, so several query heads sum into one
    dK/dV block)."""
    q, k, v, do, kb, bs, kw = _bwd_case(cuda_device, dtype, d=head_dim,
                                        tq=300, tk=300, h=6, h_kv=2,
                                        kbias=True, bias=True, seed=28)
    out, lse = fa._flash_fwd_ref(q, k, v, kb, bs, **kw)
    delta = fa._delta(do, out)

    def run():
        dq = fa.flash_bwd_dq_kernel(q, k, v, do, lse, delta, kb, bs, **kw)
        return (dq, *fa.flash_bwd_dkv_kernel(q, k, v, do, lse, delta, kb, bs,
                                             kbias_grad=True, **kw))
    first = run()
    for _ in range(3):
        for a, b_ in zip(first, run()):
            assert torch.equal(a, b_)


# -- the redesigned qmm (split K, decode tiles) and db2 on tensor cores ---

def _qmm_operands(dev, m, k, n, dtype, seed):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy((rng.randn(m, k) * 2).astype(np.float32)).to(
        dev, dtype)
    w = torch.from_numpy((rng.randn(k, n) / np.sqrt(k)).astype(np.float32))
    w[:, n // 3] = 0.0
    w = w.to(dev, dtype)
    ws = qk.channel_scale(w)
    qw = qk.weight_layout(w, ws)
    xs = torch.tensor(x.float().abs().max().item() / 127.0 * 0.8, device=dev)
    return x, qw, xs, ws


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("k,n", [(8, 130), (40, 768), (768, 3072),
                                 (3072, 768), (768, 130)])
@pytest.mark.parametrize("m", [1, 8, 16, 17, 64, 65, 1000, 8184])
def test_qmm_kernel_every_path_bit_for_bit(cuda_device, dtype, k, n, m):
    """Every tile configuration (decode rows of 16 and of 64 with a K
    split, the 128 x 256 tile (64 x 256 for fp32 x) and the 64 x 128
    one), K not a multiple of 8 or 16, N 130: bit for bit against
    ``_qmm_ref``, in the input dtype and in fp32 out, with a zero-amax
    column."""
    x, qw, xs, ws = _qmm_operands(cuda_device, m, k, n, dtype, seed=m + k + n)
    for out_dtype in (dtype, torch.float32):
        got = qk.qmm_kernel(x, qw, xs, ws, out_dtype)
        want = qk._qmm_ref(x, qw, xs, ws, out_dtype)
        torch.cuda.synchronize()
        assert got.dtype == out_dtype and got.shape == (m, n)
        assert torch.equal(got, want)
        assert not got[:, n // 3].any()


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(8, 3072, 768), (8, 768, 768),
                                   (1, 768, 2304), (17, 3072, 768),
                                   (64, 768, 3072)])
def test_qmm_split_k_resets_its_workspace(cuda_device, m, k, n):
    """Decode rows split K into an int32 workspace: two calls in a row
    give equal results, equal to the plain version, and leave the
    workspace (arrival counters included) zero.  Prefill rows do not
    split."""
    x, qw, xs, ws = _qmm_operands(cuda_device, m, k, n, torch.bfloat16,
                                  seed=7)
    first = qk.qmm_kernel(x, qw, xs, ws, torch.bfloat16)
    second = qk.qmm_kernel(x, qw, xs, ws, torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert torch.equal(first, qk._qmm_ref(x, qw, xs, ws, torch.bfloat16))
    work = qk._workspace(m, n, qw.shape[1], 1, x.device)
    assert work is not None and not work.any()
    assert qk._workspace(1024, n, qw.shape[1], 1, x.device) is None


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 300])
def test_qmm_kernel_unaligned_x(cuda_device, m):
    """x that starts off a 16-byte boundary takes element loads."""
    x, qw, xs, ws = _qmm_operands(cuda_device, m, 768, 768, torch.bfloat16,
                                  seed=9)
    buf = torch.empty(m * 768 + 1, dtype=torch.bfloat16, device=cuda_device)
    xu = buf[1:].view(m, 768)
    xu.copy_(x)
    assert xu.data_ptr() % 16
    got = qk.qmm_kernel(xu, qw, xs, ws, torch.bfloat16)
    assert torch.equal(got, qk._qmm_ref(x, qw, xs, ws, torch.bfloat16))


def _db2_kernel_names(fn):
    """The names of the CUDA kernels ``fn`` launches.  ``fn`` runs once
    before the profiler's window opens: the first launch of a kernel in a
    process loads its module lazily (CUDA's lazy loading), and with that
    load inside the window the profiler could miss the launch."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages() if "db2" in e.key]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["full", "causal", "gqa4_2", "window",
                                  "cross", "kbias", "q_tail"])
@pytest.mark.parametrize("head_dim", [16, 32, 48, 64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_db2_tensor_cores_match_plain(cuda_device, case, head_dim,
                                            dtype):
    """db2's tensor-core path at every width it takes, over the cases of
    ``test_flash_db2_kernel_matches_plain``: within 1e-4 of max |dbias|
    of the plain version, zeros outside the band."""
    kw = dict(bias=True, causal=case not in ("full", "kbias", "q_tail"),
              d=head_dim, seed=30 + head_dim)
    kw.update({"gqa4_2": dict(h_kv=2), "window": dict(window=50),
               "cross": dict(tq=70, tk=200),
               "kbias": dict(kbias=True),
               "q_tail": dict(tq=130, tk=256)}.get(case, {}))
    _check_db2_kernel(*_bwd_case(cuda_device, dtype, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,head_dim,mma", [
    (torch.bfloat16, 64, True), (torch.float16, 128, True),
    (torch.bfloat16, 48, True), (torch.float32, 64, False),
    (torch.bfloat16, 256, False), (torch.float16, 200, False)])
def test_flash_db2_path_by_dtype_and_width(cuda_device, dtype, head_dim,
                                           mma):
    """bf16 and fp16 up to width 128 launch the tensor-core db2 kernel;
    fp32 and wider heads the SIMT one (the profiler's kernel names)."""
    q, k, v, do, kb, bs, kw = _bwd_case(cuda_device, dtype, d=head_dim,
                                        tq=100, tk=100, bias=True, seed=33)
    out, lse = fa._flash_fwd_ref(q, k, v, kb, bs, **kw)
    delta = fa._delta(do, out)
    names = _db2_kernel_names(lambda: fa.flash_bwd_db2_kernel(
        q, k, v, do, lse, delta, kb, bs, **kw))
    assert len(names) == 1, names
    assert ("db2_mma" in names[0]) == mma, names
    _check_db2_kernel(q, k, v, do, kb, bs, kw)


# -- the kernels captured in CUDA graphs -------------------------------------------

cache = importlib.import_module("apex_tpu_torch.cache")


def _tensors(out):
    return [t for t in torch.utils._pytree.tree_leaves(out)
            if isinstance(t, torch.Tensor)]


def _captured_equals_eager(fn, *args):
    """``fn(*args)`` eagerly, then captured (``cache.warmup``) and
    replayed twice on the same inputs: each replay's outputs equal the
    eager ones bit for bit, and every wrapper's counter counts what ran
    on the card: the eager call, the warm run and the two replays, each
    launching what the eager call launched (the capture launches
    nothing)."""
    counters = cache._build.COUNTED
    before = [c.launches for c in counters]
    want = [t.clone() for t in _tensors(fn(*args))]
    eager = [c.launches - b for c, b in zip(counters, before)]
    assert any(eager)
    step = cache.warmup(fn, *args)
    assert isinstance(step, cache.Captured)
    assert {c.__name__: n for c, n in step.launches.items()} == {
        c.__name__: n for c, n in zip(counters, eager) if n}
    for _ in range(2):
        got = _tensors(step(*args))
        torch.cuda.synchronize()
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert [c.launches - b for c, b in zip(counters, before)] == [
        n * (1 + cache.WARM_RUNS + 2) for n in eager]
    return step


CAPTURE_CASES = ["layer_norm", "layer_norm_bwd", "flash_prefill",
                 "flash_decode_split_kv", "flash_bwd", "qmm_decode_split_k",
                 "qmm_prefill", "bn_act", "xentropy", "conv_fwd", "conv_dgrad",
                 "conv_wgrad"]


def _capture_case(dev, case):
    """(the wrapper as a function of tensors, its arguments) at a shape of
    the serving or training path."""
    rng = np.random.RandomState(40)

    def t(*shape, dtype=torch.bfloat16):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            dev, dtype)
    if case == "layer_norm":
        return (lambda x, w, b: fln.layer_norm_fwd_kernel(x, w, b, 1e-5),
                (t(1024, 768), t(768, dtype=torch.float32),
                 t(768, dtype=torch.float32)))
    if case == "layer_norm_bwd":
        x, w = t(1024, 768), t(768, dtype=torch.float32)
        _, mean, invvar = fln.layer_norm_fwd_kernel(x, w, w, 1e-5)
        return (lambda g, x, m, iv, w: fln.layer_norm_bwd_kernel(
            g, x, m, iv, w), (t(1024, 768), x, mean, invvar, w))
    if case == "flash_prefill":
        kw = dict(sm_scale=0.125, causal=True, q_offset=0, window=None)
        return (lambda q, k, v: fa.flash_fwd_kernel(q, k, v, None, None,
                                                    **kw),
                (t(1, 256, 12, 64), t(1, 256, 12, 64), t(1, 256, 12, 64)))
    if case == "flash_decode_split_kv":
        kw = dict(sm_scale=0.125, causal=True, q_offset=1023, window=None)
        kb = torch.where(torch.arange(1024, device=dev) < 700, 0.0,
                         -1e9)[None].expand(8, 1024).contiguous()
        return (lambda q, k, v, kb: fa.flash_fwd_kernel(q, k, v, kb, None,
                                                        **kw),
                (t(8, 1, 12, 64), t(8, 1024, 12, 64), t(8, 1024, 12, 64),
                 kb))
    if case == "flash_bwd":
        q, k, v, do, kb, bs, kw = _bwd_case(dev, torch.bfloat16)
        out, lse = fa._flash_fwd_ref(q, k, v, kb, bs, **kw)
        delta = fa._delta(do, out)
        return (lambda q, k, v, do, lse, delta: (
            fa.flash_bwd_dq_kernel(q, k, v, do, lse, delta, None, None,
                                   **kw),
            fa.flash_bwd_dkv_kernel(q, k, v, do, lse, delta, None, None,
                                    **kw)[:2]),
                (q, k, v, do, lse, delta))
    if case in ("qmm_decode_split_k", "qmm_prefill"):
        m = 8 if case == "qmm_decode_split_k" else 1024
        x, qw, xs, ws = _qmm_operands(dev, m, 3072, 768, torch.bfloat16,
                                      seed=41)
        return (lambda x, qw, xs, ws: qk.qmm_kernel(x, qw, xs, ws,
                                                    torch.bfloat16),
                (x, qw, xs, ws))
    if case == "bn_act":
        c = 256
        x, z, g = t(4096, c), t(4096, c), t(4096, c)
        mean, invstd, w, b = (t(c, dtype=torch.float32) for _ in range(4))
        invstd = invstd.abs() + 0.5
        return (lambda x, z, g, mean, invstd, w, b: (
            fba.bn_act_fwd_kernel(x, mean, invstd, w, b, z, True),
            fba.bn_act_bwd_kernel(g, x, mean, invstd, w, b, z, True)),
                (x, z, g, mean, invstd, w, b))
    if case == "xentropy":
        x = t(1023, 50257, dtype=torch.float32)
        labels = torch.from_numpy(rng.randint(0, 50257, 1023).astype(
            np.int32)).to(dev)
        g = t(1023, dtype=torch.float32)

        def run(x, labels, g):
            loss, mlse = xent.xentropy_fwd_kernel(x, labels, 0.1)
            return loss, xent.xentropy_bwd_kernel(g, x, mlse, labels, 0.1)
        return run, (x, labels, g)
    xs, ws = (16, 28, 28, 64), (3, 3, 64, 128)
    stride, padding, dil = (2, 2), ((0, 1), (0, 1)), (1, 1)
    oh, ow = cv._out_hw(28, 28, padding, 3, 3, *stride, *dil)
    x, w, dy = t(*xs), t(*ws) * 0.05, t(16, oh, ow, 128)
    if case == "conv_fwd":
        return (lambda x, w: cv.conv_fwd_kernel(x, w, stride, padding,
                                                dil)[0], (x, w))
    if case == "conv_dgrad":
        return (lambda dy, w: cv.conv_dgrad_kernel(dy, w, stride, padding,
                                                   dil, (28, 28)), (dy, w))
    return (lambda x, dy: cv.conv_wgrad_kernel(x, dy, stride, padding, dil,
                                               (3, 3)), (x, dy))


@pytest.mark.cuda
@pytest.mark.parametrize("case", CAPTURE_CASES)
def test_kernel_captured_replays_equal_eager(conv_device, case):
    """Every kernel wrapper of the captured paths (serving's LN, flash
    prefill and split-KV decode, qmm's split-K decode and its prefill
    tiles; training's LN, flash, BN, cross-entropy and conv forward,
    dgrad and wgrad) captured in a CUDA graph and replayed twice equals
    its eager call bit for bit: the launchers take the current stream,
    and the buffers they make (qmm's workspace, split-KV's partials,
    wgrad's split sums) are safe to replay."""
    fn, args = _capture_case(conv_device, case)
    _captured_equals_eager(fn, *args)
    if case == "qmm_decode_split_k":
        work = qk._workspace(8, 768, args[1].shape[1], 1, conv_device)
        assert work is not None and not work.any()


@pytest.mark.cuda
def test_captured_o4_engine_serves_new_weights(cuda_device):
    """An O4 engine (int8 projections from prepared weights, an int8 KV
    cache) captures its steps at warmup; after an in-place update of the
    weights, or after they are replaced (``assign=True``), it captures
    them again and serves the new weights' tokens, equal to a fresh
    engine's on those weights."""
    models = importlib.import_module("apex_tpu_torch.models")
    quant = importlib.import_module("apex_tpu_torch.quant")
    engine = importlib.import_module("apex_tpu_torch.serving.engine")
    cfg = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
               mlp_dim=256, max_len=128, dtype=torch.bfloat16)
    sites = [f"block_{i}/{p}" for i in range(2) for p in (
        "attention/query", "attention/key", "attention/value",
        "attention/out", "mlp_up", "mlp_down")]
    qcfg = quant.QuantConfig.frozen(quant.Calibration(
        {s: 0.05 for s in sites}))

    def serve(model):
        eng = engine.ServingEngine(model, buckets=(64,), page_size=16,
                                   max_seqs=2, cache_dtype=torch.int8,
                                   device=cuda_device).warmup()
        prompts = [np.arange(1, 20) % 500, np.arange(7, 40) % 500]
        out = [r.tokens for r in eng.generate(prompts, 8)]
        return eng, out

    model = models.gpt_tiny(**cfg, quant=qcfg, device=cuda_device, seed=1)
    eng, before = serve(model)
    assert eng.stats["captures"] == 2 and eng.stats["aot_misses"] == 0
    new = models.gpt_tiny(**cfg, quant=qcfg, device=cuda_device, seed=2)
    model.load_state_dict(new.state_dict())
    prompts = [np.arange(1, 20) % 500, np.arange(7, 40) % 500]
    after = [r.tokens for r in eng.generate(prompts, 8)]
    assert eng.stats["recaptures"] == 2 and eng.stats["aot_misses"] == 0
    fresh, want = serve(new)
    for a, w in zip(after, want):
        np.testing.assert_array_equal(a, w)
    assert any(not np.array_equal(a, b) for a, b in zip(after, before))
    fresh.close()
    # replaced, not updated in place: the graphs are captured again too
    third = models.gpt_tiny(**cfg, quant=qcfg, device=cuda_device, seed=3)
    model.load_state_dict(third.state_dict(), assign=True)
    again = [r.tokens for r in eng.generate(prompts, 8)]
    assert eng.stats["recaptures"] == 4 and eng.stats["aot_misses"] == 0
    fresh, want = serve(third)
    for a, w in zip(again, want):
        np.testing.assert_array_equal(a, w)
    eng.close()
    fresh.close()


@pytest.mark.cuda
def test_stage_windows_onto_the_card(cuda_device):
    """Windows assembled by two workers and staged onto the card through
    pinned memory on a side stream: CUDA tensors, in order, the ragged
    tail padded with its last batch; their values are there when the
    consumer's stream reads them."""
    runtime = importlib.import_module("apex_tpu_torch.runtime")
    batches = [(np.full((64, 256), i, np.float32), np.full((64,), i))
               for i in range(7)]
    loader = runtime.stage_windows(iter(batches), 3, workers=2)
    got = [(x.sum(dim=(1, 2)).cpu(), y[:, 0].cpu(), n)
           for (x, y), n in loader]
    assert [n for _, _, n in got] == [3, 3, 1]
    for j, (xs, ys, _) in enumerate(got):
        want = torch.tensor([min(3 * j + i, 6) for i in range(3)])
        assert torch.equal(ys, want)
        assert torch.equal(xs, want.float() * 64 * 256)
    assert loader.stats.as_dict()["batches"] == 3


@pytest.mark.cuda
def test_step_pipeline_tail_and_skip_captured_equal_eager(cuda_device):
    """``StepPipeline`` at K 3 on the card: two full windows (the hot
    graph) and a ragged one of two steps (the tail graph, captured at
    its first use, its padded step gated on the device), with an inf in
    the loss of the second step under a dynamic scale: every state leaf
    and every real step's loss equal eight eager steps bit for bit."""
    models = importlib.import_module("apex_tpu_torch.models")
    training = importlib.import_module("apex_tpu_torch.training")
    runtime = importlib.import_module("apex_tpu_torch.runtime")
    model = models.gpt_tiny(vocab_size=96, hidden_size=64, num_layers=2,
                            num_heads=4, mlp_dim=128, max_len=32,
                            device=cuda_device, seed=3)

    def loss_fn(p, batch):
        x, y, mult = batch
        logp = torch.log_softmax(
            torch.func.functional_call(model, p, (x,)), dim=-1)
        return -logp.gather(-1, y[..., None]).mean() * mult

    init, step = training.make_train_step(
        loss_fn, training.sgd(0.1, momentum=0.9), opt_level="O0",
        loss_scale="dynamic")
    rng = np.random.RandomState(5)
    batches = []
    for i in range(8):
        ids = torch.from_numpy(rng.randint(1, 96, (4, 13))).to(cuda_device)
        mult = torch.tensor(float("inf") if i == 1 else 1.0,
                            device=cuda_device)
        batches.append((ids[:, :-1], ids[:, 1:], mult))
    ref, want = init(model.state_dict()), []
    for b in batches:
        ref, m = step(ref, b)
        want.append(float(m["loss"]))
    pipe = runtime.StepPipeline(step, 3)
    state, reader = pipe.run(init(model.state_dict()),
                             runtime.window_batches(iter(batches), 3))
    assert pipe.stats["captures"] == {"hot": 1, "tail": 1}
    assert pipe.stats["replays"] == 3 and reader.steps_pushed == 8
    assert float(reader.last()["loss"][1]) == want[7]
    for g, w in zip(torch.utils._pytree.tree_leaves(state),
                    torch.utils._pytree.tree_leaves(ref)):
        assert torch.equal(g, w) if isinstance(w, torch.Tensor) else g == w
    assert float(state.scaler.loss_scale) == 2.0 ** 15


# -- the bucketed optimizers captured, and ResNet remat on the card ---------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", ["adam", "lamb"])
def test_bucketed_update_captured_replays_equal_eager(cuda_device, name):
    """A bucketed Adam or LAMB update (Packed moments, a skip mask, a
    dynamic grad scale) captured in a CUDA graph and replayed twice:
    every output equal to its eager call bit for bit."""
    mt = importlib.import_module("apex_tpu_torch.multi_tensor")
    F = importlib.import_module("apex_tpu_torch.optimizers.functional")
    rng = np.random.RandomState(40)
    shapes = {"w": (768, 768), "b": (768,), "ln.scale": (768,),
              "emb": (1000, 64)}

    def tree(scale=1.0):
        return {k: torch.from_numpy(scale * rng.randn(*s).astype(
            np.float32)).to(cuda_device) for k, s in shapes.items()}
    params, grads = tree(), tree(1e-2)
    store = mt.BucketStore(params, decay_mask={k: not k.endswith(".scale")
                                               for k in shapes})
    init, update = {"adam": (F.adam_init, F.adam_update),
                    "lamb": (F.lamb_init, F.lamb_update)}[name]
    state = init(params, store=store)
    for _ in range(2):                       # moments away from zero
        params, state = update(grads, state, params, lr=1e-2, store=store,
                               weight_decay=0.01)

    def fn(grads, state, params, keep, grad_scale):
        return update(grads, state, params, lr=1e-2, store=store,
                      weight_decay=0.01, apply_mask=keep,
                      grad_scale=grad_scale)
    args = (grads, state, params, torch.tensor(True, device=cuda_device),
            torch.tensor(2.0, device=cuda_device))
    want = [t.clone() for t in _tensors(fn(*args))]
    step = cache.warmup(fn, *args)
    for _ in range(2):
        got = _tensors(step(*args))
        torch.cuda.synchronize()
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert isinstance(step.out[1].exp_avg, mt.Packed)


@pytest.mark.cuda
def test_resnet_conv_out_remat_equals_no_remat(conv_device):
    """A bottleneck ResNet (``PallasConv``, the fused BN, fp32) with
    ``remat="conv_out"``: the loss, every gradient and the batch
    statistics equal those without remat bit for bit, and the conv
    forward and BN forward counters rise by the recomputed stretches'
    launches (per block two convs, and its three BNs plus a downsample
    BN), the backward counters not at all."""
    models = importlib.import_module("apex_tpu_torch.models")
    groupbn = importlib.import_module("apex_tpu_torch.contrib.groupbn")
    ops = importlib.import_module("apex_tpu_torch.ops")
    cv = importlib.import_module("apex_tpu_torch.ops.conv")
    fba = importlib.import_module(
        "apex_tpu_torch.normalization.fused_bn_act")
    counters = (cv.conv_fwd_kernel, cv.conv_dgrad_kernel,
                cv.conv_wgrad_kernel, fba.bn_act_fwd_kernel,
                fba.bn_act_bwd_kernel)
    x = torch.from_numpy(np.random.RandomState(41).randn(
        8, 32, 32, 3).astype(np.float32)).to(conv_device)
    runs = {}
    for remat in (False, "conv_out"):
        m = models.ResNet(stage_sizes=[1, 1], block_cls=models.BottleneckBlock,
                          num_filters=8, num_classes=10,
                          norm_cls=groupbn.BatchNorm2d_NHWC,
                          conv_cls=ops.PallasConv, remat=remat,
                          device=conv_device, seed=2)
        params, stats = m.variables()
        params = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        stats = {k: v.clone() for k, v in stats.items()}
        before = [c.launches for c in counters]
        logits, new_stats = m.apply(params, stats, x)
        loss = torch.sin(logits).sum()
        grads = torch.autograd.grad(loss, list(params.values()))
        torch.cuda.synchronize()
        runs[remat] = (loss, grads, new_stats,
                       [c.launches - b for c, b in zip(counters, before)])
    (loss, grads, stats, plain), (rloss, rgrads, rstats, counts) = (
        runs[False], runs["conv_out"])
    assert torch.equal(loss, rloss)
    assert all(torch.equal(a, b) for a, b in zip(grads, rgrads))
    assert all(torch.equal(stats[k], rstats[k]) for k in stats)
    blocks, downsampled = 2, 2
    assert plain == [1 + 4 * blocks, 4 * blocks, 1 + 4 * blocks,
                     1 + 3 * blocks + downsampled,
                     1 + 3 * blocks + downsampled]
    assert counts == [plain[0] + 2 * blocks, plain[1], plain[2],
                      plain[3] + 3 * blocks + downsampled, plain[4]]


# -- the imperative amp API and the O1 policy on the card ------------------------

@pytest.mark.cuda
def test_o1_mode_captured_replays_equal_eager(conv_device):
    """A function of listed ops (a bf16 product of fp32 tensors, an fp32
    softmax of it, a promoted cat) under ``amp.init()``, captured by
    ``cache.warmup`` while the mode is pushed and replayed twice: every
    output equal to its eager call bit for bit, in the policy's dtypes."""
    amp = importlib.import_module("apex_tpu_torch.amp")
    gen = torch.Generator(device=conv_device).manual_seed(7)
    a = torch.randn(64, 96, device=conv_device, generator=gen)
    b = torch.randn(96, 32, device=conv_device, generator=gen)

    def fn(a, b):
        y = a @ b
        return y, torch.softmax(y, -1), torch.cat([y, b[:64].T[:, :32]])
    amp.init()
    try:
        want = [t.clone() for t in fn(a, b)]
        assert [t.dtype for t in want] == [torch.bfloat16, torch.float32,
                                           torch.float32]
        step = cache.warmup(fn, a, b)
        assert isinstance(step, cache.Captured)
        for _ in range(2):
            got = step(a, b)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and torch.equal(g, w)
    finally:
        amp.shutdown()


@pytest.mark.cuda
def test_imperative_fused_adam_o2_bert_tiny_card_vs_cpu(conv_device):
    """``amp.initialize(bert_tiny, FusedAdam, O2)``, three steps of the
    tied-head cross-entropy through ``scale_loss`` on the card and on the
    CPU from the same weights (fp32 activations over the bf16 parameters,
    so the two differ by fp32 summation order): the fp32 masters within
    rtol/atol 1e-4, the norms fp32, the rest bf16."""
    amp = importlib.import_module("apex_tpu_torch.amp")
    models = importlib.import_module("apex_tpu_torch.models")
    optimizers = importlib.import_module("apex_tpu_torch.optimizers")
    xent = importlib.import_module("apex_tpu_torch.contrib.xentropy")
    masters = []
    for dev in ("cpu", conv_device):
        model = models.bert_tiny(device=dev, seed=3, num_classes=None,
                                 attention_impl="flash")
        opt = optimizers.FusedAdam(model.parameters(), lr=1e-4,
                                   bucketed=True)
        model, opt = amp.initialize(model, opt, opt_level="O2",
                                    loss_scale="dynamic", verbosity=0)
        assert model.word_embeddings.embedding.dtype == torch.bfloat16
        assert model.embeddings_ln.scale.dtype == torch.float32
        for i in range(3):
            ids, labels = (torch.from_numpy(x).to(dev) for x in
                           np.random.RandomState(30 + i).randint(
                               0, 1024, (2, 4, 64)))
            feats = model(ids)
            logits = feats @ model.word_embeddings.embedding.float().T
            loss = xent.softmax_cross_entropy_loss(
                logits.reshape(-1, logits.shape[-1]), labels.reshape(-1),
                smoothing=0.1, padding_idx=-1).mean()
            with amp.scale_loss(loss, opt) as scaled:
                scaled.backward()
            opt.step()
            opt.zero_grad()
        masters.append({k: v.cpu() for k, v in opt.master_tree().items()})
        amp.initialize(enabled=False, verbosity=0)
    for k, v in masters[0].items():
        torch.testing.assert_close(masters[1][k], v, rtol=1e-4, atol=1e-4,
                                   msg=k)


#: the DCGAN biases that feed a BatchNorm over their channel: their
#: gradient is zero but for rounding, which Adam turns into lr-sized steps
_DCGAN_BN_FED = {"deconv1.bias", "deconv2.bias", "deconv3.bias",
                 "conv2.bias", "conv3.bias", "conv4.bias"}


@pytest.mark.cuda
def test_dcgan_o0_iteration_card_vs_cpu(conv_device):
    """One pipelined DCGAN iteration at O0 (ngf/ndf 8, batch 4) on the
    card and on the CPU from the same weights (TF32 off): the losses
    within rtol 1e-4; the iteration's gradients of D's two losses and of
    G's loss (through the CPU's new D on both) within 1e-4 of each net's
    largest |gradient| (fp32 summation order); the new parameters within
    rtol/atol 1e-4 in 99.9% of each leaf's elements but for the biases
    that feed a BatchNorm, every element within 2.2 lr (Adam's step is
    lr times the gradient's sign wherever the gradient is within
    rounding of zero); and the trainer's Adam fed the CPU's gradients
    on both devices within 1e-6 + 1e-5 |x| (the update's own
    rounding)."""
    dcgan = importlib.import_module("apex_tpu_torch.examples.dcgan.main_amp")
    training = importlib.import_module("apex_tpu_torch.training")
    pytree = torch.utils._pytree
    args = dcgan.parse(["--batchSize", "4", "--ngf", "8", "--ndf", "8",
                        "--opt_level", "O0", "--data-pool", "1"])
    tx = training.adam(lr=args.lr, beta1=args.beta1, beta2=0.999)

    def to(tree, dev):
        return pytree.tree_map(
            lambda t: t.to(dev) if isinstance(t, torch.Tensor) else t, tree)

    def grads(loss_fn, params):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        return {k: g.cpu() for k, g in zip(leaves, torch.autograd.grad(
            loss_fn(leaves), list(leaves.values())))}
    runs, start = [], None
    for dev in ("cpu", conv_device):
        netG, netD = dcgan.build_models(args, dev)
        real, noise = dcgan.synthetic_pool(args, dev)[0]
        state, step = dcgan.build_pipelined(args, netG, netD)
        start = state if start is None else start      # the CPU's
        runs.append((netG, netD, (real, noise),
                     step(to(start, dev), (real, noise))))
    d_next = runs[0][3][0]["d"]
    got = []
    for netG, netD, (real, noise), (new, metrics) in runs:
        dev = real.device
        st = to(start, dev)
        with torch.no_grad():
            fake = dcgan._forward(netG, st["g"], noise)
        g_d = grads(lambda p: dcgan.bce_with_logits(
            dcgan._forward(netD, p, real), 1.0) + dcgan.bce_with_logits(
            dcgan._forward(netD, p, fake), 0.0), st["d"])
        g_g = grads(lambda p: dcgan.bce_with_logits(dcgan._forward(
            netD, to(d_next, dev), dcgan._forward(netG, p, noise)), 1.0),
            st["g"])
        got.append(({f"{n}.{k}": v.cpu() for n in ("g", "d")
                     for k, v in new[n].items()},
                    [float(metrics["loss_d"]), float(metrics["loss_g"])],
                    (g_d, g_g)))
    (cpu, cpu_l, cpu_g), (card, card_l, card_g) = got
    np.testing.assert_allclose(card_l, cpu_l, rtol=1e-4)
    for card_net, cpu_net in zip(card_g, cpu_g):
        scale = max(g.abs().max().item() for g in cpu_net.values())
        for k, b in cpu_net.items():
            assert (card_net[k] - b).abs().max().item() <= 1e-4 * scale, k
    for k, v in cpu.items():
        torch.testing.assert_close(card[k], v, rtol=0,
                                   atol=2.2 * args.lr, msg=k)
        if k.split(".", 1)[1] not in _DCGAN_BN_FED:
            close = torch.isclose(card[k], v, rtol=1e-4, atol=1e-4)
            assert close.float().mean().item() >= 0.999, k
    for n, g in zip(("d", "g"), cpu_g):
        want, have = (pytree.tree_leaves(tx.update(
            to(g, dev), to(start[f"{n}_opt"], dev), to(start[n], dev)))
            for dev in ("cpu", conv_device))
        for a, b in zip(have, want):
            if b.is_floating_point():
                torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-6)


# -- checkpoints of a captured pipeline, weight hot-swap on the card ----------------

@pytest.mark.cuda
def test_captured_pipeline_async_save_between_replays(cuda_device, tmp_path):
    """An async save of the state a captured ``StepPipeline`` returned,
    made between two replays: the next replay overwrites that state in
    place, and the checkpoint still holds exactly the state after the
    first window (its copies are ordered before the replay on the
    stream).  A fresh pipeline resumed from it replays the second window
    from the restored values: equal to four eager steps bit for bit."""
    models = importlib.import_module("apex_tpu_torch.models")
    training = importlib.import_module("apex_tpu_torch.training")
    runtime = importlib.import_module("apex_tpu_torch.runtime")
    checkpoint = importlib.import_module("apex_tpu_torch.checkpoint")
    model = models.gpt_tiny(vocab_size=4096, hidden_size=512, num_layers=4,
                            num_heads=8, mlp_dim=2048, max_len=64,
                            device=cuda_device, seed=4)

    def loss_fn(p, batch):
        x, y = batch
        logp = torch.log_softmax(
            torch.func.functional_call(model, p, (x,)).float(), dim=-1)
        return -logp.gather(-1, y[..., None]).mean()

    init, step = training.make_train_step(loss_fn, training.adam(1e-3),
                                          opt_level="O2")
    rng = np.random.RandomState(6)
    batches = []
    for _ in range(4):
        ids = torch.from_numpy(rng.randint(1, 4096, (8, 65))).to(cuda_device)
        batches.append((ids[:, :-1], ids[:, 1:]))
    ref, after = init(model.state_dict()), []
    for b in batches:
        ref, _ = step(ref, b)
        after.append(torch.utils._pytree.tree_map(
            lambda t: t.clone() if isinstance(t, torch.Tensor) else t, ref))
    windows = list(runtime.window_batches(iter(batches), 2))
    pipe = runtime.StepPipeline(step, 2).warmup(init(model.state_dict()),
                                                windows[0][0])
    mgr = checkpoint.CheckpointManager(str(tmp_path))
    state, _ = pipe.step_window(init(model.state_dict()), windows[0][0])
    mgr.save(2, state)
    state, _ = pipe.step_window(state, windows[1][0])
    mgr.wait()
    restored = mgr.restore(like=init(model.state_dict()))
    mgr.close()

    def leaves(tree):
        return [x for x in torch.utils._pytree.tree_leaves(tree)
                if isinstance(x, torch.Tensor)]
    assert all(torch.equal(g, w) for g, w in zip(leaves(restored.state),
                                                 leaves(after[1])))
    assert all(torch.equal(g, w) for g, w in zip(leaves(state),
                                                 leaves(after[3])))
    assert all(x.is_cuda for x in leaves(restored.state))
    fresh = runtime.StepPipeline(step, 2).warmup(restored.state,
                                                 windows[1][0])
    resumed, _ = fresh.step_window(restored.state, windows[1][0])
    assert all(torch.equal(g, w) for g, w in zip(leaves(resumed),
                                                 leaves(after[3])))


@pytest.mark.cuda
def test_manager_reserve_pins_the_first_save_buffer(cuda_device, tmp_path):
    """``reserve`` pins the snapshot's buffer on its own thread and the
    manager keeps it, through an emptied host cache (every CUDA graph
    capture empties it), for the first async save, which then pins
    nothing on the caller's thread; a later save reuses the same buffer.
    Each checkpoint holds the tree bit for bit."""
    checkpoint = importlib.import_module("apex_tpu_torch.checkpoint")
    empty = (getattr(getattr(torch, "accelerator", None), "empty_host_cache",
                     None) or torch._C._host_emptyCache)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    tree = {"w": torch.randn(1000, 300, device=cuda_device, generator=g),
            "h": torch.randn(77, device=cuda_device,
                             generator=g).to(torch.bfloat16),
            "n": torch.arange(5, device=cuda_device),
            "cpu": torch.ones(3)}
    empty()
    mgr = checkpoint.CheckpointManager(str(tmp_path))
    mgr.reserve(tree)
    mgr._reserving.join()
    empty()

    def allocs():
        return torch.cuda.memory.host_memory_stats()["num_host_alloc"]
    before = allocs()
    saved = {}
    for step in (1, 2):
        saved[step] = {k: v.clone() for k, v in tree.items()}
        mgr.save(step, tree)
        mgr.wait()
        tree["w"].add_(1.0)
    assert allocs() == before
    for step, want in saved.items():
        restored = mgr.restore(like=tree, step=step)
        assert all(torch.equal(restored.state[k], want[k]) for k in want)
        assert restored.state["h"].dtype == torch.bfloat16
    mgr.close()


@pytest.mark.cuda
@pytest.mark.parametrize("o4", [False, True])
def test_engine_adopts_weights_between_steps(cuda_device, tmp_path, o4):
    """A captured engine at O2 (bf16) or O4 (int8 projections, int8 KV)
    watching a checkpoint directory: a checkpoint published while a
    request is in flight is adopted between two scheduler steps, every
    graph is captured again (at O4 with every int8 weight prepared
    again), and the requests after it give a fresh engine's tokens on
    the new weights."""
    models = importlib.import_module("apex_tpu_torch.models")
    quant = importlib.import_module("apex_tpu_torch.quant")
    engine = importlib.import_module("apex_tpu_torch.serving.engine")
    checkpoint = importlib.import_module("apex_tpu_torch.checkpoint")
    cfg = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
               mlp_dim=256, max_len=128, dtype=torch.bfloat16)
    kw = {}
    if o4:
        sites = [f"block_{i}/{p}" for i in range(2) for p in (
            "attention/query", "attention/key", "attention/value",
            "attention/out", "mlp_up", "mlp_down")]
        cfg["quant"] = quant.QuantConfig.frozen(quant.Calibration(
            {s: 0.05 for s in sites}))
        kw["cache_dtype"] = torch.int8

    def preparations(m):
        return sum(getattr(x, "preparations", 0) for x in m.modules())
    model = models.gpt_tiny(**cfg, device=cuda_device, seed=1)
    new = models.gpt_tiny(**cfg, device=cuda_device, seed=2)
    eng = engine.ServingEngine(model, buckets=(64,), page_size=16,
                               max_seqs=2, device=cuda_device,
                               watch_dir=str(tmp_path), poll_every_s=3600,
                               **kw).warmup()
    prompts = [np.arange(1, 20) % 500, np.arange(7, 40) % 500]
    comp = eng.submit(prompts[0], 16)
    for _ in range(4):
        eng.step()
    prepared = preparations(model)
    with checkpoint.CheckpointManager(str(tmp_path)) as mgr:
        mgr.save(5, new.state_dict(), block=True)
    assert eng.watcher.poll_once()
    eng.run_until_idle()
    assert comp.result(timeout=0).ok
    assert eng.stats["hotswaps"] == 1 and eng.stats["recaptures"] == 2
    assert eng.stats["swap_s"] > 0
    if o4:
        assert preparations(model) - prepared == 12
    after = [r.tokens for r in eng.generate(prompts, 8)]
    assert eng.stats["aot_misses"] == 0
    eng.close()
    fresh = engine.ServingEngine(new, buckets=(64,), page_size=16,
                                 max_seqs=2, device=cuda_device,
                                 **kw).warmup()
    want = [r.tokens for r in fresh.generate(prompts, 8)]
    fresh.close()
    for a, w in zip(after, want):
        np.testing.assert_array_equal(a, w)


# -- the tuner's tiles ---------------------------------------------------------

_TUNE_FAMILIES = ["flash_attention", "conv2d", "fused_layer_norm",
                  "bn_relu_residual", "xentropy", "quantized_matmul"]


@pytest.mark.cuda
@pytest.mark.parametrize("name,extra", [(n, {}) for n in _TUNE_FAMILIES] + [
    ("flash_attention", {"head_dim": 128}),          # the d128 tiles
    ("flash_attention", {"q_len": 1, "kv_len": 700})])   # decode chunks
def test_tune_candidates_match_plain(conv_device, name, extra):
    """Every legal candidate of a family's small shape (and flash's at
    width 128 and on decode): its outputs (the case's forward and
    backward) equal the plain version's on the CPU within the family's
    table tolerance (bf16 2e-2 of the largest value, fp32 1e-4), and the
    rule's bit for bit (exact families) or within the spec's stated
    tolerance."""
    from apex_tpu_torch.tune import measure, registry
    spec = registry.get_spec(name)
    shape = dict(spec.small_shape, **extra)
    card, cpu = spec.build(shape, False), spec.build(shape, True)
    default = spec.defaults(shape)
    ref = card.run(default)
    want = [t.float() for t in measure._leaves(cpu.run(default))]
    tol = 2e-2 if shape.get("dtype") == "bfloat16" else 1e-4
    legal = [c for c in measure._dedupe(
        spec, shape, [default] + spec.candidates(shape, None))
        if c == default or spec.constraint(shape, c)]
    assert len(legal) >= 2
    for cfg in legal:
        out = card.run(cfg)
        torch.cuda.synchronize()
        if spec.exact:
            assert measure._tree_equal_bitwise(ref, out), cfg
        else:
            assert measure._tree_close(ref, out, card.tol), cfg
        for got, w in zip(measure._leaves(out), want):
            err = (got.cpu().float() - w).abs().max().item()
            assert err <= tol * max(1.0, w.abs().max().item()), (cfg, err)


@pytest.mark.cuda
def test_tile_legality_is_the_kernels(conv_device):
    """The tile queries answer from the kernels: qmm's plan() fills a
    half at -1 from its rule and refuses a tile it lacks, and the launch
    refuses it too; flash's check takes its instantiated tiles, a decode
    chunk of 32 keys or a multiple, and refuses the rest."""
    qk = importlib.import_module("apex_tpu_torch.quant.kernels")
    bf = torch.bfloat16
    rule = qk.kernel_tile(1024, 768, 3072, bf)
    assert rule in qk.tiles(2)
    assert qk.kernel_tile(1024, 768, 3072, bf, (rule[0], -1)) == rule
    assert qk.kernel_tile(1024, 768, 3072, bf, (16, -1)) is None  # 16 x 256
    assert qk.kernel_tile(8, 768, 768, bf) == (16, 32)
    assert qk.kernel_tile(8, 768, 768, bf, (64, -1)) == (64, 32)
    x = torch.randn(100, 128, device=conv_device, dtype=bf) * 0.05
    w = torch.randn(128, 256, device=conv_device, dtype=bf) * 0.05
    base = qk.quantized_matmul(x, w, x_scale=0.002)
    torch.testing.assert_close(                       # 64 x 32 at M 100
        qk.quantized_matmul(x, w, x_scale=0.002, block_n=32), base,
        rtol=0, atol=0)
    torch.testing.assert_close(                       # wgmma's 128 x 128
        qk.quantized_matmul(x, w, x_scale=0.002, block_m=128, block_n=128),
        base, rtol=0, atol=0)
    with pytest.raises(ValueError, match="not one the kernel has"):
        qk.quantized_matmul(x, w, x_scale=0.002, block_m=128, block_n=64)
    for tile in fa.tiles(64, bf):
        assert fa.tile_fits(1023, 64, bf, tile)
    assert not fa.tile_fits(1023, 64, bf, (32, 32))
    assert not fa.tile_fits(1023, 64, torch.float32, (128, 128))  # SIMT
    assert fa.tile_fits(1, 64, bf, (-1, 96))
    assert not fa.tile_fits(1, 64, bf, (-1, 100))
    q = torch.randn(1, 256, 2, 64, device=conv_device, dtype=bf)
    torch.testing.assert_close(
        fa.flash_attention(q, q, q, causal=True, block_k=64),
        fa.flash_attention(q, q, q, causal=True, block_q=64, block_k=64),
        rtol=0, atol=0)
    with pytest.raises(ValueError, match="not one the forward kernel"):
        fa.flash_attention(q, q, q, causal=True, block_q=32, block_k=32)


@pytest.mark.cuda
def test_tuned_cache_reaches_the_launch(conv_device, tmp_path, monkeypatch):
    """With a cache entry for the call's bucket, each public function
    left at its defaults consults it on the kernel path (a hit in
    ``dispatch_stats``) and launches that tile: its output equals the
    explicit tile's bit for bit; an entry of another card misses."""
    from apex_tpu_torch.tune import dispatch, store
    fba = importlib.import_module("apex_tpu_torch.normalization.fused_bn_act")
    qk = importlib.import_module("apex_tpu_torch.quant.kernels")
    cv = importlib.import_module("apex_tpu_torch.ops.conv")
    xe = importlib.import_module("apex_tpu_torch.contrib.xentropy")
    path = str(tmp_path / "tune_configs.json")
    monkeypatch.setenv("APEX_TPU_TUNE_CACHE", path)
    store._STATE["memo_path"] = store._STATE["memo"] = None
    dispatch.reset_stats()
    dev = conv_device
    g = torch.Generator().manual_seed(0)

    def rnd(*s, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(*s, generator=g) * scale).to(dev, dtype)

    x = rnd(300, 768)
    q, k, v = (rnd(2, 256, 4, 64, scale=0.5) for _ in range(3))
    xc, wc = rnd(2, 8, 8, 64), rnd(3, 3, 64, 128, scale=0.05)
    xq, wq = rnd(100, 128, scale=0.05), rnd(128, 256, scale=0.05)
    xb, zb = rnd(640, 128), rnd(640, 128)
    vb = [torch.linspace(0.5, 1.5, 128, device=dev) for _ in range(4)]
    lg = rnd(32, 1000, dtype=torch.float32)
    lab = torch.arange(1, 33, device=dev)
    calls = {
        "fused_layer_norm": (
            fln.tune_bucket(300, 768, 2), {"row_block": 8},
            lambda **t: fln.fused_layer_norm(x, (768,), **t)),
        "flash_attention": (
            fa.tune_bucket(256, 256, 64, True, False, False),
            {"block_q": 128, "block_k": 128},
            lambda **t: fa.flash_attention(q, k, v, causal=True, **t)),
        "conv2d": (
            cv.tune_bucket(2, 8, 8, 64, 128, 3, 3, 1, 1, 1, 1, 2, False,
                           False), {"block_m": 128, "block_n": 64},
            lambda **t: cv.conv2d(xc, wc, **t)),
        "quantized_matmul": (
            qk.tune_bucket(100, 128, 256, 2), {"block_m": 16, "block_n": 32},
            lambda **t: qk.quantized_matmul(xq, wq, x_scale=0.002, **t)),
        "bn_relu_residual": (
            fba.tune_bucket(640, 128, 2, True), {"row_block": 16},
            lambda **t: fba.bn_relu_residual(xb, *vb, z=zb, **t)),
        "xentropy": (
            xe.tune_bucket(32, 1000), {"col_block": 512, "num_warps": 4},
            lambda **t: xe.xentropy_fwd_kernel(
                lg, lab.to(torch.int32), 0.1, tuple(t.values()) or None)[0]
            if t else xe.softmax_cross_entropy_loss(lg, lab, 0.1)),
    }
    rule = {n: fn() for n, (_, _, fn) in calls.items()}
    # each family's config version (flash's, conv's and qmm's are 2,
    # their wgmma rules')
    version = dict(dict.fromkeys(calls, 1),
                   flash_attention=fa.TUNE_VERSION,
                   conv2d=cv.TUNE_VERSION,
                   quantized_matmul=qk.TUNE_VERSION)
    for name, (bucket, cfg, _) in calls.items():
        store.put(name, version[name], bucket, cfg, path=path)
        store.put(name, version[name], bucket, cfg, dev_kind="TPU_v5_lite",
                  path=path)
    for name, (_, cfg, fn) in calls.items():
        tuned, explicit = fn(), fn(**cfg)
        torch.testing.assert_close(tuned, explicit, rtol=0, atol=0)
        assert dispatch.dispatch_stats()["by_kernel"][name]["hits"] >= 1
    # only another card's entries: every consult misses, the rule runs
    with open(path) as f:
        data = json.load(f)
    data["entries"] = {k: e for k, e in data["entries"].items()
                       if e["device_kind"] == "TPU_v5_lite"}
    with open(path, "w") as f:
        json.dump(data, f)
    store.load(reload=True)
    dispatch.reset_stats()
    for name, (_, _, fn) in calls.items():
        torch.testing.assert_close(fn(), rule[name], rtol=0, atol=0)
        st = dispatch.dispatch_stats()["by_kernel"][name]
        assert st["hits"] == 0 and st["misses"] >= 1


# -- generate's captured decode step; zero1 in an NCCL group of one ------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_generate_captured_decode_step_equals_eager(cuda_device, dtype):
    """The ``decode=True`` step of gpt_tiny captured (``cache.warmup``)
    and replayed twice from the same cache and token equals its eager
    call bit for bit (logits and the cache it writes), the LayerNorm
    kernel launched by every replay; and ``generate`` captured gives the
    tokens of ``generate(capture=False)``."""
    models = importlib.import_module("apex_tpu_torch.models")
    gpt = importlib.import_module("apex_tpu_torch.models.gpt")
    model = models.gpt_tiny(dtype=dtype, max_len=64, device=cuda_device,
                            seed=3)
    prompt = torch.from_numpy(np.random.RandomState(5).randint(
        1, 1024, (3, 7))).to(cuda_device)
    with gpt._decoding(model), torch.no_grad():
        cache0 = models.init_decode_cache(model, 3)
        for t in range(5):                      # a cache part filled
            model(prompt[:, t:t + 1], cache=cache0)

        def step(cache, tok):
            return model(tok[:, None], cache=cache)[0][:, 0]

        def fresh():
            return torch.utils._pytree.tree_map(torch.clone, cache0)

        want_cache = fresh()
        want = step(want_cache, prompt[:, 5])
        run = cache.warmup(step, fresh(), prompt[:, 5])
        assert isinstance(run, cache.Captured)
        per_replay = run.launches[fln.layer_norm_fwd_kernel]
        assert per_replay == 2 * 2 + 1
        for _ in range(2):
            before = fln.layer_norm_fwd_kernel.launches
            got = run(fresh(), prompt[:, 5])
            torch.cuda.synchronize()
            assert fln.layer_norm_fwd_kernel.launches == before + per_replay
            assert torch.equal(got, want)
            for a, b in zip(torch.utils._pytree.tree_leaves(
                    run.static_args[0]),
                    torch.utils._pytree.tree_leaves(want_cache)):
                assert torch.equal(a, b)
    a = models.generate(model, model, prompt, 20)
    b = models.generate(model, model, prompt, 20, capture=False)
    assert a.shape == (3, 27) and torch.equal(a, b)


@pytest.mark.cuda
def test_zero1_nccl_group_of_one_equals_replicated(cuda_device, tmp_path):
    """``zero1`` Adam over an NCCL group of one through
    ``make_train_step(reduce_grads=False)`` at O2 equals the replicated
    step bit for bit: parameters and both moments after three steps."""
    import torch.distributed as dist
    models = importlib.import_module("apex_tpu_torch.models")
    training = importlib.import_module("apex_tpu_torch.training")
    zero = importlib.import_module("apex_tpu_torch.parallel.zero")
    main_amp = importlib.import_module("apex_tpu_torch.examples.lm.main_amp")
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/s",
                            world_size=1, rank=0)
    try:
        group = dist.group.WORLD
        model = models.gpt_tiny(dtype=torch.bfloat16, device=cuda_device,
                                seed=0)
        params = {k: v.detach() for k, v in model.state_dict().items()}
        ids = torch.from_numpy(np.random.RandomState(6).randint(
            1, 1024, (4, 65))).to(cuda_device)
        batch = (ids[:, :-1].contiguous(), ids[:, 1:].contiguous())

        def loss_fn(p, b):
            return main_amp.lm_loss(torch.func.functional_call(
                model, p, (b[0],)), b[1], fused=True)

        states = {}
        for name in ("replicated", "zero1"):
            adam = training.adam(1e-3, weight_decay=0.1)
            tx = zero.zero1(adam, group, num_shards=1) if name == "zero1" \
                else adam
            init_fn, step_fn = training.make_train_step(
                loss_fn, tx, opt_level="O2",
                axis_name=group if name == "zero1" else None,
                reduce_grads=name != "zero1")
            st = init_fn({k: v.clone() for k, v in params.items()})
            for _ in range(3):
                st, _ = step_fn(st, batch)
            states[name] = st
        rs, zs = states["replicated"], states["zero1"]
        for k in params:
            assert torch.equal(rs.params[k], zs.params[k]), k
        n = sum(v.numel() for v in params.values())
        assert torch.equal(zero._flatten(rs.opt_state.exp_avg),
                           zs.opt_state.inner.exp_avg[:n])
        assert torch.equal(zero._flatten(rs.opt_state.exp_avg_sq),
                           zs.opt_state.inner.exp_avg_sq[:n])
    finally:
        dist.destroy_process_group()


def _ring_case(dev, dtype, tq, h, d, seed):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(2, tq, h, d).astype(np.float32))
            .to(dev, dtype) for _ in range(4)]


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [-512, -1024, -475, 0, 37, 512])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2),
                                        (torch.float16, 2e-2)])
@pytest.mark.parametrize("tq", [512, 8])
def test_flash_kernels_at_signed_ring_offsets(cuda_device, offset, causal,
                                              dtype, atol, tq):
    """Kernels 10-12 at the ring's relative offsets ``q_off - k_off``
    (negative, zero, positive multiples of the shard, a non-multiple, a
    shard two ahead): the forward (tensor cores for bf16/fp16, SIMT for
    fp32, split-KV with its combine for q_len 8) against its plain
    version, a row that sees no key giving ``out = 0`` and ``lse =
    -1e30``; dQ and dK/dV against theirs with a global ``lse`` (finite on
    every row, as the ring's), hidden rows and unseen keys giving zero
    gradients; no NaN anywhere."""
    q, k, v, do = _ring_case(cuda_device, dtype, tq, 12, 64, 19)
    if tq != 512:
        k, v = (_ring_case(cuda_device, dtype, 512, 12, 64, 20)[i]
                for i in (0, 1))
    kw = dict(sm_scale=0.125, causal=causal, q_offset=offset)
    out, lse = fa.flash_fwd_kernel(q, k, v, None, None, **kw)
    want_out, want_lse = fa._flash_fwd_ref(q, k, v, None, None, **kw)
    torch.cuda.synchronize()
    assert not torch.isnan(out.float()).any() and not torch.isnan(lse).any()
    torch.testing.assert_close(out.float(), want_out.float(), atol=atol,
                               rtol=atol)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=1e-4)
    rows = torch.arange(tq, device=cuda_device)
    hidden = (offset + rows < 0) if causal else torch.zeros_like(rows, dtype=torch.bool)
    if hidden.any():
        assert (out[:, hidden] == 0).all()
        assert (lse[:, :, hidden] == fa.NEG_INF).all()
    # the global lse of a ring: finite on every row
    glse = torch.where(lse == fa.NEG_INF, torch.full_like(lse, 0.5),
                       torch.logaddexp(lse, torch.full_like(lse, 0.5)))
    glse = glse.contiguous()
    delta = fa._delta(do, out)
    dq = fa.flash_bwd_dq_kernel(q, k, v, do, glse, delta, None, None, **kw)
    dk, dv, _ = fa.flash_bwd_dkv_kernel(q, k, v, do, glse, delta, None,
                                        None, **kw)
    wq, wk, wv, _, _ = fa._flash_bwd_ref(q, k, v, None, None, out, glse, do,
                                         **kw)
    torch.cuda.synchronize()
    for got, want in ((dq, wq), (dk, wk), (dv, wv)):
        assert not torch.isnan(got.float()).any()
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=atol)
    if hidden.any():
        assert (dq[:, hidden] == 0).all()
    if causal:
        unseen = torch.arange(k.shape[1], device=cuda_device) > offset + tq - 1
        if unseen.any():
            assert (dk[:, unseen] == 0).all() and (dv[:, unseen] == 0).all()


# -- the wgmma forward (csrc/flash_attention_sm90.cu) ----------------------------

def _wg_case(dev, dtype, *, b=2, tq=200, tk=200, h=4, h_kv=4, d=64, seed=31):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(b, n, hh, d).astype(np.float32))
            .to(dev, dtype) for n, hh in ((tq, h), (tk, h_kv), (tk, h_kv))]


def _wg_check(q, k, v, kb, bias, kw, tile=None):
    """One forward through the wgmma route (its counter moves by one)
    against the plain version at phase 4's gates: out 2e-2, lse 1e-3, no
    NaN."""
    before = dict(fa.flash_fwd_kernel.routes)
    out, lse = fa.flash_fwd_kernel(q, k, v, kb, bias, tile=tile, **kw)
    torch.cuda.synchronize()
    assert fa.flash_fwd_kernel.routes["wgmma"] == before["wgmma"] + 1
    want, want_lse = fa._flash_fwd_ref(q, k, v, kb, bias, **kw)
    assert not torch.isnan(out.float()).any()
    assert not torch.isnan(lse).any()
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=1e-4)
    return out, lse


WG_CASES = {
    "causal": {}, "full": dict(causal=False),
    "cross_333_1021": dict(tq=333, tk=1021),
    "t1023": dict(b=1, tq=1023, tk=1023, h=2, h_kv=2),
    "gqa4_2": dict(h_kv=2), "mqa4_1": dict(h_kv=1),
    "window64": dict(window=64),
    "kbias": dict(causal=False, kbias=True),
    "bias": dict(causal=False, bias=True),
    "bias_causal": dict(bias=True),
    "kbias_bias_window": dict(kbias=True, bias=True, window=48)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(WG_CASES))
@pytest.mark.parametrize("d", [48, 64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_wgmma_semantics(cuda_device, case, d, dtype):
    """The rule's wgmma tile at widths 48 (in the 64 instantiation: zero
    columns read, never stored), 64 and 128: causal (the queries the
    suffix of the keys), every key visible, ragged tq 333 over tk 1021,
    T 1023, GQA and MQA, a sliding window, the fp32 [B, S] key-padding
    and [B, T, S] biases."""
    spec = dict(WG_CASES[case])
    causal = spec.pop("causal", True)
    window = spec.pop("window", None)
    kbias, bias = spec.pop("kbias", False), spec.pop("bias", False)
    q, k, v = _wg_case(cuda_device, dtype, d=d, **spec)
    b, tq, tk = q.shape[0], q.shape[1], k.shape[1]
    g = torch.Generator(device=cuda_device).manual_seed(5)
    kb = bs = None
    if kbias:
        kb = torch.where(torch.rand(b, tk, device=cuda_device, generator=g)
                         < 0.8, 0.0, -1e9)
    if bias:
        bs = torch.randn(b, tq, tk, device=cuda_device, generator=g)
    kw = dict(sm_scale=d ** -0.5, causal=causal,
              q_offset=tk - tq if causal else 0, window=window)
    _wg_check(q, k, v, kb, bs, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", fa._WGMMA_TILES)
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", ["causal_cross", "bias_window"])
def test_flash_wgmma_every_tile(cuda_device, tile, d, case):
    """Every wgmma tile the tuner may name; one whose bias stages do not
    fit a block's shared memory is refused, by tile_fits and the
    launch."""
    bias_case = case == "bias_window"
    q, k, v = _wg_case(cuda_device, torch.bfloat16, tq=333, tk=400, d=d,
                       seed=7)
    bs = (torch.randn(2, 333, 400, device=cuda_device) if bias_case
          else None)
    kw = dict(sm_scale=d ** -0.5, causal=True, q_offset=67,
              window=80 if bias_case else None)
    if not fa.tile_fits(333, d, torch.bfloat16, tile, bias_case):
        assert bias_case
        with pytest.raises(ValueError, match="not one the forward kernel"):
            fa.flash_fwd_kernel(q, k, v, None, bs, tile=tile, **kw)
        return
    _wg_check(q, k, v, None, bs, kw, tile=tile)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [-512, 0, 512, -475])
@pytest.mark.parametrize("d", [48, 64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_wgmma_signed_ring_offsets(cuda_device, offset, d, dtype):
    """The ring's relative offsets on 512-row shards: a row that sees no
    key gives out 0 and lse -1e30 (at -512 no row sees one, and no tile
    is loaded), no NaN."""
    q, k, v = _wg_case(cuda_device, dtype, tq=512, tk=512, h=6, h_kv=6,
                       d=d, seed=19)
    out, lse = _wg_check(q, k, v, None, None,
                         dict(sm_scale=d ** -0.5, causal=True,
                              q_offset=offset))
    hidden = offset + torch.arange(512, device=cuda_device) < 0
    assert (out[:, hidden] == 0).all()
    assert (lse[:, :, hidden] == fa.NEG_INF).all()
    assert (lse[:, :, ~hidden] > fa.NEG_INF).all()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_wgmma_fully_masked_rows(cuda_device, d, dtype):
    """Rows hidden by the band inside a block that has visible rows: the
    first 100 rows see no key (q_offset -100), with a window the rest see
    at most 30; hidden rows 0 / -1e30, exactly."""
    q, k, v = _wg_case(cuda_device, dtype, tq=256, tk=256, d=d, seed=3)
    out, lse = _wg_check(q, k, v, None, None,
                         dict(sm_scale=d ** -0.5, causal=True,
                              q_offset=-100, window=30))
    assert (out[:, :100] == 0).all()
    assert (lse[:, :, :100] == fa.NEG_INF).all()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [48, 64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_wgmma_reads_fused_projection_views(cuda_device, d, dtype):
    """q, k and v as strided views of one [B, T, 3, H, D] projection:
    read in place by TMA, the same outputs bit for bit as on contiguous
    copies."""
    g = torch.Generator(device=cuda_device).manual_seed(11)
    qkv = torch.randn(2, 300, 3, 4, d, device=cuda_device,
                      generator=g).to(dtype)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous() and fa._tma_ok(d, q, k, v)
    kw = dict(sm_scale=d ** -0.5, causal=True)
    out, lse = _wg_check(q, k, v, None, None, kw)
    out2, lse2 = fa.flash_fwd_kernel(q.contiguous(), k.contiguous(),
                                     v.contiguous(), None, None, **kw)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)


@pytest.mark.cuda
def test_flash_wgmma_refused_view_routes_to_mma_or_raises(cuda_device):
    """A q that starts 2 bytes past a 16-byte boundary breaks TMA's rule:
    the rule routes the call to the mma.sync kernel (its counter moves),
    and an explicit wgmma tile raises."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    n = 2 * 200 * 4 * 64
    flat = torch.randn(n + 1, device=cuda_device, generator=g).to(
        torch.bfloat16)
    q = flat[1:].view(2, 200, 4, 64)
    _, k, v = _wg_case(cuda_device, torch.bfloat16)
    assert not fa._tma_ok(64, q, k, v)
    kw = dict(sm_scale=0.125, causal=True)
    before = dict(fa.flash_fwd_kernel.routes)
    out, lse = fa.flash_fwd_kernel(q, k, v, None, None, **kw)
    torch.cuda.synchronize()
    assert fa.flash_fwd_kernel.routes["mma"] == before["mma"] + 1
    assert fa.flash_fwd_kernel.routes["wgmma"] == before["wgmma"]
    want, _ = fa._flash_fwd_ref(q, k, v, None, None, **kw)
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
    with pytest.raises(ValueError, match="TMA"):
        fa.flash_fwd_kernel(q, k, v, None, None, tile=(64, 96), **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_wgmma_bit_stable(cuda_device, d, dtype):
    """Two calls, identical outputs (no atomics, a fixed order of sums)."""
    q, k, v = _wg_case(cuda_device, dtype, tq=500, tk=500, d=d, seed=8)
    bs = torch.randn(2, 500, 500, device=cuda_device)
    kw = dict(sm_scale=d ** -0.5, causal=True)
    a = fa.flash_fwd_kernel(q, k, v, None, bs, **kw)
    b = fa.flash_fwd_kernel(q, k, v, None, bs, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
def test_flash_routes_count_captured_replays(cuda_device):
    """A captured forward counts its route as it counts its launches: the
    warm run as it runs, the capture nothing, each replay one; the
    replays equal the eager call bit for bit."""
    cache = importlib.import_module("apex_tpu_torch.cache")
    q, k, v = _wg_case(cuda_device, torch.bfloat16, seed=4)

    def fwd(q, k, v):
        return fa.flash_fwd_kernel(q, k, v, None, None, sm_scale=0.125,
                                   causal=True)[0]

    eager = fwd(q, k, v)
    before = dict(fa.flash_fwd_kernel.routes)
    launches = fa.flash_fwd_kernel.launches
    step = cache.warmup(fwd, q, k, v)
    outs = [step(q, k, v).clone() for _ in range(2)]
    torch.cuda.synchronize()
    runs = cache.WARM_RUNS + 2
    assert fa.flash_fwd_kernel.routes["wgmma"] == before["wgmma"] + runs
    assert fa.flash_fwd_kernel.launches == launches + runs
    assert all(fa.flash_fwd_kernel.routes[r] == before[r]
               for r in ("mma", "simt", "split"))
    assert all(torch.equal(o, eager) for o in outs)


# -- the wgmma backward (csrc/flash_attention_bwd_sm90.cu) -------------------------

def _bwd_routes():
    return (dict(fa.flash_bwd_dq_kernel.routes),
            dict(fa.flash_bwd_dkv_kernel.routes))


def _bwd_on_route(q, k, v, do, kb, bs, kw, route, atol=3e-2):
    """dQ and dK/dV on ``route`` (None: the rule's), each launch counted on
    the route wanted (``route`` or wgmma), against the plain version at
    ``atol``; returns ``(dq, dk, dv, part)``."""
    out, lse = fa._flash_fwd_ref(q, k, v, kb, bs, **kw)
    delta = fa._delta(do, out)
    before = _bwd_routes()
    dq = fa.flash_bwd_dq_kernel(q, k, v, do, lse, delta, kb, bs,
                                route=route, **kw)
    dk, dv, part = fa.flash_bwd_dkv_kernel(q, k, v, do, lse, delta, kb, bs,
                                           kbias_grad=kb is not None,
                                           route=route, **kw)
    torch.cuda.synchronize()
    after = _bwd_routes()
    want_route = route or "wgmma"
    for was, now in zip(before, after):
        assert {r: now[r] - was[r] for r in now} == {
            r: int(r == want_route) for r in now}
    want = fa._flash_bwd_ref(q, k, v, kb, bs, out, lse, do, **kw)
    for name, got, wnt in (("dq", dq, want[0]), ("dk", dk, want[1]),
                           ("dv", dv, want[2])):
        assert got.dtype == q.dtype and got.shape == wnt.shape, name
        assert not torch.isnan(got.float()).any(), name
        torch.testing.assert_close(got.float(), wnt.float(), atol=atol,
                                   rtol=atol, msg=name)
    if kb is not None:
        torch.testing.assert_close(part.sum(1) / kw["sm_scale"], want[3],
                                   atol=atol, rtol=atol)
    return dq, dk, dv, part


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(TC_BWD_CASES))
@pytest.mark.parametrize("d", [48, 64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_bwd_wgmma_route_matches_plain(cuda_device, case, d, dtype):
    """Every tensor-core backward case on the wgmma kernels at widths 48
    (in the 64 instantiation), 64 and 128, each launch on the wgmma
    route, and the mma.sync kernels on the same inputs, both within the
    unchanged 3e-2 of the plain version."""
    args = _bwd_case(cuda_device, dtype, d=d, seed=24, **TC_BWD_CASES[case])
    _bwd_on_route(*args, route=None)
    _bwd_on_route(*args, route="mma")


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [-512, 0, 512, -475])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_bwd_wgmma_signed_ring_offsets(cuda_device, offset, d):
    """The ring's relative offsets on 512-row shards: a hidden row's dQ
    and an unseen key's dK and dV are 0 exactly (at -512 nothing is
    seen and only zeros are written), no NaN."""
    q, k, v, do, kb, bs, kw = _bwd_case(cuda_device, torch.bfloat16,
                                        tq=512, tk=512, h=4, h_kv=2, d=d,
                                        seed=36)
    kw = dict(kw, q_offset=offset)
    dq, dk, dv, _ = _bwd_on_route(q, k, v, do, kb, bs, kw, route=None)
    hidden = offset + torch.arange(512, device=cuda_device) < 0
    assert (dq[:, hidden] == 0).all()
    unseen = torch.arange(512, device=cuda_device) > offset + 511
    assert (dk[:, unseen] == 0).all() and (dv[:, unseen] == 0).all()


def _bwd_float64_witness(q, k, v, kb, do, lse, delta, *, sm_scale, **_):
    """dq, dk and dv of an unmasked call as :func:`fa._flash_bwd_ref`
    computes them, with dp, ds and every product in float64 from the same
    fp32 scores, lse and delta: p and ds rounded to the inputs' dtype
    before their products, as the kernels and the plain version round
    them, and nothing else rounded."""
    kr, vr = fa._repeat_kv(q, k, v)
    p = torch.exp(fa._scores(q, kr, kb, None, sm_scale) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.double(), vr.double())
    ds = p.double() * (dp - delta.double()[..., None]) * sm_scale
    dsr = ds.float().to(q.dtype).double()
    dq = torch.einsum("bhqk,bkhd->bqhd", dsr, kr.double())
    dk = torch.einsum("bhqk,bqhd->bkhd", dsr, q.double())
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).double(),
                      do.double())
    b, tk, h_kv, d = k.shape
    grp = q.shape[2] // h_kv
    return (dq, dk.reshape(b, tk, h_kv, grp, d).sum(3),
            dv.reshape(b, tk, h_kv, grp, d).sum(3))


def _gaps(got, want, atol=3e-2):
    """Per output: the largest |got - want| and the largest excess over
    ``atol + atol * |want|`` (assert_close's bound; <= 0 within it)."""
    out = {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        diff = (g.double() - w.double()).abs()
        out[name] = (diff.max().item(),
                     (diff - atol - atol * w.double().abs()).max().item())
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_bwd_wgmma_fully_masked_rows(cuda_device, d, dtype):
    """Rows the band hides entirely (lse -1e30: the first 100 see no key
    at q_offset -100, the rest at most 30 with the window), and rows whose
    keys a -1e9 key-padding bias hides everywhere, on the wgmma kernels.
    There the fp32 scores all round to -1e9, every p is 1 and |dq| reaches
    ~80 as a sum of 256 terms that can cancel, so a ds that an fp32
    rounding puts on the other side of a bf16 rounding moves dq by up to
    ~0.04.  Both kernels are held, within the same 3e-2, to the float64
    witness (:func:`_bwd_float64_witness`), dk and dv to the plain
    version too, and dq to the plain version at width 64; each gap is
    printed, the plain version's own to the witness beside it."""
    q, k, v, do, kb, bs, kw = _bwd_case(cuda_device, dtype, tq=256, tk=256,
                                        d=d, seed=27)
    kw = dict(kw, q_offset=-100, window=30)
    dq, _, _, _ = _bwd_on_route(q, k, v, do, kb, bs, kw, route=None)
    assert (dq[:, :100] == 0).all()
    kb = torch.full((2, 256), -1e9, device=cuda_device)
    kw = dict(kw, causal=False, window=None, q_offset=0)
    if d == 64:
        _bwd_on_route(q, k, v, do, kb, None, kw, route=None)
    out, lse = fa._flash_fwd_ref(q, k, v, kb, None, **kw)
    delta = fa._delta(do, out)
    plain = fa._flash_bwd_ref(q, k, v, kb, None, out, lse, do, **kw)[:3]
    witness = _bwd_float64_witness(q, k, v, kb, do, lse, delta, **kw)
    print(f"\n-1e9 on every key, d {d} {dtype}: (max |diff|, excess over "
          f"3e-2 + 3e-2 |want|); plain vs witness {_gaps(plain, witness)}")
    for route in ("wgmma", "mma"):
        got = (fa.flash_bwd_dq_kernel(q, k, v, do, lse, delta, kb, None,
                                      route=route, **kw),
               *fa.flash_bwd_dkv_kernel(q, k, v, do, lse, delta, kb, None,
                                        kbias_grad=True, route=route,
                                        **kw)[:2])
        torch.cuda.synchronize()
        print(f"  {route}: vs witness {_gaps(got, witness)}, vs plain "
              f"{_gaps(got, plain)}")
        for name, g, w in zip(("dq", "dk", "dv"), got, witness):
            torch.testing.assert_close(g.double(), w, atol=3e-2, rtol=3e-2,
                                       msg=f"{route} {name} vs witness")
        for name, g, w in zip(("dq", "dk", "dv"), got, plain):
            if name == "dq" and d != 64:
                continue   # its gap is printed above
            torch.testing.assert_close(g.float(), w.float(), atol=3e-2,
                                       rtol=3e-2, msg=f"{route} {name}")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_bwd_wgmma_reads_fused_projection_views(cuda_device, d,
                                                      dtype):
    """q, k and v as strided views of one [B, T, 3, H, D] projection (do
    contiguous, as autograd hands it): read in place by TMA, the same
    gradients bit for bit as on contiguous copies."""
    g = torch.Generator(device=cuda_device).manual_seed(11)
    qkv = torch.randn(2, 300, 3, 4, d, device=cuda_device,
                      generator=g).to(dtype)
    q, k, v = qkv.unbind(2)
    do = torch.randn(2, 300, 4, d, device=cuda_device, generator=g).to(dtype)
    assert not q.is_contiguous() and fa._tma_ok(d, q, k, v, do)
    kw = dict(sm_scale=d ** -0.5, causal=True, q_offset=0, window=None)
    got = _bwd_on_route(q, k, v, do, None, None, kw, route=None)
    out, lse = fa._flash_fwd_ref(q, k, v, None, None, **kw)
    delta = fa._delta(do, out)
    qc, kc, vc = (x.contiguous() for x in (q, k, v))
    dq = fa.flash_bwd_dq_kernel(qc, kc, vc, do, lse, delta, None, None, **kw)
    dk, dv, _ = fa.flash_bwd_dkv_kernel(qc, kc, vc, do, lse, delta, None,
                                        None, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got[:3], (dq, dk, dv)))


@pytest.mark.cuda
def test_flash_bwd_refused_view_routes_to_mma(cuda_device):
    """A do that starts 2 bytes past a 16-byte boundary breaks TMA's rule:
    dQ and dK/dV run the mma.sync kernels (their counters move), and the
    wgmma route named for such a view raises."""
    q, k, v, _, kb, bs, kw = _bwd_case(cuda_device, torch.bfloat16, seed=5)
    g = torch.Generator(device=cuda_device).manual_seed(2)
    flat = torch.randn(q.numel() + 1, device=cuda_device, generator=g).to(
        torch.bfloat16)
    do = flat[1:].view(q.shape)
    assert not fa._tma_ok(64, q, k, v, do)
    out, lse = fa._flash_fwd_ref(q, k, v, None, None, **kw)
    delta = fa._delta(do, out)
    before = _bwd_routes()
    dq = fa.flash_bwd_dq_kernel(q, k, v, do, lse, delta, None, None, **kw)
    dk, dv, _ = fa.flash_bwd_dkv_kernel(q, k, v, do, lse, delta, None,
                                        None, **kw)
    torch.cuda.synchronize()
    for was, now in zip(before, _bwd_routes()):
        assert now["mma"] == was["mma"] + 1 and now["wgmma"] == was["wgmma"]
    want = fa._flash_bwd_ref(q, k, v, None, None, out, lse, do, **kw)
    for got, wnt in zip((dq, dk, dv), want[:3]):
        torch.testing.assert_close(got.float(), wnt.float(), atol=3e-2,
                                   rtol=3e-2)
    with pytest.raises(ValueError, match="route"):
        fa.flash_bwd_dq_kernel(q, k, v, do, lse, delta, None, None,
                               route="wgmma", **kw)


@pytest.mark.cuda
def test_flash_bwd_routes_count_captured_replays(cuda_device):
    """Captured dQ and dK/dV count their routes as they count their
    launches: the warm run as it runs, the capture nothing, each replay
    one; the replays equal the eager calls bit for bit."""
    cache = importlib.import_module("apex_tpu_torch.cache")
    q, k, v, do, _, _, kw = _bwd_case(cuda_device, torch.bfloat16, seed=6)
    out, lse = fa._flash_fwd_ref(q, k, v, None, None, **kw)
    delta = fa._delta(do, out)

    def bwd(q, k, v, do):
        dq = fa.flash_bwd_dq_kernel(q, k, v, do, lse, delta, None, None,
                                    **kw)
        return (dq, *fa.flash_bwd_dkv_kernel(q, k, v, do, lse, delta, None,
                                             None, **kw)[:2])

    eager = bwd(q, k, v, do)
    before = _bwd_routes()
    launches = (fa.flash_bwd_dq_kernel.launches,
                fa.flash_bwd_dkv_kernel.launches)
    step = cache.warmup(bwd, q, k, v, do)
    outs = [[t.clone() for t in step(q, k, v, do)] for _ in range(2)]
    torch.cuda.synchronize()
    runs = cache.WARM_RUNS + 2
    for was, now in zip(before, _bwd_routes()):
        assert now == dict(was, wgmma=was["wgmma"] + runs)
    assert (fa.flash_bwd_dq_kernel.launches,
            fa.flash_bwd_dkv_kernel.launches) == (launches[0] + runs,
                                                  launches[1] + runs)
    assert all(torch.equal(a, b) for o in outs for a, b in zip(o, eager))


# -- kernels 14 and 1 on wgmma (csrc/quant_sm90.cu, csrc/conv_sm90.cu) --------------

def _routed(wrapper, fn):
    """``fn()``'s result and the launches it added to each of
    ``wrapper.routes``."""
    before = dict(wrapper.routes)
    out = fn()
    torch.cuda.synchronize()
    return out, {r: n - before[r] for r, n in wrapper.routes.items()
                 if n != before[r]}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("m", [65, 1000, 1024, 8184])
def test_qmm_wgmma_route_bit_for_bit(cuda_device, dtype, m):
    """The prefill and training rows (M > 64) run quant_sm90.cu's wgmma
    kernel, bit for bit ``_qmm_ref`` at N 130, 768, 3072 and K 40, 768,
    3072 (the K tail read as TMA's zero fill), with a zero-amax weight
    column, in the input dtype and fp32 out; each launch counted on the
    wgmma route, which the rule takes at K 768 and 3072 (K 40 keeps
    mma.sync); quant.cu's mma.sync kernel on the same inputs gives the
    same bits."""
    for n in (130, 768, 3072):
        for k in (40, 768, 3072):
            x, qw, xs, ws = _qmm_operands(cuda_device, m, k, n, dtype,
                                          seed=m + 3 * k + n)
            rule = "wgmma" if k >= 128 else "mma"
            assert qk._route(m, k, n, dtype, None,
                             qk._tma_ok(x, qw)) == rule
            for out_dtype in (dtype, torch.float32):
                got, routes = _routed(qk.qmm_kernel, lambda: qk.qmm_kernel(
                    x, qw, xs, ws, out_dtype, route="wgmma"))
                assert routes == {"wgmma": 1}, (n, k, routes)
                assert torch.equal(got, qk._qmm_ref(x, qw, xs, ws,
                                                    out_dtype)), (n, k)
                assert not got[:, n // 3].any()
            mma, routes = _routed(qk.qmm_kernel, lambda: qk.qmm_kernel(
                x, qw, xs, ws, dtype, route="mma"))
            assert routes == {"mma": 1}
            assert torch.equal(mma, qk._qmm_ref(x, qw, xs, ws, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qmm_wgmma_every_tile_bit_for_bit(cuda_device, dtype):
    """Every tile of the wgmma kernel (two warpgroups over the rows or
    over K) gives the plain version's bits, and ``kernel_tile`` answers
    for it from the library."""
    x, qw, xs, ws = _qmm_operands(cuda_device, 1000, 768, 3072, dtype,
                                  seed=5)
    want = qk._qmm_ref(x, qw, xs, ws, dtype)
    for tile in qk._wgmma_tiles(x.element_size()):
        got, routes = _routed(qk.qmm_kernel, lambda: qk.qmm_kernel(
            x, qw, xs, ws, dtype, tile))
        assert routes == {"wgmma": 1} and torch.equal(got, want), tile
        assert qk.kernel_tile(1000, 768, 3072, dtype, tile) == tile
    assert qk.kernel_tile(1000, 768, 3072, dtype) in qk._wgmma_tiles(
        x.element_size())


@pytest.mark.cuda
def test_qmm_routes_refuse_what_they_do_not_take(cuda_device):
    """A route the call cannot take raises: wgmma for decode rows or for
    an x TMA cannot read (its start off 16 bytes), split for prefill
    rows, a tile neither kernel has; the decode rows run split."""
    bf = torch.bfloat16
    x, qw, xs, ws = _qmm_operands(cuda_device, 64, 768, 768, bf, seed=3)
    with pytest.raises(ValueError, match="route 'wgmma'"):
        qk.qmm_kernel(x, qw, xs, ws, bf, route="wgmma")
    got, routes = _routed(qk.qmm_kernel, lambda: qk.qmm_kernel(
        x, qw, xs, ws, bf, route="split"))
    assert routes == {"split": 1}
    assert torch.equal(got, qk._qmm_ref(x, qw, xs, ws, bf))
    x, qw, xs, ws = _qmm_operands(cuda_device, 300, 768, 768, bf, seed=3)
    with pytest.raises(ValueError, match="route 'split'"):
        qk.qmm_kernel(x, qw, xs, ws, bf, route="split")
    buf = torch.empty(300 * 768 + 1, dtype=bf, device=cuda_device)
    xu = buf[1:].view(300, 768)
    xu.copy_(x)
    with pytest.raises(ValueError, match="route 'wgmma'"):
        qk.qmm_kernel(xu, qw, xs, ws, bf, route="wgmma")
    got, routes = _routed(qk.qmm_kernel, lambda: qk.qmm_kernel(
        xu, qw, xs, ws, bf))
    assert routes == {"mma": 1}
    assert torch.equal(got, qk._qmm_ref(x, qw, xs, ws, bf))
    with pytest.raises(ValueError, match="not one the kernel has"):
        qk.qmm_kernel(x.float(), qw, xs, ws, torch.float32, (128, 256))


#: phase 15's forward shapes that take the wgmma route (ResNet-50 at B
#: 128), then ragged M and N, padded edges and stride 2 at small sizes:
#: x shape, w shape, stride, flax padding
WGMMA_CONV_CASES = {
    "[128,56,56,64] 3x3/1": ((128, 56, 56, 64), (3, 3, 64, 64), 1, "SAME"),
    "[128,56,56,128] 3x3/2": ((128, 56, 56, 128), (3, 3, 128, 128), 2,
                              "SAME"),
    "[128,14,14,1024] 1x1 ->256": ((128, 14, 14, 1024), (1, 1, 1024, 256),
                                   1, "SAME"),
    "[128,14,14,1024] 1x1/2 ->2048": ((128, 14, 14, 1024),
                                      (1, 1, 1024, 2048), 2, "SAME"),
    "[128,56,56,64] 1x1 ->256": ((128, 56, 56, 64), (1, 1, 64, 256), 1,
                                 "SAME"),
    "ragged 3x3/2 ->72": ((3, 9, 11, 64), (3, 3, 64, 72), 2, "SAME"),
    "ragged 3x3/1 ->8": ((2, 7, 5, 128), (3, 3, 128, 8), 1,
                         ((2, 0), (1, 1))),
    "ragged 1x1/2 valid ->136": ((1, 13, 13, 192), (1, 1, 192, 136), 2,
                                 "VALID"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", sorted(WGMMA_CONV_CASES))
def test_conv_fwd_wgmma_route(conv_device, case, dtype):
    """bf16 and fp16 with C a multiple of 64 run conv_sm90.cu's wgmma
    kernel: within phase 15's tolerance of the plain conv, both tile
    widths bit for bit, and with the fused epilogue the output equal to
    ``fused_bn_act._fwd_ref`` of the route's own pre-activation bit for
    bit; each launch counted on the wgmma route."""
    xs, ws, s, pad = WGMMA_CONV_CASES[case]
    stride, dil = (s, s), (1, 1)
    padding = cv._norm_padding(pad, xs[1], xs[2], ws[0], ws[1], s, s, 1, 1)
    oh, ow = cv._out_hw(xs[1], xs[2], padding, ws[0], ws[1], s, s, 1, 1)
    gen = torch.Generator(device=conv_device).manual_seed(21)
    x = torch.randn(xs, device=conv_device, generator=gen).to(dtype)
    w = (torch.randn(ws, device=conv_device, generator=gen)
         / (ws[0] * ws[1] * ws[2]) ** 0.5).to(dtype)
    o = ws[3]
    epi = (0.3 * torch.randn(o, device=conv_device, generator=gen),
           torch.rand(o, device=conv_device, generator=gen) + 0.5,
           1 + 0.2 * torch.randn(o, device=conv_device, generator=gen),
           0.2 * torch.randn(o, device=conv_device, generator=gen),
           torch.randn((xs[0], oh, ow, o), device=conv_device,
                       generator=gen).to(dtype), True)
    (out, _), routes = _routed(cv.conv_fwd_kernel, lambda: cv.conv_fwd_kernel(
        x, w, stride, padding, dil))
    assert routes == {"wgmma": 1}
    _conv_err_ok(out, cv._fwd_ref(x, w, stride, padding, dil)[0])
    for bn in (64, 128):
        assert torch.equal(cv.conv_fwd_kernel(x, w, stride, padding, dil,
                                              block_n=bn)[0], out), bn
    (got, pre), routes = _routed(cv.conv_fwd_kernel, lambda: (
        cv.conv_fwd_kernel(x, w, stride, padding, dil, *epi,
                           want_preact=True)))
    assert routes == {"wgmma": 1}
    assert torch.equal(pre, out)
    assert torch.equal(got, fba._fwd_ref(pre, *epi))


@pytest.mark.cuda
def test_conv_fwd_routes_refuse_what_they_do_not_take(conv_device):
    """The stem's C = 3 and fp32 keep conv.cu's routes (mma, simt), and
    naming wgmma for them raises; mma may run where the rule is
    wgmma."""
    pads = ((1, 1), (1, 1))
    x = torch.randn((2, 8, 8, 3), device=conv_device, dtype=torch.bfloat16)
    w = torch.randn((3, 3, 3, 64), device=conv_device, dtype=torch.bfloat16)
    _, routes = _routed(cv.conv_fwd_kernel, lambda: cv.conv_fwd_kernel(
        x, w, (1, 1), pads, (1, 1)))
    assert routes == {"mma": 1}
    with pytest.raises(ValueError, match="route 'wgmma'"):
        cv.conv_fwd_kernel(x, w, (1, 1), pads, (1, 1), route="wgmma")
    x = torch.randn((2, 8, 8, 64), device=conv_device)
    w = torch.randn((3, 3, 64, 64), device=conv_device)
    _, routes = _routed(cv.conv_fwd_kernel, lambda: cv.conv_fwd_kernel(
        x, w, (1, 1), pads, (1, 1)))
    assert routes == {"simt": 1}
    for route in ("wgmma", "mma"):
        with pytest.raises(ValueError, match=f"route '{route}'"):
            cv.conv_fwd_kernel(x, w, (1, 1), pads, (1, 1), route=route)
    xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
    _, routes = _routed(cv.conv_fwd_kernel, lambda: cv.conv_fwd_kernel(
        xb, wb, (1, 1), pads, (1, 1), route="mma"))
    assert routes == {"mma": 1}


#: the conv backward's wgmma cases: every ResNet-50 site but the stem at
#: B 2 (``RESNET50_SITES``, flax 'SAME' pads), then ragged M, padded edges,
#: strides 1 and 2, a dilated tap and a ragged C under a dgrad of O 64:
#: x shape, w shape, stride, padding, dilation
WGMMA_BWD_CASES = dict(
    {site: (xs, ws, s, "SAME", 1)
     for site, (xs, ws, s) in RESNET50_SITES.items() if xs[3] % 64 == 0},
    **{"ragged 3x3/1 pad (2,0),(1,1) 128->64": (
           (2, 7, 5, 128), (3, 3, 128, 64), 1, ((2, 0), (1, 1)), 1),
       "ragged 3x3/2 64->128": ((3, 9, 11, 64), (3, 3, 64, 128), 2,
                                "SAME", 1),
       "ragged 1x1/2 valid 192->64": ((1, 13, 13, 192), (1, 1, 192, 64), 2,
                                      "VALID", 1),
       "ragged 3x3/2 pad (0,1) 64->72": ((3, 10, 9, 64), (3, 3, 64, 72), 2,
                                         ((0, 1), (0, 1)), 1),
       "dilated 3x3 64->64": ((2, 12, 12, 64), (3, 3, 64, 64), 1, "VALID",
                              2),
       "dgrad ragged C 40 ->64": ((2, 6, 6, 40), (3, 3, 40, 64), 1, "SAME",
                                  1)})


def _conv_bwd_case(device, case, dtype, seed):
    xs, ws, s, pad, d = WGMMA_BWD_CASES[case]
    stride, dil = (s, s), (d, d)
    padding = cv._norm_padding(pad, xs[1], xs[2], ws[0], ws[1], s, s, d, d)
    oh, ow = cv._out_hw(xs[1], xs[2], padding, ws[0], ws[1], s, s, d, d)
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(xs, device=device, generator=gen).to(dtype)
    w = (torch.randn(ws, device=device, generator=gen)
         / (ws[0] * ws[1] * ws[2]) ** 0.5).to(dtype)
    dy = torch.randn((xs[0], oh, ow, ws[3]), device=device,
                     generator=gen).to(dtype)
    return x, w, dy, stride, padding, dil


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", sorted(
    c for c, (_, ws, *_) in WGMMA_BWD_CASES.items() if ws[3] % 64 == 0))
def test_conv_dgrad_wgmma_route(conv_device, case, dtype):
    """bf16 and fp16 dgrad with O a multiple of 64 runs conv_sm90.cu's
    wgmma kernel (the parity classes in one launch at stride 2): within
    phase 15's tolerance of the plain version, both tile widths bit for
    bit, each launch counted on the wgmma route."""
    x, w, dy, stride, padding, dil = _conv_bwd_case(conv_device, case,
                                                    dtype, 22)
    hw = x.shape[1:3]
    dx, routes = _routed(cv.conv_dgrad_kernel, lambda: cv.conv_dgrad_kernel(
        dy, w, stride, padding, dil, hw))
    assert routes == {"wgmma": 1}
    _conv_err_ok(dx, cv._dgrad_ref(dy, w, stride, padding, dil, hw))
    for bn in (64, 128):
        assert torch.equal(cv.conv_dgrad_kernel(dy, w, stride, padding, dil,
                                                hw, block_n=bn), dx), bn


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", sorted(
    c for c, (xs, _, _, _, d) in WGMMA_BWD_CASES.items()
    if xs[3] % 64 == 0 and d == 1))
def test_conv_wgrad_wgmma_route(conv_device, case, dtype):
    """bf16 and fp16 wgrad with C a multiple of 64 runs conv_sm90.cu's
    wgmma kernel and its reduce: within phase 15's tolerance of the plain
    version, 99.9% of bf16 elements within one ulp of the fp64 sum, both
    tile widths (256 x 64 and 128 x 128) bit for bit, each call counted
    once on the wgmma route."""
    x, w, dy, stride, padding, dil = _conv_bwd_case(conv_device, case,
                                                    dtype, 23)
    ks = w.shape[:2]
    dw, routes = _routed(cv.conv_wgrad_kernel, lambda: cv.conv_wgrad_kernel(
        x, dy, stride, padding, dil, ks))
    assert routes == {"wgmma": 1}
    _conv_err_ok(dw, cv._wgrad_ref(x, dy, stride, padding, dil, ks),
                 _wgrad_fp64(x, dy, stride, padding, ks))
    for bn in (64, 128):
        assert torch.equal(cv.conv_wgrad_kernel(x, dy, stride, padding, dil,
                                                ks, block_n=bn), dw), bn


@pytest.mark.cuda
def test_conv_bwd_routes_refuse_what_they_do_not_take(conv_device):
    """dgrad with O not a multiple of 64 or a stride of more than 16
    parity classes, and the stem's wgrad (C = 3), keep conv.cu's mma.sync
    kernels and refuse wgmma; fp32 keeps SIMT and refuses both
    tensor-core routes; mma may run where the rule is wgmma."""
    pads, bf = ((1, 1), (1, 1)), torch.bfloat16
    dy = torch.randn((2, 8, 8, 72), device=conv_device, dtype=bf)
    w = torch.randn((3, 3, 64, 72), device=conv_device, dtype=bf)
    _, routes = _routed(cv.conv_dgrad_kernel, lambda: cv.conv_dgrad_kernel(
        dy, w, (1, 1), pads, (1, 1), (8, 8)))
    assert routes == {"mma": 1}
    with pytest.raises(ValueError, match="dgrad route 'wgmma'"):
        cv.conv_dgrad_kernel(dy, w, (1, 1), pads, (1, 1), (8, 8),
                             route="wgmma")
    x = torch.randn((2, 8, 8, 3), device=conv_device, dtype=bf)
    dy = torch.randn((2, 8, 8, 64), device=conv_device, dtype=bf)
    _, routes = _routed(cv.conv_wgrad_kernel, lambda: cv.conv_wgrad_kernel(
        x, dy, (1, 1), pads, (1, 1), (3, 3)))
    assert routes == {"mma": 1}
    with pytest.raises(ValueError, match="wgrad route 'wgmma'"):
        cv.conv_wgrad_kernel(x, dy, (1, 1), pads, (1, 1), (3, 3),
                             route="wgmma")
    x = torch.randn((2, 8, 8, 64), device=conv_device)
    dy = torch.randn((2, 8, 8, 64), device=conv_device)
    w = torch.randn((3, 3, 64, 64), device=conv_device)
    for route in ("wgmma", "mma"):
        with pytest.raises(ValueError, match=f"dgrad route '{route}'"):
            cv.conv_dgrad_kernel(dy, w, (1, 1), pads, (1, 1), (8, 8),
                                 route=route)
        with pytest.raises(ValueError, match=f"wgrad route '{route}'"):
            cv.conv_wgrad_kernel(x, dy, (1, 1), pads, (1, 1), (3, 3),
                                 route=route)
    _, routes = _routed(cv.conv_wgrad_kernel, lambda: cv.conv_wgrad_kernel(
        x, dy, (1, 1), pads, (1, 1), (3, 3)))
    assert routes == {"simt": 1}
    # a stride of more than 16 parity classes runs conv.cu's dgrad
    dy5 = torch.randn((1, 4, 4, 64), device=conv_device, dtype=bf)
    w5 = torch.randn((1, 1, 64, 64), device=conv_device, dtype=bf)
    valid = ((0, 0), (0, 0))
    dx5, routes = _routed(cv.conv_dgrad_kernel, lambda: cv.conv_dgrad_kernel(
        dy5, w5, (5, 5), valid, (1, 1), (20, 20)))
    assert routes == {"mma": 1}
    _conv_err_ok(dx5, cv._dgrad_ref(dy5, w5, (5, 5), valid, (1, 1),
                                    (20, 20)))
    with pytest.raises(ValueError, match="dgrad route 'wgmma'"):
        cv.conv_dgrad_kernel(dy5, w5, (5, 5), valid, (1, 1), (20, 20),
                             route="wgmma")
    xb, dyb, wb = x.to(bf), dy.to(bf), w.to(bf)
    for kernel, args in ((cv.conv_dgrad_kernel, (dyb, wb, (1, 1), pads,
                                                 (1, 1), (8, 8))),
                         (cv.conv_wgrad_kernel, (xb, dyb, (1, 1), pads,
                                                 (1, 1), (3, 3)))):
        _, routes = _routed(kernel, lambda: kernel(*args, route="mma"))
        assert routes == {"mma": 1}
        _, routes = _routed(kernel, lambda: kernel(*args))
        assert routes == {"wgmma": 1}


@pytest.mark.cuda
def test_db2_kernel_names_seen_from_a_fresh_process(cuda_device):
    """The db2 path test's profiler window, in a new process, where the
    db2 kernel's first launch loads its module: ``_db2_kernel_names``
    sees the one tensor-core db2 launch (its call before the window keeps
    that load out of it)."""
    import os
    import subprocess
    import sys
    tests = os.path.dirname(os.path.abspath(__file__))
    code = (
        "import json, sys, torch\n"
        f"sys.path[:0] = [{os.path.dirname(tests)!r}, {tests!r}]\n"
        "import test_torch_kernels_cuda as t\n"
        "dev = torch.device('cuda')\n"
        "q, k, v, do, kb, bs, kw = t._bwd_case(dev, torch.bfloat16, d=64, "
        "tq=100, tk=100, bias=True, seed=33)\n"
        "out, lse = t.fa._flash_fwd_ref(q, k, v, kb, bs, **kw)\n"
        "delta = t.fa._delta(do, out)\n"
        "print(json.dumps(t._db2_kernel_names(lambda: "
        "t.fa.flash_bwd_db2_kernel(q, k, v, do, lse, delta, kb, bs, "
        "**kw))))\n")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-2000:]
    names = json.loads(run.stdout.strip().splitlines()[-1])
    assert len(names) == 1 and "db2_mma" in names[0], names
