"""The port's kernels against their plain versions, on the card.

Imports neither JAX nor the test conftest's JAX set-up, so it runs on a
GPU host without JAX:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Every test is marked ``cuda`` and skips (inside its fixture) where no
CUDA device is visible.
"""

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
    """Gradients go through the backward kernels; only the [B, T, S]
    bias gradient and a per-head bias have no kernel and raise."""
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
    with pytest.raises(NotImplementedError, match="_bwd_db2_kernel"):
        fa.flash_attention(q, q, q, bias=bias)
    with pytest.raises(NotImplementedError, match="per-head"):
        fa.flash_attention(q.detach(), q.detach(), q.detach(),
                           bias=torch.zeros(1, 2, 8, 8, device=cuda_device))


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
    from apex_tpu_torch.parallel.sync_batchnorm import _moments
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
        mean, var, _ = _moments(x, (0, 1, 2))
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
