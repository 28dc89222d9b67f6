"""The port's NHWC conv (``apex_tpu_torch.ops.conv``) against the JAX
package's Pallas conv, run in interpret mode (the real Pallas kernels on
the CPU, as ``tests/test_conv.py`` runs them).

Same numpy inputs through both.  Tolerances: fp32 rtol/atol 1e-4 (the
summation order differs); bf16 forward 1e-1 (the JAX test's own: bf16
outputs of sums over up to 392 products); gradients 1e-4 in fp32.  On
the CPU the port runs its plain versions only, so every conv kernel
counter stays 0; the kernels themselves are held against those plain
versions on the card (``tests/test_torch_kernels_cuda.py``,
``chip_smoke.py`` phase 15).
"""

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from apex_tpu.ops import conv as jconv
from apex_tpu_torch.models.resnet import Conv
from apex_tpu_torch.ops import conv as tconv

# (x_shape, w_shape, stride, padding, dilation): tests/test_conv.py's
# matrix, then the C = 3 stem at a small size and a ragged C = 5, O = 8
MATRIX = [
    ((2, 8, 8, 16), (3, 3, 16, 32), 1, "SAME", 1),
    ((2, 9, 7, 8), (3, 3, 8, 16), 2, "SAME", 1),
    ((2, 8, 8, 8), (1, 1, 8, 16), 1, "VALID", 1),
    ((2, 8, 8, 8), (1, 1, 8, 16), 2, "VALID", 1),
    ((2, 12, 12, 8), (3, 3, 8, 16), 1, "VALID", 2),
    ((1, 14, 14, 8), (7, 7, 8, 16), 2, ((3, 3), (3, 3)), 1),
    ((2, 16, 16, 3), (7, 7, 3, 8), 2, ((3, 3), (3, 3)), 1),
    ((2, 10, 10, 5), (3, 3, 5, 8), 2, "SAME", 1),
]
IDS = ["stage", "odd_stride", "pointwise", "strided_1x1", "dilated",
       "stem_like", "stem_c3", "ragged_c5_o8"]


def _arrays(seed, *shapes):
    rs = np.random.RandomState(seed)
    return [rs.randn(*s).astype(np.float32) for s in shapes]


def _geometry(case):
    xs, ws, s, p, d = MATRIX[case]
    stride, dilation = tconv._pair(s), tconv._pair(d)
    padding = tconv._norm_padding(p, xs[1], xs[2], ws[0], ws[1], *stride,
                                  *dilation)
    return xs, ws, stride, padding, dilation


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(MATRIX)), ids=IDS)
def test_forward_matches_jax_pallas(case, dtype):
    xs, ws, s, p, d = MATRIX[case]
    x, w = _arrays(case, xs, ws)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jconv.conv2d(jnp.asarray(x, jdt), jnp.asarray(w, jdt), stride=s,
                        padding=p, dilation=d, interpret=True)
    got = tconv.conv2d(torch.from_numpy(x).to(tdt),
                       torch.from_numpy(w).to(tdt), stride=s, padding=p,
                       dilation=d)
    assert tuple(got.shape) == want.shape and got.dtype == tdt
    _close(got.float().numpy(), want, 1e-1 if dtype == "bfloat16" else 1e-4)


@pytest.mark.parametrize("case", range(len(MATRIX)), ids=IDS)
def test_dx_dw_match_jax_grad_of_pallas(case):
    """dx and dw of ``sum(sin(conv))``: the port's Function (plain
    backward on the CPU) against ``jax.grad`` through the Pallas dgrad
    and wgrad kernels.  The weights are scaled by ``1 / sqrt(fan_in)``,
    as an initialized layer's are, so the outputs are of unit size."""
    xs, ws, s, p, d = MATRIX[case]
    x, w = _arrays(10 + case, xs, ws)
    w = w / np.float32(np.sqrt(ws[0] * ws[1] * ws[2]))

    def jloss(x, w):
        return jnp.sum(jnp.sin(jconv.conv2d(x, w, stride=s, padding=p,
                                            dilation=d, interpret=True)))
    jdx, jdw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    loss = torch.sin(tconv.conv2d(tx, tw, stride=s, padding=p,
                                  dilation=d)).sum()
    dx, dw = torch.autograd.grad(loss, (tx, tw))
    _close(dx.numpy(), jdx, 1e-4)
    _close(dw.numpy(), jdw, 1e-4)


@pytest.mark.parametrize("case", range(len(MATRIX)), ids=IDS)
def test_plain_dgrad_wgrad_match_pallas_kernels(case):
    """Each backward kernel's plain version (what the card holds its
    kernel against) against the Pallas kernel it replaces, on the same
    cotangent."""
    xs, ws, stride, padding, dilation = _geometry(case)
    oh, ow = tconv._out_hw(xs[1], xs[2], padding, ws[0], ws[1], *stride,
                           *dilation)
    x, w, dy = _arrays(20 + case, xs, ws, (xs[0], oh, ow, ws[3]))
    want_dx = jconv._pallas_dgrad(jnp.asarray(dy), jnp.asarray(w), stride,
                                  padding, dilation, xs[1:3], (None, None),
                                  True)
    want_dw = jconv._pallas_wgrad(jnp.asarray(x), jnp.asarray(dy), stride,
                                  padding, dilation, ws, (None, None), True,
                                  jnp.float32)
    got_dx = tconv._dgrad_ref(torch.from_numpy(dy), torch.from_numpy(w),
                              stride, padding, dilation, xs[1:3])
    got_dw = tconv._wgrad_ref(torch.from_numpy(x), torch.from_numpy(dy),
                              stride, padding, dilation, ws[:2])
    _close(got_dx.numpy(), want_dx, 1e-4)
    _close(got_dw.numpy(), want_dw, 1e-4)


def _epilogue(seed, o, out_shape, with_z):
    rs = np.random.RandomState(seed)
    mean, scale, bias = (rs.randn(o).astype(np.float32) for _ in range(3))
    invstd = (np.abs(rs.randn(o)) + 0.5).astype(np.float32)
    z = rs.randn(*out_shape).astype(np.float32) if with_z else None
    return mean, invstd, scale, bias, z


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "no_relu"])
@pytest.mark.parametrize("with_z", [False, True], ids=["no_z", "z"])
def test_fused_epilogue_forward_and_seven_cotangents(with_z, relu):
    """conv + BN epilogue (+ residual) (+ ReLU): the forward, the
    pre-activation and every cotangent (x, w, mean, invstd, scale, bias,
    z) against the JAX fused kernel (weights scaled by ``1 /
    sqrt(fan_in)``)."""
    x, w = _arrays(3, (2, 8, 8, 16), (3, 3, 16, 32))
    w = w / np.float32(12.0)
    ep = _epilogue(4, 32, (2, 8, 8, 32), with_z)
    args = [x, w, *ep[:4]] + ([ep[4]] if with_z else [])

    def jloss(x, w, mean, invstd, scale, bias, z=None):
        return jnp.sum(jnp.sin(jconv.conv2d(
            x, w, mean=mean, invstd=invstd, scale=scale, bias=bias, z=z,
            relu=relu, interpret=True)))
    jargs = [jnp.asarray(a) for a in args]
    jval, jgrads = jax.value_and_grad(jloss, argnums=tuple(range(len(args))))(
        *jargs)
    targs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    tx, tw, mean, invstd, scale, bias, *z = targs
    out = tconv.conv2d(tx, tw, mean=mean, invstd=invstd, scale=scale,
                       bias=bias, z=z[0] if z else None, relu=relu)
    loss = torch.sin(out).sum()
    grads = torch.autograd.grad(loss, targs)
    np.testing.assert_allclose(loss.item(), float(jval), rtol=1e-5,
                               atol=1e-4)
    for g, jg in zip(grads, jgrads):
        _close(g.numpy(), jg, 1e-4)
    # the forward kernel's plain version with its pre-activation, against
    # the Pallas forward kernel's
    padding = tconv._norm_padding("SAME", 8, 8, 3, 3, 1, 1, 1, 1)
    t_ep = [None if a is None else torch.from_numpy(a) for a in ep]
    got, pre = tconv._fwd_ref(torch.from_numpy(x), torch.from_numpy(w),
                              (1, 1), padding, (1, 1), *t_ep, relu=relu,
                              want_preact=True)
    j_ep = [None if a is None else jnp.asarray(a) for a in ep]
    want, jpre = jconv._pallas_fwd(jnp.asarray(x), jnp.asarray(w), (1, 1),
                                   padding, (1, 1), *j_ep, relu, True,
                                   (None, None), True, jnp.float32)
    _close(got.numpy(), want, 1e-4)
    _close(pre.numpy(), jpre, 1e-4)


def test_argument_validation_messages():
    x, w = torch.ones((1, 4, 4, 8)), torch.ones((3, 3, 8, 8))
    for kw, match in (
            (dict(mean=torch.zeros(8)), "together"),
            (dict(relu=True), "epilogue"),
            (dict(mean=torch.zeros(8), invstd=torch.ones(8),
                  scale=torch.ones(8)), "together"),
            (dict(mean=torch.zeros(8), invstd=torch.ones(8),
                  z=torch.ones((1, 2, 2, 8))), "output shape"),
            (dict(groups=2), "in-channels")):
        with pytest.raises(ValueError, match=match):
            tconv.conv2d(x, w, **kw)
        # the JAX function refuses the same calls with the same words
        jkw = {k: (jnp.asarray(v.numpy()) if torch.is_tensor(v) else v)
               for k, v in kw.items()}
        with pytest.raises(ValueError, match=match):
            jconv.conv2d(jnp.ones((1, 4, 4, 8)), jnp.ones((3, 3, 8, 8)),
                         **jkw)
    with pytest.raises(ValueError, match="NHWC"):
        tconv.conv2d(torch.ones((4, 4, 8)), w)
    with pytest.raises(ValueError, match="padding"):
        tconv.conv2d(x, w, padding="FULL")


def test_pallas_conv_has_conv_parameters_and_output():
    """Same generator, same kernel; the same output as ``Conv`` (flax
    'SAME', the asymmetric stride-2 pads on an even map)."""
    x = torch.from_numpy(_arrays(5, (2, 10, 10, 6))[0])
    for k, s in (((3, 3), (2, 2)), ((1, 1), (1, 1)), ((7, 7), (2, 2))):
        a = Conv(6, 8, k, s, device="cpu",
                 generator=torch.Generator().manual_seed(7))
        b = tconv.PallasConv(6, 8, k, s, device="cpu",
                             generator=torch.Generator().manual_seed(7))
        assert [n for n, _ in b.named_parameters()] == ["kernel"]
        assert torch.equal(a.kernel, b.kernel)
        with torch.no_grad():
            torch.testing.assert_close(b(x), a(x), atol=1e-5, rtol=1e-5)


def test_grouped_conv_falls_back_and_is_counted():
    """A depthwise conv is outside the kernels' contract: the plain conv,
    the same output as flax's ``nn.Conv``, counted with reason
    ``groups``."""
    x = _arrays(6, (2, 8, 8, 16))[0]
    m = tconv.PallasConv(16, 16, (3, 3), feature_group_count=16,
                         use_bias=True, device="cpu")
    assert tuple(m.kernel.shape) == (3, 3, 1, 16)
    with torch.no_grad():
        m.bias.copy_(torch.linspace(-1, 1, 16))
    ref = fnn.Conv(features=16, kernel_size=(3, 3), feature_group_count=16)
    want = ref.apply({"params": {"kernel": m.kernel.detach().numpy(),
                                 "bias": m.bias.detach().numpy()}},
                     jnp.asarray(x))
    tconv.reset_conv_dispatch_stats()
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    _close(got.numpy(), want, 1e-5)
    stats = tconv.conv_dispatch_stats()
    assert stats == {"pallas_sites": 0, "fallback_sites": 1,
                     "fallback_reasons": {"groups": 1}}
    tconv.reset_conv_dispatch_stats()


def test_cpu_path_launches_no_kernel():
    """On the CPU, forward and backward (with an epilogue) run the plain
    versions: every conv launch counter stays where it was, and the
    kernel wrappers refuse CPU tensors."""
    counters = (tconv.conv_fwd_kernel, tconv.conv_dgrad_kernel,
                tconv.conv_wgrad_kernel)
    before = [c.launches for c in counters]
    x, w = (torch.from_numpy(a).requires_grad_(True)
            for a in _arrays(8, (2, 6, 6, 8), (3, 3, 8, 8)))
    out = tconv.conv2d(x, w, mean=torch.zeros(8), invstd=torch.ones(8),
                       relu=True)
    out.sum().backward()
    assert x.grad is not None and w.grad is not None
    assert [c.launches for c in counters] == before == [0, 0, 0]
    pads = ((1, 1), (1, 1))
    for call in (
            lambda: tconv.conv_fwd_kernel(x.detach(), w.detach(), (1, 1),
                                          pads, (1, 1)),
            lambda: tconv.conv_dgrad_kernel(out.detach(), w.detach(), (1, 1),
                                            pads, (1, 1), (6, 6)),
            lambda: tconv.conv_wgrad_kernel(x.detach(), out.detach(), (1, 1),
                                            pads, (1, 1), (3, 3))):
        with pytest.raises(ValueError, match="CUDA"):
            call()


@pytest.mark.parametrize("m,n,k", [(576, 64, 401408), (4608, 512, 6272),
                                   (147, 64, 1605632), (1024, 2048, 25088),
                                   (40, 8, 50), (392, 64, 1605632),
                                   (1024, 256, 25088), (1152, 128, 100352),
                                   (72, 136, 77)])
def test_wgrad_splits_cover_k(m, n, k):
    """wgrad's split of its pixel sum: every split non-empty, together
    exactly K, each a whole number of K steps, and (where K has 8 steps a
    split to give) about 4 blocks of the kernels' tile an SM."""
    splits, per = tconv._wgrad_splits(m, n, k, 132)
    assert per % tconv._BK == 0 and splits >= 1
    assert (splits - 1) * per < k <= splits * per
    tiles = -(-m // tconv._BM) * -(-n // tconv._tile_n(n))
    assert tconv._tile_n(n) == (128 if n >= 128 else 64)
    if k >= 8 * tconv._BK * -(-4 * 132 // tiles):
        # rounding each split up to whole K steps may drop a split or two
        assert tiles * splits >= 3.5 * 132


# the C = 3 stem and a ragged C / O, as the kernel wrappers lay them out
LAYOUT_CASES = {
    # x shape, w shape, stride, padding
    "stem_c3": ((2, 16, 16, 3), (7, 7, 3, 8), (2, 2), ((3, 3), (3, 3))),
    "ragged_c5_o12": ((2, 9, 7, 5), (3, 3, 5, 12), (2, 1),
                      ((1, 1), (0, 2))),
}


@pytest.mark.parametrize("case", sorted(LAYOUT_CASES))
def test_padded_layout_matches_jax_pallas(case):
    """The kernel wrappers' layout pass (C and O zero-padded to multiples
    of 8, zero weights for the pad, the padded channels cut off after the
    launch): the plain forward (with the epilogue) and wgrad on the padded
    operands, cut back, against JAX's ``_pallas_fwd`` and
    ``_pallas_wgrad`` in interpret mode on the unpadded ones; the pad is
    exactly zero.  fp32, 1e-4 (summation order only)."""
    xs, ws, stride, padding = LAYOUT_CASES[case]
    dil = (1, 1)
    c, o = xs[3], ws[3]
    oh, ow = tconv._out_hw(xs[1], xs[2], padding, ws[0], ws[1], *stride,
                           *dil)
    x, w, dy = _arrays(40, xs, ws, (xs[0], oh, ow, o))
    w = w / np.float32(np.sqrt(ws[0] * ws[1] * c))
    ep = _epilogue(41, o, (xs[0], oh, ow, o), True)
    t_ep = [torch.from_numpy(a) for a in ep]
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    px, pw, *p_ep = tconv._fwd_layout(tx, tw, *t_ep)
    assert px.shape[3] % 8 == 0 and pw.shape[2:] == (px.shape[3],
                                                     -(-o // 8) * 8)
    assert not px[..., c:].any() and not pw[:, :, c:].any()
    assert not pw[..., o:].any()
    got, pre = tconv._fwd_ref(px, pw, stride, padding, dil, *p_ep,
                              relu=True, want_preact=True)
    want, jpre = jconv._pallas_fwd(jnp.asarray(x), jnp.asarray(w), stride,
                                   padding, dil,
                                   *(jnp.asarray(a) for a in ep), True, True,
                                   (None, None), True, jnp.float32)
    _close(got[..., :o].numpy(), want, 1e-4)
    _close(pre[..., :o].numpy(), jpre, 1e-4)
    qx, qdy = tconv._wgrad_layout(tx, torch.from_numpy(dy))
    assert qx.shape == px.shape and qdy.shape[3] == pw.shape[3]
    dw = tconv._wgrad_ref(qx, qdy, stride, padding, dil, ws[:2])
    assert not dw[:, :, c:].any() and not dw[..., o:].any()
    want_dw = jconv._pallas_wgrad(jnp.asarray(x), jnp.asarray(dy), stride,
                                  padding, dil, ws, (None, None), True,
                                  jnp.float32)
    _close(dw[:, :, :c, :o].numpy(), want_dw, 1e-4)
    rdy, rw = tconv._dgrad_layout(torch.from_numpy(dy), tw)
    assert rw.shape == pw.shape and rdy.shape[3] == pw.shape[3]
    dx = tconv._dgrad_ref(rdy, rw, stride, padding, dil, xs[1:3])
    assert not dx[..., c:].any()
    want_dx = jconv._pallas_dgrad(jnp.asarray(dy), jnp.asarray(w), stride,
                                  padding, dil, xs[1:3], (None, None), True)
    _close(dx[..., :c].numpy(), want_dx, 1e-4)


def test_fwd_route_by_dtype_channels_and_tma():
    """The forward's route rule (pure Python, no card): fp32 on conv.cu's
    SIMT path; bf16 and fp16 on the wgmma kernel where the channel count
    (as the kernels take it, padded to 8) is a multiple of 64 and TMA
    reads the weight; else conv.cu's mma.sync kernel (the C = 3 stem,
    padded to 8; a ragged C); the conv's tuner version is 3 (the backward
    took its own wgmma routes)."""
    for dt in (torch.bfloat16, torch.float16):
        for c in (64, 128, 256, 512, 1024, 2048):
            assert tconv._fwd_route(dt, c, True) == "wgmma"
        assert tconv._fwd_route(dt, 64, False) == "mma"
        for c in (8, 16, 40, 72, 96):
            assert tconv._fwd_route(dt, c, True) == "mma"
    for c in (8, 64, 128):
        assert tconv._fwd_route(torch.float32, c, True) == "simt"
    assert tconv.TUNE_VERSION == 3
    assert tconv.conv_fwd_kernel.routes.keys() == {"wgmma", "mma", "simt"}


def test_dgrad_route_by_dtype_channels_and_tma():
    """dgrad's route rule (pure Python, no card): the channels it gathers
    are dy's O; bf16 and fp16 run conv_sm90.cu's wgmma kernel where O (as
    the kernels take it, padded to 8) is a multiple of 64 and TMA reads
    the weight (and the stride has at most 16 parity classes), else
    conv.cu's mma.sync kernel; fp32 its SIMT path.  Every ResNet-50 dgrad
    site (O 64 to 2048) takes wgmma."""
    for dt in (torch.bfloat16, torch.float16):
        for o in (64, 128, 256, 512, 1024, 2048):
            assert tconv._dgrad_route(dt, o, True) == "wgmma"
        assert tconv._dgrad_route(dt, 64, False) == "mma"
        for o in (8, 16, 40, 72, 136):
            assert tconv._dgrad_route(dt, o, True) == "mma"
        # strides up to sh * sw 16: the parity classes decoded on the host
        for classes in (1, 4, 16):
            assert tconv._dgrad_route(dt, 64, True, classes) == "wgmma"
        assert tconv._dgrad_route(dt, 64, True, 25) == "mma"
    for o in (8, 64, 128):
        assert tconv._dgrad_route(torch.float32, o, True) == "simt"
    assert tconv.conv_dgrad_kernel.routes.keys() == {"wgmma", "mma", "simt"}


def test_wgrad_route_by_dtype_channels_and_tma():
    """wgrad's route rule (pure Python, no card): the channels it gathers
    are x's C; bf16 and fp16 run the wgmma kernel where C (padded to 8) is
    a multiple of 64 and TMA reads dy, else the mma.sync kernel (the
    C = 3 stem, padded to 8); fp32 SIMT.  Both kernels take the same
    split plan, whatever the tile."""
    for dt in (torch.bfloat16, torch.float16):
        for c in (64, 128, 256, 512, 1024, 2048):
            assert tconv._wgrad_route(dt, c, True) == "wgmma"
        assert tconv._wgrad_route(dt, 64, False) == "mma"
        for c in (8, 16, 40, 72, 96):
            assert tconv._wgrad_route(dt, c, True) == "mma"
    for c in (8, 64, 128):
        assert tconv._wgrad_route(torch.float32, c, True) == "simt"
    assert tconv.conv_wgrad_kernel.routes.keys() == {"wgmma", "mma", "simt"}


@pytest.mark.parametrize("kind,rule,route,ok", [
    ("forward", "wgmma", None, "wgmma"), ("dgrad", "wgmma", "mma", "mma"),
    ("wgrad", "wgmma", "wgmma", "wgmma"), ("wgrad", "mma", None, "mma"),
    ("dgrad", "mma", "wgmma", None), ("wgrad", "simt", "mma", None),
    ("forward", "simt", "wgmma", None), ("dgrad", "wgmma", "simt", None)])
def test_named_route_taken_or_refused(kind, rule, route, ok):
    """A named route runs where the rule takes it, ``mma`` also where the
    rule is ``wgmma`` (the smoke run's comparison); any other raises
    ``ValueError`` naming the route, before anything launches."""
    if ok is None:
        with pytest.raises(ValueError, match=f"{kind} route '{route}'"):
            tconv._take_route(kind, rule, route, torch.bfloat16, 64)
    else:
        assert tconv._take_route(kind, rule, route, torch.bfloat16,
                                 64) == ok


@pytest.mark.parametrize("m,n,k", [(576, 64, 401408), (4608, 512, 6272),
                                   (64, 64, 401408), (1024, 2048, 6272),
                                   (256, 64, 401408), (2304, 256, 25088),
                                   (1152, 128, 100352), (64, 8, 126),
                                   (192, 136, 49)])
def test_wgrad_wgmma_splits_cover_k_whatever_the_tile(m, n, k):
    """The wgmma wgrad's own split of its pixel sum: every split
    non-empty, together exactly K, each a whole number of 32-pixel K
    steps and at least 8 of them where K has that many, the blocks of the
    rule's tile at most 4 waves of two an SM.  The plan is a function of
    the GEMM's shape alone (the rule's tile, not the one a call runs), so
    both tile widths sum the same splits in the same order."""
    splits, per = tconv._wgrad_wgmma_splits(m, n, k, 132)
    assert per % 32 == 0 and splits >= 1
    assert (splits - 1) * per < k <= splits * per
    k_steps = -(-k // 32)
    if k_steps >= 16:
        assert per >= 8 * 32
    bn = tconv._tile_n(n)
    tiles = -(-m // tconv._WGRAD_WGMMA_BM[bn]) * -(-n // bn)
    assert splits == 1 or tiles * splits <= 4 * 2 * 132


def test_wgrad_wgmma_splits_fill_whole_waves():
    """Where K is long, the splits fill whole waves of two blocks an SM:
    at [128,56,56,64] 3x3/1 (M 576 in 3 tiles of 256 x 64) 88 splits
    make 264 blocks, one wave of 132 x 2."""
    splits, _ = tconv._wgrad_wgmma_splits(576, 64, 128 * 56 * 56, 132)
    assert 3 * splits == 2 * 132
