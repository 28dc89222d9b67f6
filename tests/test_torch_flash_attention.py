"""The port's flash-attention forward against the JAX package's.

Same numpy inputs through JAX ``flash_attention`` (the Pallas kernel in
interpret mode, with explicit blocks, wherever the shape tiles; its jnp
path where it does not, e.g. ``q_len = 1``) and through the port, whose
CPU path is the plain version of the CUDA kernel.  fp32 at 2e-5.  The
gradients (the backward kernels' plain version through the autograd
Function) against ``jax.grad`` of the Pallas kernels in interpret mode,
at 5e-4 as the JAX package's own test holds them; ragged and
cross-length cases, which the Pallas path cannot tile, against torch
autograd through the plain forward.  The kernels themselves run only on
the card (``tests/test_torch_kernels_cuda.py``).
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.ops.flash_attention import flash_attention as jflash
from apex_tpu_torch.ops.attention import (blockwise_attention,
                                          dot_product_attention)
from apex_tpu_torch.ops.flash_attention import flash_attention

# the package re-exports the function under the module's name
fa_mod = importlib.import_module("apex_tpu_torch.ops.flash_attention")

TOL = dict(atol=2e-5, rtol=2e-5)


def _qkv(b, tq, tk, h, h_kv, d, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, tq, h, d).astype(np.float32)
    k = rng.randn(b, tk, h_kv, d).astype(np.float32)
    v = rng.randn(b, tk, h_kv, d).astype(np.float32)
    return q, k, v


def _both(q, k, v, jax_kw=None, **kw):
    jkw = {k_: jnp.asarray(v_) if isinstance(v_, np.ndarray) else v_
           for k_, v_ in kw.items()}
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **jkw,
                  **(jax_kw or {}))
    tkw = {k_: torch.from_numpy(v_) if isinstance(v_, np.ndarray) else v_
           for k_, v_ in kw.items()}
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), **tkw)
    assert got.shape == q.shape
    return got.numpy(), np.asarray(want)


BLOCKS = dict(interpret=True, block_q=16, block_k=16)


def test_causal_mha():
    q, k, v = _qkv(2, 32, 32, 2, 2, 16)
    got, want = _both(q, k, v, BLOCKS, causal=True)
    np.testing.assert_allclose(got, want, **TOL)


def test_gqa_four_over_two():
    q, k, v = _qkv(2, 32, 32, 4, 2, 16, seed=1)
    got, want = _both(q, k, v, BLOCKS, causal=True)
    np.testing.assert_allclose(got, want, **TOL)


def test_decode_tq1_with_key_padding_bias():
    """One fresh token against a cache whose tail is dead."""
    q, k, v = _qkv(3, 1, 24, 2, 2, 16, seed=2)
    live = np.arange(24)[None, :] <= np.array([[5], [23], [0]])
    kb = np.where(live, 0.0, -1e9).astype(np.float32)
    got, want = _both(q, k, v, {"interpret": True}, causal=True,
                      key_padding_bias=kb)
    np.testing.assert_allclose(got, want, **TOL)


def test_bts_bias_non_causal():
    q, k, v = _qkv(2, 32, 32, 2, 2, 16, seed=3)
    bias = np.random.RandomState(4).randn(2, 32, 32).astype(np.float32)
    got, want = _both(q, k, v, BLOCKS, causal=False, bias=bias)
    np.testing.assert_allclose(got, want, **TOL)


def test_bias_with_key_padding_folded_and_broadcast():
    q, k, v = _qkv(2, 16, 16, 2, 2, 16, seed=5)
    bias = np.random.RandomState(6).randn(2, 1, 16).astype(np.float32)
    kb = np.where(np.arange(16) < 12, 0.0, -1e9)[None].repeat(2, 0).astype(
        np.float32)
    got, want = _both(q, k, v, BLOCKS, causal=False, bias=bias,
                      key_padding_bias=kb)
    np.testing.assert_allclose(got, want, **TOL)


def test_window_8():
    q, k, v = _qkv(1, 32, 32, 2, 2, 16, seed=7)
    got, want = _both(q, k, v, BLOCKS, causal=True, window=8)
    np.testing.assert_allclose(got, want, **TOL)


def test_suffix_alignment_tq_lt_tk():
    """Causal q_len < kv_len: the queries are the last q_len positions."""
    q, k, v = _qkv(2, 16, 48, 2, 2, 16, seed=8)
    got, want = _both(q, k, v, BLOCKS, causal=True)
    np.testing.assert_allclose(got, want, **TOL)


def test_per_head_bias_runs_plain_on_cpu():
    q, k, v = _qkv(1, 8, 8, 2, 2, 16, seed=9)
    b4 = np.random.RandomState(10).randn(1, 2, 8, 8).astype(np.float32)
    got, want = _both(q, k, v, causal=True, bias=b4)
    np.testing.assert_allclose(got, want, **TOL)


def test_validation_errors():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 4, 3, 2, 16))
    with pytest.raises(ValueError, match="must divide"):
        flash_attention(q, k, v)
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 4, 2, 2, 16))
    with pytest.raises(ValueError, match="q_len <= kv_len"):
        flash_attention(q, k, v, causal=True)
    with pytest.raises(ValueError, match="requires causal"):
        flash_attention(q, k, v, window=2)
    with pytest.raises(ValueError, match="broadcastable"):
        flash_attention(q, k, v, bias=torch.zeros(1, 3, 4))
    with pytest.raises(ValueError, match="bias must be"):
        flash_attention(q, k, v, bias=torch.zeros(8, 4))


@pytest.mark.parametrize("causal", [False, True])
def test_oracles_agree_with_plain_kernel_version(causal):
    """ops.attention (materialized and blockwise) is the oracle of the
    kernel's plain version; the fp32 lse is m + log(l)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 20, 20, 2, 2, 32, 11))
    out, lse = fa_mod._flash_fwd_ref(q, k, v, None, None, sm_scale=32 ** -.5,
                                     causal=causal)
    torch.testing.assert_close(out, dot_product_attention(
        q, k, v, causal=causal), **TOL)
    torch.testing.assert_close(out, blockwise_attention(
        q, k, v, causal=causal, block_size=8), **TOL)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * 32 ** -.5
    if causal:
        s = s.masked_fill(~torch.ones(20, 20, dtype=torch.bool).tril(), -1e30)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), **TOL)


# -- backward ------------------------------------------------------------------

BWD_TOL = dict(atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("case", ["causal", "full", "gqa4_2", "mqa4_1",
                                  "window64", "kbias_grad",
                                  "bias_no_grad"])
def test_grads_match_jax_pallas_interpret(case):
    """dq, dk, dv (and the key-padding-bias gradient) at B=1, T=256, D=32
    against ``jax.grad`` of the Pallas kernels (128-row blocks)."""
    h_kv = {"gqa4_2": 2, "mqa4_1": 1}.get(case, 4)
    q, k, v = _qkv(1, 256, 256, 4, h_kv, 32, seed=20)
    rng = np.random.RandomState(21)
    g = rng.randn(1, 256, 4, 32).astype(np.float32)
    kw = dict(causal=case not in ("full", "kbias_grad", "bias_no_grad"),
              window=64 if case == "window64" else None)
    leaves = [q, k, v]
    bias = None
    if case == "kbias_grad":
        leaves.append((0.5 * rng.randn(1, 256)).astype(np.float32))
    if case == "bias_no_grad":
        bias = rng.randn(1, 256, 256).astype(np.float32)

    def jloss(*xs):
        out = jflash(*xs[:3], key_padding_bias=xs[3] if len(xs) > 3 else
                     None, bias=None if bias is None else jnp.asarray(bias),
                     block_q=128, block_k=128, interpret=True, **kw)
        return jnp.sum(out * g)

    want = jax.grad(jloss, argnums=tuple(range(len(leaves))))(
        *(jnp.asarray(x) for x in leaves))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in leaves]
    out = flash_attention(*ts[:3], key_padding_bias=ts[3] if len(ts) > 3
                          else None, bias=None if bias is None
                          else torch.from_numpy(bias), **kw)
    got = torch.autograd.grad((out * torch.from_numpy(g)).sum(), ts)
    for name, gt, wt in zip(("dq", "dk", "dv", "dkbias"), got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt),
                                   err_msg=name, **BWD_TOL)


@pytest.mark.parametrize("case", ["ragged200", "cross_causal",
                                  "ragged_gqa_window", "bias_grad",
                                  "kbias_broadcast"])
def test_grads_match_autograd_of_plain_forward(case):
    """Lengths the Pallas path cannot tile, and a key-padding bias
    broadcast over the batch: the Function's plain backward against
    torch autograd through the plain forward."""
    tq, tk, h_kv = {"cross_causal": (70, 200, 4),
                    "ragged_gqa_window": (200, 200, 2)}.get(
                        case, (200, 200, 4))
    q, k, v = _qkv(2, tq, tk, 4, h_kv, 32, seed=22)
    rng = np.random.RandomState(23)
    kw = dict(causal=case != "bias_grad",
              window=30 if case == "ragged_gqa_window" else None)
    extra = []
    if case == "bias_grad":
        extra = [rng.randn(2, tq, tk).astype(np.float32),
                 (0.5 * rng.randn(2, tk)).astype(np.float32)]
    if case == "kbias_broadcast":
        extra = [(0.5 * rng.randn(1, tk)).astype(np.float32)]
    g = torch.from_numpy(rng.randn(2, tq, 4, 32).astype(np.float32))
    grads = []
    for plain in (False, True):
        ts = [torch.from_numpy(x).requires_grad_(True)
              for x in [q, k, v] + extra]
        bias = kb = None
        if len(extra) == 2:
            bias, kb = ts[3], ts[4]
        elif extra:
            kb = ts[3]
        if plain:
            b3 = None if bias is None else bias + kb[:, None, :]
            out, _ = fa_mod._flash_fwd_ref(
                *ts[:3], kb if bias is None else None, b3,
                sm_scale=32 ** -0.5,
                q_offset=tk - tq if kw["causal"] else 0, **kw)
        else:
            out = flash_attention(*ts[:3], bias=bias, key_padding_bias=kb,
                                  **kw)
        grads.append(torch.autograd.grad((out * g).sum(), ts))
    for gt, wt in zip(*grads):
        torch.testing.assert_close(gt, wt, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", ["full", "causal", "window64", "gqa4_2"])
def test_bts_bias_grad_matches_jax_pallas_interpret(case):
    """The head-summed gradient of a learnable [B, T, S] bias (the Pallas
    ``_bwd_db2_kernel``, 128-row blocks, interpret mode) and dq/dk/dv
    beside it, at B=2, T=256, D=32, against the Function's plain
    backward; the same 5e-4 as the other gradients."""
    h_kv = 2 if case == "gqa4_2" else 4
    q, k, v = _qkv(2, 256, 256, 4, h_kv, 32, seed=30)
    rng = np.random.RandomState(31)
    bias = rng.randn(2, 256, 256).astype(np.float32)
    g = rng.randn(2, 256, 4, 32).astype(np.float32)
    kw = dict(causal=case != "full",
              window=64 if case == "window64" else None)

    def jloss(*xs):
        out = jflash(*xs[:3], bias=xs[3], block_q=128, block_k=128,
                     interpret=True, **kw)
        return jnp.sum(out * g)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(x) for x in (q, k, v, bias)))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v, bias)]
    out = flash_attention(*ts[:3], bias=ts[3], **kw)
    got = torch.autograd.grad((out * torch.from_numpy(g)).sum(), ts)
    for name, gt, wt in zip(("dq", "dk", "dv", "dbias"), got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt),
                                   err_msg=name, **BWD_TOL)
    if kw["causal"]:                     # hidden keys get no gradient
        hidden = np.triu(np.ones((256, 256), bool), 1)
        assert not got[3].numpy()[:, hidden].any()


def test_per_head_bias_grads_match_jax():
    """A per-head [B, H, T, S] bias takes the plain path on either device
    (JAX: its jnp ``blockwise_attention``); its gradient and q/k/v's
    against ``jax.grad`` of the JAX function, GQA and causal."""
    q, k, v = _qkv(2, 24, 24, 4, 2, 16, seed=32)
    rng = np.random.RandomState(33)
    b4 = rng.randn(2, 4, 24, 24).astype(np.float32)
    g = rng.randn(2, 24, 4, 16).astype(np.float32)

    def jloss(*xs):
        return jnp.sum(jflash(*xs[:3], bias=xs[3], causal=True) * g)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(x) for x in (q, k, v, b4)))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v, b4)]
    out = flash_attention(*ts[:3], bias=ts[3], causal=True)
    got = torch.autograd.grad((out * torch.from_numpy(g)).sum(), ts)
    for name, gt, wt in zip(("dq", "dk", "dv", "dbias"), got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt),
                                   err_msg=name, atol=2e-5, rtol=2e-5)


def test_mha_attention_is_the_blockwise_alias_as_in_jax():
    """``ops.mha_attention`` (exported by the package, as JAX's
    ``apex_tpu.ops``) is ``blockwise_attention``: the same numpy inputs
    through JAX's alias and the port's agree at fp32 2e-5."""
    from apex_tpu import ops as jops
    from apex_tpu_torch import ops
    q, k, v = _qkv(2, 24, 24, 2, 2, 16, 5)
    for causal in (False, True):
        want = jops.mha_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  block_size=8)
        got = ops.mha_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=causal,
                                block_size=8)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        torch.testing.assert_close(got, blockwise_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            causal=causal, block_size=8), rtol=0, atol=0)
    assert "mha_attention" in ops.__all__


# -- the forward's routes and tiles (csrc/flash_attention_sm90.cu beside
#    csrc/flash_attention.cu): the pure-Python side, which picks the kernel

@pytest.mark.parametrize("tq,d,dtype,tile,tma,want", [
    (64, 64, torch.bfloat16, None, True, "wgmma"),
    (16, 128, torch.float16, None, True, "wgmma"),
    (333, 48, torch.bfloat16, None, True, "wgmma"),
    (64, 64, torch.bfloat16, None, False, "mma"),
    (64, 32, torch.bfloat16, None, True, "mma"),
    (64, 16, torch.float16, None, True, "mma"),
    (64, 64, torch.bfloat16, (64, 64), True, "mma"),
    (64, 64, torch.bfloat16, (128, 128), True, "mma"),
    (64, 128, torch.bfloat16, (128, 96), True, "wgmma"),
    (64, 64, torch.float16, (64, 160), True, "wgmma"),
    (64, 64, torch.float32, None, True, "simt"),
    (64, 160, torch.bfloat16, None, True, "simt"),
    (64, 256, torch.float16, None, True, "simt"),
    (15, 64, torch.bfloat16, None, True, "decode"),
    (1, 64, torch.bfloat16, (64, 96), True, "decode"),
])
def test_forward_route_by_dtype_width_qlen_and_tile(tq, d, dtype, tile, tma,
                                                    want):
    assert fa_mod._route(tq, d, dtype, tile, tma) == want


def test_tma_rule_on_views():
    """TMA reads a view in place when its start is 16-byte aligned and its
    strides are nonzero multiples of 16 bytes: a fused projection's q, k
    and v pass; an odd start, a 52-wide head, a batch broadcast by a zero
    stride fail (and then route to ``mma``).  A dimension of size 1 may
    have any stride.  The fp32 bias may broadcast its batch, not its
    rows."""
    b, t, h, d = 2, 32, 4, 64
    bf = torch.bfloat16
    q, k, v = torch.zeros(b, t, 3, h, d, dtype=bf).unbind(2)
    assert q.stride() == (t * 3 * h * d, 3 * h * d, d, 1)
    assert fa_mod._tma_ok(d, q, k, v)
    odd = torch.zeros(b * t * h * d + 1, dtype=bf)[1:].view(b, t, h, d)
    assert not fa_mod._tma_ok(d, odd, k, v)
    w52 = torch.zeros(b, t, h, 52, dtype=bf)
    assert not fa_mod._tma_ok(52, w52, w52, w52)
    k_bcast = torch.zeros(1, t, h, d, dtype=bf).expand(b, t, h, d)
    assert not fa_mod._tma_ok(d, q, k_bcast, v)
    one = torch.zeros(t * h * d + 8, dtype=bf)[8:].as_strided(
        (1, t, h, d), (3, h * d, d, 1))
    assert fa_mod._tma_ok(d, one, one, one)
    assert fa_mod._tma_ok(d, q, k, v, bias=torch.zeros(b, t, t))
    assert fa_mod._tma_ok(d, q, k, v,
                          bias=torch.zeros(1, t, t).expand(b, t, t))
    assert not fa_mod._tma_ok(d, q, k, v,
                              bias=torch.zeros(b, 1, t).expand(b, t, t))
    assert not fa_mod._tma_ok(d, q, k, v,
                              bias=torch.zeros(b, t, t + 1)[..., 1:])
    assert (fa_mod._route(t, d, bf, None, fa_mod._tma_ok(d, odd, k, v))
            == "mma")


def test_tiles_each_name_one_kernel_and_hold_the_rule():
    bf, fp = torch.bfloat16, torch.float16
    mma = set((fa_mod._RULE_TILE,) + fa_mod._TUNED_TILES)
    wg = set(fa_mod._WGMMA_TILES)
    assert not mma & wg and len(wg) == 4
    for d in (48, 64, 128):
        assert set(fa_mod.tiles(d, bf)) == set(fa_mod.tiles(d, fp)) \
            == mma | wg
        assert fa_mod.tiles(d, bf)[:4] == fa_mod._WGMMA_TILES
        assert fa_mod.rule_tile(d, bf) in fa_mod.tiles(d, bf)
    assert fa_mod.tiles(16, bf) == fa_mod.tiles(32, fp) == ((64, 64),)
    assert fa_mod.tiles(64, torch.float32) == fa_mod.tiles(256, bf) == ()
    assert fa_mod.rule_tile(64, bf) == fa_mod.rule_tile(48, fp) == (64, 96)
    assert fa_mod.rule_tile(128, bf) == fa_mod.rule_tile(100, fp) \
        == (128, 96)
    assert fa_mod.rule_tile(32, bf) == fa_mod.rule_tile(
        64, torch.float32) == fa_mod.rule_tile(256, bf) == (64, 64)


def test_route_counter_keys():
    routes = fa_mod.flash_fwd_kernel.routes
    assert set(routes) == {"wgmma", "mma", "simt", "split", "decode"}
    assert all(isinstance(n, int) for n in routes.values())


# -- the backward's routes (csrc/flash_attention_bwd_sm90.cu beside
#    csrc/flash_attention_bwd.cu)

@pytest.mark.parametrize("d,dtype,tma,want", [
    (64, torch.bfloat16, True, "wgmma"),
    (128, torch.float16, True, "wgmma"),
    (48, torch.bfloat16, True, "wgmma"),
    (33, torch.float16, True, "wgmma"),
    (64, torch.bfloat16, False, "mma"),
    (128, torch.bfloat16, False, "mma"),
    (32, torch.bfloat16, True, "mma"),
    (16, torch.float16, True, "mma"),
    (64, torch.float32, True, "simt"),
    (16, torch.float32, True, "simt"),
    (129, torch.bfloat16, True, "simt"),
    (256, torch.float16, True, "simt"),
])
def test_backward_route_by_dtype_and_width(d, dtype, tma, want):
    assert fa_mod._bwd_route(d, dtype, tma) == want


def test_backward_tma_rule_on_views():
    """dQ and dK/dV take the wgmma kernels where q, k, v, do, the outputs
    and the bias all meet TMA's rules: a fused projection's strided q, k
    and v and a batch-broadcast bias pass; an odd ``do``, a 52-wide head,
    a bias broadcast over its rows fail and route to ``mma``; fp32 is
    ``simt``.  A named ``mma`` route is taken where the rule is wgmma;
    any other route the call cannot take raises."""
    b, t, h, d = 2, 32, 4, 64
    bf = torch.bfloat16
    q, k, v = torch.zeros(b, t, 3, h, d, dtype=bf).unbind(2)
    do = torch.zeros(b, t, h, d, dtype=bf)
    out = torch.zeros(b, t, h, d, dtype=bf)
    pick = fa_mod._pick_bwd_route
    assert pick(None, q, k, v, do, None, out) == "wgmma"
    assert pick(None, q, k, v, do, None, out, out) == "wgmma"
    bias = torch.zeros(1, t, t).expand(b, t, t)
    assert pick(None, q, k, v, do, bias, out) == "wgmma"
    assert pick(None, q, k, v, do, torch.zeros(b, 1, t).expand(b, t, t),
                out) == "mma"
    odd = torch.zeros(b * t * h * d + 1, dtype=bf)[1:].view(b, t, h, d)
    assert pick(None, q, k, v, odd, None, out) == "mma"
    assert pick(None, odd, k, v, do, None, out) == "mma"
    w52 = torch.zeros(b, t, h, 52, dtype=bf)
    assert pick(None, w52, w52, w52, w52, None, w52) == "mma"
    w16 = torch.zeros(b, t, h, 16, dtype=bf)
    assert pick(None, w16, w16, w16, w16, None, w16) == "mma"
    f32 = torch.zeros(b, t, h, d)
    assert pick(None, f32, f32, f32, f32, None, f32) == "simt"
    assert pick("mma", q, k, v, do, None, out) == "mma"
    assert pick("wgmma", q, k, v, do, None, out) == "wgmma"
    for route, args in (("wgmma", (q, k, v, odd, None, out)),
                        ("simt", (q, k, v, do, None, out)),
                        ("mma", (f32, f32, f32, f32, None, f32)),
                        ("split", (q, k, v, do, None, out))):
        with pytest.raises(ValueError, match="route"):
            pick(route, *args)


def test_backward_route_counter_keys():
    for wrapper in (fa_mod.flash_bwd_dq_kernel, fa_mod.flash_bwd_dkv_kernel):
        assert set(wrapper.routes) == {"wgmma", "mma", "simt"}
        assert all(isinstance(n, int) for n in wrapper.routes.values())
        assert wrapper in fa_mod._build.COUNTED


@pytest.mark.parametrize("d", [48, 64, 128])
@pytest.mark.parametrize("case", ["causal", "window", "bias", "gqa_cross"])
def test_wgmma_route_widths_match_jax(d, case):
    """The widths the wgmma route serves (48 in the 64 instantiation, 64
    and 128) with the semantics it carries over: the plain version (its
    CPU path) against the JAX Pallas kernel in interpret mode."""
    if case == "gqa_cross":
        q, k, v = _qkv(1, 16, 32, 4, 2, d, seed=d)
        got, want = _both(q, k, v, BLOCKS, causal=True)
    elif case == "bias":
        q, k, v = _qkv(2, 32, 32, 2, 2, d, seed=d + 1)
        bias = np.random.RandomState(d).randn(2, 32, 32).astype(np.float32)
        got, want = _both(q, k, v, BLOCKS, bias=bias)
    else:
        q, k, v = _qkv(2, 32, 32, 2, 2, d, seed=d + 2)
        kw = dict(window=8) if case == "window" else {}
        got, want = _both(q, k, v, BLOCKS, causal=True, **kw)
    np.testing.assert_allclose(got, want, **TOL)


# -- the decode route (csrc/flash_decode_sm90.cu): the rule that picks it,
#    its chunking, and its plain version against JAX

@pytest.mark.parametrize("tq,d,dtype,views,want", [
    (1, 64, torch.bfloat16, "contiguous", "decode"),
    (15, 64, torch.float16, "contiguous", "decode"),
    (4, 128, torch.bfloat16, "contiguous", "decode"),
    (1, 48, torch.bfloat16, "contiguous", "decode"),
    (1, 104, torch.float16, "contiguous", "decode"),
    (1, 64, torch.bfloat16, "fused", "decode"),
    (1, 64, torch.float32, "contiguous", "split"),
    (1, 16, torch.bfloat16, "contiguous", "split"),
    (1, 32, torch.float16, "contiguous", "split"),
    (1, 160, torch.bfloat16, "contiguous", "split"),
    (1, 256, torch.bfloat16, "contiguous", "split"),
    (1, 52, torch.bfloat16, "contiguous", "split"),
    (1, 64, torch.bfloat16, "odd_start", "split"),
    (1, 64, torch.bfloat16, "batch_broadcast", "split"),
    (16, 64, torch.bfloat16, "contiguous", "wgmma"),
])
def test_decode_route_by_dtype_width_qlen_and_views(tq, d, dtype, views,
                                                    want):
    """q_len < 16 runs the decode kernel for bf16 and fp16 at kernel widths
    64 and 128 (heads 33-128) wherever TMA can read K and V in place (a
    fused projection's strided views included); fp32, widths 16, 32 and
    above 128, a head whose rows break TMA's 16-byte rule, an odd start
    and a batch broadcast by a zero stride run ``split``: the rule, asked
    of the views, never a failed launch."""
    b, tk, h, h_kv = 2, 40, 4, 2
    q = torch.zeros(b, tq, h, d, dtype=dtype)
    if views == "fused":
        k, v = torch.zeros(b, tk, 2, h_kv, d, dtype=dtype).unbind(2)
    elif views == "odd_start":
        k = torch.zeros(b * tk * h_kv * d + 1, dtype=dtype)[1:].view(
            b, tk, h_kv, d)
        v = torch.zeros(b, tk, h_kv, d, dtype=dtype)
    elif views == "batch_broadcast":
        k = torch.zeros(1, tk, h_kv, d, dtype=dtype).expand(b, tk, h_kv, d)
        v = torch.zeros(b, tk, h_kv, d, dtype=dtype)
    else:
        k, v = (torch.zeros(b, tk, h_kv, d, dtype=dtype) for _ in range(2))
    tma = (dtype != torch.float32
           and fa_mod._kernel_dim(d) in fa_mod._TUNED_DIMS
           and (fa_mod._decode_ok(q, k, v) if tq < fa_mod._SPLIT_TQ
                else fa_mod._tma_ok(d, q, k, v)))
    assert fa_mod._route(tq, d, dtype, None, tma) == want
    if tq < fa_mod._SPLIT_TQ:
        # a named split route is taken where the rule is decode; nothing
        # else is
        assert fa_mod._pick_fwd_route("split", want) == "split"
        assert fa_mod._pick_fwd_route(None, want) == want
        with pytest.raises(ValueError, match="route"):
            fa_mod._pick_fwd_route("wgmma", want)
        if want == "split":
            with pytest.raises(ValueError, match="route"):
                fa_mod._pick_fwd_route("decode", want)


@pytest.mark.parametrize("b,h_kv,rows,tk,d", [
    (8, 12, 1, 1024, 64), (8, 12, 1, 256, 64), (8, 4, 3, 1024, 64),
    (3, 12, 1, 1000, 128), (2, 2, 2, 20, 64), (2, 1, 32, 4096, 128),
    (1, 12, 8, 512, 48), (8, 12, 1, 8192, 64), (1, 1, 1, 20000, 64),
    (64, 32, 4, 4096, 128),
])
def test_decode_split_covers_the_keys_within_a_wave(b, h_kv, rows, tk, d):
    """The decode rule's chunking: chunks multiples of 32 keys up to
    1,024, every key in exactly one chunk, at most 8 chunks (one cluster)
    unless 1,024-key chunks need more, and no more blocks than three an
    SM unless one chunk a unit already exceeds that."""
    sms = 132
    splits, chunk = fa_mod._decode_split(b, h_kv, rows, tk, d, sms)
    assert chunk % fa_mod._DECODE_BK == 0
    assert fa_mod._DECODE_BK <= chunk <= fa_mod._DECODE_MAX_CHUNK
    assert (splits - 1) * chunk < tk <= splits * chunk
    assert splits <= fa_mod._DECODE_CLUSTER or chunk == 1024
    units = b * h_kv * -(-rows // fa_mod._DECODE_ROWS[fa_mod._kernel_dim(d)])
    assert units * splits <= max(3 * sms, units) or chunk == 1024


def _decode_case(case):
    """(q, k, v, key-padding bias or None, window or None) of a decode
    case, fp32 numpy."""
    rng = np.random.RandomState(sum(map(ord, case)))
    b, tk, d = 2, 300, 64
    tq, h, h_kv = {"tq1_gqa": (1, 12, 4), "tq4_mha": (4, 12, 12),
                   "tq15_gqa": (15, 12, 4)}.get(case, (1, 12, 4))
    q = rng.randn(b, tq, h, d).astype(np.float32)
    k = rng.randn(b, tk, h_kv, d).astype(np.float32)
    v = rng.randn(b, tk, h_kv, d).astype(np.float32)
    kb, window = None, None
    if case in ("dead_tail", "tq4_mha", "tq15_gqa", "tq1_gqa"):
        # the engine's cache: each row's live prefix, -1e9 on the tail
        live = np.arange(tk)[None, :] <= np.array([[57], [tk - 1]])
        kb = np.where(live, 0.0, -1e9).astype(np.float32)
    elif case == "window":
        window = 70
    elif case == "chunk_no_live_key":
        # keys 96-191 dead in every row: a whole chunk of 32 (and of 64)
        # weighs nothing
        kb = np.where((np.arange(tk) >= 96) & (np.arange(tk) < 192), -1e9,
                      0.0)[None].repeat(b, 0).astype(np.float32)
    elif case == "row_no_live_key":
        # batch row 0 sees only dead keys: every score -1e9, as JAX's
        # kernel gives them (the average of v)
        kb = np.zeros((b, tk), np.float32)
        kb[0] = -1e9
    return q, k, v, kb, window


DECODE_CASES = ["tq1_gqa", "tq4_mha", "tq15_gqa", "dead_tail", "window",
                "chunk_no_live_key", "row_no_live_key"]


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("chunk", ["rule", 32, 96])
def test_decode_plain_version_matches_jax(case, chunk):
    """The decode kernel's arithmetic (its plain version,
    ``_flash_fwd_split_ref`` at the decode rule's chunk or a named one:
    each chunk's (m, l, acc), merged in chunk order) against the JAX
    flash attention on the same inputs: q_len 1, 4 and 15, GQA 12/4 and
    12/12, the serving cache's -1e9 dead tail, a window that leaves the
    early chunks with no visible key, a chunk whose keys are all dead and
    a row whose keys are all dead.  fp32 at 2e-5."""
    q, k, v, kb, window = _decode_case(case)
    b, tq, h, d = q.shape
    tk, h_kv = k.shape[1], k.shape[2]
    if chunk == "rule":
        chunk = fa_mod._decode_split(b, h_kv, tq * (h // h_kv), tk, d,
                                     132)[1]
    jkw = dict(causal=True, interpret=True)
    if window is not None:
        jkw["window"] = window
    if kb is not None:
        jkw["key_padding_bias"] = jnp.asarray(kb)
    want = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             **jkw))
    tq_, tk_, tv_ = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = fa_mod._flash_fwd_split_ref(
        tq_, tk_, tv_, None if kb is None else torch.from_numpy(kb), None,
        sm_scale=d ** -0.5, causal=True, q_offset=tk - tq, window=window,
        chunk=chunk)
    np.testing.assert_allclose(out.numpy(), want, **TOL)
    full = fa_mod._flash_fwd_ref(
        tq_, tk_, tv_, None if kb is None else torch.from_numpy(kb), None,
        sm_scale=d ** -0.5, causal=True, q_offset=tk - tq, window=window)
    torch.testing.assert_close(lse, full[1], atol=1e-4, rtol=1e-5)
