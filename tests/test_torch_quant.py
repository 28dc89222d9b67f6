"""The port's int8 path (amp O4) against the JAX package's.

Same numpy inputs through ``apex_tpu.quant`` and ``apex_tpu_torch.quant``:

* ``quantized_matmul``: the port's plain version (what a CPU tensor
  takes) against the JAX Pallas kernel in interpret mode, EXACTLY, at
  the JAX test matrix (fp32 and bf16 at (32,64,48), (17,96,130), (8,8,8))
  and with an all-zero weight column; ``quantize``/``dequantize``/
  ``saturation_count`` exactly; the straight-through dx/dw against
  ``jax.grad`` within one bf16 ulp of max |grad| (the bf16 products of
  the two frameworks may round their fp32 sums apart by one ulp);
* calibration: ``Calibrator.freeze`` on one observation stream, the
  ``state_dict`` round trip JAX -> port -> JAX, the 12 observe sites of
  gpt_tiny letter for letter;
* the model hook and O4 training: gpt_tiny bf16 O4 logits under JAX's
  frozen calibration, O4 with no scales bitwise O2, the O4 preset, the O4
  state layout, a three-step O4 trajectory against JAX's;
* the int8 KV cache: ``QuantPool`` scatter/gather bitwise, the byte and
  page arithmetic, and the int8-KV engine's greedy tokens.

The CUDA kernel itself runs only on the card
(``tests/test_torch_kernels_cuda.py``).
"""

import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu import quant as jquant
from apex_tpu import serving as jserving
from apex_tpu import training as jtraining
from apex_tpu.amp.properties import opt_levels as jopt_levels
from apex_tpu.models import gpt_tiny as jgpt_tiny
from apex_tpu.serving import kv_cache as JKV
from apex_tpu_torch import quant, telemetry, training
from apex_tpu_torch.telemetry.metrics import MetricsRegistry
from apex_tpu_torch.amp import AmpOptionError, opt_levels
from apex_tpu_torch.convert import gpt_params_from_jax
from apex_tpu_torch.examples.lm import main_amp
from apex_tpu_torch.models import gpt_tiny
from apex_tpu_torch.quant import kernels as K
from apex_tpu_torch.serving import ServingEngine
from apex_tpu_torch.serving import kv_cache as KV

CFG = dict(vocab_size=96, hidden_size=64, num_layers=2, num_heads=4,
           mlp_dim=128, max_len=32)


def _np(t):
    return t.detach().float().numpy()


def _operands(m, k, n, seed=0, zero_channel=None):
    """fp32 numpy x, w and the per-tensor scale, as the JAX tests make
    them."""
    rs = np.random.RandomState(seed)
    x = rs.randn(m, k).astype(np.float32)
    w = (rs.randn(k, n) / np.sqrt(k)).astype(np.float32)
    if zero_channel is not None:
        w[:, zero_channel] = 0.0
    return x, w


def _pair(x, w, dtype):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    xs = float(np.abs(np.asarray(jx, np.float32)).max()) / 127.0
    return (jx, jw), (torch.from_numpy(x).to(dtype),
                      torch.from_numpy(w).to(dtype)), xs


# -- the kernel's function --------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(32, 64, 48), (17, 96, 130), (8, 8, 8)])
def test_quantized_matmul_equals_jax_interpret(dtype, m, k, n):
    (jx, jw), (tx, tw), xs = _pair(*_operands(m, k, n), dtype)
    want = np.asarray(jquant.quantized_matmul(jx, jw, x_scale=xs,
                                              interpret=True), np.float32)
    for kw in ({}, {"impl": "jnp"}, {"impl": "pallas", "interpret": True}):
        got = quant.quantized_matmul(tx, tw, x_scale=xs, **kw)
        assert got.dtype == dtype and got.shape == (m, n)
        np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(
        _np(quant.quantized_matmul_ref(tx, tw, x_scale=xs)),
        np.asarray(jquant.quantized_matmul_ref(jx, jw, x_scale=xs),
                   np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_zero_amax_column_equals_jax(dtype):
    (jx, jw), (tx, tw), xs = _pair(*_operands(16, 32, 24, zero_channel=5),
                                   dtype)
    got = _np(quant.quantized_matmul(tx, tw, x_scale=xs))
    np.testing.assert_array_equal(got, np.asarray(jquant.quantized_matmul(
        jx, jw, x_scale=xs, interpret=True), np.float32))
    assert np.all(got[:, 5] == 0.0)
    # a zero-amax activation round-trips as zeros
    z = quant.quantized_matmul(torch.zeros((4, 32), dtype=dtype), tw,
                               x_scale=quant.amax_to_scale(0.0))
    assert not z.any()


def test_3d_input_and_given_w_scale():
    x, w = _operands(12, 32, 16, seed=4)
    x3 = x.reshape(3, 4, 32)
    ws = np.abs(w).max(0) / 100.0
    want = jquant.quantized_matmul(jnp.asarray(x3), jnp.asarray(w),
                                   x_scale=0.02, w_scale=jnp.asarray(ws),
                                   interpret=True)
    got = quant.quantized_matmul(torch.from_numpy(x3), torch.from_numpy(w),
                                 x_scale=0.02, w_scale=torch.from_numpy(ws))
    assert got.shape == (3, 4, 16)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_quantize_dequantize_saturation_equal_jax():
    """Ties at exactly half a step (round half to even), values past the
    range (clipped), a per-channel scale, and the zero-amax guard."""
    rs = np.random.RandomState(1)
    x = (rs.randn(64, 40) * 3).astype(np.float32)
    x[0, :8] = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 126.5, 300.0, -300.0],
                        np.float32)
    for scale in (np.float32(1.0), np.float32(0.0173),
                  (np.abs(x).max(0) / 127.0).astype(np.float32)[None, :]):
        got = quant.quantize(torch.from_numpy(x), torch.from_numpy(
            np.asarray(scale)))
        want = jquant.quantize(jnp.asarray(x), jnp.asarray(scale))
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        back = quant.dequantize(got, torch.from_numpy(np.asarray(scale)),
                                torch.bfloat16)
        np.testing.assert_array_equal(_np(back), np.asarray(
            jquant.dequantize(want, jnp.asarray(scale), jnp.bfloat16),
            np.float32))
    for xs in (0.0173, 0.05, 1.0):
        assert int(quant.saturation_count(torch.from_numpy(x), xs)) == int(
            jquant.saturation_count(jnp.asarray(x), xs))
    amax = np.array([0.0, 1.0, 3e-3], np.float32)
    np.testing.assert_array_equal(
        quant.amax_to_scale(torch.from_numpy(amax)).numpy(),
        np.asarray(jquant.amax_to_scale(jnp.asarray(amax))))
    np.testing.assert_array_equal(
        quant.channel_scale(torch.from_numpy(x)).numpy(),
        np.asarray(jquant.channel_scale(jnp.asarray(x))))


def test_quantize_ties_round_half_to_even():
    got = quant.quantize(torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 126.5]),
                         1.0)
    assert got.tolist() == [0, 2, 2, 0, -2, 126]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_straight_through_grads_match_jax(dtype):
    """dx = g @ w.T and dw = x.T @ g in the operands' dtype, against
    ``jax.grad`` through the Pallas kernel in interpret mode, within one
    bf16 ulp (2**-8 relative) of max |grad| for bf16, 1e-6 for fp32."""
    (jx, jw), (tx, tw), xs = _pair(*_operands(16, 32, 24, seed=1), dtype)

    def jloss(x, w):
        return jnp.sum(jquant.quantized_matmul(
            x, w, x_scale=xs, interpret=True).astype(jnp.float32) ** 2) / 100

    want = jax.grad(jloss, argnums=(0, 1))(jx, jw)
    leaves = [t.clone().requires_grad_(True) for t in (tx, tw)]
    out = quant.quantized_matmul(*leaves, x_scale=xs)
    got = torch.autograd.grad((out.float() ** 2).sum() / 100, leaves)
    for g, wnt in zip(got, want):
        assert g.dtype == dtype
        wnt = np.asarray(wnt, np.float32)
        tol = (2.0 ** -8 if dtype == torch.bfloat16 else 1e-6) \
            * np.abs(wnt).max()
        np.testing.assert_allclose(_np(g), wnt, rtol=0, atol=tol)


def test_scales_get_zero_grads_and_backward_runs_no_kernel():
    x, w = _operands(8, 16, 8, seed=2)
    xs = torch.tensor(0.03, requires_grad=True)
    ws = (torch.from_numpy(np.abs(w).max(0)) / 127).requires_grad_(True)
    out = quant.quantized_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                 x_scale=xs, w_scale=ws)
    gxs, gws = torch.autograd.grad(out.sum(), (xs, ws))
    assert not gxs.any() and not gws.any() and gws.shape == (8,)


def test_quantized_matmul_validation():
    x = torch.zeros((4, 16))
    with pytest.raises(ValueError, match="w must be"):
        quant.quantized_matmul(x, torch.zeros((8, 4)), x_scale=1.0)
    with pytest.raises(ValueError, match="impl"):
        quant.quantized_matmul(x, torch.zeros((16, 4)), x_scale=1.0,
                               impl="bogus", interpret=True)
    with pytest.raises(NotImplementedError, match="block_m"):
        quant.quantized_matmul(x, torch.zeros((16, 4)), x_scale=1.0,
                               block_m=128)
    # the kernel's wrapper takes CUDA tensors only: no quiet plain path
    qw = torch.zeros((4, 16), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        K.qmm_kernel(x, qw, torch.tensor(1.0), torch.ones(4), torch.float32)
    with pytest.raises(ValueError, match="multiple of 16"):
        K.qmm_kernel(torch.zeros((4, 8)), torch.zeros((4, 8),
                                                      dtype=torch.int8),
                     torch.tensor(1.0), torch.ones(4), torch.float32)


# -- calibration --------------------------------------------------------------------

def _stream(seed=0, n=20):
    rs = np.random.RandomState(seed)
    return [(f"block_{i % 2}/mlp_up", float(abs(v)))
            for i, v in enumerate(rs.randn(n) * 3)] + \
        [("block_0/attention/query", 0.0)]


@pytest.mark.parametrize("mode", ["max", 99.9, 50.0, 12.5])
def test_calibrator_freeze_equals_jax(mode):
    jcal, cal = jquant.Calibrator(history=8), quant.Calibrator(history=8)
    for name, amax in _stream():
        jcal.observe(name, amax)
        cal.observe(name, amax)
    assert cal.sites == jcal.sites
    want, got = jcal.freeze(mode), cal.freeze(mode)
    assert got.scales == want.scales and got.amax == want.amax
    assert got.meta == want.meta
    assert got.state_dict() == want.state_dict()


def test_calibration_state_dict_round_trips_between_packages():
    jcal = jquant.Calibrator()
    for name, amax in _stream(1):
        jcal.observe(name, amax)
    jcalib = jcal.freeze(99.0)
    jcalib.note_saturation("block_1/mlp_up", 3)
    port = quant.Calibration.from_state_dict(jcalib.state_dict())
    assert port.scales == jcalib.scales and port.amax == jcalib.amax
    assert port.x_scale_for("block_1/mlp_up") == jcalib.get("block_1/mlp_up")
    assert "block_0/mlp_up" in port and len(port) == len(jcalib)
    back = jquant.Calibration.from_state_dict(port.state_dict())
    assert back.state_dict() == jcalib.state_dict()
    port.note_saturation("block_1/mlp_up", 2)
    port.note_saturation("block_1/mlp_up", 5)
    assert port.saturations == {"block_1/mlp_up": 7}


def test_calibration_refusals():
    with pytest.raises(ValueError, match="version"):
        quant.Calibration.from_state_dict({"version": 99})
    with pytest.raises(ValueError, match="observation"):
        quant.Calibrator().freeze()
    c = quant.Calibrator()
    c.observe("a", 1.0)
    with pytest.raises(ValueError, match="percentile"):
        c.freeze(mode=0.0)
    # the telemetry mirror and the saturation events are ported (held
    # against JAX's in tests/test_torch_telemetry.py)
    reg = MetricsRegistry()
    quant.Calibrator(registry=reg).observe("x", 2.0)
    assert reg.gauge("quant_absmax/x").value == 2.0
    rec = telemetry.Recorder(io.StringIO())
    cal = quant.Calibration({})
    cal.note_saturation("a", 1, recorder=rec)
    assert rec.metrics.counter("quant_saturations/a").value == 1
    assert cal.saturations == {"a": 1}
    # the JAX quant_stats collection (nested amax leaves) harvests too
    c.harvest({"block_0": {"mlp_up": {"amax": np.float32(2.0)}}})
    assert c.sites == ["a", "block_0/mlp_up"]


# -- the model hook ------------------------------------------------------------------

@pytest.fixture(scope="module")
def flax_params():
    ids = jnp.asarray(np.random.RandomState(0).randint(1, 96, (2, 12)))
    return jgpt_tiny(**CFG).init(jax.random.PRNGKey(3), ids)["params"]


def _port_model(flax_params, dtype=torch.bfloat16, quant_cfg=None):
    m = gpt_tiny(**CFG, dtype=dtype, quant=quant_cfg, device="cpu")
    m.load_state_dict(gpt_params_from_jax(
        jax.tree_util.tree_map(np.asarray, flax_params)))
    return m


def _ids(seed, b=2, t=16):
    return np.random.RandomState(seed).randint(1, 96, (b, t))


def _jax_calibration(flax_params, n=3):
    """JAX's observe phase, each batch starting from a zero ``quant_stats``
    collection passed in (a per-batch absmax)."""
    obs = jgpt_tiny(**CFG, dtype=jnp.bfloat16,
                    quant=jquant.QuantConfig.observe())
    zeros = obs.init(jax.random.PRNGKey(0), jnp.asarray(_ids(0)))[
        "quant_stats"]
    cal = jquant.Calibrator()
    stats = []
    for i in range(n):
        _, st = obs.apply({"params": flax_params, "quant_stats": zeros},
                          jnp.asarray(_ids(10 + i)), mutable=["quant_stats"])
        st = jax.device_get(st["quant_stats"])
        cal.harvest(st)
        stats.append(st)
    return cal, stats


def test_observe_sites_and_amax_match_jax(flax_params):
    """The 12 sites of gpt_tiny, letter for letter, and per-batch absmax
    within 1e-2 relative (bf16 activations of the two frameworks round
    apart by an ulp here and there upstream of a projection)."""
    jcal, jstats = _jax_calibration(flax_params)
    obs = _port_model(flax_params, quant_cfg=quant.QuantConfig.observe())
    cal = quant.Calibrator()
    for i, jst in enumerate(jstats):
        with torch.no_grad():
            obs(torch.from_numpy(_ids(10 + i)))
        st = quant.quant_stats(obs)
        cal.harvest(st)
        want = jquant.calibrate._flatten_stats(jst)
        assert sorted(st) == sorted(want)
        for site, amax in st.items():
            assert amax == pytest.approx(want[site], rel=1e-2), site
    assert len(cal.sites) == 12 and cal.sites == jcal.sites
    assert "block_1/attention/query" in cal.sites
    assert float(obs.block_0.mlp_up.amax) == 0.0     # reset by the read


def test_o4_without_scales_is_bitwise_o2(flax_params):
    ids = torch.from_numpy(_ids(4))
    plain = _port_model(flax_params)
    hooked = _port_model(flax_params,
                         quant_cfg=quant.QuantConfig("quant", scales={}))
    assert list(plain.state_dict()) == list(hooked.state_dict())
    with torch.no_grad():
        assert torch.equal(plain(ids), hooked(ids))
    # the same generator draws: an O4 model's init is an O2 model's
    a = gpt_tiny(**CFG, device="cpu", seed=5)
    b = gpt_tiny(**CFG, device="cpu", seed=5,
                 quant=quant.QuantConfig.observe())
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)


def test_o4_logits_match_jax_under_jax_calibration(flax_params):
    """gpt_tiny bf16 at O4 under JAX's frozen calibration, loaded through
    ``from_state_dict``.  Quantization itself moves these logits little
    (max |port O2 - JAX O4| 0.026, RMS 0.0049), and a bf16 activation
    that differs by an ulp between the frameworks can move its int8 value
    one step (max |port O4 - JAX O4| 0.015, RMS 0.0031).  So the port's
    O4 logits must lie within 2e-2 of JAX's, below the O2 gap, and be
    closer to them by RMS than the port's O2 logits are, by a fifth at
    least: a port that skipped quantization fails both."""
    jcal, _ = _jax_calibration(flax_params)
    jcalib = jcal.freeze()
    ids = _ids(7)
    jm = jgpt_tiny(**CFG, dtype=jnp.bfloat16,
                   quant=jquant.QuantConfig.frozen(jcalib))
    want = np.asarray(jm.apply({"params": flax_params}, jnp.asarray(ids)))
    want = want.astype(np.float32)
    calib = quant.Calibration.from_state_dict(jcalib.state_dict())
    tm = _port_model(flax_params, quant_cfg=quant.QuantConfig.frozen(calib))
    with torch.no_grad():
        got = _np(tm(torch.from_numpy(ids)))
        o2 = _np(_port_model(flax_params)(torch.from_numpy(ids)))
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)

    def rms(a):
        return float(np.sqrt(np.mean(np.square(a))))
    assert rms(got - want) < 0.8 * rms(o2 - want), (rms(got - want),
                                                    rms(o2 - want))
    assert rms(got - want) < 0.8 * rms(got - o2), (rms(got - want),
                                                   rms(got - o2))


# -- amp O4 and training ---------------------------------------------------------------

def test_o4_preset_equals_jax():
    want, got = jopt_levels["O4"](), opt_levels["O4"]()
    for name, value in want.options.items():
        if name == "cast_model_outputs":
            continue
        g = got.options[name]
        if name == "cast_model_type":
            assert str(g) == "torch." + jnp.dtype(value).name
        else:
            assert g == value, name
    assert not opt_levels["O2"]().quantize
    with pytest.raises(AmpOptionError, match="quantize"):
        p = opt_levels["O1"]()
        p.quantize = True
    p = opt_levels["O4"]()
    p.quantize = False
    with pytest.raises(AmpOptionError, match="O2/O3/O4"):
        p.patch_functions = True
    with pytest.raises(AmpOptionError, match="bool"):
        opt_levels["O4"]().quantize = 1


def _lm_loss(model):
    def loss_fn(p, batch):
        x, y = batch
        return main_amp.lm_loss(torch.func.functional_call(model, p, (x,)),
                                y, 0.1)
    return loss_fn


def _jax_lm_loss(jm):
    def loss_fn(p, batch):
        xb, yb = batch
        logits = jm.apply({"params": p}, xb)
        flat = logits.reshape(-1, logits.shape[-1])
        labels = yb.reshape(-1)
        logp = jax.nn.log_softmax(flat.astype(jnp.float32), axis=-1)
        nll = -jnp.take_along_axis(logp, labels[:, None], axis=-1)[:, 0]
        losses = 0.9 * nll + 0.1 * -jnp.mean(logp, axis=-1)
        return jnp.mean(jnp.where(labels == 0, 0.0, losses))
    return loss_fn


def test_o4_state_layout_is_o2s(flax_params):
    tm = _port_model(flax_params, quant_cfg=quant.QuantConfig("quant", {}))
    init4, _ = training.make_train_step(_lm_loss(tm), training.adam(),
                                        opt_level="O4", loss_scale="dynamic")
    init2, _ = training.make_train_step(_lm_loss(tm), training.adam(),
                                        opt_level="O2", loss_scale="dynamic")
    s4, s2 = init4(tm.state_dict()), init2(tm.state_dict())
    assert all(v.dtype == torch.float32 for v in s4.params.values())
    assert list(s4.params) == list(s2.params)
    assert list(s4.opt_state.exp_avg) == list(s2.opt_state.exp_avg)
    assert float(s4.scaler.loss_scale) == float(s2.scaler.loss_scale)


def test_o4_step_without_scales_is_bitwise_o2_step(flax_params):
    ids = _ids(8, t=17)
    x, y = torch.from_numpy(ids[:, :-1]), torch.from_numpy(ids[:, 1:])
    states = []
    for level, cfg in (("O2", None), ("O4", quant.QuantConfig("quant", {}))):
        tm = _port_model(flax_params, quant_cfg=cfg)
        init, step = training.make_train_step(
            _lm_loss(tm), training.adam(1e-3), opt_level=level)
        st, _ = step(init(tm.state_dict()), (x, y))
        states.append(st.params)
    for k, v in states[0].items():
        assert torch.equal(v, states[1][k]), k


def test_o4_three_steps_track_jax(flax_params):
    """Three Adam steps at O4 under JAX's calibration in both packages:
    losses within 2e-3 relative (measured 1.2e-4), and each parameter's
    change from its init within 0.3 of the norm of JAX's change (measured
    0.22 at most; Adam's first steps move an element by about lr times
    the sign of its gradient, so the few elements whose tiny gradients
    differ in sign between the frameworks differ by 2 lr).  A port whose
    straight-through dw were zero would miss every kernel by the whole
    change.  The key projection's bias has a zero gradient in exact
    arithmetic and is held to its step bound only."""
    jcalib = _jax_calibration(flax_params)[0].freeze()
    jm = jgpt_tiny(**CFG, dtype=jnp.bfloat16,
                   quant=jquant.QuantConfig.frozen(jcalib))
    jinit, jstep = jtraining.make_train_step(
        _jax_lm_loss(jm), jtraining.adam(1e-3, weight_decay=0.1),
        opt_level="O4")
    tm = _port_model(flax_params, quant_cfg=quant.QuantConfig.frozen(
        quant.Calibration.from_state_dict(jcalib.state_dict())))
    init, step = training.make_train_step(
        _lm_loss(tm), training.adam(1e-3, weight_decay=0.1), opt_level="O4")
    jst, st = jinit(flax_params), init(tm.state_dict())
    init_params = {k: v.clone().numpy() for k, v in st.params.items()}
    ids = _ids(9, b=4, t=17)
    x, y = ids[:, :-1], ids[:, 1:]
    jstep = jax.jit(jstep)
    for i in range(3):
        jst, jmet = jstep(jst, (jnp.asarray(x), jnp.asarray(y)))
        st, met = step(st, (torch.from_numpy(x), torch.from_numpy(y)))
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=2e-3, err_msg=f"step {i}")
    want = {"/".join(str(p.key) for p in path).replace("/", "."): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(
                jst.params)}
    assert sorted(want) == sorted(init_params)
    for k, w in want.items():
        got = st.params[k].numpy()
        if k.endswith("attention.key.bias"):
            assert np.abs(got).max() <= 3 * 1e-3 * 1.01, k
            continue
        d_got, d_want = got - init_params[k], np.asarray(w) - init_params[k]
        rel = np.linalg.norm(d_got - d_want) / np.linalg.norm(d_want)
        assert rel <= 0.3, (k, rel)


# -- the prepared weight -------------------------------------------------------------

@pytest.fixture(scope="module")
def o4_cfg(flax_params):
    """The port's frozen config from JAX's calibration of gpt_tiny."""
    jcalib = _jax_calibration(flax_params)[0].freeze()
    return quant.QuantConfig.frozen(
        quant.Calibration.from_state_dict(jcalib.state_dict()))


def _sites(model):
    return [m for m in model.modules()
            if isinstance(m, quant.QuantDenseGeneral)]


def _uncached_logits(model, ids):
    """Logits with every site's prepared weight emptied before each use
    (the per-call preparation, without gradients)."""
    def empty(mod, args):
        mod._prepared = None
    hooks = [m.register_forward_pre_hook(empty) for m in _sites(model)]
    try:
        with torch.no_grad():
            return model(ids)
    finally:
        for h in hooks:
            h.remove()


def test_o4_prepares_each_site_once_without_grad(flax_params, o4_cfg):
    """gpt_tiny bf16 at O4 under ``torch.no_grad()``: three forwards
    prepare each of the 12 sites once, the logits equal, bit for bit,
    those with the prepared weights emptied before every use, and they
    lie within the O4 test's 2e-2 of JAX's O4 logits."""
    tm = _port_model(flax_params, quant_cfg=o4_cfg)
    ids = [torch.from_numpy(_ids(20 + i)) for i in range(3)]
    with torch.no_grad():
        got = [tm(x) for x in ids]
    assert [m.preparations for m in _sites(tm)] == [1] * 12
    for x, g in zip(ids, got):
        assert torch.equal(g, _uncached_logits(tm, x))
    jm = jgpt_tiny(**CFG, dtype=jnp.bfloat16, quant=jquant.QuantConfig.frozen(
        jquant.Calibration.from_state_dict(o4_cfg.scales.state_dict())))
    want = np.asarray(jm.apply({"params": flax_params},
                               jnp.asarray(ids[0].numpy())), np.float32)
    np.testing.assert_allclose(_np(got[0]), want, atol=2e-2, rtol=0)


def test_o4_prepared_weight_follows_updates(flax_params, o4_cfg):
    """An in-place update of one site's kernel prepares that site again;
    ``load_state_dict`` and a ``.data`` assignment prepare again.  After
    each, the logits equal those of a model built afresh from the same
    weights."""
    tm = _port_model(flax_params, quant_cfg=o4_cfg)
    ids = torch.from_numpy(_ids(30))

    def fresh_logits():
        m = gpt_tiny(**CFG, dtype=torch.bfloat16, quant=o4_cfg, device="cpu")
        m.load_state_dict(tm.state_dict())
        with torch.no_grad():
            return m(ids)
    with torch.no_grad():
        tm(ids)
        site = tm.block_1.mlp_up
        site.kernel.mul_(1.5)
        got = tm(ids)
    counts = {m.site: m.preparations for m in _sites(tm)}
    assert counts.pop("block_1/mlp_up") == 2
    assert set(counts.values()) == {1}
    assert torch.equal(got, fresh_logits())

    other = gpt_tiny(**CFG, dtype=torch.bfloat16, device="cpu", seed=11)
    tm.load_state_dict(other.state_dict())
    with torch.no_grad():
        got = tm(ids)
    assert {m.preparations for m in _sites(tm)} == {2, 3}
    assert torch.equal(got, fresh_logits())

    site = tm.block_0.attention.query
    site.kernel.data = site.kernel.detach() * 0.5
    with torch.no_grad():
        got = tm(ids)
    assert site.preparations == 3
    assert torch.equal(got, fresh_logits())


def test_o4_with_grad_never_reads_the_prepared_weight(flax_params, o4_cfg):
    """With gradients recorded every call prepares (the training path),
    and no call reads what a call without gradients kept; the logits are
    the same bits either way.  Weights prepared under
    ``torch.inference_mode`` are no inference tensors."""
    tm = _port_model(flax_params, quant_cfg=o4_cfg)
    ids = torch.from_numpy(_ids(31))
    with torch.inference_mode():
        served = tm(ids).clone()
    for m in _sites(tm):
        assert not m._prepared[2].is_inference()
        assert not m._prepared[3].is_inference()

    def refuse(*a, **kw):
        raise AssertionError("the cache was read with grad enabled")
    for m in _sites(tm):
        m._prepared_weight = refuse
    trained = [tm(ids) for _ in range(2)]
    assert [m.preparations for m in _sites(tm)] == [3] * 12
    assert trained[0].requires_grad
    trained[0].float().sum().backward()
    assert tm.block_0.mlp_up.kernel.grad is not None
    for t in trained:
        assert torch.equal(t.detach(), served)


# -- the int8 KV cache --------------------------------------------------------------

def _tiny_pair(max_len=64):
    jm = jgpt_tiny(max_len=max_len, dtype=jnp.float32)
    tm = gpt_tiny(max_len=max_len, dtype=torch.float32, device="cpu")
    return jm, tm


def test_quant_pool_scatter_gather_equal_jax():
    jm, tm = _tiny_pair()
    jk, jv = JKV.make_pool(jm, n_pages=5, page_size=4, dtype=jnp.int8)
    pk, pv = KV.make_pool(tm, n_pages=5, page_size=4, dtype=torch.int8)
    assert isinstance(pk, KV.QuantPool) and pk.dtype == torch.float32
    assert tuple(pk.shape) == tuple(jk.shape)
    assert pk.scale.shape == jk.scale.shape and pk.data.dtype == torch.int8
    assert KV.storage_dtype(pk) == JKV.storage_dtype(jk) == "int8"
    rs = np.random.RandomState(0)
    L, _, page, n_kv, hd = pk.shape
    dense = (rs.randn(L, 2 * page, n_kv, hd) * 2).astype(np.float32)
    dense[0, 0, 0] = 0.0                      # a zero-amax row
    jk = JKV.scatter_prefill(jk, jnp.asarray([1, 3], jnp.int32),
                             jnp.asarray(dense))
    KV.scatter_prefill(pk, torch.tensor([1, 3]), torch.from_numpy(dense))
    tok = rs.randn(L, 2, n_kv, hd).astype(np.float32)
    jk = JKV.scatter_token(jk, jnp.asarray([3, 0], jnp.int32),
                           jnp.asarray([2, 1], jnp.int32), jnp.asarray(tok))
    KV.scatter_token(pk, torch.tensor([3, 0]), torch.tensor([2, 1]),
                     torch.from_numpy(tok))
    np.testing.assert_array_equal(pk.data.numpy(), np.asarray(jk.data))
    np.testing.assert_array_equal(pk.scale.numpy(), np.asarray(jk.scale))
    tables = np.asarray([[1, 3], [0, 0]], np.int32)
    jviews = JKV.gather_views(jk, jv, tables)
    views = KV.gather_views(pk, pv, torch.from_numpy(tables))
    for (jkk, jvv), (tk, tv) in zip(jviews, views):
        assert tk.dtype == torch.float32
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jkk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jvv))


def test_kv_bytes_and_page_budget_equal_jax():
    for kw in ({}, dict(num_kv_heads=2), dict(hidden_size=256, num_heads=4)):
        jm = jgpt_tiny(dtype=jnp.bfloat16, **kw)
        tm = gpt_tiny(dtype=torch.bfloat16, device="cpu", **kw)
        for jdt, tdt in ((None, None), (jnp.int8, torch.int8),
                         (jnp.float32, torch.float32),
                         (jnp.bfloat16, torch.bfloat16)):
            assert KV.kv_bytes_per_token(tm, tdt) == \
                JKV.kv_bytes_per_token(jm, jdt)
            for budget in (1 << 20, 8 << 20, 12345678):
                assert KV.pages_for_budget(tm, 16, budget, tdt) == \
                    JKV.pages_for_budget(jm, 16, budget, jdt)
    # GPT-2 small: int8 costs hd + 4 bytes a head, bf16 2 hd
    small = gpt_tiny(hidden_size=768, num_layers=12, num_heads=12,
                     mlp_dim=8, vocab_size=8, max_len=8,
                     dtype=torch.bfloat16, device="cpu")
    assert KV.kv_bytes_per_token(small, torch.int8) == 19584
    assert KV.kv_bytes_per_token(small) == 36864


def test_int8_kv_engine_tokens_equal_jax_engine():
    """The config of ``tests/test_quant.py``'s int8 decode test (gpt_tiny
    fp32, buckets (32, 64), page 8, 4 slots, three prompts, 8 new
    tokens): the int8-KV engine's greedy tokens equal the JAX int8-KV
    engine's, and its stats carry the int8 byte count."""
    jm, _ = _tiny_pair(128)
    rs = np.random.RandomState(0)
    probe = jnp.asarray(rs.randint(1, 1024, (1, 8)))
    params = jm.init(jax.random.PRNGKey(1), probe)["params"]
    prompts = [rs.randint(1, 1024, (n,)).astype(np.int32)
               for n in (5, 17, 30)]
    jeng = jserving.ServingEngine(jm, params, buckets=(32, 64), page_size=8,
                                  max_seqs=4, cache_dtype=jnp.int8)
    jeng.warmup()
    want = jeng.generate(prompts, max_new_tokens=8)
    jstats = dict(jeng.stats)
    jeng.close()
    tm = gpt_tiny(max_len=128, dtype=torch.float32, device="cpu")
    tm.load_state_dict(gpt_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    eng = ServingEngine(tm, buckets=(32, 64), page_size=8, max_seqs=4,
                        cache_dtype=torch.int8, device="cpu").warmup()
    got = eng.generate(prompts, max_new_tokens=8)
    assert eng.kv_cache_dtype == "int8"
    assert isinstance(eng.pool_k, KV.QuantPool)
    assert eng.stats["kv_bytes_per_token"] == jstats["kv_bytes_per_token"]
    eng.close()
    for w, g in zip(want, got):
        assert g.ok and w.ok
        np.testing.assert_array_equal(g.tokens, w.tokens)


def test_lm_trainer_o4_without_calibration_is_bitwise_o2():
    """``--opt-level O4`` in the LM trainer, which takes no calibration
    (as the JAX trainer's), steps bit for bit as O2."""
    base = ["--synthetic", "--steps", "2", "--device", "cpu", "--vocab",
            "256", "--hidden", "64", "--layers", "2", "--heads", "4",
            "--seq-len", "33"]
    res = {lvl: main_amp.train(main_amp.parse(base + ["--opt-level", lvl]),
                               log=lambda line: None)
           for lvl in ("O2", "O4")}
    assert res["O4"]["losses"] == res["O2"]["losses"]
    for k, v in res["O2"]["state"].params.items():
        assert torch.equal(res["O4"]["state"].params[k], v), k
