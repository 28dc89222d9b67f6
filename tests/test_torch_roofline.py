"""The port's roofline stage (``apex_tpu_torch.prof.roofline``) against
the JAX package's on the same numpy inputs.

Counterparts of the harvest, ledger and peaks tests of JAX's
``tests/test_roofline.py`` (its ``regress`` tests were ported with the
telemetry readers): the harvested matmul and conv FLOPs equal JAX's
jaxpr walk's EXACTLY on a matmul, a VALID conv, an MLP, the LeNet
example's training step and a GPT tiny training step with
``attention_impl="full"`` (where the JAX walk meets no ``pallas_call``
it would count once per block); regions group through nested scopes
and through the backward; ``mfu_ledger`` and ``format_ledger`` give
JAX's JSON and text for the same ``CostHarvest`` numbers and peaks;
``load_peaks`` never returns a TPU's number.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from apex_tpu.prof import capture as jcapture
from apex_tpu.prof import roofline as jroofline
from apex_tpu.prof import timeline as jtimeline
from apex_tpu_torch import prof, runtime, training
from apex_tpu_torch.prof import capture, roofline, timeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(*shapes, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


# -- cost harvest -------------------------------------------------------------

def _matmul_args():
    return _np((8, 16), (16, 32))


def test_harvest_matmul_flops_exact():
    x, w = _matmul_args()
    jh = jroofline.harvest_costs(lambda a, b: a @ b, jnp.asarray(x),
                                 jnp.asarray(w), xla=False)
    h = roofline.harvest_costs(lambda a, b: a @ b, torch.from_numpy(x),
                               torch.from_numpy(w), xla=False)
    assert h.source == "dispatch"
    assert h.matmul_flops == jh.matmul_flops == 2 * 8 * 16 * 32
    assert h.flops == h.jaxpr_flops == h.matmul_flops
    assert h.jaxpr_bytes == jh.jaxpr_bytes == (8 * 16 + 16 * 32 + 8 * 32) * 4
    assert h.counter_flops is None


def test_harvest_conv_flops_hand_computed():
    x, k = _np((2, 8, 8, 3), (3, 3, 3, 4))
    jh = jroofline.harvest_costs(
        lambda a, b: jax.lax.conv_general_dilated(
            a, b, window_strides=(1, 1), padding="VALID",
            dimension_numbers=("NHWC", "HWIO", "NHWC")),
        jnp.asarray(x), jnp.asarray(k), xla=False)
    h = roofline.harvest_costs(
        F.conv2d, torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
        torch.from_numpy(k.transpose(3, 2, 0, 1).copy()), xla=False)
    assert h.matmul_flops == jh.matmul_flops == 2 * (2 * 6 * 6 * 4) * 9 * 3


def test_harvest_flop_counter_agrees_with_walk():
    """With ``xla`` (JAX's compiler cross-check) FlopCounterMode counts
    the same call; on a plain product it agrees exactly, and the matmul
    split always comes from the walk."""
    x, w = _matmul_args()
    h = roofline.harvest_costs(lambda a, b: a @ b, torch.from_numpy(x),
                               torch.from_numpy(w), xla=True)
    assert h.counter_flops == h.matmul_flops == 2 * 8 * 16 * 32
    assert h.source == "dispatch"


def test_harvest_without_cross_check_parity():
    """Without the cross-check the harvest is the same walk: the same
    totals, matmul count and regions."""
    f, args = _scoped_model()
    ref = roofline.harvest_costs(f, *args, xla=True)
    h = roofline.harvest_costs(f, *args, xla=False)
    assert (h.flops, h.matmul_flops, h.by_region) == (
        ref.flops, ref.matmul_flops, ref.by_region)
    assert h.counter_flops is None and ref.counter_flops == ref.matmul_flops


def _scoped_model():
    def f(x, w1, w2):
        with capture.scope("blockA"):
            with capture.scope("mm"):
                h = x @ w1
        with capture.scope("blockB"):
            return torch.tanh(h) @ w2
    return f, [torch.from_numpy(a) for a in _np((4, 8), (8, 8), (8, 2))]


def _jax_scoped_model():
    def f(x, w1, w2):
        with jcapture.scope("blockA"):
            with jcapture.scope("mm"):
                h = x @ w1
        with jcapture.scope("blockB"):
            return jnp.tanh(h) @ w2
    return f, [jnp.asarray(a) for a in _np((4, 8), (8, 8), (8, 2))]


def test_region_attribution_nested_scopes():
    f, args = _scoped_model()
    jf, jargs = _jax_scoped_model()
    for depth in (1, 2):
        h = roofline.harvest_costs(f, *args, xla=False, region_depth=depth)
        jh = jroofline.harvest_costs(jf, *jargs, xla=False,
                                     region_depth=depth)
        assert {k: v["matmul_flops"] for k, v in h.by_region.items()} == {
            k: v["matmul_flops"] for k, v in jh.by_region.items()}
    h = roofline.harvest_costs(f, *args, xla=False)
    assert set(h.by_region) == {"blockA", "blockB"}
    assert h.by_region["blockA"]["matmul_flops"] == 2 * 4 * 8 * 8
    assert h.coverage_pct == pytest.approx(100.0)


def test_region_attribution_survives_backward_pass():
    """Forward and backward ops of one region land in the same row, as
    JAX's ``transpose(jvp(...))`` peel to the forward scope: the port
    stamps each autograd node with its forward's region.  Per-region
    matmul FLOPs equal JAX's."""
    f, args = _scoped_model()
    jf, jargs = _jax_scoped_model()

    def train(x, w1, w2):
        w1, w2 = (w.detach().requires_grad_(True) for w in (w1, w2))
        return torch.autograd.grad(f(x, w1, w2).sum(), (w1, w2))

    h = roofline.harvest_costs(train, *args, xla=False)
    jh = jroofline.harvest_costs(
        jax.grad(lambda x, w1, w2: jnp.sum(jf(x, w1, w2)), argnums=(1, 2)),
        *jargs, xla=False)
    assert set(h.by_region) <= {"blockA", "blockB", "<unattributed>"}
    assert h.by_region["blockA"]["matmul_flops"] >= 2 * (2 * 4 * 8 * 8)
    for region in ("blockA", "blockB"):
        assert h.by_region[region]["matmul_flops"] \
            == jh.by_region[region]["matmul_flops"]
    assert h.matmul_flops == jh.matmul_flops


@pytest.mark.parametrize("path", [
    "blockA/mm", "transpose(jvp(blockA))/mm", "pjit/scan", "jit(step)", "",
    "branch2a/mm", "body_net/mm", "scanner/mm", "jitter/mm", "condhead/mm",
    "custom_vjp_call",
    "transpose(jvp(stage1))/conv_general_dilated_transpose_lhs",
    "conv_general_dilated_transpose_lhs/mm", "conv_general_dilated",
    "block_3/attn", "act/swishish_fwd/swishish_bwd"])
def test_region_path_helper(path):
    for depth in (1, 2):
        assert capture.region_path(path, depth) \
            == jcapture.region_path(path, depth)


def test_harvest_never_recaptures_the_training_step():
    """Harvesting walks fake tensors: the pipeline's capture count stays
    where its own run left it."""
    def loss_fn(p, b):
        return (b @ p["w"]).sum()

    init_fn, step_fn = training.make_train_step(loss_fn, training.sgd(0.1),
                                                opt_level="O0")
    state = init_fn({"w": torch.ones(4, 2)})
    pipe = runtime.StepPipeline(step_fn, 1)
    window = torch.ones(1, 3, 4)
    with prof.assert_trace_count(pipe, 1):
        state, _ = pipe.step_window(state, window)
    with prof.assert_trace_count(pipe, 0):
        roofline.harvest_costs(step_fn, state, window[0])
        roofline.harvest_costs(pipe.loop, state, window,
                               torch.ones(1, dtype=torch.bool), xla=False)
        state, _ = pipe.step_window(state, window)


# -- FLOPs equal JAX's on the stated models -----------------------------------

def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_mlp_training_step_matmul_flops_equal_jax():
    x, w1, w2, w3 = _np((16, 32), (32, 64), (64, 64), (64, 10))

    def tloss(ws, x):
        h = x
        for i, w in enumerate(ws):
            h = h @ w
            if i < len(ws) - 1:
                h = torch.relu(h)
        return h.sum()

    def tgrad(w1, w2, w3, x):
        ws = [w.detach().requires_grad_(True) for w in (w1, w2, w3)]
        return torch.autograd.grad(tloss(ws, x), ws)

    def jloss(w1, w2, w3, x):
        h = jax.nn.relu(x @ w1)
        h = jax.nn.relu(h @ w2)
        return jnp.sum(h @ w3)

    h = roofline.harvest_costs(tgrad, *(torch.from_numpy(a) for a in
                                        (w1, w2, w3, x)))
    jh = jroofline.harvest_costs(jax.grad(jloss, argnums=(0, 1, 2)),
                                 *(jnp.asarray(a) for a in (w1, w2, w3, x)),
                                 xla=False)
    assert h.matmul_flops == jh.matmul_flops
    assert h.counter_flops == h.matmul_flops


def test_lenet_training_step_matmul_flops_equal_jax():
    """The LeNet examples of both packages ('SAME' 5x5 convs, three
    dense layers) on the same weights' shapes: the gradient's matmul and
    conv FLOPs are equal."""
    from apex_tpu_torch.examples.prof import lenet
    jl = _load(os.path.join(REPO, "examples", "prof", "lenet.py"),
               "_jax_prof_lenet")
    model = jl.LeNet()
    x = jnp.asarray(np.random.RandomState(0).rand(8, 32, 32, 1),
                    jnp.float32)
    y = jnp.asarray(np.arange(8) % 10)
    params = model.init(jax.random.PRNGKey(0), x)

    def jloss(p, x, y):
        logp = jax.nn.log_softmax(model.apply(p, x))
        return -jnp.mean(jnp.take_along_axis(logp, y[:, None], 1))

    jh = jroofline.harvest_costs(jax.grad(jloss), params, x, jnp.asarray(y),
                                 xla=False)
    step, ex = lenet.entry()
    h = roofline.harvest_costs(step, *ex)
    assert h.matmul_flops == jh.matmul_flops
    assert set(h.by_region) >= {"conv1", "conv2", "classifier"}
    # conv1: its forward and its weight gradient (the input needs none)
    assert h.by_region["conv1"]["matmul_flops"] \
        == 2 * 2 * (8 * 6 * 32 * 32) * 5 * 5 * 1


def test_gpt_tiny_training_step_matmul_flops_equal_jax():
    from apex_tpu.models import gpt_tiny as jgpt_tiny
    from apex_tpu_torch.convert import gpt_params_from_jax
    from apex_tpu_torch.examples.lm import main_amp
    from apex_tpu_torch.models import gpt_tiny
    cfg = dict(max_len=32, vocab_size=96, hidden_size=32, num_layers=2,
               num_heads=2, mlp_dim=64, attention_impl="full")
    ids = np.random.RandomState(1).randint(1, 96, (4, 17))
    x, y = ids[:, :-1], ids[:, 1:]
    jm = jgpt_tiny(**cfg)
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"]

    def jloss(p, x, y):
        logits = jm.apply({"params": p}, x)
        logp = jax.nn.log_softmax(logits.reshape(-1, 96).astype(jnp.float32))
        return -jnp.mean(jnp.take_along_axis(logp, y.reshape(-1)[:, None],
                                             -1))

    jh = jroofline.harvest_costs(jax.grad(jloss), params, jnp.asarray(x),
                                 jnp.asarray(y), xla=False)
    tm = gpt_tiny(**cfg, device="cpu")
    tm.load_state_dict(gpt_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in tm.state_dict().items()}

    def tgrad(p, x, y):
        loss = main_amp.lm_loss(torch.func.functional_call(tm, p, (x,)), y)
        return torch.autograd.grad(loss, list(p.values()))

    h = roofline.harvest_costs(tgrad, leaves, torch.from_numpy(x),
                               torch.from_numpy(y))
    assert h.matmul_flops == jh.matmul_flops
    assert h.counter_flops == h.matmul_flops
    assert {"embed", "block_0", "block_1", "head", "loss"} <= set(
        h.by_region)


def test_flash_kernels_count_their_formula_in_the_lm_step():
    """With the default flash attention the step's attention products
    are the kernels' records (visible pairs, not the plain version's
    full T x T), and the dense products equal the full-attention
    step's."""
    from apex_tpu_torch.examples.lm import main_amp
    argv = ["--synthetic", "--device", "cpu", "--vocab", "128", "--hidden",
            "64", "--layers", "2", "--heads", "4", "--seq-len", "33", "-b",
            "4", "--opt-level", "O0"]
    state, step, batch = main_amp.build(main_amp.parse(argv))
    flash = roofline.harvest_costs(step, state, batch, xla=False)
    prof_ = prof.profile_function(step, state, batch, xla_cost=False)
    ops = [r.op for r in prof_.records]
    assert ops.count("flash_attention_fwd") == 2
    assert ops.count("flash_attention_bwd_dq") == 2
    assert ops.count("flash_attention_bwd_dkv") == 2
    assert ops.count("layer_norm_fwd") == ops.count("layer_norm_bwd") == 5
    assert ops.count("xentropy_fwd") == ops.count("xentropy_bwd") == 1
    b, t, h, d = 4, 32, 4, 16
    pairs = b * t * (t + 1) // 2
    attn = 2 * (4 + 6 + 8) * h * d * pairs
    state, step, batch = main_amp.build(main_amp.parse(
        argv + ["--attention", "full"]))
    full = roofline.harvest_costs(step, state, batch, xla=False)
    # the full step's attention: QK^T and PV forward, and their four
    # backward products, over every pair
    full_attn = 2 * 6 * 2 * b * h * t * t * d
    assert flash.matmul_flops - attn == full.matmul_flops - full_attn


# -- MFU ledger ---------------------------------------------------------------

def _toy(mod):
    return mod.CostHarvest(
        flops=2e9, bytes=2e7, source="jaxpr", matmul_flops=1.9e9,
        jaxpr_flops=2e9, jaxpr_bytes=2e7,
        by_region={
            "dense": {"flops": 1.9e9, "bytes": 4e6,
                      "matmul_flops": 1.9e9, "ops": 3},
            "norm": {"flops": 1e8, "bytes": 1.6e7,
                     "matmul_flops": 0.0, "ops": 7},
        })


PEAKS = {"flops": 100e12, "hbm_gb_s": 1000.0, "source": "test"}


def test_mfu_ledger_classification_and_normalization():
    led = roofline.mfu_ledger(_toy(roofline), step_time_s=1e-3, peaks=PEAKS)
    jled = jroofline.mfu_ledger(_toy(jroofline), step_time_s=1e-3,
                                peaks=PEAKS)
    assert led == jled
    assert led["schema_version"] == timeline.SCHEMA_VERSION
    by = {r["region"]: r for r in led["regions"]}
    assert by["dense"]["bound"] == "compute"
    assert by["norm"]["bound"] == "memory"
    assert sum(r["modeled_ms"] for r in led["regions"]) \
        == pytest.approx(1.0, rel=0.01)
    assert led["total"]["mfu_pct"] == pytest.approx(
        100 * 1.9e9 / 1e-3 / 100e12, rel=0.01)


def test_mfu_ledger_top_truncation_json_and_text_equal_jax():
    kw = dict(step_time_s=1e-3, peaks={"flops": 1e12, "hbm_gb_s": 100.0},
              top=1)
    led = roofline.mfu_ledger(_toy(roofline), **kw)
    jled = jroofline.mfu_ledger(_toy(jroofline), **kw)
    assert json.dumps(led) == json.dumps(jled)
    assert len(led["regions"]) == 1 and led["regions_dropped"] == 1
    assert roofline.format_ledger(led) == jroofline.format_ledger(jled)
    assert "roofline ledger" in roofline.format_ledger(led)


def test_mfu_ledger_gap_attribution_from_timeline():
    events = [
        {"t": 0.0, "kind": "run", "meta": {}},
        {"t": 0.3, "kind": "retrace", "program": "hot", "step": 0,
         "n_traces": 1, "first": True, "new_sig": True, "sig": "s",
         "dur": 0.3},
        {"t": 0.3, "kind": "window", "step": 0, "k": 4, "n_valid": 4,
         "dur": 0.3, "gap": 0.0, "program": "hot"},
        {"t": 0.5, "kind": "loader_wait", "dur": 0.05, "qdepth": 0},
        {"t": 0.6, "kind": "window", "step": 4, "k": 4, "n_valid": 4,
         "dur": 0.1, "gap": 0.2, "program": "hot"},
        {"t": 0.9, "kind": "window", "step": 8, "k": 4, "n_valid": 4,
         "dur": 0.1, "gap": 0.2, "program": "hot"},
    ]
    ta, jta = timeline.analyze(events), jtimeline.analyze(events)
    kw = dict(peaks={"flops": 1e12, "hbm_gb_s": 100.0},
              best_window_step_s=0.02)
    led = roofline.mfu_ledger(_toy(roofline), timeline=ta, **kw)
    assert led == jroofline.mfu_ledger(_toy(jroofline), timeline=jta, **kw)
    gap = led["gap"]
    assert gap["compile_pct"] > 0
    assert gap["dispatch_gap_pct"] == ta["attribution"]["dispatch_gap_pct"]
    assert 0 <= gap["steady_vs_best_pct"] <= 100
    assert led["total"]["step_ms"] == pytest.approx(
        ta["elapsed_s"] / ta["steps"] * 1e3, rel=0.01)
    assert roofline.format_ledger(led) == jroofline.format_ledger(
        jroofline.mfu_ledger(_toy(jroofline), timeline=jta, **kw))


def test_load_peaks_reads_a_peaks_file_and_never_a_tpus(tmp_path):
    p = tmp_path / "BENCH_EXTRA.json"
    p.write_text(json.dumps({
        "measured_matmul_tflops": 127.4, "peak_bf16_tflops": 197.0,
        "resnet50": {"prof_measured": {"by_category": [
            {"category": "loop fusion", "gb_per_s": 881.0}]}}}))
    pk = roofline.load_peaks(str(p))
    assert pk == jroofline.load_peaks(str(p))
    assert roofline.load_peaks(str(tmp_path))["flops"] \
        == pytest.approx(127.4e12)
    q = tmp_path / "h100.json"
    q.write_text(json.dumps({"peak_bf16_tflops": 989.0}))
    pk = roofline.load_peaks(str(q))
    assert pk["flops"] == 989e12 and pk["hbm_gb_s"] == 3350.0
    if not torch.cuda.is_available():
        for path in (None, str(tmp_path / "nope.json")):
            with pytest.raises(RuntimeError, match="peaks"):
                roofline.load_peaks(path)
    assert roofline.DEFAULT_HBM_GB_S == 3350.0
    assert roofline.DEVICE_PEAKS["H100"] == (989e12, 3350.0)


def test_load_peaks_by_card_name(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=0: "NVIDIA H100 80GB HBM3")
    pk = roofline.load_peaks()
    assert (pk["flops"], pk["hbm_gb_s"]) == (989e12, 3350.0)
    assert pk["source"] == "data_sheet:NVIDIA H100 80GB HBM3"
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=0: "Some Other Card")
    with pytest.raises(ValueError, match="data-sheet"):
        roofline.load_peaks()


def test_roofline_cli_json(tmp_path, capsys, monkeypatch):
    mod = tmp_path / "torch_roofline_cli_target.py"
    mod.write_text(
        "import torch\n"
        "def entry():\n"
        "    def f(x, w):\n"
        "        return x @ w\n"
        "    return f, (torch.zeros((256, 512)), torch.zeros((512, 512)))\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    peaks = tmp_path / "peaks.json"
    peaks.write_text(json.dumps({"peak_bf16_tflops": 989.0,
                                 "hbm_gb_s": 3350.0}))
    rc = roofline.main(["--fn", "torch_roofline_cli_target:entry",
                        "--no-xla", "--step-ms", "1.0", "--json",
                        "--peaks", str(peaks)])
    assert rc == 0
    led = json.loads(capsys.readouterr().out)
    assert led["total"]["matmul_flops_g"] == pytest.approx(
        2 * 256 * 512 * 512 / 1e9, rel=0.01)
    assert led["schema_version"] == timeline.SCHEMA_VERSION
    assert led["peaks"]["tflops"] == 989.0
    rc = roofline.main(["--peaks", str(peaks), "--memory", "--step-ms", "2"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "peak HBM" in out and "conv1" in out


def test_bench_harvest_cross_check_shape():
    """A dense tower's backward: 5 products of 2 (B S) H H each, as
    JAX's (two forward, two wgrads, one dgrad)."""
    b, s, hdim = 2, 8, 16
    x = torch.zeros(b * s, hdim)
    w = torch.zeros(hdim, hdim)

    def g(x, w1, w2):
        w1, w2 = (t.detach().requires_grad_(True) for t in (w1, w2))
        return torch.autograd.grad((torch.tanh(x @ w1) @ w2).sum(), (w1, w2))

    h = roofline.harvest_costs(g, x, w, w, xla=False)
    assert h.matmul_flops == 5 * (2 * hdim * hdim) * b * s
