"""The port's step pipeline (``apex_tpu_torch.runtime``, ``training.
chain_steps``, the prefetch loader of ``apex_tpu_torch.data``) against
the JAX package's.

Same numpy weights and batches through JAX's ``StepPipeline`` (a
``lax.scan`` per window) and the port's (the same window functions, run
eagerly on the CPU; captured in CUDA graphs on the card, which
``chip_smoke.py`` holds against eager steps): K 1, 3 and 4 on gpt_tiny
and on a small ResNet with its BN statistics as model state, each with a
ragged tail, and an overflow skip mid-window under a dynamic loss scale.
Losses rtol 1e-5 and parameters atol 1e-5 (fp32 summation order; SGD, so
no per-element step normalisation magnifies the rounding).  Then the
port's K chained steps against K single steps of the port, bit for bit;
the deferred metric reader, ``window_batches``, ``stage_windows`` over
``PrefetchLoader``, ``GracefulShutdown``, and both trainers' CLIs with
``--steps-per-call``.
"""

import os
import signal
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu import runtime as jruntime
from apex_tpu import training as jtraining
from apex_tpu.contrib.groupbn import BatchNorm2d_NHWC as JBatchNorm2d_NHWC
from apex_tpu.models import gpt_tiny as jgpt_tiny
from apex_tpu.models import resnet as jresnet
from apex_tpu_torch import data, runtime, training
from apex_tpu_torch.contrib.groupbn import BatchNorm2d_NHWC
from apex_tpu_torch.convert import gpt_params_from_jax, \
    resnet_variables_to_jax
from apex_tpu_torch.examples.imagenet import main_amp as imagenet_main
from apex_tpu_torch.examples.lm import main_amp
from apex_tpu_torch.models import BasicBlock, ResNet, gpt_tiny

CFG = dict(vocab_size=96, hidden_size=64, num_layers=2, num_heads=4,
           mlp_dim=128, max_len=32)
RESNET_SMALL = dict(stage_sizes=[1, 1, 1, 1], num_filters=8, num_classes=10)


def _flat_jax(tree):
    return {"/".join(str(p.key) for p in path).replace("/", "."):
            np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


# -- the two models' steps, JAX and port, on the same weights ------------------

def _gpt_pair(loss_scale):
    """SGD steps of gpt_tiny at O0 (fp32), the loss multiplied by the
    batch's third leaf (1, or inf to make the step overflow)."""
    jm = jgpt_tiny(**CFG)
    ids = jnp.asarray(np.random.RandomState(0).randint(1, 96, (2, 12)))
    jparams = jm.init(jax.random.PRNGKey(3), ids)["params"]
    tm = gpt_tiny(**CFG, device="cpu")
    tm.load_state_dict(gpt_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams)))

    def jloss(p, batch):
        x, y, mult = batch
        logp = jax.nn.log_softmax(jm.apply({"params": p}, x), axis=-1)
        nll = -jnp.take_along_axis(logp, y[..., None], axis=-1)
        return jnp.mean(nll) * mult

    def tloss(p, batch):
        x, y, mult = batch
        logp = torch.log_softmax(
            torch.func.functional_call(tm, p, (x,)), dim=-1)
        return -logp.gather(-1, y[..., None]).mean() * mult

    kw = dict(opt_level="O0", loss_scale=loss_scale)
    jinit, jstep = jtraining.make_train_step(
        jloss, jtraining.sgd(0.1, momentum=0.9), **kw)
    init, step = training.make_train_step(
        tloss, training.sgd(0.1, momentum=0.9), **kw)

    def batches(n, bad_step=None):
        rng = np.random.RandomState(7)
        out = []
        for i in range(n):
            ids = rng.randint(1, 96, (4, 13))
            out.append((ids[:, :-1], ids[:, 1:],
                        np.float32(np.inf if i == bad_step else 1.0)))
        return out

    def to_jax(b):
        return (jnp.asarray(b[0], jnp.int32), jnp.asarray(b[1], jnp.int32),
                jnp.asarray(b[2]))

    def to_torch(b):
        return (torch.from_numpy(b[0]), torch.from_numpy(b[1]),
                torch.tensor(b[2]))

    return ((jinit(jparams), jstep, to_jax),
            (lambda: init(tm.state_dict()), step, to_torch), batches)


def _resnet_pair(loss_scale):
    """SGD steps of a small ResNet at O0 with the BN statistics as model
    state (the ImageNet trainer's step, its plain loss), the loss
    multiplied by the batch's third leaf."""
    jm = jresnet.ResNet(block_cls=jresnet.BasicBlock, dtype=jnp.float32,
                        norm_cls=JBatchNorm2d_NHWC, **RESNET_SMALL)
    tm = ResNet(block_cls=BasicBlock, dtype=torch.float32,
                norm_cls=BatchNorm2d_NHWC, device="cpu", seed=4,
                **RESNET_SMALL)
    variables = resnet_variables_to_jax(*tm.variables())

    def jloss(p, ms, batch):
        logits, upd = jm.apply({"params": p, "batch_stats": ms}, batch[0],
                               train=True, mutable=["batch_stats"])
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        nll = -jnp.take_along_axis(logp, batch[1][:, None], axis=-1)
        return jnp.mean(nll) * batch[2], upd["batch_stats"]

    def tloss(p, ms, batch):
        logits, new_ms = tm.apply(p, ms, batch[0])
        loss = imagenet_main.image_loss(logits, batch[1], fused=False)
        return loss * batch[2], new_ms

    kw = dict(opt_level="O0", loss_scale=loss_scale, has_model_state=True)
    jinit, jstep = jtraining.make_train_step(
        jloss, jtraining.sgd(0.01, momentum=0.9), **kw)
    init, step = training.make_train_step(
        tloss, training.sgd(0.01, momentum=0.9), **kw)
    params, stats = tm.variables()

    def batches(n, bad_step=None):
        rng = np.random.RandomState(8)
        return [(rng.randn(4, 32, 32, 3).astype(np.float32),
                 rng.randint(0, 10, 4),
                 np.float32(np.inf if i == bad_step else 1.0))
                for i in range(n)]

    def to_jax(b):
        return (jnp.asarray(b[0]), jnp.asarray(b[1], jnp.int32),
                jnp.asarray(b[2]))

    def to_torch(b):
        return (torch.from_numpy(b[0]), torch.from_numpy(b[1]).long(),
                torch.tensor(b[2]))

    def port_state():
        return init({k: v.detach().clone() for k, v in params.items()},
                    {k: v.clone() for k, v in stats.items()})

    return ((jinit(variables["params"], variables["batch_stats"]), jstep,
             to_jax), (port_state, step, to_torch), batches)


_PAIRS = {"gpt_tiny": _gpt_pair, "resnet": _resnet_pair}


def _run_pipeline(rt, step, state, batches, k, transform):
    """``rt.StepPipeline`` over ``rt.window_batches``: the final state
    and every real step's loss, loss scale and overflow flag."""
    seen = []
    pipe = rt.StepPipeline(step, k=k)
    state, reader = pipe.run(
        state, rt.window_batches(iter(batches), k, transform=transform),
        on_metrics=lambda wm: seen.append((wm.n_valid, wm.fetch())))
    out = {name: np.concatenate([np.ravel(np.asarray(m[name]))[:n]
                                 for n, m in seen])
           for name in ("loss", "loss_scale", "overflow")}
    return state, out, reader


@pytest.mark.parametrize("model,k,dynamic", [
    ("gpt_tiny", 1, False), ("gpt_tiny", 3, True), ("gpt_tiny", 4, False),
    ("resnet", 1, False), ("resnet", 3, True), ("resnet", 4, True)])
def test_pipeline_matches_jax_pipeline(model, k, dynamic):
    """Two full windows and a ragged tail (K 1: three full windows)
    through both pipelines; with a dynamic scale an inf mid-window
    (first window's middle step) is skipped on the device in both: the
    same per-step losses, scales and overflow flags, the same final
    parameters (and BN statistics)."""
    jax_side, port_side, make_batches = _PAIRS[model](
        "dynamic" if dynamic else None)
    n = 2 * k + max(1, k - 1)
    batches = make_batches(n, bad_step=k // 2 if dynamic else None)
    jstate, jout, _ = _run_pipeline(jruntime, jax_side[1], jax_side[0],
                                    batches, k, jax_side[2])
    state, out, reader = _run_pipeline(runtime, port_side[1], port_side[0](),
                                       batches, k, port_side[2])
    assert reader.steps_pushed == n
    np.testing.assert_allclose(out["loss"], jout["loss"], rtol=1e-5)
    np.testing.assert_array_equal(out["loss_scale"], jout["loss_scale"])
    np.testing.assert_array_equal(out["overflow"], jout["overflow"])
    if dynamic:
        assert out["overflow"][k // 2] and out["overflow"].sum() == 1
        assert float(state.scaler.loss_scale) == 2.0 ** 15
    want = _flat_jax(jstate.params)
    assert set(state.params) == set(want)
    for name, v in state.params.items():
        np.testing.assert_allclose(v.numpy(), want[name], rtol=0,
                                   atol=1e-5, err_msg=name)
    if model == "resnet":
        want = _flat_jax(jstate.model_state)
        for name, v in state.model_state.items():
            np.testing.assert_allclose(v.numpy(), want[name], rtol=0,
                                       atol=1e-5, err_msg=name)


@pytest.mark.parametrize("k", [1, 3, 4])
def test_chained_steps_equal_single_steps_bitwise(k):
    """The port's pipeline (full windows and a ragged tail) against the
    same steps one ``step_fn`` call at a time: every state leaf equal bit
    for bit, and the padded steps of the tail leave no trace."""
    _, (init, step, to_torch), make_batches = _gpt_pair("dynamic")
    n = 2 * k + max(1, k - 1)
    batches = make_batches(n, bad_step=1)
    state, out, _ = _run_pipeline(runtime, step, init(), batches, k,
                                  to_torch)
    ref = init()
    losses = []
    for b in batches:
        ref, m = step(ref, to_torch(b))
        losses.append(float(m["loss"]))
    np.testing.assert_array_equal(out["loss"], np.float32(losses))
    got, want = (torch.utils._pytree.tree_leaves(s) for s in (state, ref))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w) if isinstance(w, torch.Tensor) else g == w


def test_chain_steps_stacks_metrics_on_k():
    """``chain_steps`` runs the steps in order and stacks each metric on
    a leading K axis, as JAX's ``lax.scan`` does."""
    def step(state, batch):
        (x,) = batch
        new = state + x.sum()
        return new, {"total": new, "x0": x[0]}

    window = (torch.arange(12.).reshape(3, 4),)
    state, metrics = training.chain_steps(step)(torch.tensor(0.), window)
    jstate, jmetrics = jtraining.chain_steps(
        lambda s, b: (s + b[0].sum(), {"total": s + b[0].sum(),
                                       "x0": b[0][0]}))(
        jnp.float32(0.), (jnp.arange(12.).reshape(3, 4),))
    assert float(state) == float(jstate) == 66.0
    for name in ("total", "x0"):
        np.testing.assert_array_equal(metrics[name].numpy(),
                                      np.asarray(jmetrics[name]))


def test_pipeline_rejects_what_it_does_not_take():
    _, (init, step, to_torch), make_batches = _gpt_pair(None)
    with pytest.raises(ValueError):
        runtime.StepPipeline(step, k=0)
    with pytest.raises(NotImplementedError, match="wrap"):
        runtime.StepPipeline(step, k=2, wrap=lambda f: f)
    with pytest.raises(NotImplementedError, match="telemetry"):
        runtime.StepPipeline(step, k=2, telemetry=object())
    pipe = runtime.StepPipeline(step, k=2)
    window, _ = next(runtime.window_batches(iter(make_batches(2)), 2,
                                            transform=to_torch))
    with pytest.raises(ValueError):
        pipe.step_window(init(), window, n_valid=0)
    # the CPU captures nothing: warmup is free and memory_stats is None
    assert pipe.warmup(init(), window, tail=True) is pipe
    assert pipe.memory_stats() is None
    pipe.step_window(init(), window)
    assert pipe.stats == {"captures": {"hot": 0, "tail": 0}, "replays": 0,
                          "steps": 2}


# -- the deferred reader, windows and the loader --------------------------------

def test_deferred_metrics_one_window_behind_like_jax():
    for rt, val in ((runtime, torch.tensor), (jruntime, jnp.float32)):
        reader = rt.DeferredMetrics()
        assert reader.push({"loss": val(0.0)}, 4) is None
        prev = reader.push({"loss": val(1.0)}, 4)
        assert prev is not None and prev.step == 0 and prev.n_valid == 4
        assert reader.steps_pushed == 8
        np.testing.assert_allclose(reader.last()["loss"], 1.0)


@pytest.mark.parametrize("n_windows", [1, 2, 5])
def test_deferred_metrics_flush_drops_no_window(n_windows):
    reader = runtime.DeferredMetrics()
    returned = []
    for i in range(n_windows):
        prev = reader.push({"loss": torch.tensor(float(i))}, 4)
        if prev is not None:
            returned.append(prev.step)
    flushed = reader.flush()
    returned += [wm.step for wm in flushed]
    assert returned == [4 * i for i in range(n_windows)]
    assert reader.flush() == []
    np.testing.assert_allclose(flushed[-1].fetch()["loss"], n_windows - 1)


def test_window_fetch_keeps_every_dtype():
    """One stacked read brings back fp32, bf16, bool and int64 leaves
    with their values and numpy dtypes (bf16 as fp32)."""
    metrics = {"loss": torch.tensor([1.5, -2.25]),
               "half": torch.tensor([0.5, 3.0], dtype=torch.bfloat16),
               "overflow": torch.tensor([False, True]),
               "count": torch.tensor([2 ** 40 + 1, 3])}
    host = runtime.WindowMetrics(0, 2, metrics).fetch()
    np.testing.assert_array_equal(host["loss"], np.float32([1.5, -2.25]))
    assert host["half"].dtype == np.float32
    np.testing.assert_array_equal(host["overflow"], [False, True])
    assert host["overflow"].dtype == np.bool_
    np.testing.assert_array_equal(host["count"], [2 ** 40 + 1, 3])


def test_window_batches_equal_jax():
    batches = [(np.full((2,), i, np.float32),) for i in range(5)]
    for pad in (True, False):
        got = list(runtime.window_batches(iter(batches), 2, pad_tail=pad))
        want = list(jruntime.window_batches(iter(batches), 2, pad_tail=pad))
        assert [n for _, n in got] == [n for _, n in want]
        for (g, _), (w, _) in zip(got, want):
            np.testing.assert_array_equal(g[0], w[0])
    with pytest.raises(ValueError):
        next(runtime.window_batches(iter(batches), 0))


def test_stage_windows_over_prefetch_loader_equal_jax():
    """Windows assembled by two workers and staged onto the CPU: torch
    tensors, in order, equal to the JAX package's staged windows."""
    batches = [(np.full((2, 3), i, np.float32), np.int64(i))
               for i in range(7)]
    loader = runtime.stage_windows(iter(batches), 3, device="cpu",
                                   workers=2)
    got = list(loader)
    want = list(jruntime.stage_windows(iter(batches), 3))
    assert [n for _, n in got] == [n for _, n in want] == [3, 3, 1]
    for (g, _), (w, _) in zip(got, want):
        assert isinstance(g[0], torch.Tensor) and g[0].device.type == "cpu"
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w[0]))
        np.testing.assert_array_equal(g[1].numpy(), np.asarray(w[1]))
    snap = loader.stats.as_dict()
    assert snap["batches"] == 3 and snap["staged"] == 3
    assert data.format_loader_line(snap).startswith("loader: stall ")


def test_prefetch_loader_orders_errors_and_closes():
    """Ordered delivery under uneven transform times, a producer error
    raised after every earlier batch, and an early break that stops the
    threads."""
    def slow_odd(i):
        if i % 2:
            threading.Event().wait(0.01)
        return np.full((2,), i)

    got = [int(x[0]) for x in data.PrefetchLoader(
        range(9), transform=slow_odd, workers=3, device="cpu")]
    assert got == list(range(9))

    def bad(i):
        if i == 3:
            raise KeyError("batch 3")
        return np.full((1,), i)

    seen = []
    with pytest.raises(KeyError, match="batch 3"):
        for x in data.PrefetchLoader(range(6), transform=bad, workers=2,
                                     device="cpu"):
            seen.append(int(x[0]))
    assert seen == [0, 1, 2]
    def loader_threads():
        return [t for t in threading.enumerate()
                if t.name.startswith("apex-tpu-torch-prefetch")]

    loader = data.PrefetchLoader(iter(range(1000)), device="cpu",
                                 workers=2)
    for i, _ in enumerate(loader):
        if i == 2:
            break
    loader.close()
    for t in loader_threads():
        t.join(timeout=5)
    assert not any(t.is_alive() for t in loader_threads())
    with pytest.raises(ValueError):
        data.PrefetchLoader([], workers=0, device="cpu")
    with pytest.raises(NotImplementedError, match="telemetry"):
        data.PrefetchLoader([], device="cpu", telemetry=object())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            data.PrefetchLoader([])


def test_graceful_shutdown_signal_and_request():
    prev = signal.getsignal(signal.SIGTERM)
    with runtime.GracefulShutdown(signals=(signal.SIGTERM,)) as stop:
        assert not stop.draining
        os.kill(os.getpid(), signal.SIGTERM)
        assert stop._drain.wait(timeout=5)
        assert stop.draining and stop.reason == "signal:SIGTERM"
    assert signal.getsignal(signal.SIGTERM) is prev
    stop = runtime.GracefulShutdown()
    stop.request("preemption-notice")
    stop.request("second")
    assert stop.draining and stop.reason == "preemption-notice"
    with pytest.raises(NotImplementedError, match="telemetry"):
        runtime.GracefulShutdown(telemetry=object())


class _Windows:
    """A window stream that records being closed."""

    def __init__(self, windows):
        self._it, self.closed = iter(windows), False

    def __iter__(self):
        return self._it

    def close(self):
        self.closed = True


@pytest.mark.parametrize("drain", [False, True])
def test_pipeline_run_checkpoints_drains_and_closes(drain, tmp_path):
    """``StepPipeline.run`` with a checkpoint manager: a save every 4
    steps with the loader state taken at the window's boundary, a final
    blocking save where it stops (``steps=6`` of 8 batches; with
    ``drain``, a SIGTERM during the first window: a save at step 2 and no
    second one), the windows closed; every checkpoint holds the state of
    the step it names, bit for bit the uninterrupted run's."""
    from apex_tpu_torch import checkpoint
    _, (port_state, step, to_torch), make_batches = _gpt_pair(None)
    batches = make_batches(8)
    ref, states = port_state(), []
    for b in batches[:6]:
        ref, _ = step(ref, to_torch(b))
        states.append(ref)
    mgr = checkpoint.CheckpointManager(str(tmp_path), every_steps=4)
    windows = _Windows(runtime.window_batches(iter(batches), 2,
                                              transform=to_torch))
    lines, taken = [], []

    def loader_state(at):
        taken.append(at)
        return {"cursor": at}

    def on_window(n):
        if drain and n == 2:
            os.kill(os.getpid(), signal.SIGTERM)
    state, reader = runtime.StepPipeline(step, 2).run(
        port_state(), windows, steps=6, manager=mgr, start_step=0,
        loader_state=loader_state, on_window=on_window, drain=drain,
        log=lines.append)
    stop = 2 if drain else 6
    assert reader.steps_pushed == stop and windows.closed
    assert [s for s, _ in checkpoint.list_checkpoints(str(tmp_path))] == (
        [2] if drain else [4, 6])
    assert taken[-1] == stop and lines[-1].startswith(
        f"checkpoint: step {stop} saved under")
    assert any(line.startswith("drain: stopping at step 2")
               for line in lines) == drain
    def leaves(tree):
        return [x for x in torch.utils._pytree.tree_leaves(tree)
                if isinstance(x, torch.Tensor)]
    for at in ([2] if drain else [4, 6]):
        got = checkpoint.load_checkpoint_dir(str(tmp_path), port_state(),
                                             step=at)
        assert got.loader_state == {"cursor": at}
        assert len(leaves(got.state)) == len(leaves(states[at - 1])) > 10
        assert all(torch.equal(a, b) for a, b in
                   zip(leaves(got.state), leaves(states[at - 1])))
    assert all(torch.equal(a, b) for a, b in
               zip(leaves(state), leaves(states[stop - 1])))


# -- the trainers with --steps-per-call --------------------------------------------

LM_TINY = ["--synthetic", "--device", "cpu", "--vocab", "128", "--hidden",
           "64", "--layers", "2", "--heads", "4", "--seq-len", "33", "-b",
           "4", "--lr", "3e-3"]


def test_lm_trainer_steps_per_call_equals_single_steps(capsys):
    """``--steps-per-call 2`` prints a line per step, rounds ``--steps``
    up to whole windows, and ends in the state of single steps, bit for
    bit."""
    assert main_amp.main(LM_TINY + ["--steps", "3",
                                    "--steps-per-call", "2"]) == 0
    out = capsys.readouterr().out
    assert "--steps 3 rounded up to 4" in out
    losses = [float(ln.split()[3]) for ln in out.splitlines()
              if ln.startswith("step ")]
    assert len(losses) == 4 and losses[-1] < losses[0]
    quiet = dict(log=lambda s: None)
    two = main_amp.train(main_amp.parse(
        LM_TINY + ["--steps", "4", "--steps-per-call", "2"]), **quiet)
    one = main_amp.train(main_amp.parse(
        LM_TINY + ["--steps", "4", "--no-aot-warmup"]), **quiet)
    assert two["losses"] == one["losses"]
    for name, v in one["state"].params.items():
        assert torch.equal(two["state"].params[name], v), name
    assert two["pipeline"]["steps"] == 4


def test_imagenet_trainer_steps_per_call(capsys, tmp_path):
    """The refusal is gone: ``--steps-per-call 2`` trains, ``--prof``
    rounds up to whole windows, and ``--compilation-cache`` points the
    kernel builds at its directory."""
    from apex_tpu_torch import _build, cache
    build_dir = _build.BUILD_DIR
    triton_dir = os.environ.get("TRITON_CACHE_DIR")
    try:
        assert imagenet_main.main(
            ["--synthetic", "--device", "cpu", "--arch", "resnet18", "-b",
             "4", "--image-size", "32", "--prof", "3", "--steps-per-call",
             "2", "--compilation-cache", str(tmp_path / "kernels")]) == 0
        assert _build.BUILD_DIR == str(tmp_path / "kernels")
        assert cache.cache_dir() == str(tmp_path / "kernels")
    finally:
        _build.set_build_dir(build_dir)
        cache._STATE["dir"] = None
        if triton_dir is None:
            os.environ.pop("TRITON_CACHE_DIR", None)
        else:
            os.environ["TRITON_CACHE_DIR"] = triton_dir
    out = capsys.readouterr().out
    assert "--prof 3 rounded up to 4" in out
    assert "iter 3" in out and out.rstrip().endswith("done")
