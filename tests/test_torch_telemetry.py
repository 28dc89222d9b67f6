"""The port's telemetry recorder and its hooks, against the JAX package.

* **Same events in, same stream out.**  One event sequence built from a
  numpy seed (windows, captures, the metric reads with their loss-scale
  skips and growths, the loader, checkpoints, collectives, memory,
  serving, quant, drain, spans, a rotated segment, the summary) goes
  through JAX's ``Recorder`` and the port's on one injected clock: the
  JSONL files are equal line for line, and so are their Chrome exports
  and the rotated sets' expansion.
* **The disabled path is bitwise.**  The LM, ImageNet (ResNet-18 at 32 x
  32) and DCGAN trainers (both modes) on the CPU end in the same state
  with ``--telemetry --watchdog --metrics-textfile`` as without; the LM
  stream has one ``window`` and one ``metrics`` event a window, one
  ``retrace`` with ``first`` and no alert.
* **The piggyback.**  With a recorder the deferred reader makes one
  ``_finish_read`` a window, as without.
* **The hooks one by one:** ``PrefetchLoader`` (its stall gauge is
  ``LoaderStats``' share), ``CheckpointManager`` (snapshot, serialize
  and commit for a save, error for a failing writer), ``WeightWatcher``
  (stage and stage_error), ``GracefulShutdown`` (drain), the imperative
  loss scaler and ``FusedAdam`` (skip events, ``opt_step``),
  ``Calibration.note_saturation`` and the ``Calibrator``'s registry
  mirror (against JAX's), ``publish_conv_counters`` (JAX's names).
* **Collectives over four gloo processes** (this file run as each rank's
  worker): ``reduce_gradients`` notes one ``collective`` event whose
  bytes are the gradients' (leafwise) or the buckets' (``bucket_store``),
  ``broadcast_params`` one; a ``StepPipeline`` of a data-parallel step
  notes its collectives once, at the first window; the four per-rank
  streams read the same in JAX's and the port's ``prof.fleet``.
"""

import json
import os
import sys

import numpy as np
import torch

WORLD = 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- the ranks' side -------------------------------------------------------------

def _rank_grads(rank):
    rng = np.random.RandomState(rank)
    return {"w": torch.from_numpy(rng.randn(3, 5).astype(np.float32)),
            "b": torch.from_numpy(rng.randn(7).astype(np.float32)),
            "h": torch.from_numpy(rng.randn(6).astype(np.float32)).to(
                torch.bfloat16)}


def _worker(out_dir):
    from apex_tpu_torch import runtime, telemetry, training
    from apex_tpu_torch.multi_tensor.buckets import BucketStore
    from apex_tpu_torch.parallel import (broadcast_params, multiproc,
                                         reduce_gradients)
    torch.set_num_threads(1)
    rank, world = multiproc.initialize(device="cpu")
    assert world == WORLD
    rec = telemetry.start(os.path.join(out_dir, f"rank{rank}.jsonl"),
                          watchdog=True)
    grads = _rank_grads(rank)
    reduce_gradients(grads, "data")
    store = BucketStore(grads)
    reduce_gradients(grads, "data", bucket_store=store)
    broadcast_params(grads, "data")
    rec.event("marker", name="pipeline")

    def loss_fn(p, batch):
        x, y = batch
        return ((x @ p["w"] - y) ** 2).mean()
    init, step = training.make_train_step(
        loss_fn, training.sgd(lr=0.1), opt_level="O0", axis_name="data")
    rng = np.random.RandomState(10 + rank)
    batch = (torch.from_numpy(rng.randn(4, 5).astype(np.float32)),
             torch.from_numpy(rng.randn(4, 2).astype(np.float32)))
    state = init({"w": torch.zeros(5, 2)})
    window = tuple(t.unsqueeze(0).expand(2, *t.shape) for t in batch)
    pipe = runtime.StepPipeline(step, 2)
    state, reader = pipe.run(state, ((window, 2) for _ in range(3)),
                             on_metrics=lambda wm: wm.fetch())
    rec.close()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             bucket_bytes=sum(d.numel() * d.element_size()
                              for d in store.pack(grads).data),
             n_buckets=len(store.pack(grads).data),
             w=state.params["w"].numpy())
    multiproc.shutdown()


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    _worker(sys.argv[sys.argv.index("--out") + 1])
    sys.exit(0)

# -- the test process's side (JAX imports only here) -------------------------------

import pytest  # noqa: E402

from apex_tpu.ops import conv as jconv  # noqa: E402
from apex_tpu.prof import fleet as jfleet  # noqa: E402
from apex_tpu.prof import timeline as jtimeline  # noqa: E402
from apex_tpu.quant import calibrate as jcalibrate  # noqa: E402
from apex_tpu.telemetry import events as jevents  # noqa: E402
from apex_tpu.telemetry import metrics as jmetrics  # noqa: E402
from apex_tpu_torch import (amp, checkpoint, data, runtime,  # noqa: E402
                            telemetry, training)
from apex_tpu_torch.examples.dcgan import main_amp as dcgan  # noqa: E402
from apex_tpu_torch.examples.imagenet import \
    main_amp as imagenet  # noqa: E402
from apex_tpu_torch.examples.lm import main_amp as lm  # noqa: E402
from apex_tpu_torch.ops import conv as tconv  # noqa: E402
from apex_tpu_torch.optimizers import FusedAdam  # noqa: E402
from apex_tpu_torch.parallel import multiproc  # noqa: E402
from apex_tpu_torch.prof import fleet as tfleet  # noqa: E402
from apex_tpu_torch.prof import timeline as ttimeline  # noqa: E402
from apex_tpu_torch.quant import calibrate as tcalibrate  # noqa: E402
from apex_tpu_torch.serving.hotswap import WeightWatcher  # noqa: E402
from apex_tpu_torch.telemetry import events as tevents  # noqa: E402
from apex_tpu_torch.telemetry import metrics as tmetrics  # noqa: E402

TELEMETRY_ENV = ("APEX_TPU_TELEMETRY", "APEX_TPU_WATCHDOG",
                 "APEX_TPU_METRICS_PORT", "APEX_TPU_METRICS_TEXTFILE",
                 "APEX_TPU_TRACE_SAMPLE", "APEX_TPU_SLO")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in TELEMETRY_ENV:
        monkeypatch.delenv(k, raising=False)
    tevents.set_recorder(None)
    yield
    tevents.set_recorder(None)


class FakeTime:
    def __init__(self):
        self.n = 0

    def perf_counter(self):
        self.n += 1
        return 500.0 + 0.0007 * self.n

    def time(self):
        return 1_700_000_123.5

    def monotonic(self):
        return self.perf_counter()


def _lines(path):
    with open(path) as f:
        return f.read().splitlines()


def _synthetic_stream(mod, path, seed):
    """One seeded event sequence through ``mod``'s Recorder; returns the
    rotated set's paths as ``expand_stream_paths`` orders them."""
    rng = np.random.RandomState(seed)
    rec = mod.Recorder(path, meta={"example": "synthetic", "seed": seed},
                       run_id=f"run-{seed}", max_bytes=6000,
                       process_index=1, process_count=2)
    step, k = 0, 4
    rec.event("retrace", program="hot", step=0, n_traces=1, first=True,
              new_sig=True, sig="float32[4, 8]", dur=1.5)
    scale = 65536.0
    for w in range(12):
        rec.event("window", step=step, k=k, n_valid=k,
                  dur=round(float(rng.rand() * 1e-3), 6),
                  gap=round(float(rng.rand() * 1e-4), 6), program="hot")
        rec.metrics.histogram("window_dispatch_s").observe(
            float(rng.rand()))
        overflow = rng.rand(k) < 0.2
        scales = []
        for o in overflow:
            scale = scale / 2 if o else scale * (2 if rng.rand() < .1 else 1)
            scales.append(scale)
        values = {"loss": rng.randn(k).astype(np.float32),
                  "loss_scale": np.asarray(scales, np.float32),
                  "overflow": overflow}
        rec.observe_window_metrics(step, k, values, float(rng.rand()))
        if w == 5:          # a refetched window
            rec.observe_window_metrics(step, k, values, 0.001)
        rec.event("loader_wait", dur=round(float(rng.rand() * 1e-3), 6),
                  qdepth=int(rng.randint(3)))
        rec.event("stage", seq=w, dur=0.0005)
        step += k
    rec.note_collective("psum", ("data",), 4096, 2, dtype="float32",
                        participants=2)
    rec.note_collective("broadcast", "data", 1024, 1)
    rec.event("checkpoint", phase="snapshot", step=8, dur=0.01, bytes=10,
              shard=1)
    rec.event("memory", phase="harvest", peak_bytes=123, bytes_limit=1000,
              headroom_pct=87.7)
    rec.event("serving", phase="done", slot=0, bucket=64, n_tokens=4,
              ttft_s=0.1, tpot_s=0.01, total_s=0.2, queue_wait_s=0.0)
    rec.event("quant", phase="saturation", name="s", exceeded=1)
    with rec.span("opt_step", step=3):
        pass
    rec.run_info["x"] = "y"
    rec.event("drain", reason="signal:SIGTERM")
    rec.close(loader_stats={"loader_stall_pct": 1.5, "batches": 12})
    return mod.expand_stream_paths(path)


@pytest.mark.parametrize("seed", [0, 1])
def test_recorder_stream_matches_jax(tmp_path, monkeypatch, seed):
    monkeypatch.setattr(jevents, "time", FakeTime())
    monkeypatch.setattr(tevents, "time", FakeTime())
    os.makedirs(tmp_path / "j")
    os.makedirs(tmp_path / "t")
    jp = _synthetic_stream(jevents, str(tmp_path / "j" / "run.jsonl"), seed)
    tp = _synthetic_stream(tevents, str(tmp_path / "t" / "run.jsonl"), seed)
    assert [os.path.basename(p) for p in tp] == [os.path.basename(p)
                                                 for p in jp]
    assert len(tp) > 1                # the stream rotated
    for a, b in zip(jp, tp):
        assert _lines(b) == _lines(a)
    jev = jevents._iter_events(str(tmp_path / "j" / "run.jsonl"))
    tev = tevents._iter_events(str(tmp_path / "t" / "run.jsonl"))
    assert tev == jev
    assert tevents.chrome_events(tev, pid=3, host="h", t_offset_s=1.5) \
        == jevents.chrome_events(jev, pid=3, host="h", t_offset_s=1.5)
    n = tevents.to_chrome_trace(tev, str(tmp_path / "t.trace.json"))
    assert n == jevents.to_chrome_trace(jev, str(tmp_path / "j.trace.json"))
    assert ttimeline.analyze(tev) == jtimeline.analyze(jev)
    kinds = {e["kind"] for e in tev}
    assert {"run", "rotate", "window", "metrics", "scale", "retrace",
            "collective", "summary", "drain", "opt_step"} <= kinds


def test_start_reads_the_jax_environment(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="APEX_TPU_TELEMETRY"):
        telemetry.start()
    assert telemetry.start_from_env() is None
    monkeypatch.setenv("APEX_TPU_TELEMETRY", str(tmp_path / "e.jsonl"))
    monkeypatch.setenv("APEX_TPU_WATCHDOG", "1")
    monkeypatch.setenv("APEX_TPU_METRICS_TEXTFILE", str(tmp_path / "m.prom"))
    monkeypatch.setenv("APEX_TPU_TRACE_SAMPLE", "2")
    monkeypatch.setenv("APEX_TPU_SLO", "ttft_p99<1s")
    rec = telemetry.start_from_env(example="env")
    assert telemetry.get_recorder() is rec
    assert rec.watchdog is not None and rec.tracer.sample_n == 2
    assert rec.exporter.textfile == str(tmp_path / "m.prom")
    assert rec.slo.spec.describe() == "ttft_p99<1s"
    rec.close()
    assert telemetry.get_recorder() is None
    assert os.path.exists(tmp_path / "m.prom")
    rec.event("late", x=1)            # dropped after close, no error
    head = json.loads(_lines(tmp_path / "e.jsonl")[0])
    assert head["kind"] == "run" and head["meta"] == {"example": "env"}


# -- the trainers, with and without telemetry ----------------------------------------

LM = ["--synthetic", "--device", "cpu", "--vocab", "128", "--hidden", "64",
      "--layers", "2", "--heads", "4", "--seq-len", "33", "-b", "4",
      "--steps", "4", "--steps-per-call", "2"]


@pytest.fixture
def one_thread():
    """The bit-for-bit runs on one CPU thread: a GEMM's reduction order
    may follow the threads it gets on a loaded host, which would part two
    runs whatever the telemetry does."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flags(tmp_path, name):
    return ["--telemetry", str(tmp_path / f"{name}.jsonl"), "--watchdog",
            "--metrics-textfile", str(tmp_path / f"{name}.prom")]


def _same_tree(a, b):
    la, lb = torch.utils._pytree.tree_leaves(a), \
        torch.utils._pytree.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y


def _events(path):
    return [json.loads(x) for x in _lines(path)]


def test_lm_trainer_bitwise_with_telemetry(tmp_path, one_thread):
    plain = lm.run(LM, log=lambda *a: None)
    out = []
    rec_run = lm.run(LM + _flags(tmp_path, "lm"), log=out.append)
    _same_tree(rec_run["state"], plain["state"])
    assert rec_run["losses"] == plain["losses"]
    assert tevents.get_recorder() is None
    ev = _events(tmp_path / "lm.jsonl")
    kinds = [e["kind"] for e in ev]
    assert kinds.count("window") == kinds.count("metrics") == 2
    retr = [e for e in ev if e["kind"] == "retrace"]
    assert len(retr) == 1 and retr[0]["first"] and retr[0]["new_sig"]
    assert "alert" not in kinds and kinds[-1] == "summary"
    metrics = [e for e in ev if e["kind"] == "metrics"]
    assert [m["step"] for m in metrics] == [0, 2]
    assert all(np.isfinite(m["loss"]).all() and len(m["loss"]) == 2
               for m in metrics)
    assert out[-1] == "health: ok (0 alerts)  export textfile " + str(
        tmp_path / "lm.prom")
    with open(tmp_path / "lm.prom") as f:
        prom = f.read()
    assert "apex_tpu_steps_per_s " in prom and "apex_tpu_loss " in prom
    a = ttimeline.analyze(ev)
    assert (a["steps"], a["windows"]) == (4, 2)


def test_imagenet_trainer_bitwise_with_telemetry(tmp_path, capsys,
                                                 one_thread):
    argv = ["--synthetic", "--device", "cpu", "--arch", "resnet18", "-b",
            "4", "--image-size", "32", "--prof", "2", "--steps-per-call",
            "2"]
    plain = imagenet.run(argv)
    rec_run = imagenet.run(argv + _flags(tmp_path, "in"))
    _same_tree(rec_run["state"], plain["state"])
    out = capsys.readouterr().out
    assert "health: ok (0 alerts)  conv-sites" in out
    ev = _events(tmp_path / "in.jsonl")
    summary = ev[-1]
    assert summary["kind"] == "summary"
    assert summary["metrics"]["counters"]["conv_pallas_sites"] > 0


@pytest.mark.parametrize("mode", [[], ["--imperative"]])
def test_dcgan_trainer_bitwise_with_telemetry(tmp_path, mode, one_thread):
    argv = ["--device", "cpu", "--ngf", "8", "--ndf", "8", "--batchSize",
            "4", "--iters-per-epoch", "4", "--steps-per-call", "2"] + mode
    quiet = lambda *a: None  # noqa: E731
    plain = dcgan.run(argv, log=quiet)
    rec_run = dcgan.run(argv + _flags(tmp_path, "dc"), log=quiet)
    if mode:
        for p, q in zip(plain["nets"], rec_run["nets"]):
            _same_tree(dict(p.state_dict()), dict(q.state_dict()))
    else:
        _same_tree(rec_run["state"], plain["state"])
    assert rec_run["loss_d"] == plain["loss_d"]
    kinds = [e["kind"] for e in _events(tmp_path / "dc.jsonl")]
    if mode:
        assert kinds.count("opt_step") == 2 * 4
    else:
        assert kinds.count("window") == kinds.count("metrics") == 2


def test_reader_makes_one_read_a_window_with_a_recorder(tmp_path,
                                                        monkeypatch):
    calls = []
    real = runtime._finish_read

    def counting(read):
        calls.append(1)
        return real(read)
    monkeypatch.setattr(runtime, "_finish_read", counting)
    argv = LM[:-4] + ["--steps", "6", "--steps-per-call", "2"]
    lm.run(argv, log=lambda *a: None)
    without = len(calls)
    del calls[:]
    lm.run(argv + ["--telemetry", str(tmp_path / "r.jsonl")],
           log=lambda *a: None)
    assert len(calls) == without == 3
    metrics = [e for e in _events(tmp_path / "r.jsonl")
               if e["kind"] == "metrics"]
    assert len(metrics) == 3 and not any(m.get("refetch")
                                         for m in metrics)


def test_rank_in_the_stream_path(tmp_path, monkeypatch):
    """Under the spawner every rank gets the same arguments: ``{rank}``
    in ``--telemetry`` gives each its stream, stamped with its rank."""
    from apex_tpu_torch.examples import _telemetry as flags
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    args = lm.parse(LM + ["--telemetry", str(tmp_path / "r{rank}.jsonl")])
    assert flags.stream_path(args) == str(tmp_path / "r1.jsonl")
    rec = flags.start(args, "lm", log=lambda *a: None)
    assert rec.watchdog is not None and rec.exporter is None
    out = []
    flags.finish(rec, args, log=out.append)
    assert out == [f"telemetry: {tmp_path / 'r1.jsonl'} (python -m "
                   f"apex_tpu_torch.prof.timeline to analyze)",
                   "health: ok (0 alerts)"]
    head = _events(tmp_path / "r1.jsonl")[0]
    assert (head["process_index"], head["process_count"]) == (1, 2)
    assert flags.start(lm.parse(LM), "lm") is None


# -- the hooks one by one ---------------------------------------------------------

def test_prefetch_loader_events_and_stall_gauge(tmp_path):
    rec = telemetry.start(str(tmp_path / "l.jsonl"))
    loader = data.PrefetchLoader(iter(range(12)), device="cpu", workers=2)
    assert [int(x) for x in loader] == list(range(12))
    gauge = rec.metrics.gauge("loader_stall_pct").value
    rec.close()
    ev = _events(tmp_path / "l.jsonl")
    assert sum(e["kind"] == "loader_wait" for e in ev) == 12
    assert sorted(e["seq"] for e in ev if e["kind"] == "stage") == list(
        range(12))
    (last,) = [e for e in ev if e["kind"] == "loader"]
    assert last["phase"] == "exhausted"
    # the gauge is the share in the LoaderStats snapshot at the end
    assert last["stats"]["batches"] == 12
    assert gauge == last["stats"]["loader_stall_pct"]
    assert set(last["stats"]) == set(loader.stats.as_dict())
    hist = ev[-1]["metrics"]["histograms"]
    assert hist["loader_wait_s"]["count"] == hist["stage_s"]["count"] == 12


def test_checkpoint_manager_events(tmp_path):
    rec = telemetry.start(str(tmp_path / "c.jsonl"), watchdog=True)
    mgr = checkpoint.CheckpointManager(str(tmp_path / "ck"))
    assert mgr.run_id == rec.run_id
    state = {"w": torch.arange(6.0), "s": torch.tensor(3)}
    mgr.save(2, state)
    mgr.wait()
    assert rec.metrics.gauge("checkpoint_last_step").value == 2
    os.rename(tmp_path / "ck", tmp_path / "gone")
    open(str(tmp_path / "ck"), "w").close()    # a file where the dir was
    mgr.save(4, state)
    with pytest.raises(checkpoint.CheckpointError):
        mgr.wait()
    mgr.close()
    rec.close()
    ck = [e for e in _events(tmp_path / "c.jsonl")
          if e["kind"] == "checkpoint"]
    assert [e["phase"] for e in ck] == ["snapshot", "serialize", "commit",
                                        "snapshot", "error"]
    assert ck[0]["bytes"] == 6 * 4 + 8 and ck[0]["step"] == 2
    assert rec.metrics.counter("checkpoint_errors").value == 1
    assert rec.watchdog.health()["by_rule"] == {"checkpoint_failed": 1}


def test_weight_watcher_stage_and_stage_error(tmp_path):
    d = str(tmp_path / "w")
    like = {"w": torch.zeros(4)}
    mgr = checkpoint.CheckpointManager(d, async_write=False)
    mgr.save(1, {"w": torch.ones(4)})
    mgr.save(2, {"w": torch.ones(5)})        # loads against the wrong shape
    rec = telemetry.start(str(tmp_path / "s.jsonl"))
    bad = WeightWatcher(d, like=like)
    assert not bad.poll_once()
    good = WeightWatcher(d, like=like, initial_step=None,
                         extract=lambda r: r.state)
    mgr.save(3, {"w": torch.full((4,), 3.0)})
    assert good.poll_once()
    rec.close()
    mgr.close()
    serving = [e for e in _events(tmp_path / "s.jsonl")
               if e["kind"] == "serving"]
    assert [(e["phase"], e["step"]) for e in serving] == [
        ("stage_error", 2), ("stage", 3)]
    assert "Error" in serving[0]["error"] and serving[1]["dur"] > 0


def test_graceful_shutdown_emits_drain_once(tmp_path):
    rec = tevents.Recorder(str(tmp_path / "d.jsonl"))
    stop = runtime.GracefulShutdown(telemetry=rec)
    stop.request("preemption")
    stop.request("again")
    rec.close()
    drains = [e for e in _events(tmp_path / "d.jsonl")
              if e["kind"] == "drain"]
    assert [e["reason"] for e in drains] == ["preemption"]


def test_pipeline_capture_and_window_events_on_the_cpu(tmp_path):
    init, step = training.make_train_step(
        lambda p, b: ((b @ p["w"]) ** 2).mean(), training.sgd(lr=0.1),
        opt_level="O0")
    state = init({"w": torch.ones(3, 2)})
    rec = tevents.Recorder(str(tmp_path / "p.jsonl"))
    pipe = runtime.StepPipeline(step, 2, telemetry=rec)
    windows = [(torch.ones(2, 4, 3), 2), (torch.ones(2, 4, 3), 2),
               (torch.ones(2, 4, 3), 1), (torch.ones(2, 5, 3), 2)]
    state, _ = pipe.run(state, windows)
    assert pipe.memory_stats() is None
    rec.close()
    ev = _events(tmp_path / "p.jsonl")
    retr = [(e["program"], e["step"], e["first"], e["new_sig"])
            for e in ev if e["kind"] == "retrace"]
    assert retr == [("hot", 0, True, True), ("tail", 4, True, True),
                    ("hot", 5, False, True)]
    assert rec.metrics.counter("retraces").value == 1
    wins = [(e["step"], e["n_valid"], e["program"]) for e in ev
            if e["kind"] == "window"]
    assert wins == [(0, 2, "hot"), (2, 2, "hot"), (4, 1, "tail"),
                    (5, 2, "hot")]
    assert ttimeline.analyze(ev)["retraces"] == jtimeline.analyze(
        ev)["retraces"] == {"compiles": 2, "respecializations": 0,
                            "retraces": 1, "by_signature": [
                                "float32[2, 5, 3]"],
                            "compile_s": ttimeline.analyze(ev)[
                                "retraces"]["compile_s"]}


def test_imperative_skip_events(tmp_path):
    rec = telemetry.start(str(tmp_path / "i.jsonl"), watchdog=True)
    scaler = amp.LossScaler("dynamic")
    g = {"w": torch.tensor([float("inf")])}
    scaler.unscale(g)
    assert scaler.update_scale_sync() is True
    model = torch.nn.Linear(3, 1)
    opt = FusedAdam(model.parameters(), lr=1e-3)
    model, opt = amp.initialize(model, opt, opt_level="O2",
                                loss_scale="dynamic", verbosity=0)
    try:
        for i, factor in enumerate([1.0, float("inf"), 1.0]):
            x = torch.ones(2, 3)
            with amp.scale_loss(model(x.to(torch.bfloat16)).float().sum()
                                * factor, opt) as s:
                s.backward()
            opt.step()
            opt.zero_grad()
    finally:
        amp.shutdown()
    rec.close()
    ev = _events(tmp_path / "i.jsonl")
    skips = [(e["source"], e["step"]) for e in ev if e["kind"] == "scale"]
    assert skips == [("imperative", 0), ("optimizer", 1)]
    assert sum(e["kind"] == "opt_step" for e in ev) == 3
    assert rec.metrics.counter("loss_scale_skips").value == 2
    assert rec.watchdog.health()["ok"]   # two lone skips: no collapse


def _calibration_run(cal_mod, events_mod, metrics_mod, path):
    rec = events_mod.Recorder(path, run_id="c", process_index=0,
                              process_count=1)
    events_mod.set_recorder(rec)
    try:
        c = cal_mod.Calibrator(history=4)
        rng = np.random.RandomState(0)
        for _ in range(6):
            c.harvest({"block_0": {"qkv": {"amax": float(rng.rand())}},
                       "head": {"amax": float(rng.rand() * 3)}})
        own = metrics_mod.MetricsRegistry()
        cal_mod.Calibrator(registry=own).observe("x", 2.0)
        cal = c.freeze(99.0)
        cal.note_saturation("block_0/qkv", 5, window=16)
        cal.note_saturation("head", 0)
        cal.note_saturation("head", 7, recorder=rec)
        out = (cal.state_dict(), cal.saturations, rec.metrics.snapshot(),
               own.snapshot())
    finally:
        events_mod.set_recorder(None)
    rec.close()
    return out


def test_calibration_telemetry_matches_jax(tmp_path):
    t = _calibration_run(tcalibrate, tevents, tmetrics,
                         str(tmp_path / "t.jsonl"))
    j = _calibration_run(jcalibrate, jevents, jmetrics,
                         str(tmp_path / "j.jsonl"))
    assert t == j
    assert t[2]["counters"]["quant_saturations/head"] == 7

    def quant(p):
        return [{k: v for k, v in e.items() if k != "t"}
                for e in _events(p) if e["kind"] == "quant"]
    assert quant(tmp_path / "t.jsonl") == quant(tmp_path / "j.jsonl")


def test_publish_conv_counters_matches_jax_names(monkeypatch):
    stats = {"pallas_sites": 40, "fallback_sites": 3,
             "fallback_reasons": {"groups": 2, "small": 1}}
    regs = []
    for mod, metrics_mod in ((jconv, jmetrics), (tconv, tmetrics)):
        monkeypatch.setattr(mod, "conv_dispatch_stats", lambda: stats)
        reg = metrics_mod.MetricsRegistry()
        assert mod.publish_conv_counters(reg) == stats
        mod.publish_conv_counters(reg)   # unchanged counts: no bump
        regs.append(reg.snapshot())
    assert regs[1] == regs[0]
    assert regs[1]["counters"] == {"conv_pallas_sites": 40,
                                   "conv_fallback_sites": 3,
                                   "conv_fallback_groups": 2,
                                   "conv_fallback_small": 1}


# -- collectives over four gloo processes --------------------------------------------

@pytest.fixture(scope="module")
def rank_streams(tmp_path_factory):
    out = tmp_path_factory.mktemp("telemetry_ddp")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for k in TELEMETRY_ENV:
        env.pop(k, None)
    results = multiproc.spawn([os.path.abspath(__file__), "--out",
                               str(out)], WORLD, f"file://{out}/store",
                              timeout=120, capture=True, env=env)
    if any(r["returncode"] != 0 for r in results):
        pytest.fail("\n".join(
            f"rank {r['rank']} exited {r['returncode']}:\n{r['output']}"
            for r in results))
    return out


def test_reduce_gradients_notes_the_bucket_bytes(rank_streams):
    for r in range(WORLD):
        ev = _events(rank_streams / f"rank{r}.jsonl")
        assert ev[0]["process_index"] == r
        assert ev[0]["process_count"] == WORLD
        cut = next(i for i, e in enumerate(ev) if e["kind"] == "marker")
        coll = [e for e in ev[:cut] if e["kind"] == "collective"]
        saved = np.load(rank_streams / f"rank{r}.npz")
        leaf_bytes = (15 + 7) * 4 + 6 * 2
        assert [(e["op"], e["axis"], e["bytes"], e["n"], e["dtype"],
                 e["participants"]) for e in coll] == [
            ("psum", ["data"], leaf_bytes, 3, "mixed", WORLD),
            ("psum", ["data"], int(saved["bucket_bytes"]),
             int(saved["n_buckets"]), "mixed", WORLD),
            ("broadcast", ["data"], leaf_bytes, 3, "mixed", WORLD)]


def test_pipeline_notes_its_collectives_once(rank_streams):
    ev = _events(rank_streams / "rank0.jsonl")
    cut = next(i for i, e in enumerate(ev) if e["kind"] == "marker")
    tail = ev[cut:]
    coll = [e for e in tail if e["kind"] == "collective"]
    retr = [e for e in tail if e["kind"] == "retrace"]
    assert len(retr) == 1 and len([e for e in tail
                                   if e["kind"] == "window"]) == 3
    # the first step of the first window: the gradients (5 x 2 fp32)
    # and the loss's pmean, nothing from the later steps and windows
    assert all(tail.index(e) < tail.index(
        [w for w in tail if w["kind"] == "window"][0]) for e in coll)
    grads = [e for e in coll if e["bytes"] == 5 * 2 * 4]
    assert len(grads) == 1 and grads[0]["n"] == 1
    a = ttimeline.analyze(ev)
    assert a == jtimeline.analyze(ev)
    ws = [np.load(rank_streams / f"rank{r}.npz")["w"] for r in range(WORLD)]
    assert all(np.array_equal(ws[0], w) for w in ws)


def test_fleet_reads_the_rank_streams_as_jax_does(rank_streams):
    paths = [str(rank_streams / f"rank{r}.jsonl") for r in range(WORLD)]
    t = tfleet.analyze_fleet(tfleet.load_fleet(paths))
    j = jfleet.analyze_fleet(jfleet.load_fleet(paths))
    assert json.dumps(t, sort_keys=True) == json.dumps(j, sort_keys=True)
    assert t["n_hosts"] == WORLD and [h["host"] for h in t["hosts"]] == [
        0, 1, 2, 3]
    assert len(t["windows"]) == 3
    assert any(c["op"] == "psum" for c in t["collectives"]["by_op"])
