"""The port's request tracing and SLO engine against the JAX package's,
and the serving engine's span trees on the CPU.

* ``Tracer``: the same sampling sequence gives the same trace and span
  ids, and the same ``span`` lines in the stream (both recorders and
  both tracers on one injected clock, so the JSONL is byte for byte);
* the SLO engine: specs parse to the same objectives (bad ones raise in
  both), a seeded stream of ``done`` events folds into the same ``slo``
  events, gauges and verdict, and ``evaluate`` agrees;
* the port's engine with a recorder and ``trace_sample_n=1`` on
  gpt_tiny: one ``done`` event and one complete span tree per request
  (a ``request`` root; ``queue``, ``prefill`` and one ``decode_step``
  per decode step the request was in), TTFT and TPOT from the stream
  equal to each ``ServedResult.timings``, the tokens equal to a run
  without a recorder.
"""

import json

import numpy as np
import pytest
import torch

from apex_tpu.telemetry import events as jevents
from apex_tpu.telemetry import slo as jslo
from apex_tpu.telemetry import tracing as jtracing
from apex_tpu_torch.models import gpt_tiny
from apex_tpu_torch.prof import requests as trequests
from apex_tpu_torch.serving import ServingEngine
from apex_tpu_torch.telemetry import events as tevents
from apex_tpu_torch.telemetry import slo as tslo
from apex_tpu_torch.telemetry import tracing as ttracing


class FakeTime:
    """An injected clock: every ``perf_counter`` read advances 1.25 ms."""

    def __init__(self):
        self.n = 0

    def perf_counter(self):
        self.n += 1
        return 1000.0 + 0.00125 * self.n

    def time(self):
        return 1_700_000_000.0

    def monotonic(self):
        return self.perf_counter()


@pytest.fixture
def clocks(monkeypatch):
    for mod in (jevents, tevents, jtracing, ttracing):
        monkeypatch.setattr(mod, "time", FakeTime())
    tevents.set_recorder(None)
    yield
    tevents.set_recorder(None)


def _lines(path):
    with open(path) as f:
        return f.read().splitlines()


def _trace_run(events_mod, tracing_mod, path, sample_n):
    rec = events_mod.Recorder(path, run_id="r", process_index=2,
                              process_count=4)
    tr = tracing_mod.attach(rec, sample_n=sample_n)
    ids = []
    for i in range(12):
        trace = tr.sample()
        root = tr.next_span_id() if trace is not None else None
        ids.append((trace, root))
        with tr.span("prefill", trace, parent=root, slot=i % 3) as sid:
            ids.append(sid)
        tr.emit("decode_step", trace, parent=root, dur=0.004 * i,
                batch_size=i)
        tr.emit("request", trace, span=root, dur=0.1 + i, n_tokens=i)
    rec.close()
    return ids


@pytest.mark.parametrize("sample_n", [0, 1, 2, 5])
def test_tracer_matches_jax(tmp_path, clocks, sample_n):
    j = _trace_run(jevents, jtracing, str(tmp_path / "j.jsonl"), sample_n)
    t = _trace_run(tevents, ttracing, str(tmp_path / "t.jsonl"), sample_n)
    assert t == j
    assert _lines(tmp_path / "t.jsonl") == _lines(tmp_path / "j.jsonl")
    traced = [x for x in t if isinstance(x, tuple) and x[0] is not None]
    assert len(traced) == (0 if sample_n == 0 else -(-12 // sample_n))
    if traced:
        assert traced[0] == ("t2-000000", "s000000")


@pytest.mark.parametrize("raw,want", [("", 0), ("3", 3), ("-2", 0),
                                      ("x", 0)])
def test_sample_n_from_env_matches_jax(monkeypatch, raw, want):
    monkeypatch.setenv("APEX_TPU_TRACE_SAMPLE", raw)
    assert ttracing.sample_n_from_env() == jtracing.sample_n_from_env() \
        == want


SPECS = ["ttft_p99<200ms,tpot_p99<30ms", "e2e_p90 <= 2s",
         "queue_wait<500us", "ttft_p99.9<0.2s, tpot<25ms", " tpot_p50<1"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_slo_matches_jax(spec):
    j, t = jslo.parse_slo(spec), tslo.parse_slo(spec)
    assert tuple(t.objectives) == tuple(j.objectives)
    assert (t.target_pct, t.budget(), t.describe()) == (
        j.target_pct, j.budget(), j.describe())


@pytest.mark.parametrize("spec", ["", "latency_p99<1s", "ttft_p0<1s",
                                  "ttft>1s", "ttft<1h"])
def test_bad_slo_specs_raise_in_both(spec):
    with pytest.raises(ValueError):
        jslo.parse_slo(spec)
    with pytest.raises(ValueError):
        tslo.parse_slo(spec)


def _dones(seed, n=200):
    rng = np.random.RandomState(seed)
    t, out = 0.0, []
    for i in range(n):
        t += float(rng.exponential(2.0))
        ttft = float(rng.lognormal(np.log(0.12), 0.6))
        tpot = (None if rng.rand() < 0.1
                else float(rng.lognormal(np.log(0.02), 0.5)))
        out.append({"kind": "serving", "phase": "done", "t": round(t, 6),
                    "ttft_s": ttft, "tpot_s": tpot, "total_s": ttft + 1.0,
                    "queue_wait_s": float(rng.rand() * 0.1)})
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_slo_engine_matches_jax(tmp_path, clocks, seed):
    spec = "ttft_p99<200ms,tpot_p99<30ms"
    outs = []
    for events_mod, slo_mod, name in ((jevents, jslo, "j"),
                                      (tevents, tslo, "t")):
        rec = events_mod.Recorder(str(tmp_path / f"{name}.jsonl"),
                                  run_id="r", process_index=0,
                                  process_count=1)
        eng = slo_mod.attach(rec, spec)
        for e in _dones(seed):
            eng.observe(e)
        outs.append((eng.last, eng.total, eng.bad_total,
                     eng.format_line(), rec.metrics.snapshot()["gauges"]))
        rec.close()
    assert outs[1] == outs[0]
    assert (_lines(tmp_path / "t.jsonl") == _lines(tmp_path / "j.jsonl"))
    reqs = _dones(seed)
    assert tslo.evaluate(spec, reqs) == jslo.evaluate(spec, reqs)


def test_slo_reaches_the_watchdog_through_the_recorder(tmp_path):
    rec = tevents.start(str(tmp_path / "s.jsonl"), watchdog=True,
                        slo="ttft_p99<1ms")
    for e in _dones(3, 40):
        rec.event("serving", **{k: v for k, v in e.items()
                                if k not in ("kind", "t")})
    rules = rec.watchdog.health()["by_rule"]
    assert rules.get("slo_exhausted") == 1 and rules.get("slo_burn") == 1
    assert rec.metrics.gauge("slo_goodput_pct").value == 0.0
    rec.close()
    summary = json.loads(_lines(tmp_path / "s.jsonl")[-1])
    assert summary["kind"] == "summary" and summary["slo"]["exhausted"]


def test_serving_cli_flags(tmp_path, capsys, monkeypatch):
    """``python -m apex_tpu_torch.serving --telemetry --trace-sample
    --slo`` records every request's tree and prints the verdicts."""
    from apex_tpu_torch.serving import __main__ as cli
    monkeypatch.delenv("APEX_TPU_TELEMETRY", raising=False)
    path = str(tmp_path / "cli.jsonl")
    cli.main(["--model", "gpt_tiny", "--dtype", "float32", "--buckets",
              "64,128", "--requests", "3", "--max-new", "4", "--device",
              "cpu", "--telemetry", path, "--trace-sample", "1", "--slo",
              "ttft_p99<60s"])
    out = capsys.readouterr().out
    assert "slo: ttft_p99<60s: goodput 100.0%" in out
    assert "health: ok (0 alerts)" in out
    assert f"prof.requests {path} --slo 'ttft_p99<60s'" in out
    a = trequests.analyze(trequests.load_request_events([path]))
    assert a["requests"]["n_requests"] == a["n_sampled"] == 3


# -- the engine's span trees ------------------------------------------------------

def _engine_run(model, prompts, rec=None):
    tevents.set_recorder(rec)
    try:
        eng = ServingEngine(model, buckets=(32, 64), max_seqs=3,
                            device="cpu").warmup()
        res = eng.generate(prompts, max_new_tokens=6)
        steps = eng.stats["decode_steps"]
        eng.close()
    finally:
        tevents.set_recorder(None)
    return res, steps


def test_engine_spans_and_dones_on_the_cpu(tmp_path):
    n = torch.get_num_threads()
    torch.set_num_threads(1)      # the tokens bit for bit: one GEMM order
    try:
        _engine_spans_and_dones(tmp_path)
    finally:
        torch.set_num_threads(n)


def _engine_spans_and_dones(tmp_path):
    model = gpt_tiny(dtype=torch.float32, device="cpu", seed=0)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, model.vocab_size, (int(n),))
               for n in rng.randint(3, 30, 7)]
    plain, _ = _engine_run(model, prompts)
    path = str(tmp_path / "serve.jsonl")
    rec = tevents.start(path, trace_sample_n=1, watchdog=True,
                        slo="ttft_p99<60s,tpot_p99<60s")
    traced, steps = _engine_run(model, prompts, rec)
    rec.close()
    for a, b in zip(plain, traced):
        assert np.array_equal(a.tokens, b.tokens)
    events = [json.loads(x) for x in _lines(path)]
    dones = [e for e in events
             if e["kind"] == "serving" and e["phase"] == "done"]
    assert len(dones) == len(prompts)
    decodes = [e for e in events
               if e["kind"] == "serving" and e["phase"] == "decode"]
    assert len(decodes) == steps
    falls = {w["trace"]: w for w in trequests.build_waterfalls(events)}
    assert len(falls) == len(prompts)
    for d in dones:
        w = falls[d["trace"]]
        names = [s["name"] for s in w["spans"]]
        root = [s for s in w["spans"] if s["name"] == "request"]
        assert len(root) == 1 and root[0]["parent"] is None
        assert all(s["parent"] == root[0]["span"] for s in w["spans"]
                   if s["name"] != "request")
        assert names.count("queue") == names.count("prefill") == 1
        # every decode step after the prefill's token, until the last
        assert w["decode_steps"] == d["n_tokens"] - 1
    # TTFT and TPOT per request, from the stream, are the results'
    by_slot = sorted(dones, key=lambda e: e["t"])
    got = sorted((e["ttft_s"], e["tpot_s"]) for e in by_slot)
    want = sorted((r.timings["ttft_s"], r.timings["tpot_s"])
                  for r in traced)
    assert got == want
    a = trequests.analyze(events, slo="ttft_p99<60s")
    assert a["requests"]["n_requests"] == len(prompts)
    assert a["slo"]["met"] and a["n_sampled"] == len(prompts)
    assert a["slo_online"]["goodput_pct"] == 100.0
    retraces = [e for e in events if e["kind"] == "retrace"]
    assert retraces == []             # the CPU captures nothing
