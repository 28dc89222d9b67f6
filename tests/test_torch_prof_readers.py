"""The port's offline readers (``prof.timeline``, ``prof.requests``,
``prof.fleet``, ``prof.regress``) against the JAX package's, both ways.

* A stream written by the port's LM trainer on the CPU (2 layers, width
  64, K 2, 4 steps) and one written by the JAX package's LM example at
  the same size each go through JAX's and the port's ``timeline``,
  ``requests``, ``fleet`` and ``regress``: their JSON outputs are equal,
  and so are the CLIs' ``--json`` prints, reports and Chrome exports.
* The same for a serving stream of the port's engine on gpt_tiny (every
  request traced, an SLO folded online).
* The fleet fixture (``synthetic_fleet``, four hosts, one slow) analyses
  the same in both; ``regress`` flags the same regressions and exits
  with the same codes (0, 1, and 2 on a future schema).
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from apex_tpu.prof import fleet as jfleet
from apex_tpu.prof import regress as jregress
from apex_tpu.prof import requests as jrequests
from apex_tpu.prof import timeline as jtimeline
from apex_tpu.telemetry import events as jevents
from apex_tpu_torch.examples.lm import main_amp as lm
from apex_tpu_torch.models import gpt_tiny
from apex_tpu_torch.prof import fleet as tfleet
from apex_tpu_torch.prof import regress as tregress
from apex_tpu_torch.prof import requests as trequests
from apex_tpu_torch.prof import timeline as ttimeline
from apex_tpu_torch.serving import ServingEngine
from apex_tpu_torch.telemetry import events as tevents

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = ["--synthetic", "--steps", "4", "--steps-per-call", "2", "--vocab",
        "256", "--hidden", "64", "--layers", "2", "--heads", "4",
        "--seq-len", "33", "-b", "4"]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("APEX_TPU_TELEMETRY", "APEX_TPU_WATCHDOG",
              "APEX_TPU_METRICS_PORT", "APEX_TPU_METRICS_TEXTFILE",
              "APEX_TPU_TRACE_SAMPLE", "APEX_TPU_SLO"):
        monkeypatch.delenv(k, raising=False)
    tevents.set_recorder(None)
    jevents.set_recorder(None)
    yield
    tevents.set_recorder(None)
    jevents.set_recorder(None)


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """``{"port_lm", "jax_lm", "port_serve"}`` stream paths."""
    d = tmp_path_factory.mktemp("streams")
    out = {"port_lm": str(d / "port_lm.jsonl"),
           "jax_lm": str(d / "jax_lm.jsonl"),
           "port_serve": str(d / "port_serve.jsonl")}
    lm.run(SIZE + ["--device", "cpu", "--telemetry", out["port_lm"],
                   "--watchdog"], log=lambda *a: None)
    # the JAX example, in this process, as its command line runs it
    spec = importlib.util.spec_from_file_location(
        "jax_lm_example", os.path.join(REPO, "examples", "lm",
                                       "main_amp.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    argv = sys.argv
    sys.argv = ["main_amp.py"] + SIZE + ["--attention", "full",
                                         "--telemetry", out["jax_lm"]]
    try:
        example.main()
    finally:
        sys.argv = argv
        jevents.set_recorder(None)
    model = gpt_tiny(dtype=torch.float32, device="cpu", seed=0)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(1, model.vocab_size, (int(n),))
               for n in rng.randint(3, 40, 6)]
    rec = tevents.start(out["port_serve"], watchdog=True, trace_sample_n=1,
                        slo="ttft_p99<60s,tpot_p99<60s")
    try:
        eng = ServingEngine(model, buckets=(32, 64), max_seqs=4,
                            device="cpu").warmup()
        eng.generate(prompts, max_new_tokens=5)
        eng.close()
    finally:
        rec.close()
    return out


def _same(a, b):
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


NAMES = ["port_lm", "jax_lm", "port_serve"]


@pytest.mark.parametrize("name", NAMES)
def test_timeline_reads_the_same(streams, name, tmp_path):
    path = streams[name]
    t = ttimeline.analyze(ttimeline.load_events(path))
    j = jtimeline.analyze(jtimeline.load_events(path))
    _same(t, j)
    assert ttimeline.format_report(t) == jtimeline.format_report(j) \
        .replace("apex_tpu.prof", "apex_tpu_torch.prof")
    if name != "port_serve":
        assert (t["steps"], t["windows"]) == (4, 2)
        assert t["retraces"]["retraces"] == 0
        assert len(t["loss_scale"]["trajectory"]) == 4
    tc, jc = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    assert ttimeline.main([path, "--chrome", tc]) == 0
    assert jtimeline.main([path, "--chrome", jc]) == 0
    with open(tc) as f, open(jc) as g:
        assert json.load(f) == json.load(g)


@pytest.mark.parametrize("name", NAMES)
def test_timeline_cli_json_prints_the_same(streams, name, capsys):
    assert ttimeline.main([streams[name], "--json"]) == 0
    t = capsys.readouterr().out
    assert jtimeline.main([streams[name], "--json"]) == 0
    assert t == capsys.readouterr().out


@pytest.mark.parametrize("slo", [None, "ttft_p99<200ms,tpot_p99<30ms"])
@pytest.mark.parametrize("name", NAMES)
def test_requests_reads_the_same(streams, name, slo):
    ev = trequests.load_request_events([streams[name]])
    assert ev == jrequests.load_request_events([streams[name]])
    t, j = trequests.analyze(ev, slo=slo), jrequests.analyze(ev, slo=slo)
    _same(t, j)
    if name == "port_serve":
        assert t["requests"]["n_requests"] == 6 and t["n_sampled"] == 6
        assert (trequests.format_report(t)
                == jrequests.format_report(j))
    else:
        assert t["requests"] is None


def test_requests_chrome_lanes_match(streams, tmp_path):
    ev = trequests.load_request_events([streams["port_serve"]])
    n = trequests.to_request_chrome_trace(ev, str(tmp_path / "t.json"))
    assert n == jrequests.to_request_chrome_trace(ev,
                                                  str(tmp_path / "j.json"))
    with open(tmp_path / "t.json") as f, open(tmp_path / "j.json") as g:
        assert json.load(f) == json.load(g)


def test_fleet_reads_the_same(streams, tmp_path):
    paths = [streams["port_lm"], streams["jax_lm"]]
    t = tfleet.analyze_fleet(tfleet.load_fleet(paths))
    j = jfleet.analyze_fleet(jfleet.load_fleet(paths))
    _same(t, j)
    assert t["n_hosts"] == 2
    merged = trequests.load_request_events(paths)
    assert merged == jrequests.load_request_events(paths)
    assert (tfleet.to_fleet_chrome_trace(tfleet.load_fleet(paths),
                                         str(tmp_path / "t.json"))
            == jfleet.to_fleet_chrome_trace(jfleet.load_fleet(paths),
                                            str(tmp_path / "j.json")))


@pytest.mark.parametrize("kw", [{}, dict(slow_host=0, slow_factor=2.5),
                                dict(n_hosts=3, stall_host=1, seed=4)])
def test_fleet_fixture_analyses_the_same(tmp_path, kw):
    os.makedirs(tmp_path / "t")
    os.makedirs(tmp_path / "j")
    assert (tfleet.synthetic_fleet(**kw)
            == jfleet.synthetic_fleet(**kw))
    tp = tfleet.synthetic_fleet(dir=str(tmp_path / "t"), **kw)
    jp = jfleet.synthetic_fleet(dir=str(tmp_path / "j"), **kw)
    t = tfleet.analyze_fleet(tfleet.load_fleet(tp))
    j = jfleet.analyze_fleet(jfleet.load_fleet(jp))
    for x in (t, j):
        for h in x["hosts"]:
            h.pop("path")
    _same(t, j)
    assert t["straggler"]["consistent"]
    assert t["straggler"]["host"] == kw.get("slow_host", 2)
    assert tfleet.format_report(t) == jfleet.format_report(j)


def _summary(streams, name):
    return ttimeline.analyze(ttimeline.load_events(streams[name]))


@pytest.mark.parametrize("tol", [[], ["--tol", "steps_per_s=1"],
                                 ["--tol-default", "0.1"]])
def test_regress_flags_the_same(streams, tmp_path, capsys, tol):
    base = _summary(streams, "port_lm")
    cur = json.loads(json.dumps(base))
    cur["steps_per_s"] = base["steps_per_s"] * 0.5
    cur["step_time"]["p50_ms"] = base["step_time"]["p50_ms"] * 3
    cur["retraces"]["retraces"] = 2
    t = tregress.diff_summaries(base, cur)
    assert t == jregress.diff_summaries(base, cur)
    assert {r["metric"] for r in t["regressions"]} >= {
        "steps_per_s", "step_time.p50_ms", "retraces.retraces"}
    paths = []
    for name, obj in (("b", base), ("c", cur), ("same", base)):
        paths.append(str(tmp_path / f"{name}.json"))
        with open(paths[-1], "w") as f:
            json.dump(obj, f)
    for args, code in (([paths[0], paths[1]], 1),
                       ([paths[0], paths[2]], 0)):
        assert tregress.main(args + tol + ["--json"]) == code
        out = capsys.readouterr().out
        assert jregress.main(args + tol + ["--json"]) == code
        assert out == capsys.readouterr().out


def test_regress_and_timeline_refuse_a_future_schema(tmp_path, capsys):
    future = str(tmp_path / "f.json")
    with open(future, "w") as f:
        json.dump({"schema_version": "9.0", "steps_per_s": 1.0}, f)
    assert tregress.main([future, future]) == jregress.main(
        [future, future]) == 2
    for mod in (ttimeline, jtimeline):
        with pytest.raises(ValueError, match="FUTURE"):
            mod.check_schema_version({"schema_version": "2.0"})
        mod.check_schema_version({"schema_version": "1.9"})
    assert ttimeline.SCHEMA_VERSION == jtimeline.SCHEMA_VERSION


def test_rotated_set_reads_as_one_stream(tmp_path):
    path = str(tmp_path / "rot.jsonl")
    rec = tevents.Recorder(path, max_bytes=400)
    for i in range(40):
        rec.event("window", step=2 * i, k=2, n_valid=2, dur=0.001,
                  gap=0.0)
    rec.close()
    segs = tevents.expand_stream_paths(path)
    assert len(segs) > 2 and segs == jevents.expand_stream_paths(path)
    assert tevents.expand_stream_paths(str(tmp_path / "rot.jsonl.*")) \
        == jevents.expand_stream_paths(str(tmp_path / "rot.jsonl.*"))
    a = ttimeline.analyze(ttimeline.load_events(path + ".1"))
    _same(a, jtimeline.analyze(jtimeline.load_events(path + ".1")))
    assert a["steps"] == 80
