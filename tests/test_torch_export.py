"""The port's Prometheus export and metrics registry against the JAX
package's.

* ``render``: one registry populated the same way in both packages
  (counters, gauges, reservoir histograms with and without their fixed
  latency buckets, run-info labels that need escaping, the watchdog's
  health) renders to the same text, byte for byte;
* the registry: counters, high-water gauges, histogram snapshots and
  the crc32-seeded reservoir's percentiles equal JAX's over more samples
  than the reservoir holds; ``sanitize_name`` and the value literals;
* the exporter: the textfile replaced atomically at its interval, the
  ``GET /metrics`` endpoint on a free localhost port (404 elsewhere),
  ``close`` rendering once more and stopping the server;
* the device-memory gauges read nothing on the CPU.
"""

import os
import urllib.error
import urllib.request

import numpy as np
import pytest

from apex_tpu.telemetry import events as jevents
from apex_tpu.telemetry import export as jexport
from apex_tpu.telemetry import metrics as jmetrics
from apex_tpu.telemetry import watchdog as jwdog
from apex_tpu_torch.prof import memory as tmemory
from apex_tpu_torch.telemetry import events as tevents
from apex_tpu_torch.telemetry import export as texport
from apex_tpu_torch.telemetry import metrics as tmetrics
from apex_tpu_torch.telemetry import watchdog as twdog


@pytest.fixture(autouse=True)
def _no_recorder():
    tevents.set_recorder(None)
    yield
    tevents.set_recorder(None)


def _populate(events_mod, wd_mod, path, seed=0):
    rec = events_mod.Recorder(path, run_id="run-1", process_index=1,
                              process_count=4)
    wd_mod.attach(rec)
    rng = np.random.RandomState(seed)
    m = rec.metrics
    m.counter("steps_dispatched").inc(17)
    m.counter("loss_scale_skips").inc()
    m.counter("quant_saturations/block_0/qkv").inc(3)
    m.gauge("loss").set(2.5)
    m.gauge("loss_scale").set(65536.0)
    m.gauge("nan_gauge").set(float("nan"))
    m.gauge("inf_gauge").set(float("inf"))
    m.gauge("peak_hbm_bytes").set_max(1e9)
    m.gauge("peak_hbm_bytes").set_max(5e8)
    for x in rng.exponential(0.02, 700):
        m.histogram("window_dispatch_s").observe(float(x))
    for x in rng.randn(50):
        m.histogram("quant_amax/block_0").observe(float(x))
    rec.run_info["kv_cache_dtype"] = 'int8 "q"\\n'
    rec.event("alert", rule="x", severity="warning")
    wd = rec.watchdog
    wd.observe({"kind": "checkpoint", "phase": "error", "step": 3,
                "error": "e"})
    return rec


def test_render_matches_jax_byte_for_byte(tmp_path):
    j = _populate(jevents, jwdog, str(tmp_path / "j.jsonl"))
    t = _populate(tevents, twdog, str(tmp_path / "t.jsonl"))
    text = texport.render(t)
    assert text == jexport.render(j)
    assert 'apex_tpu_run_info{kv_cache_dtype="int8 \\"q\\"\\\\n"' in text
    assert "apex_tpu_window_dispatch_s_hist_bucket{le=\"+Inf\"} 700" in text
    assert "apex_tpu_nan_gauge NaN" in text and "+Inf" in text
    assert "apex_tpu_watchdog_ok 0" in text
    j.close()
    t.close()


@pytest.mark.parametrize("name", ["loss", "9lives", "quant_amax/block_0",
                                  "a-b.c:d", "serving_ttft_s"])
def test_sanitize_name_matches_jax(name):
    assert texport.sanitize_name(name) == jexport.sanitize_name(name)


@pytest.mark.parametrize("value", [None, 0, 3, 2.5, -1e20, 1e15,
                                   float("nan"), float("inf"),
                                   float("-inf")])
def test_value_literals_match_jax(value):
    assert texport._num(value) == jexport._num(value)


@pytest.mark.parametrize("name,n", [("serving_ttft_s", 100),
                                    ("window_gap_s", 2000),
                                    ("quant_amax/x", 513),
                                    ("loss_values", 5000)])
def test_histogram_reservoir_matches_jax(name, n):
    """crc32-seeded reservoirs: the same samples give the same
    percentiles and snapshot, past the reservoir's 512."""
    rng = np.random.RandomState(n)
    jr, tr = jmetrics.MetricsRegistry(), tmetrics.MetricsRegistry()
    for x in rng.lognormal(-4, 1, n):
        jr.histogram(name).observe(float(x))
        tr.histogram(name).observe(float(x))
    assert tr.snapshot() == jr.snapshot()
    qs = (1.0, 50.0, 90.0, 99.0, 99.9)
    assert (tr.histogram(name).percentiles(qs)
            == jr.histogram(name).percentiles(qs))


def test_disabled_registry_and_rolling_match_jax():
    reg = tmetrics.MetricsRegistry(enabled=False)
    reg.counter("a").inc()
    reg.gauge("b").set(1)
    reg.histogram("c").observe(1)
    assert reg.snapshot() == {"counters": {}, "gauges": {},
                              "histograms": {}}
    jr, tr = jmetrics.Rolling(8), tmetrics.Rolling(8)
    for x in np.random.RandomState(0).rand(21):
        jr.observe(x)
        tr.observe(x)
    assert (tr.median(), tr.mean, tr.total, tr.full) == (
        jr.median(), jr.mean, jr.total, jr.full)
    samples = list(np.random.RandomState(1).rand(33))
    assert (tmetrics.nearest_rank_percentiles(samples, (5, 50, 95))
            == jmetrics.nearest_rank_percentiles(samples, (5, 50, 95)))
    assert tmetrics.nearest_rank_percentiles([]) == [None, None, None]


def test_textfile_interval_and_atomic_replace(tmp_path):
    rec = tevents.Recorder(str(tmp_path / "r.jsonl"))
    prom = str(tmp_path / "m.prom")
    exp = texport.attach_exporter(rec, textfile=prom, every_s=60.0)
    assert exp.tick(now=1e6) and exp.renders == 1
    assert not exp.tick(now=1e6 + 1.0) and exp.renders == 1
    rec.metrics.gauge("steps_per_s").set(12.5)
    assert exp.tick(now=1e6 + 61.0) and exp.renders == 2
    with open(prom) as f:
        text = f.read()
    assert "apex_tpu_steps_per_s 12.5" in text
    assert not os.path.exists(prom + ".tmp")
    assert exp.describe() == f"textfile {prom}"
    rec.metrics.counter("late").inc()
    rec.close()                       # the last render
    with open(prom) as f:
        assert "apex_tpu_late_total 1" in f.read()


def test_http_endpoint_on_a_free_port(tmp_path):
    rec = tevents.start(str(tmp_path / "r.jsonl"), export_port=0,
                        watchdog=True)
    exp = rec.exporter
    assert exp.port and exp.describe() == (
        f"http://localhost:{exp.port}/metrics")
    rec.metrics.gauge("serving_tokens_per_s").set(123.0)
    url = f"http://127.0.0.1:{exp.port}"
    with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
        body = r.read().decode()
        assert r.headers["Content-Type"].startswith("text/plain")
    assert body == texport.render(rec)
    assert "apex_tpu_serving_tokens_per_s 123" in body
    assert "apex_tpu_watchdog_ok 1" in body
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(url + "/other", timeout=10)
    assert err.value.code == 404
    rec.close()
    with pytest.raises(OSError):
        urllib.request.urlopen(url + "/metrics", timeout=2)


def test_unwritable_textfile_disables_itself(tmp_path, capsys):
    rec = tevents.Recorder(str(tmp_path / "r.jsonl"))
    exp = texport.attach_exporter(
        rec, textfile=str(tmp_path / "missing" / "m.prom"), every_s=0.05)
    assert not exp.tick(now=1e9)
    assert exp.textfile is None and "disabling" in capsys.readouterr().err
    rec.event("still", ok=True)       # the event path survives
    rec.close()


def test_device_memory_reads_nothing_on_the_cpu(tmp_path):
    rec = tevents.Recorder(str(tmp_path / "r.jsonl"))
    assert tmemory.device_memory() == []
    assert tmemory.update_device_memory_gauges(rec) is False
    ev = tmemory.record_memory(rec, {"peak_bytes": 80, "source": "x"},
                               limit_bytes=100)
    assert ev == {"phase": "harvest", "peak_bytes": 80, "source": "x",
                  "bytes_limit": 100, "headroom_pct": 20.0}
    tmemory.record_memory(rec, {"peak_bytes": 10}, limit_bytes=100)
    assert rec.metrics.gauge("peak_hbm_bytes").value == 80
    assert tmemory.record_memory(None, {"peak_bytes": 1}) is None
    rec.close()
