"""Live metrics export: Prometheus text exposition of a running stream
— counterpart of ``apex_tpu/telemetry/export.py``.

* :func:`render` turns the recorder's registry snapshot and the
  watchdog's health into Prometheus text exposition (counters, gauges,
  histogram summaries and fixed-bound ``_hist`` families), the JAX
  package's text line for line, ``apex_tpu_`` names included, so one
  dashboard reads both;
* :class:`PrometheusExporter` renders on the threads that already emit
  events (the recorder calls :meth:`~PrometheusExporter.tick` after each
  line; a render happens once ``every_s`` has elapsed) into an
  atomically renamed textfile, and serves ``GET /metrics`` from a stdlib
  ``ThreadingHTTPServer`` (bound to loopback by default) that renders
  fresh per scrape;
* the device-memory gauges (``hbm_bytes_in_use``, ``hbm_bytes_limit``,
  ``hbm_headroom_pct``, ``hbm_peak_bytes_in_use``) come from the CUDA
  allocator at each render (:func:`apex_tpu_torch.prof.memory.
  update_device_memory_gauges`), a host read with no synchronization.

Usage::

    rec = telemetry.start("run.jsonl", export_port=9100,
                          export_textfile="metrics.prom")
    print(rec.exporter.describe())      # scrape URL + textfile path
"""

from __future__ import annotations

import os
import re
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = ["PrometheusExporter", "attach_exporter", "render",
           "sanitize_name"]

#: metric-name prefix; every exported family is ``apex_tpu_<name>``.
NAMESPACE = "apex_tpu"

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize_name(name: str) -> str:
    """Registry instrument name -> legal Prometheus metric name."""
    name = _NAME_RE.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _label_value(v) -> str:
    """Escape a label VALUE per the exposition format (backslash, double
    quote, newline) — run_info values are free-form caller strings and
    one bad character would invalidate the whole scrape."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _line(name: str, value, labels: Optional[Dict[str, str]] = None) -> str:
    if labels:
        lab = ",".join(f'{k}="{_label_value(v)}"'
                       for k, v in sorted(labels.items()))
        return f"{name}{{{lab}}} {_num(value)}"
    return f"{name} {_num(value)}"


def _num(v) -> str:
    if v is None:
        return "NaN"
    f = float(v)
    # non-finite values are legal Prometheus literals — a NaN loss
    # gauge (one overflow-skipped window) must render, not crash the
    # textfile into self-disable (found by the verify probe)
    if f != f:
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def render(recorder) -> str:
    """Render one recorder's registry + watchdog health as Prometheus
    text exposition (``text/plain; version=0.0.4``).

    Counters become ``<ns>_<name>_total`` counters, gauges plain
    gauges, histograms a summary-style family (``_count``/``_sum`` plus
    ``{quantile=...}`` gauges from the deterministic reservoir).  Run
    identity rides an ``<ns>_run_info`` gauge labelled with ``run_id``
    and the host's ``process_index``/``process_count`` so a fleet
    scrape can aggregate per host; watchdog health exports as
    ``<ns>_watchdog_ok`` plus per-rule ``<ns>_watchdog_alerts_total``.
    """
    snap = recorder.metrics.snapshot()
    lines: List[str] = []
    info_labels = {"run_id": recorder.run_id,
                   "process_index": str(recorder.process_index),
                   "process_count": str(recorder.process_count)}
    # free-form identity labels (e.g. the serving kv_cache_dtype)
    for k, v in sorted((getattr(recorder, "run_info", None) or {}).items()):
        info_labels.setdefault(sanitize_name(str(k)), str(v))
    lines.append(f"# TYPE {NAMESPACE}_run_info gauge")
    lines.append(_line(f"{NAMESPACE}_run_info", 1, info_labels))
    for name, value in sorted((snap.get("counters") or {}).items()):
        metric = f"{NAMESPACE}_{sanitize_name(name)}_total"
        lines.append(f"# TYPE {metric} counter")
        lines.append(_line(metric, value))
    for name, value in sorted((snap.get("gauges") or {}).items()):
        metric = f"{NAMESPACE}_{sanitize_name(name)}"
        lines.append(f"# TYPE {metric} gauge")
        lines.append(_line(metric, value))
    for name, h in sorted((snap.get("histograms") or {}).items()):
        if not isinstance(h, dict):
            continue
        metric = f"{NAMESPACE}_{sanitize_name(name)}"
        lines.append(f"# TYPE {metric} summary")
        for q, key in (("0.5", "p50"), ("0.9", "p90"), ("0.99", "p99")):
            if h.get(key) is not None:
                lines.append(_line(metric, h[key], {"quantile": q}))
        lines.append(_line(f"{metric}_sum", h.get("sum", 0.0)))
        lines.append(_line(f"{metric}_count", h.get("count", 0)))
        # true cumulative histogram: exact
        # fixed-bound bucket counts as a SEPARATE `_hist` family —
        # Prometheus forbids mixing summary and histogram series under
        # one name, and the summary family above is the stable surface
        # existing dashboards scrape.  `rate()`/`histogram_quantile()`
        # work on this one.
        buckets = h.get("buckets")
        if isinstance(buckets, dict) and buckets.get("le"):
            hist = f"{metric}_hist"
            lines.append(f"# TYPE {hist} histogram")
            for le, c in zip(buckets["le"], buckets.get("counts") or []):
                lines.append(_line(f"{hist}_bucket", c, {"le": _num(le)}))
            lines.append(_line(f"{hist}_bucket", h.get("count", 0),
                               {"le": "+Inf"}))
            lines.append(_line(f"{hist}_sum", h.get("sum", 0.0)))
            lines.append(_line(f"{hist}_count", h.get("count", 0)))
    wd = recorder.watchdog
    if wd is not None:
        health = wd.health()
        lines.append(f"# TYPE {NAMESPACE}_watchdog_ok gauge")
        lines.append(_line(f"{NAMESPACE}_watchdog_ok",
                           1 if health.get("ok") else 0))
        metric = f"{NAMESPACE}_watchdog_alerts_total"
        lines.append(f"# TYPE {metric} counter")
        lines.append(_line(metric, health.get("alerts", 0)))
        for rule, n in sorted((health.get("by_rule") or {}).items()):
            lines.append(_line(f"{NAMESPACE}_watchdog_rule_alerts_total",
                               n, {"rule": sanitize_name(rule)}))
    return "\n".join(lines) + "\n"


class PrometheusExporter:
    """Periodic Prometheus renderer riding the recorder's event flow.

    ``tick()`` — called by :meth:`Recorder.event` after every written
    line, on the emitting thread — is one clock read and a compare
    until ``every_s`` elapses, then one render + one atomic textfile
    replace (``os.replace`` of a ``.tmp`` sibling, the node-exporter
    textfile-collector contract).  The optional HTTP endpoint
    (``port=0`` binds an ephemeral port, read it back from ``.port``)
    renders fresh on each ``GET /metrics``, entirely on the server
    thread — an idle training loop still scrapes current numbers.
    """

    def __init__(self, recorder, *, textfile: Optional[str] = None,
                 port: Optional[int] = None, every_s: float = 5.0,
                 bind: str = "127.0.0.1"):
        self._rec = recorder
        self.textfile = textfile
        #: endpoint bind address — loopback by DEFAULT: the exposition
        #: carries run identity and health with no auth, so reaching it
        #: from off-host is an explicit choice (``bind="0.0.0.0"``),
        #: not a surprise.
        self.bind = bind
        self.every_s = max(0.05, float(every_s))
        self._render_lock = threading.Lock()   # interval gate (tick)
        self._write_lock = threading.Lock()    # serializes .tmp writes
        self._last_render = 0.0
        self.renders = 0          # textfile render count
        self._httpd = None
        self._http_thread = None
        self.port: Optional[int] = None
        if port is not None:
            self._start_http(int(port))

    # -- render paths -------------------------------------------------------
    def render(self) -> str:
        """Fresh exposition text (also refreshes device-memory gauges
        when the backend exposes them — a host API read, no device
        sync)."""
        self._update_device_memory()
        return render(self._rec)

    def _update_device_memory(self) -> None:
        try:
            from ..prof import memory as _memory
            _memory.update_device_memory_gauges(self._rec)
        except Exception:
            pass

    def tick(self, now: Optional[float] = None) -> bool:
        """Maybe render (interval elapsed) — returns True when a
        textfile write actually happened.  Never raises into the
        recorder's event path: an unwritable textfile disables itself
        loudly once rather than poisoning every subsequent event."""
        if self.textfile is None:
            return False
        now = time.monotonic() if now is None else now
        if now - self._last_render < self.every_s:
            return False
        with self._render_lock:
            if now - self._last_render < self.every_s:
                return False
            self._last_render = now
        try:
            self.write_textfile()
            return True
        except Exception as e:
            import sys
            print(f"telemetry.export: textfile write failed "
                  f"({type(e).__name__}: {e}) — disabling the textfile "
                  f"exporter", file=sys.stderr)
            self.textfile = None
            return False

    def write_textfile(self) -> str:
        """Render now and atomically replace the textfile (write a
        ``.tmp`` sibling, fsync-free ``os.replace``).  Returns the
        path.  Serialized under its own lock: two emitting threads (or
        a tick racing ``close()``) must never interleave writes into
        the same ``.tmp`` — the scraper's never-torn contract holds all
        the way through shutdown."""
        target = self.textfile
        if target is None:
            raise ValueError("textfile exporter is disabled")
        text = self.render()
        with self._write_lock:
            tmp = f"{target}.tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                f.write(text)
            os.replace(tmp, target)
            self.renders += 1
        return target

    # -- http endpoint ------------------------------------------------------
    def _start_http(self, port: int) -> None:
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        exporter = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):              # noqa: N802 (stdlib API name)
                if self.path.rstrip("/") not in ("", "/metrics"):
                    self.send_error(404)
                    return
                body = exporter.render().encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4; "
                                 "charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):     # scrapes must not spam stderr
                pass

        self._httpd = ThreadingHTTPServer((self.bind, port), _Handler)
        self.port = int(self._httpd.server_address[1])
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="apex-tpu-torch-metrics-http")
        self._http_thread.start()

    # -- lifecycle ----------------------------------------------------------
    def describe(self) -> str:
        """Human-readable scrape target(s) — the examples' exit line."""
        parts = []
        if self.port is not None:
            host = ("localhost" if self.bind in ("127.0.0.1", "")
                    else self.bind)
            parts.append(f"http://{host}:{self.port}/metrics")
        if self.textfile is not None:
            parts.append(f"textfile {self.textfile}")
        return " + ".join(parts) if parts else "disabled"

    def close(self) -> None:
        """Final textfile render + endpoint shutdown.  Idempotent."""
        if self.textfile is not None:
            try:
                self.write_textfile()
            except Exception:
                pass
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            try:
                httpd.shutdown()
                httpd.server_close()
            except Exception:
                pass


def attach_exporter(recorder, *, textfile: Optional[str] = None,
                    port: Optional[int] = None,
                    every_s: float = 5.0,
                    bind: str = "127.0.0.1") -> PrometheusExporter:
    """Build a :class:`PrometheusExporter` and hook it onto
    ``recorder`` (``telemetry.start(export_textfile=..., export_port=
    ...)`` calls this).  Returns the exporter.  ``bind`` defaults to
    loopback; pass ``"0.0.0.0"`` to expose the endpoint off-host."""
    exp = PrometheusExporter(recorder, textfile=textfile, port=port,
                             every_s=every_s, bind=bind)
    recorder.attach_exporter(exp)
    return exp
