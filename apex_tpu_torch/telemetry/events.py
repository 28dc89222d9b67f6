"""Structured event stream — counterpart of
``apex_tpu/telemetry/events.py``.

A run's record is assembled at the host boundaries the port already
crosses, never inside a captured graph (whose Python body runs once, at
capture):

* the window replay and the host gap between replays
  (:class:`apex_tpu_torch.runtime.StepPipeline`), and each capture as a
  ``retrace`` event (a CUDA-graph capture is the counterpart of a jit
  cache growth);
* the one-window-behind metric read
  (:class:`apex_tpu_torch.runtime.DeferredMetrics`): the loss, the loss
  scale and the skips come from the values that read already brings
  back;
* the loader's wait and staging (:class:`apex_tpu_torch.data.
  PrefetchLoader`), the checkpoint engine, the serving engine's phases;
* each collective's bytes, noted when it is issued eagerly or captured,
  never per replay.

:class:`Recorder` writes one JSON object per line (JSONL), in the JAX
package's schema kind for kind and field for field, so a stream of
either package reads the same in both analyzers
(``python -m apex_tpu_torch.prof.timeline run.jsonl``).  Each event is
a dict, one ``json.dumps`` and one buffered write under one lock; the
training loop emits two or three a window.  With no recorder installed
every instrumented site costs one global read and the run is what it is
without telemetry.

Usage::

    from apex_tpu_torch import telemetry

    rec = telemetry.start("run.jsonl", example="lm")
    ...             # StepPipeline, PrefetchLoader, amp pick it up
    rec.close()     # writes the summary event
"""

from __future__ import annotations

import contextlib
import glob as _glob
import json
import os
import re
import threading
import time
from typing import Any, Dict, IO, List, Optional, Union

from .metrics import MetricsRegistry

__all__ = ["Recorder", "get_recorder", "set_recorder", "start",
           "start_from_env", "to_chrome_trace", "expand_stream_paths"]

_active: Optional["Recorder"] = None
_active_lock = threading.Lock()


def get_recorder() -> Optional["Recorder"]:
    """The process-wide active recorder, or None when telemetry is off —
    the ONE read every instrumented hot path pays when disabled."""
    return _active


def set_recorder(rec: Optional["Recorder"]) -> Optional["Recorder"]:
    """Install (or clear, with None) the active recorder; returns the
    previous one so scoped users can restore it."""
    global _active
    with _active_lock:
        prev, _active = _active, rec
    return prev


def _env_flag(name: str) -> Optional[bool]:
    """Tri-state env-var read: unset -> None, else the usual truthy set."""
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return None
    return raw.strip().lower() not in ("0", "false", "no", "off")


def start(path: Optional[str] = None, watchdog: Optional[bool] = None,
          run_id: Optional[str] = None, *,
          max_bytes: Optional[int] = None,
          export_textfile: Optional[str] = None,
          export_port: Optional[int] = None,
          export_every_s: float = 5.0,
          trace_sample_n: Optional[int] = None,
          slo: Optional[str] = None,
          process_index: Optional[int] = None,
          process_count: Optional[int] = None,
          **meta) -> "Recorder":
    """Open a recorder on ``path`` and install it as the active one.
    Keyword args land in the stream's leading ``run`` event.

    ``path=None`` reads ``APEX_TPU_TELEMETRY``, so any entry point can be
    instrumented by exporting the variable instead of passing a flag;
    with neither a ``ValueError`` says so.  ``watchdog``
    likewise defaults from ``APEX_TPU_WATCHDOG`` (``0``/``1``), and the
    export knobs from ``APEX_TPU_METRICS_TEXTFILE`` /
    ``APEX_TPU_METRICS_PORT``.  See :func:`start_from_env` for the
    quiet does-nothing-when-unconfigured variant.

    ``watchdog=True`` also attaches the run-health rule engine
    (:mod:`apex_tpu_torch.telemetry.watchdog`): events are folded online on
    the emitting thread and debounced ``alert`` events land in the same
    stream; read ``rec.watchdog.format_line()`` at exit for the
    one-line health summary.

    ``run_id`` names the run across interruptions: a resumed
    process passes the id restored from its checkpoint so the resumed
    stream is attributable to the same logical run; omitted, a fresh id
    is generated.  Either way it rides the ``run`` event and
    ``rec.run_id``.

    ``max_bytes`` bounds each stream segment: when
    the file crosses it, the recorder writes a ``rotate`` event,
    atomically renames the segment to ``path.<seq>`` and reopens
    ``path`` — a week-long fleet run never grows one unbounded file.
    ``prof.timeline`` / ``prof.fleet`` re-assemble the rotated set
    (:func:`expand_stream_paths`).

    ``export_textfile`` / ``export_port`` attach the live Prometheus
    exporter (:mod:`apex_tpu_torch.telemetry.export`): registry
    counters/gauges/histograms plus watchdog health rendered to
    text-exposition format every ``export_every_s`` seconds on the
    threads that already emit events (zero extra host syncs) and/or
    served from a stdlib http endpoint.

    ``trace_sample_n`` attaches the request tracer
    (:mod:`apex_tpu_torch.telemetry.tracing`): every Nth sampled
    unit (serving request) emits a ``span`` tree into the same stream;
    defaults from ``APEX_TPU_TRACE_SAMPLE`` (unset/0 -> no tracing).
    ``slo`` attaches the SLO engine (:mod:`apex_tpu_torch.telemetry.slo`) on
    a spec string like ``"ttft_p99<200ms,tpot_p99<30ms"`` (env
    ``APEX_TPU_SLO``): goodput/burn-rate gauges fold online and the
    watchdog's ``slo_burn``/``slo_exhausted`` rules alert on them."""
    if path is None:
        path = os.environ.get("APEX_TPU_TELEMETRY") or None
        if path is None:
            raise ValueError(
                "telemetry.start() needs a stream path: pass one, or set "
                "APEX_TPU_TELEMETRY=path (use telemetry.start_from_env() "
                "for an entrypoint that should quietly skip telemetry "
                "when unconfigured)")
    if watchdog is None:
        watchdog = bool(_env_flag("APEX_TPU_WATCHDOG"))
    if export_textfile is None:
        export_textfile = os.environ.get("APEX_TPU_METRICS_TEXTFILE") or None
    if export_port is None:
        raw_port = os.environ.get("APEX_TPU_METRICS_PORT")
        export_port = int(raw_port) if raw_port else None
    if trace_sample_n is None:
        from .tracing import sample_n_from_env
        trace_sample_n = sample_n_from_env()
    if slo is None:
        slo = (os.environ.get("APEX_TPU_SLO") or "").strip() or None
    rec = Recorder(path, meta=meta or None, run_id=run_id,
                   max_bytes=max_bytes, process_index=process_index,
                   process_count=process_count)
    if watchdog:
        from .watchdog import attach
        attach(rec)
    if export_textfile is not None or export_port is not None:
        from .export import attach_exporter
        attach_exporter(rec, textfile=export_textfile, port=export_port,
                        every_s=export_every_s)
    if trace_sample_n and trace_sample_n > 0:
        from .tracing import attach as attach_tracer
        attach_tracer(rec, sample_n=trace_sample_n)
    if slo is not None:
        from .slo import attach as attach_slo
        attach_slo(rec, slo)
    set_recorder(rec)
    return rec


def start_from_env(**meta) -> Optional["Recorder"]:
    """:func:`start` driven purely by env vars — returns the installed
    :class:`Recorder` when ``APEX_TPU_TELEMETRY`` names a stream path,
    else ``None`` without side effects: the call for an entry point that
    has no telemetry flags of its own
    (``APEX_TPU_TELEMETRY=run.jsonl APEX_TPU_WATCHDOG=1 python ...``)."""
    if not (os.environ.get("APEX_TPU_TELEMETRY") or "").strip():
        return None
    return start(**meta)


def _json_default(x):
    """Tolerant JSON encoding: numpy scalars and arrays (host values the
    deferred read returned) show up in metric dicts; never let an exotic
    leaf kill the stream."""
    if hasattr(x, "item") and getattr(x, "ndim", None) == 0:
        try:
            return x.item()
        except Exception:
            pass
    if hasattr(x, "tolist"):
        try:
            return x.tolist()
        except Exception:
            pass
    return repr(x)


def _process_identity() -> tuple:
    """``(process_index, process_count)`` of this process:
    :func:`apex_tpu_torch.parallel.multiproc.process_identity`, the one
    source the checkpoint's per-process parts are stamped with too, so a
    spawned worker's stream and checkpoint part agree."""
    try:
        from ..parallel.multiproc import process_identity
        return process_identity()
    except Exception:
        return 0, 1


class Recorder:
    """Thread-safe JSONL event sink + metrics registry for one run.

    Every event is ``{"t": <seconds since the recorder opened>,
    "kind": <str>, ...fields}``.  Event kinds and their schema are
    documented in ``docs/telemetry.md`` (the table the analyzer and the
    Chrome exporter are written against).

    The recorder is a context manager (``close`` on exit, restoring the
    previously active recorder if this one was active).  After
    ``close()`` every ``event()`` is a silent no-op, so late producer
    threads (loader workers draining) cannot crash shutdown.
    """

    def __init__(self, path_or_file: Union[str, IO], *,
                 meta: Optional[dict] = None, reservoir: int = 512,
                 run_id: Optional[str] = None,
                 max_bytes: Optional[int] = None,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        import uuid
        #: stable identifier of the LOGICAL run — survives kill/resume
        #: when the resuming process passes the checkpointed id back
        #: through ``telemetry.start(run_id=...)``.
        self.run_id = run_id or uuid.uuid4().hex[:12]
        self._lock = threading.Lock()
        if hasattr(path_or_file, "write"):
            self._f, self._owns, self.path = path_or_file, False, None
        else:
            self._f = open(path_or_file, "w", encoding="utf-8")
            self._owns, self.path = True, path_or_file
        self._t0 = time.perf_counter()
        #: run-start wall-clock anchor (unix seconds at ``t == 0``) — the
        #: coarse cross-host alignment ``prof.fleet`` refines with
        #: per-window dispatch indices.
        self.anchor_unix = time.time()
        if process_index is None or process_count is None:
            process_index, process_count = _process_identity()
        #: this host's slot in the fleet, stamped on the ``run`` event so
        #: a merged multi-host analysis can attribute every stream.
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        # stream rotation: segment byte budget; the
        # active file is always `path`, full segments atomically rename
        # to `path.<seq>` after a trailing `rotate` event.
        self._max_bytes = int(max_bytes) if max_bytes else None
        self._bytes_written = 0
        self._segment = 0
        self._meta = dict(meta or {})
        #: free-form identity labels merged into the Prometheus
        #: ``run_info`` exposition (e.g. the serving engine's
        #: ``kv_cache_dtype`` — ).  Last-write-wins strings.
        self.run_info: Dict[str, str] = {}
        self._closed = False
        self._counts: Dict[str, int] = {}
        #: host-side instruments, snapshotted into the ``summary`` event.
        self.metrics = MetricsRegistry(reservoir=reservoir)
        # observe_window_metrics state: _obs_hwm marks the highest step
        # already observed (a re-fetched window — warmup drain + cadence
        # print hit the same WindowMetrics twice — is tagged
        # refetch=True, a real transfer but not new data); _scale_hwm
        # guards the loss-scale derivation against the same doubling.
        self._obs_hwm = 0
        self._scale_hwm = 0
        self._last_scale: Optional[float] = None
        #: optional run-health rule engine (attach_watchdog / watchdog.attach)
        self._watchdog = None
        #: optional live metrics exporter (export.attach_exporter)
        self._exporter = None
        #: optional request tracer (tracing.attach — )
        self._tracer = None
        #: optional SLO fold (slo.attach — )
        self._slo = None
        self.event("run", **self._run_fields())

    def _run_fields(self) -> Dict[str, Any]:
        """The ``run`` event's fields — re-emitted at the head of every
        rotated segment so each file in a rotated set is
        self-describing (same run_id / anchor / host identity)."""
        return {"run_id": self.run_id, "meta": self._meta,
                "process_index": self.process_index,
                "process_count": self.process_count,
                "anchor_unix": round(self.anchor_unix, 6),
                "segment": self._segment}

    # -- core sink ----------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return not self._closed

    def now(self) -> float:
        """Seconds since the recorder opened (the stream's clock)."""
        return time.perf_counter() - self._t0

    def event(self, kind: str, **fields) -> None:
        """Append one event; silently dropped after ``close()``."""
        if self._closed:
            return
        rec = {"t": round(self.now(), 6), "kind": kind}
        rec.update(fields)
        line = json.dumps(rec, default=_json_default)
        with self._lock:
            if self._closed:
                return
            self._f.write(line + "\n")
            self._counts[kind] = self._counts.get(kind, 0) + 1
            self._bytes_written += len(line) + 1
            if (self._max_bytes is not None and self._owns and self.path
                    and self._bytes_written >= self._max_bytes):
                self._rotate_locked()
        # Watchdog fold: outside the stream lock, on THIS
        # thread — the event dict already exists, so the rules cost a
        # few dict reads and no device work.  Alerts the fold emits come
        # back through event() with kind="alert" and are not re-folded.
        wd = self._watchdog
        if wd is not None and kind != "alert":
            wd.observe(rec)
        # SLO fold: same discipline — done events fold into
        # goodput/burn state here; the `slo` events an evaluation emits
        # re-enter event() (and ARE watchdog-folded, so slo_burn /
        # slo_exhausted can alert) but are not re-folded here.
        slo = self._slo
        if slo is not None and kind not in ("alert", "slo"):
            slo.observe(rec)
        # Live-export tick: same zero-extra-thread discipline
        # — the exporter piggybacks on whichever thread wrote the event
        # and renders only when its interval has elapsed.
        exp = self._exporter
        if exp is not None:
            exp.tick()

    def _rotate_locked(self) -> None:
        """Seal the current segment and reopen ``path`` (stream-lock
        held): append a ``rotate`` event, flush, atomically rename to
        ``path.<seq>``, then start the fresh segment with a
        continuation ``run`` event so every file in the rotated set is
        independently attributable.  The stream clock (``t``) runs on
        unbroken through rotations — concatenating segments in sequence
        order reproduces the unrotated stream exactly."""
        self._segment += 1
        target = f"{self.path}.{self._segment}"
        rot = {"t": round(self.now(), 6), "kind": "rotate",
               "seq": self._segment, "to": os.path.basename(target)}
        self._f.write(json.dumps(rot) + "\n")
        self._counts["rotate"] = self._counts.get("rotate", 0) + 1
        self._f.flush()
        self._f.close()
        os.replace(self.path, target)
        self._f = open(self.path, "w", encoding="utf-8")
        head = {"t": round(self.now(), 6), "kind": "run"}
        head.update(self._run_fields())
        line = json.dumps(head, default=_json_default)
        self._f.write(line + "\n")
        self._counts["run"] = self._counts.get("run", 0) + 1
        self._bytes_written = len(line) + 1

    def attach_watchdog(self, watchdog) -> None:
        """Install a run-health watchdog
        (:class:`apex_tpu_torch.telemetry.watchdog.Watchdog`): every event
        written from now on is folded through its rules, and the final
        ``summary`` event carries its ``health`` verdict."""
        self._watchdog = watchdog

    @property
    def watchdog(self):
        """The attached watchdog, or None."""
        return self._watchdog

    def attach_exporter(self, exporter) -> None:
        """Install a live metrics exporter
        (:class:`apex_tpu_torch.telemetry.export.PrometheusExporter`): its
        ``tick()`` runs after every written event on the emitting
        thread, and ``close()`` finalizes it (last render + endpoint
        shutdown)."""
        self._exporter = exporter

    @property
    def exporter(self):
        """The attached exporter, or None."""
        return self._exporter

    def attach_tracer(self, tracer) -> None:
        """Install a request tracer
        (:class:`apex_tpu_torch.telemetry.tracing.Tracer`): instrumented
        subsystems (the serving engine) discover it here and emit
        sampled ``span`` trees through this recorder."""
        self._tracer = tracer

    @property
    def tracer(self):
        """The attached tracer, or None (tracing off)."""
        return self._tracer

    def attach_slo(self, slo) -> None:
        """Install an SLO fold
        (:class:`apex_tpu_torch.telemetry.slo.SLOEngine`): every ``serving``
        ``done`` event written from now on updates its goodput/burn
        windows, and the final ``summary`` event carries its verdict."""
        self._slo = slo

    @property
    def slo(self):
        """The attached SLO engine, or None."""
        return self._slo

    @contextlib.contextmanager
    def span(self, kind: str, **fields):
        """Context manager emitting ``kind`` with a measured ``dur``."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.event(kind, dur=round(time.perf_counter() - t0, 6),
                       **fields)

    # -- domain helpers -----------------------------------------------------
    def observe_window_metrics(self, step: int, n_valid: int, values,
                               fetch_s: float) -> None:
        """Record one window's fetched metrics (called from
        :meth:`apex_tpu_torch.runtime.WindowMetrics.fetch` with the host
        values of the one read the loop already makes, so this adds no
        read of its own).  Emits a ``metrics`` event and derives ``scale``
        skip/growth events with global step indices."""
        import numpy as np

        fields: Dict[str, Any] = {"step": step, "n_valid": n_valid,
                                  "dur": round(fetch_s, 6)}
        loss = scale = overflow = None
        if isinstance(values, dict):
            def _series(key):
                v = values.get(key)
                if v is None:
                    return None
                flat = np.ravel(np.asarray(v))
                if flat.size == 0:
                    return None
                if flat.size < n_valid:     # per-window scalar metric
                    flat = np.repeat(flat[-1], n_valid)
                return [float(x) for x in flat[:n_valid]]
            loss = _series("loss")
            scale = _series("loss_scale")
            overflow = _series("overflow")
        if loss is not None:
            fields["loss"] = [round(v, 6) for v in loss]
            self.metrics.gauge("loss").set(loss[-1])
        if scale is not None:
            fields["loss_scale"] = scale
            self.metrics.gauge("loss_scale").set(scale[-1])
        if overflow is not None:
            fields["skips"] = int(sum(1 for v in overflow if v))
        if step + n_valid <= self._obs_hwm:
            # A transfer genuinely happened (the histogram counts it),
            # but the window was already observed — tag it so the
            # analyzer and readers can discount the duplicate.
            fields["refetch"] = True
        self._obs_hwm = max(self._obs_hwm, step + n_valid)
        self.metrics.histogram("metrics_fetch_s").observe(fetch_s)
        self.event("metrics", **fields)
        # Loss-scale trajectory events (skip on overflow, growth on the
        # scale-window doubling), derived host-side from values already
        # fetched.  Monotonic guard: a re-fetched window (warmup drain +
        # cadence print hit the same WindowMetrics twice) derives nothing.
        if scale is None or step + n_valid <= self._scale_hwm:
            return
        for j in range(n_valid):
            gstep = step + j
            if gstep < self._scale_hwm:
                continue
            s = scale[j]
            if overflow is not None and overflow[j]:
                self.metrics.counter("loss_scale_skips").inc()
                self.event("scale", event="skip", step=gstep, scale=s)
            elif self._last_scale is not None and s > self._last_scale:
                self.event("scale", event="grow", step=gstep, scale=s)
            self._last_scale = s
        self._scale_hwm = step + n_valid

    def note_collective(self, op: str, axis, nbytes: int, n: int,
                        dtype: Optional[str] = None,
                        participants: Optional[int] = None) -> None:
        """Record one collective's per-invocation traffic: ``bytes`` on
        the wire, ``n`` tensors.  The port notes a collective when it is
        issued eagerly or recorded into a graph, never per replay (a
        :class:`~apex_tpu_torch.runtime.StepPipeline` lets one step of
        each capture note, as JAX notes once per trace); ``participants``
        is the group's size (the fleet merge's wait-vs-wire model)."""
        fields = {"op": op,
                  "axis": (list(axis) if isinstance(axis, (tuple, list))
                           else axis),
                  "bytes": int(nbytes), "n": int(n)}
        if dtype is not None:
            fields["dtype"] = dtype
        if participants is not None:
            fields["participants"] = int(participants)
        self.event("collective", **fields)

    # -- lifecycle ----------------------------------------------------------
    def close(self, *, loader_stats: Optional[dict] = None) -> None:
        """Write the final ``summary`` event (registry snapshot + event
        counts, plus an optional last ``loader`` snapshot) and close the
        stream.  Idempotent."""
        if self._closed:
            return
        if loader_stats:
            self.event("loader", final=True, stats=dict(loader_stats))
        summary_fields = {"metrics": self.metrics.snapshot()}
        if self._watchdog is not None:
            summary_fields["health"] = self._watchdog.health()
        if self._slo is not None and self._slo.last is not None:
            summary_fields["slo"] = dict(self._slo.last)
        self.event("summary", events=dict(self._counts), **summary_fields)
        if self._exporter is not None:
            # final render BEFORE the stream closes: the scrape target
            # sees the run's last numbers (and the endpoint goes away).
            try:
                self._exporter.close()
            except Exception:
                pass
        with self._lock:
            self._closed = True
            try:
                self._f.flush()
                if self._owns:
                    self._f.close()
            except Exception:
                pass
        if get_recorder() is self:
            set_recorder(None)

    def __enter__(self) -> "Recorder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# -- collective notes inside a step pipeline ---------------------------------
# JAX notes a collective once per trace.  The port's counterpart: outside
# a StepPipeline every collective issued is noted; inside one, only those
# of the first step of the call that captures a program (on the CPU, that
# first runs it), so a replay, or an eager window after the first, notes
# nothing.  The state is the process's, not a thread's: on CUDA the
# backward's collectives run on autograd's device thread.
_notes: List[Optional[bool]] = [None]


def _notes_open() -> bool:
    """Whether a collective issued now is noted (see above)."""
    return _notes[0] in (None, True)


@contextlib.contextmanager
def _pipeline_notes(note: bool):
    """Run a pipeline's window call with collective notes on (``note``)
    until its first step ends, or off."""
    prev, _notes[0] = _notes[0], bool(note)
    try:
        yield
    finally:
        _notes[0] = prev


def _end_noted_step() -> None:
    """A pipeline step ended: later steps of the call note nothing."""
    if _notes[0] is True:
        _notes[0] = False


# -- Chrome trace_event export ------------------------------------------------

# Stream kinds -> synthetic thread rows of the Chrome trace.
_CHROME_TIDS = {
    "window": (1, "device-loop dispatch"),
    "metrics": (2, "metric fetch (1 behind)"),
    "loader_wait": (3, "consumer wait (loader)"),
    "stage": (4, "device staging (H2D)"),
    "opt_step": (5, "optimizer step"),
    "span": (10, "request spans"),
}
_CHROME_INSTANT = {"scale": 6, "retrace": 7, "collective": 8, "marker": 9}
_CHROME_INSTANT_ROW = {6: "loss scale", 7: "retrace", 8: "collectives",
                       9: "markers"}


#: rotated-segment suffix: ``run.jsonl.3`` is segment 3 of ``run.jsonl``
_SEGMENT_RE = re.compile(r"^(?P<base>.+)\.(?P<seq>\d+)$")


def expand_stream_paths(path_or_glob: str) -> List[str]:
    """Resolve one stream argument — a path, a glob, or a member of a
    rotated set — into the ordered list of segment files to read.

    For each distinct stream base, rotated segments (``base.1``,
    ``base.2``, …) come first in sequence order, then the live ``base``
    file — the order :meth:`Recorder._rotate_locked` sealed them in, so
    concatenation reproduces the unrotated stream.  A glob that matches
    nothing returns the input unchanged (the open error stays the
    caller's, with the user's own spelling)."""
    matches = (sorted(_glob.glob(path_or_glob))
               if _glob.has_magic(path_or_glob) else [path_or_glob])
    if not matches:
        return [path_or_glob]
    bases: Dict[str, List[tuple]] = {}
    for p in matches:
        m = _SEGMENT_RE.match(p)
        if m and (m.group("base") in matches
                  or os.path.exists(m.group("base"))
                  or _glob.glob(m.group("base") + ".*")):
            bases.setdefault(m.group("base"), []).append(
                (int(m.group("seq")), p))
        else:
            bases.setdefault(p, [])
    out: List[str] = []
    for base in sorted(bases):
        segs = {p for _, p in bases[base]}
        # pick up rotated siblings the glob itself did not name
        for p in _glob.glob(_glob.escape(base) + ".*"):
            m = _SEGMENT_RE.match(p)
            if m and p not in segs:
                bases[base].append((int(m.group("seq")), p))
                segs.add(p)
        out.extend(p for _, p in sorted(bases[base]))
        if os.path.exists(base) or not bases[base]:
            out.append(base)
    return out


def _read_jsonl(path: str) -> List[dict]:
    out: List[dict] = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue            # a torn tail line must not kill analysis
    return out


def _iter_events(events_or_path) -> List[dict]:
    if isinstance(events_or_path, str):
        out: List[dict] = []
        for p in expand_stream_paths(events_or_path):
            out.extend(_read_jsonl(p))
        return out
    return list(events_or_path)


def chrome_events(events, *, pid: int = 0, host: Optional[str] = None,
                  t_offset_s: float = 0.0) -> List[dict]:
    """One stream's Chrome ``trace_event`` dicts on process lane ``pid``
    (metadata rows + slices/instants).  ``host`` names the lane
    (``process_name`` metadata — ``prof.fleet`` passes ``host<i>`` so a
    merged trace opens as a fleet timeline); ``t_offset_s`` shifts the
    stream onto a common clock (the fleet merge's aligned offset)."""
    out: List[dict] = []
    if host is not None:
        out.append({"ph": "M", "pid": pid, "tid": 0,
                    "name": "process_name", "args": {"name": host}})
    for tid, name in sorted(
            list(_CHROME_TIDS.values())
            + [(t, n) for t, n in _CHROME_INSTANT_ROW.items()]):
        out.append({"ph": "M", "pid": pid, "tid": tid,
                    "name": "thread_name", "args": {"name": name}})
    off_us = float(t_offset_s) * 1e6
    for e in events:
        kind = e.get("kind")
        t_us = float(e.get("t", 0.0)) * 1e6 + off_us
        if kind in _CHROME_TIDS:
            tid = _CHROME_TIDS[kind][0]
            dur_us = float(e.get("dur", 0.0)) * 1e6
            args = {k: v for k, v in e.items()
                    if k not in ("t", "kind", "dur")}
            name = kind
            if kind == "window":
                name = f"window@{e.get('step')}"
            elif kind == "metrics":
                name = f"fetch@{e.get('step')}"
            elif kind == "span":
                # nested complete slices on one row: queue/prefill/
                # decode sit inside their request span time-wise, so
                # Perfetto renders the waterfall as a flame
                name = f"{e.get('name', 'span')}@{e.get('trace')}"
            out.append({"ph": "X", "pid": pid, "tid": tid, "name": name,
                        "ts": t_us - dur_us, "dur": max(dur_us, 1.0),
                        "args": args})
        elif kind in _CHROME_INSTANT:
            args = {k: v for k, v in e.items() if k not in ("t", "kind")}
            name = kind if kind != "scale" else \
                f"scale:{e.get('event')}@{e.get('step')}"
            out.append({"ph": "i", "pid": pid, "tid": _CHROME_INSTANT[kind],
                        "name": name, "ts": t_us, "s": "t", "args": args})
    return out


def to_chrome_trace(events_or_path, out_path: str) -> int:
    """Convert a telemetry stream (path or loaded event list) into a
    Chrome ``trace_event`` JSON file (load in Perfetto /
    ``chrome://tracing``).  Durational events become complete ("X")
    slices on per-subsystem rows; scale/retrace/collective/marker events
    become instants.  Returns the number of trace events written.  For
    a merged multi-host trace (one ``pid`` lane per host) see
    ``python -m apex_tpu_torch.prof.fleet --chrome``."""
    events = _iter_events(events_or_path)
    out = chrome_events(events)
    n = sum(1 for e in out if e["ph"] != "M")
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump({"traceEvents": out,
                   "displayTimeUnit": "ms"}, f)
    return n
