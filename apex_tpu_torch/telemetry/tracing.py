"""Request-level tracing: deterministic trace and span ids over the
event stream — counterpart of ``apex_tpu/telemetry/tracing.py``.

A **trace** is one request's journey (submit, queue, prefill, decode
steps, done); a **span** is one timed phase of it, emitted through the
:class:`~apex_tpu_torch.telemetry.events.Recorder` as a ``span`` event
(the JAX package's schema), so rotation, the watchdog, the exporter and
the fleet merge see it like any other event.

* Ids are counter-based (``t<host>-<n>``, ``s<n>``): the same load
  gives the same tree, in either package;
* ``sample_n=N`` traces every Nth request, ``0`` (the default when
  ``APEX_TPU_TRACE_SAMPLE`` is unset) none; an untraced request pays
  one counter increment at submit and nothing per token;
* with no recorder installed the engine's call sites read one global.

Span event schema (one JSONL line per finished span)::

    {"t": <end, stream clock>, "kind": "span", "name": "prefill",
     "trace": "t0-000007", "span": "s000042", "parent": "s000041",
     "dur": 0.0183, ...free-form fields (slot/bucket/batch_size/...)}

``t`` is the span's end and ``dur`` its length (``start = t - dur``).
The root span of a trace has no ``parent``.  Read the trees back with
``python -m apex_tpu_torch.prof.requests``.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import Optional

__all__ = ["Tracer", "attach", "sample_n_from_env"]


def sample_n_from_env() -> int:
    """``APEX_TPU_TRACE_SAMPLE`` as an int (0 / unset / garbage -> 0,
    i.e. tracing off) — the flags-free wiring ``telemetry.start`` uses."""
    raw = (os.environ.get("APEX_TPU_TRACE_SAMPLE") or "").strip()
    try:
        return max(0, int(raw)) if raw else 0
    except ValueError:
        return 0


class Tracer:
    """Deterministic id factory + ``span`` event emitter for one
    recorder.

    ``sample()`` is the sampling gate: every ``sample_n``-th call
    returns a fresh trace id (the caller traces that unit), the rest
    return ``None`` (the caller emits nothing).  ``sample_n <= 0``
    never samples.  Counters are plain itertools counters under a lock
    — cheap, deterministic, and unique per process; the trace id embeds
    the recorder's ``process_index`` so merged multi-host streams never
    collide."""

    def __init__(self, recorder, sample_n: int = 1):
        self._rec = recorder
        self.sample_n = int(sample_n)
        self._lock = threading.Lock()
        self._seen = 0                       # sampling-unit counter
        self._traces = itertools.count()     # allocated trace ids
        self._spans = itertools.count()      # allocated span ids
        self._host = int(getattr(recorder, "process_index", 0) or 0)

    # -- ids ----------------------------------------------------------------
    def sample(self) -> Optional[str]:
        """One sampling decision: a new trace id for every
        ``sample_n``-th call, else ``None``.  Thread-safe (submit runs
        on caller threads)."""
        if self.sample_n <= 0:
            return None
        with self._lock:
            n = self._seen
            self._seen += 1
            if n % self.sample_n:
                return None
            return f"t{self._host}-{next(self._traces):06d}"

    def next_span_id(self) -> str:
        """A fresh span id (unique within this process' stream)."""
        with self._lock:
            return f"s{next(self._spans):06d}"

    # -- emission -----------------------------------------------------------
    def emit(self, name: str, trace: Optional[str], *,
             parent: Optional[str] = None, dur: float = 0.0,
             span: Optional[str] = None, **fields) -> Optional[str]:
        """Emit one already-measured span (the engine times a batched
        decode dispatch ONCE and emits a span per traced participant).
        ``trace=None`` is the not-sampled no-op; returns the span id so
        children can parent to it."""
        if trace is None:
            return None
        rec = self._rec
        if rec is None or not rec.enabled:
            return None
        sid = span if span is not None else self.next_span_id()
        if parent is not None:
            fields["parent"] = parent
        rec.event("span", name=name, trace=trace, span=sid,
                  dur=round(float(dur), 6), **fields)
        return sid

    @contextlib.contextmanager
    def span(self, name: str, trace: Optional[str], *,
             parent: Optional[str] = None, **fields):
        """Context manager measuring and emitting one span; yields the
        span id (``None`` when the trace is unsampled — the strict
        no-op path: no clock read, no allocation)."""
        if trace is None:
            yield None
            return
        sid = self.next_span_id()
        t0 = time.perf_counter()
        try:
            yield sid
        finally:
            self.emit(name, trace, parent=parent, span=sid,
                      dur=time.perf_counter() - t0, **fields)


def attach(recorder, sample_n: int = 1) -> Tracer:
    """Build a :class:`Tracer` and hook it onto ``recorder``
    (``telemetry.start(trace_sample_n=...)`` calls this).  Returns the
    tracer; instrumented subsystems discover it via
    ``recorder.tracer``."""
    tr = Tracer(recorder, sample_n=sample_n)
    recorder.attach_tracer(tr)
    return tr
