"""SLO engine: declarative latency objectives folded online into
goodput and burn-rate signals — counterpart of
``apex_tpu/telemetry/slo.py``.

The spec is the operator's one-liner, ``ttft_p99<200ms,tpot_p99<30ms``:
each objective names a per-request metric (``ttft``, ``tpot``, ``e2e``,
``queue_wait``), a percentile that is also the compliance target
(``p99``: 99% of requests), and a threshold with its unit (``us``,
``ms``, ``s``).  A request is good when every objective holds; goodput
is the good share; the error budget is ``100 - target_pct``; the burn
rate is ``bad share / budget``.

:class:`SLOEngine` folds the serving engine's ``done`` events on the
recorder's thread, as the watchdog does, exports ``slo_goodput_pct``,
``slo_burn_rate_short`` and ``slo_burn_rate_long`` gauges, and emits
``slo`` events that the watchdog's ``slo_burn`` and ``slo_exhausted``
rules alert on.  Every clock is the stream's (event ``t``), so a stream
replayed through the fold gives the same verdicts.  Offline,
:func:`evaluate` is ``python -m apex_tpu_torch.prof.requests --slo``.
"""

from __future__ import annotations

import re
import threading
from collections import deque
from typing import Any, Dict, List, NamedTuple, Optional, Sequence

__all__ = ["Objective", "SLOSpec", "parse_slo", "evaluate", "SLOEngine",
           "attach"]

#: objective metric name -> the ``done`` event / timings field it reads
METRIC_FIELDS = {"ttft": "ttft_s", "tpot": "tpot_s", "e2e": "total_s",
                 "queue_wait": "queue_wait_s"}

_UNITS = {"us": 1e-6, "ms": 1e-3, "s": 1.0}

_OBJ_RE = re.compile(
    r"^\s*(?P<metric>[a-z][a-z0-9_]*?)(?:_p(?P<pct>\d+(?:\.\d+)?))?\s*"
    r"(?P<op><=?)\s*(?P<value>\d+(?:\.\d+)?)\s*(?P<unit>us|ms|s)?\s*$")


class Objective(NamedTuple):
    """One parsed objective: ``metric`` (a :data:`METRIC_FIELDS` key),
    ``pct`` the compliance percentile (``p99`` -> 99.0), and
    ``threshold_s`` in seconds.  A request with the metric missing
    (e.g. TPOT on a single-token request) passes vacuously."""
    metric: str
    pct: float
    threshold_s: float

    def describe(self) -> str:
        t = self.threshold_s
        unit, scale = (("ms", 1e3) if t < 1.0 else ("s", 1.0))
        return f"{self.metric}_p{self.pct:g}<{t * scale:g}{unit}"

    def good(self, request: Dict[str, Any]) -> bool:
        v = request.get(METRIC_FIELDS[self.metric])
        return v is None or float(v) <= self.threshold_s


class SLOSpec(NamedTuple):
    """A parsed spec: the objectives plus the overall compliance target
    (the strictest percentile qualifier — ``p99`` objectives demand 99%
    of requests good)."""
    objectives: tuple
    target_pct: float

    def good(self, request: Dict[str, Any]) -> bool:
        return all(o.good(request) for o in self.objectives)

    def budget(self) -> float:
        """Error budget as a fraction (``p99`` -> 0.01), floored so a
        pathological ``p100`` target cannot divide burn rates by 0."""
        return max((100.0 - self.target_pct) / 100.0, 1e-4)

    def describe(self) -> str:
        return ",".join(o.describe() for o in self.objectives)


def parse_slo(spec) -> SLOSpec:
    """Parse ``"ttft_p99<200ms,tpot_p99<30ms"`` (an already-parsed
    :class:`SLOSpec` passes through).  Unknown metrics, units, or
    shapes raise ``ValueError`` with the offending clause — a typo'd
    SLO must fail the launch, not silently gate nothing."""
    if isinstance(spec, SLOSpec):
        return spec
    objectives: List[Objective] = []
    for clause in str(spec).split(","):
        if not clause.strip():
            continue
        m = _OBJ_RE.match(clause)
        if not m:
            raise ValueError(
                f"unparseable SLO clause {clause.strip()!r} (expected "
                f"e.g. 'ttft_p99<200ms'; metrics: "
                f"{', '.join(sorted(METRIC_FIELDS))})")
        metric = m.group("metric")
        if metric not in METRIC_FIELDS:
            raise ValueError(
                f"unknown SLO metric {metric!r} (have: "
                f"{', '.join(sorted(METRIC_FIELDS))})")
        pct = float(m.group("pct") or 99.0)
        if not 0.0 < pct <= 100.0:
            raise ValueError(f"SLO percentile p{pct:g} out of (0, 100]")
        scale = _UNITS[m.group("unit") or "s"]
        objectives.append(Objective(metric, pct,
                                    float(m.group("value")) * scale))
    if not objectives:
        raise ValueError(f"empty SLO spec {spec!r}")
    return SLOSpec(tuple(objectives),
                   target_pct=max(o.pct for o in objectives))


def evaluate(spec, requests: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Goodput of a finished request set against ``spec`` — the offline
    evaluation ``prof.requests --slo`` reports (same per-request
    ``good`` predicate as the online fold, so live gauges and offline
    reports can never disagree on classification)."""
    spec = parse_slo(spec)
    n = len(requests)
    good = sum(1 for r in requests if spec.good(r))
    out: Dict[str, Any] = {
        "spec": spec.describe(),
        "target_pct": spec.target_pct,
        "n_requests": n,
        "good": good,
        "goodput_pct": round(100.0 * good / n, 3) if n else None,
        "met": (None if not n
                else (100.0 * good / n) >= spec.target_pct),
    }
    from .metrics import nearest_rank_percentiles
    per_obj = []
    for o in spec.objectives:
        vals = [float(r[METRIC_FIELDS[o.metric]]) for r in requests
                if r.get(METRIC_FIELDS[o.metric]) is not None]
        achieved = nearest_rank_percentiles(vals, (o.pct,))[0]
        per_obj.append({
            "objective": o.describe(),
            "achieved_s": (round(achieved, 6)
                           if achieved is not None else None),
            "ok": achieved is None or achieved <= o.threshold_s,
        })
    out["objectives"] = per_obj
    return out


class SLOEngine:
    """Online fold of ``serving`` ``done`` events into goodput/burn
    gauges and ``slo`` events (see module docstring).

    ``observe`` is called by the recorder after every written event on
    the emitting thread, under this object's lock; the ``slo`` events
    an evaluation emits go back through ``Recorder.event`` OUTSIDE the
    lock (the recorder skips re-folding ``slo``/``alert`` kinds, so
    this cannot recurse)."""

    def __init__(self, recorder, spec, *, short_window_s: float = 60.0,
                 long_window_s: float = 600.0, eval_every: int = 4,
                 min_requests: int = 8):
        self._rec = recorder
        self.spec = parse_slo(spec)
        self.short_window_s = float(short_window_s)
        self.long_window_s = float(long_window_s)
        self.eval_every = max(1, int(eval_every))
        self.min_requests = int(min_requests)
        self._lock = threading.Lock()
        # (t, good) per finished request; bounded — the long window at
        # any plausible request rate fits, and an hour-long burst
        # cannot grow host memory without bound.
        self._done: deque = deque(maxlen=65536)
        self.total = 0
        self.bad_total = 0
        self._since_eval = 0
        #: last evaluation's fields (the ``slo`` event body), for the
        #: exit line and tests.
        self.last: Optional[Dict[str, Any]] = None

    # -- fold ---------------------------------------------------------------
    def observe(self, event: Dict[str, Any]) -> None:
        if event.get("kind") != "serving" or event.get("phase") != "done":
            return
        if event.get("ttft_s") is None and event.get("total_s") is None:
            return                        # an older stream's shape
        emit: Optional[Dict[str, Any]] = None
        with self._lock:
            t = float(event.get("t", 0.0))
            good = self.spec.good(event)
            self._done.append((t, good))
            self.total += 1
            self.bad_total += 0 if good else 1
            self._since_eval += 1
            if self._since_eval >= self.eval_every or self.total == 1:
                self._since_eval = 0
                emit = self._eval_locked(t)
        if emit is None:
            return
        rec = self._rec
        if rec is not None and rec.enabled:
            for name in ("slo_goodput_pct", "slo_burn_rate_short",
                         "slo_burn_rate_long"):
                key = {"slo_goodput_pct": "goodput_pct",
                       "slo_burn_rate_short": "burn_short",
                       "slo_burn_rate_long": "burn_long"}[name]
                rec.metrics.gauge(name).set(emit[key])
            rec.event("slo", phase="eval", **emit)

    def _window(self, now: float, window_s: float):
        n = bad = 0
        for t, good in reversed(self._done):
            if now - t > window_s:
                break
            n += 1
            bad += 0 if good else 1
        return n, bad

    def _eval_locked(self, now: float) -> Dict[str, Any]:
        budget = self.spec.budget()
        n_s, bad_s = self._window(now, self.short_window_s)
        n_l, bad_l = self._window(now, self.long_window_s)
        goodput = 100.0 * (n_l - bad_l) / n_l if n_l else 100.0
        burn_short = (bad_s / n_s / budget) if n_s else 0.0
        burn_long = (bad_l / n_l / budget) if n_l else 0.0
        # the run-level budget: exhausted when the bad fraction over
        # EVERYTHING served has consumed the whole allowance (not a
        # window blip — the SLO for this run is unrecoverable without
        # a quiet stretch).
        exhausted = (self.total >= self.min_requests
                     and (self.bad_total / self.total) > budget)
        self.last = {
            "goodput_pct": round(goodput, 3),
            "burn_short": round(burn_short, 3),
            "burn_long": round(burn_long, 3),
            "window_n": n_l,
            "n": self.total,
            "bad": self.bad_total,
            "target_pct": self.spec.target_pct,
            "exhausted": exhausted,
        }
        return dict(self.last)

    # -- exit line ----------------------------------------------------------
    def format_line(self) -> str:
        """One-line SLO verdict for the examples' exit print."""
        if self.last is None:
            return f"{self.spec.describe()}: no requests evaluated"
        s = self.last
        state = ("EXHAUSTED" if s["exhausted"]
                 else "burning" if s["burn_long"] > 1.0 else "ok")
        return (f"{self.spec.describe()}: goodput "
                f"{s['goodput_pct']:.1f}% (target "
                f"{s['target_pct']:g}%), burn {s['burn_short']:.1f}x/"
                f"{s['burn_long']:.1f}x short/long — {state}")


def attach(recorder, spec, **kwargs) -> SLOEngine:
    """Build an :class:`SLOEngine` and hook it onto ``recorder``
    (``telemetry.start(slo=...)`` calls this).  Returns the engine."""
    eng = SLOEngine(recorder, spec, **kwargs)
    recorder.attach_slo(eng)
    return eng
