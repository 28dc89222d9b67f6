"""Run-health watchdog — counterpart of
``apex_tpu/telemetry/watchdog.py``: an online rule engine folding the
event stream into debounced ``alert`` events.

It folds each event on the thread that emitted it (the
:class:`~apex_tpu_torch.telemetry.events.Recorder` calls
:meth:`Watchdog.observe` after writing the line), from host dicts that
already exist: no read of the device, no thread of its own.  Each firing
is an ``alert`` event in the same stream, debounced per rule (one per
``debounce_steps`` global steps).  The twelve rules, thresholds and
debounce are the JAX package's:

========================  =====================================================
``nonfinite``             a fetched ``metrics`` window holds a NaN/inf loss
``scale_collapse``        the loss scale at its floor, or >= ``max_skips``
                          consecutive overflow skips
``loader_stall``          the final ``loader`` snapshot's stall share, or a
                          window of ``loader_wait`` events, above
                          ``stall_pct``
``step_time``             a window's per-step time above ``anomaly_factor`` x
                          the rolling median
``retrace_storm``         >= ``storm_count`` captures of never-seen window
                          signatures within ``storm_steps`` steps (the port's
                          ``retrace`` events come from CUDA-graph captures)
``checkpoint_stall``      a checkpoint ``snapshot`` above ``ckpt_stall_s``, or
                          a writer backlog
``checkpoint_failed``     a checkpoint write failed (critical)
``memory_headroom``       a ``memory`` event with free device memory below
                          ``min_headroom_pct`` of the card's
``serving_queue_stall``   a request waited above ``serving_stall_s`` in the
                          serving queue
``quant_scale_saturation`` more than ``quant_max_exceeded`` range overflows of
                          a calibrated int8 site in one window
``slo_burn``              both SLO burn windows above ``slo_burn_rate``
``slo_exhausted``         the run's SLO error budget is spent (critical)
========================  =====================================================

Usage (the trainers' ``--watchdog``)::

    rec = telemetry.start("run.jsonl", watchdog=True)
    ...
    rec.close()
    print("health:", rec.watchdog.format_line())
"""

from __future__ import annotations

import math
import threading
from typing import Any, Dict, List, Optional

from .metrics import Rolling

__all__ = ["Watchdog", "attach", "RULE_NAMES"]

RULE_NAMES = ("nonfinite", "scale_collapse", "loader_stall", "step_time",
              "retrace_storm", "checkpoint_stall", "checkpoint_failed",
              "memory_headroom", "serving_queue_stall",
              "quant_scale_saturation", "slo_burn", "slo_exhausted")


class _Rule:
    """One stateful fold over the event stream.

    ``observe(event)`` returns None or an alert-field dict
    ``{"step", "message", "value"}``; severity and debouncing are the
    :class:`Watchdog`'s job."""

    name = "rule"
    severity = "warning"

    def observe(self, event: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        raise NotImplementedError


class _NonFinite(_Rule):
    name = "nonfinite"
    severity = "critical"

    def observe(self, event):
        if event.get("kind") != "metrics":
            return None
        loss = event.get("loss")
        if not loss:
            return None
        step0 = int(event.get("step", 0))
        for j, v in enumerate(loss):
            if not math.isfinite(v):
                return {"step": step0 + j, "value": repr(v),
                        "message": f"non-finite loss at step {step0 + j}"}
        return None


class _ScaleCollapse(_Rule):
    name = "scale_collapse"
    severity = "critical"

    def __init__(self, scale_floor: float = 1.0, max_skips: int = 4):
        self.scale_floor = scale_floor
        self.max_skips = max_skips
        self._streak = 0
        self._last_skip_step: Optional[int] = None

    def observe(self, event):
        if event.get("kind") != "scale":
            return None
        step = int(event.get("step", 0))
        if event.get("event") == "grow":
            self._streak = 0
            return None
        if event.get("event") != "skip":
            return None
        if self._last_skip_step is not None \
                and step == self._last_skip_step + 1:
            self._streak += 1
        else:
            self._streak = 1
        self._last_skip_step = step
        scale = float(event.get("scale", float("inf")))
        if scale <= self.scale_floor:
            return {"step": step, "value": scale,
                    "message": f"loss scale at floor ({scale:g} <= "
                               f"{self.scale_floor:g}) and still skipping"}
        if self._streak >= self.max_skips:
            return {"step": step, "value": self._streak,
                    "message": f"{self._streak} consecutive overflow "
                               f"skips (scale {scale:g}) — loss-scale "
                               f"collapse, not an isolated overflow"}
        return None


class _LoaderStall(_Rule):
    name = "loader_stall"

    def __init__(self, stall_pct: float = 30.0, window: int = 32):
        self.stall_pct = stall_pct
        self.window = max(2, int(window))
        # tumbling measurement window: evaluate once per `window`
        # loader_wait events, then reset BOTH the wait sum and the wall
        # anchor together — resetting only the anchor would divide a
        # full window of waits by one inter-event gap and over-report
        # the stall fraction ~window-fold.
        self._wait_s = 0.0
        self._n = 0
        self._t_first: Optional[float] = None

    def observe(self, event):
        kind = event.get("kind")
        if kind == "loader":
            pct = float((event.get("stats") or {})
                        .get("loader_stall_pct", 0.0))
            if pct > self.stall_pct:
                return {"step": None, "value": pct,
                        "message": f"loader stall {pct:.1f}% of wall "
                                   f"(> {self.stall_pct:.0f}%) — the input "
                                   f"engine is throttling the loop"}
            return None
        if kind != "loader_wait":
            return None
        t = float(event.get("t", 0.0))
        if self._t_first is None:
            self._t_first = t
        self._wait_s += float(event.get("dur", 0.0))
        self._n += 1
        if self._n < self.window:
            return None
        wall = t - self._t_first
        wait_s = self._wait_s
        self._t_first = t
        self._wait_s = 0.0
        self._n = 0
        if wall <= 0:
            return None
        pct = 100.0 * wait_s / wall
        if pct > self.stall_pct:
            return {"step": None, "value": round(pct, 1),
                    "message": f"train loop spent {pct:.1f}% of the last "
                               f"{wall:.1f}s waiting on the loader "
                               f"(> {self.stall_pct:.0f}%)"}
        return None


class _StepTime(_Rule):
    name = "step_time"

    def __init__(self, anomaly_factor: float = 3.0, window: int = 32,
                 min_samples: int = 8):
        self.anomaly_factor = anomaly_factor
        self.min_samples = min_samples
        self._baseline = Rolling(window)

    def observe(self, event):
        if event.get("kind") != "window":
            return None
        n = max(1, int(event.get("n_valid", 1)))
        per_step = (float(event.get("dur", 0.0))
                    + float(event.get("gap", 0.0))) / n
        baseline = self._baseline.median()
        ready = self._baseline.count >= self.min_samples
        # compare BEFORE folding the sample in, so the anomaly cannot
        # pull its own baseline up
        self._baseline.observe(per_step)
        if not ready or baseline is None or baseline <= 0:
            return None
        if per_step > self.anomaly_factor * baseline:
            return {"step": int(event.get("step", 0)),
                    "value": round(per_step * 1e3, 3),
                    "message": f"step time {per_step * 1e3:.1f} ms is "
                               f"{per_step / baseline:.1f}x the rolling "
                               f"median ({baseline * 1e3:.1f} ms) — host "
                               f"stall, sync, or preemption"}
        return None


class _RetraceStorm(_Rule):
    name = "retrace_storm"
    severity = "critical"

    def __init__(self, storm_count: int = 3, storm_steps: int = 128):
        self.storm_count = storm_count
        self.storm_steps = storm_steps
        self._steps: List[int] = []

    def observe(self, event):
        if event.get("kind") != "retrace":
            return None
        # only TRUE retraces count: not the first compile, not the
        # benign same-signature call-1 re-specialization
        if event.get("first") or not event.get("new_sig", True):
            return None
        step = int(event.get("step", 0))
        self._steps.append(step)
        self._steps = [s for s in self._steps
                       if step - s <= self.storm_steps]
        if len(self._steps) >= self.storm_count:
            return {"step": step, "value": len(self._steps),
                    "message": f"{len(self._steps)} true retraces within "
                               f"{self.storm_steps} steps — varying "
                               f"shapes/dtypes are recapturing the hot "
                               f"program"}
        return None


class _CheckpointStall(_Rule):
    """The async checkpoint engine's stall contract: the
    train loop should pay only the snapshot's D2H copy.  Fires when a
    ``checkpoint`` ``snapshot`` span exceeds ``ckpt_stall_s`` (the
    serialize/fsync work leaked back onto the loop thread, or the copy
    itself is drowning), or on a ``backlog`` event (the writer thread
    cannot keep up with the save cadence and the trigger is now
    blocking to bound host memory)."""

    name = "checkpoint_stall"

    def __init__(self, ckpt_stall_s: float = 2.0):
        self.ckpt_stall_s = ckpt_stall_s

    def observe(self, event):
        if event.get("kind") != "checkpoint":
            return None
        phase = event.get("phase")
        if phase == "backlog":
            return {"step": event.get("step"),
                    "value": event.get("value"),
                    "message": f"checkpoint writer backlog "
                               f"({event.get('value')} pending) — the "
                               f"save cadence outruns the writer thread "
                               f"and the snapshot trigger is blocking"}
        if phase != "snapshot":
            return None
        dur = float(event.get("dur", 0.0))
        if dur > self.ckpt_stall_s:
            return {"step": event.get("step"), "value": round(dur, 3),
                    "message": f"checkpoint snapshot stalled the loop "
                               f"{dur:.2f}s (> {self.ckpt_stall_s:.1f}s) "
                               f"— the D2H copy trigger is no longer "
                               f"cheap (serialize leaked onto the loop "
                               f"thread, or the state outgrew the link)"}
        return None


class _CheckpointFailed(_Rule):
    """A checkpoint write failed — the run is still training
    but its recovery point is stale; every further step widens the loss
    a preemption would cause.  Critical, debounced like the rest."""

    name = "checkpoint_failed"
    severity = "critical"

    def observe(self, event):
        if event.get("kind") != "checkpoint" \
                or event.get("phase") != "error":
            return None
        return {"step": event.get("step"),
                "value": event.get("error"),
                "message": f"checkpoint write FAILED "
                           f"({event.get('error')}) — the newest "
                           f"recovery point is stale; fix storage or "
                           f"drain now"}


class _MemoryHeadroom(_Rule):
    """Device memory kills runs first at scale, and instantly: by the
    time an OOM raises there is no stream left to warn from.  This rule
    fires from the ``memory`` events
    (:func:`apex_tpu_torch.prof.memory.record_memory`: the CUDA
    allocator's peak against the card's memory) whose free share drops
    under ``min_headroom_pct``.  Events without a limit (the CPU) fold to
    nothing."""

    name = "memory_headroom"

    def __init__(self, min_headroom_pct: float = 10.0):
        self.min_headroom_pct = float(min_headroom_pct)

    def observe(self, event):
        if event.get("kind") != "memory":
            return None
        headroom = event.get("headroom_pct")
        if headroom is None:
            limit = float(event.get("bytes_limit", 0) or 0)
            used = float(event.get("bytes_in_use", 0)
                         or event.get("peak_bytes", 0) or 0)
            if limit <= 0:
                return None
            headroom = 100.0 * max(0.0, 1.0 - used / limit)
        headroom = float(headroom)
        if headroom < self.min_headroom_pct:
            src = event.get("source") or event.get("phase") or "memory"
            return {"step": event.get("step"),
                    "value": round(headroom, 2),
                    "message": f"HBM headroom {headroom:.1f}% "
                               f"(< {self.min_headroom_pct:.0f}%) per "
                               f"{src} — the next growth (longer batch, "
                               f"retrace, fragmentation) OOMs; shrink "
                               f"the model/batch or shard further"}
        return None


class _ServingQueueStall(_Rule):
    """Request latency under load is queue wait + prefill + decode, and
    queue wait is the term that explodes when traffic outruns capacity
    (no free decode slots or KV pages).  The serving engine stamps every
    admission with the request's measured queue wait; this rule fires
    when one exceeds ``serving_stall_s`` — the "scale out or shed load"
    signal, debounced like the rest."""

    name = "serving_queue_stall"

    def __init__(self, serving_stall_s: float = 2.0):
        self.serving_stall_s = float(serving_stall_s)

    def observe(self, event):
        if event.get("kind") != "serving" \
                or event.get("phase") != "admit":
            return None
        wait = float(event.get("queue_wait", 0.0) or 0.0)
        if wait <= self.serving_stall_s:
            return None
        return {"step": None, "value": round(wait, 3),
                "message": f"request waited {wait:.2f}s in the serving "
                           f"queue (> {self.serving_stall_s:.1f}s) — "
                           f"traffic is outrunning decode slots/KV "
                           f"pages; add capacity or shed load"}


class _QuantScaleSaturation(_Rule):
    """The int8 engine's staleness alarm: frozen calibration
    scales are a bet that the observed activation range keeps holding.
    :meth:`apex_tpu_torch.quant.calibrate.Calibration.note_saturation` emits a
    ``quant`` event whenever fetched runtime absmax checks find the
    range exceeded; this rule fires when one window's ``exceeded``
    count passes ``quant_max_exceeded`` — isolated single clips are the
    normal tail LLM.int8()-style percentile calibration accepts, a
    burst means the distribution moved and accuracy is silently
    degrading.  Warning severity: the run is still numerically valid
    (clipping, not NaN), the fix is a re-observation pass."""

    name = "quant_scale_saturation"

    def __init__(self, quant_max_exceeded: int = 4):
        self.quant_max_exceeded = int(quant_max_exceeded)

    def observe(self, event):
        if event.get("kind") != "quant" \
                or event.get("phase") != "saturation":
            return None
        exceeded = int(event.get("exceeded", 0) or 0)
        if exceeded <= self.quant_max_exceeded:
            return None
        name = event.get("name", "?")
        win = event.get("window")
        return {"step": event.get("step"), "value": exceeded,
                "message": f"quant site {name!r} exceeded its calibrated "
                           f"absmax {exceeded} times"
                           f"{f' in {win} steps' if win else ''} "
                           f"(> {self.quant_max_exceeded}) — the frozen "
                           f"int8 range is stale; re-observe and "
                           f"re-freeze the calibration"}


class _SLOBurn(_Rule):
    """The serving SLO's sustained burn alarm: the
    :class:`apex_tpu_torch.telemetry.slo.SLOEngine` folds ``done`` events
    into short/long-window burn rates and emits ``slo`` evaluations;
    this rule fires when BOTH windows burn above ``slo_burn_rate`` —
    the short window makes the alert fast, the long window makes it
    evidence of a trend rather than one slow request (the standard
    multi-window burn-rate page).  Warning severity: the budget is
    being spent, not yet gone."""

    name = "slo_burn"

    def __init__(self, slo_burn_rate: float = 1.0):
        self.slo_burn_rate = float(slo_burn_rate)

    def observe(self, event):
        if event.get("kind") != "slo" or event.get("phase") != "eval":
            return None
        short = float(event.get("burn_short", 0.0) or 0.0)
        long_ = float(event.get("burn_long", 0.0) or 0.0)
        if short <= self.slo_burn_rate or long_ <= self.slo_burn_rate:
            return None
        return {"step": None, "value": round(long_, 3),
                "message": f"SLO error budget burning {short:.1f}x/"
                           f"{long_:.1f}x (short/long windows, both > "
                           f"{self.slo_burn_rate:g}x) — goodput "
                           f"{event.get('goodput_pct')}% vs target "
                           f"{event.get('target_pct')}%"}


class _SLOExhausted(_Rule):
    """The run-level SLO budget is spent: the bad fraction
    over EVERYTHING served exceeds the allowance, so no remaining
    traffic mix can bring this run back inside its target — the
    scale-out/shed-load page.  Critical, debounced like the rest."""

    name = "slo_exhausted"
    severity = "critical"

    def observe(self, event):
        if event.get("kind") != "slo" or event.get("phase") != "eval" \
                or not event.get("exhausted"):
            return None
        return {"step": None, "value": event.get("goodput_pct"),
                "message": f"SLO error budget EXHAUSTED: "
                           f"{event.get('bad')}/{event.get('n')} requests "
                           f"out of SLO (target "
                           f"{event.get('target_pct')}%) — the run can "
                           f"no longer meet its objectives; shed load "
                           f"or add capacity"}


class Watchdog:
    """Folds recorder events through the rule set and emits debounced
    ``alert`` events back into the same stream.

    Attach with :func:`attach` (or ``telemetry.start(path,
    watchdog=True)``).  ``observe`` is called by the recorder after
    every written event, on the emitting thread, under this object's
    own lock (producers span the train loop and the loader threads).
    Alerts are both written to the stream and kept in :attr:`alerts`
    for the end-of-run ``health:`` line."""

    def __init__(self, recorder=None, *, debounce_steps: int = 64,
                 rules: Optional[List[_Rule]] = None, **thresholds):
        self._recorder = recorder
        self.debounce_steps = int(debounce_steps)
        if rules is None:
            rules = [
                _NonFinite(),
                _ScaleCollapse(
                    scale_floor=thresholds.get("scale_floor", 1.0),
                    max_skips=thresholds.get("max_skips", 4)),
                _LoaderStall(
                    stall_pct=thresholds.get("stall_pct", 30.0)),
                _StepTime(
                    anomaly_factor=thresholds.get("anomaly_factor", 3.0),
                    min_samples=thresholds.get("min_samples", 8)),
                _RetraceStorm(
                    storm_count=thresholds.get("storm_count", 3),
                    storm_steps=thresholds.get("storm_steps", 128)),
                _CheckpointStall(
                    ckpt_stall_s=thresholds.get("ckpt_stall_s", 2.0)),
                _CheckpointFailed(),
                _MemoryHeadroom(
                    min_headroom_pct=thresholds.get(
                        "min_headroom_pct", 10.0)),
                _ServingQueueStall(
                    serving_stall_s=thresholds.get(
                        "serving_stall_s", 2.0)),
                _QuantScaleSaturation(
                    quant_max_exceeded=thresholds.get(
                        "quant_max_exceeded", 4)),
                _SLOBurn(
                    slo_burn_rate=thresholds.get("slo_burn_rate", 1.0)),
                _SLOExhausted(),
            ]
        self.rules = rules
        self.alerts: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self._last_fired: Dict[str, float] = {}   # rule -> step (or count)
        self._events_seen = 0

    def observe(self, event: Dict[str, Any]) -> None:
        """Fold one already-written event (never an ``alert``) through
        every rule; emit debounced alerts.  Swallows nothing silently —
        a rule raising is a bug, but it must not kill the training run,
        so it degrades to an ``alert`` about the watchdog itself."""
        fired: List[Dict[str, Any]] = []
        with self._lock:
            self._events_seen += 1
            for rule in self.rules:
                try:
                    hit = rule.observe(event)
                except Exception as e:       # pragma: no cover - rule bug
                    hit = {"step": None, "value": None,
                           "message": f"watchdog rule crashed: "
                                      f"{type(e).__name__}: {e}"}
                if hit is None:
                    continue
                # Debounce on the global step when the alert has one,
                # else on the event count — one alert per rule per
                # debounce window keeps a wedged run's stream readable.
                clock = (float(hit["step"]) if hit.get("step") is not None
                         else float(self._events_seen))
                last = self._last_fired.get(rule.name)
                if last is not None and clock - last < self.debounce_steps:
                    continue
                self._last_fired[rule.name] = clock
                alert = {"rule": rule.name, "severity": rule.severity,
                         **{k: v for k, v in hit.items() if v is not None}}
                self.alerts.append(alert)
                fired.append(alert)
        # Emit OUTSIDE the fold lock; Recorder.event skips kind="alert"
        # on the observe hook, so this cannot recurse.
        rec = self._recorder
        if rec is not None:
            for alert in fired:
                rec.event("alert", **alert)

    # -- end-of-run summary ---------------------------------------------------

    def health(self) -> Dict[str, Any]:
        """``{"ok", "alerts", "by_rule", "worst"}`` — the dict the
        recorder folds into its final ``summary`` event."""
        with self._lock:
            alerts = list(self.alerts)
        by_rule: Dict[str, int] = {}
        worst = None
        for a in alerts:
            by_rule[a["rule"]] = by_rule.get(a["rule"], 0) + 1
            if a["severity"] == "critical":
                worst = "critical"
            elif worst is None:
                worst = "warning"
        return {"ok": not alerts, "alerts": len(alerts),
                "by_rule": by_rule, "worst": worst}

    def format_line(self) -> str:
        """One-line ``health:`` summary the examples print at exit."""
        h = self.health()
        if h["ok"]:
            return "ok (0 alerts)"
        rules = ", ".join(f"{k} x{v}" for k, v in sorted(h["by_rule"].items()))
        return f"{h['worst'].upper()} — {h['alerts']} alert(s): {rules}"


def attach(recorder, **kwargs) -> Watchdog:
    """Build a :class:`Watchdog` and hook it onto ``recorder`` (every
    subsequently written event is folded online).  Returns the watchdog;
    threshold kwargs are forwarded to the default rule set."""
    wd = Watchdog(recorder, **kwargs)
    recorder.attach_watchdog(wd)
    return wd
