"""Metrics registry: counters, gauges and reservoir histograms —
counterpart of ``apex_tpu/telemetry/metrics.py``.

The host-side half of the run telemetry: named instruments a run bumps
from any thread, snapshotted into the stream's final ``summary`` event
and rendered by the Prometheus exporter.  Device values never enter the
registry directly: they ride the one read a
:class:`~apex_tpu_torch.runtime.DeferredMetrics` already makes
(:meth:`apex_tpu_torch.telemetry.Recorder.observe_window_metrics`), so
recording adds no read of its own.

Histograms keep a bounded uniform reservoir (Algorithm R) whose RNG is
seeded by the crc32 of the instrument's name, as the JAX package's is,
so the same observations give the same percentiles in both packages.
A registry built with ``enabled=False`` hands out one shared no-op
instrument.
"""

from __future__ import annotations

import bisect
import random
import threading
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "Rolling",
           "nearest_rank_percentiles", "LATENCY_BUCKETS_S",
           "default_buckets"]

#: Fixed cumulative-histogram bounds (seconds) every ``*_s`` latency
#: histogram gets by default: log-ish spacing from
#: 1 ms to 60 s.  FIXED per histogram for the whole run — Prometheus
#: ``_bucket{le=...}`` series are only rate()-able when the bounds
#: never move under the scraper.
LATENCY_BUCKETS_S: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


def default_buckets(name: str) -> Optional[Tuple[float, ...]]:
    """The fixed bucket bounds a histogram named ``name`` gets when the
    caller supplies none: seconds-valued instruments (``*_s``) take
    :data:`LATENCY_BUCKETS_S`; everything else keeps reservoir-only
    percentiles (no ``_bucket`` exposition)."""
    return LATENCY_BUCKETS_S if name.endswith("_s") else None


def nearest_rank_percentiles(samples: Sequence[float],
                             qs: Sequence[float] = (50.0, 90.0, 99.0)
                             ) -> List[Optional[float]]:
    """Nearest-rank percentiles of a sample list ([] -> all None) — the
    ONE percentile definition shared by :class:`Histogram` reservoirs
    and the offline timeline analyzer, so in-run summaries and offline
    reports can never diverge on interpolation."""
    data = sorted(samples)
    if not data:
        return [None for _ in qs]
    out = []
    for q in qs:
        idx = min(len(data) - 1,
                  max(0, int(round(q / 100.0 * (len(data) - 1)))))
        out.append(data[idx])
    return out


class Counter:
    """Monotonic counter (events seen, batches delivered, skips fired)."""

    __slots__ = ("_v", "_lock")

    def __init__(self):
        self._v = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> int:
        return self._v

    def snapshot(self):
        return self._v


class Gauge:
    """Last-value-wins instrument (current loss scale, queue depth).

    :meth:`set_max` is the high-water-mark variant the memory gauges use:
    a live ``bytes_in_use`` poll naturally dips, but a
    *peak* gauge must never regress — ``peak_hbm_bytes`` keeps the
    highest harvest the run ever recorded, across pipelines and
    re-harvests alike."""

    __slots__ = ("_v", "_lock")

    def __init__(self):
        self._v: Optional[float] = None
        self._lock = threading.Lock()

    def set(self, v) -> None:
        # plain set is last-value-wins by contract: a single float
        # assignment, no lock on the hot path
        self._v = float(v)

    def set_max(self, v) -> None:
        """Monotonic set: keep ``max(current, v)``.  Locked — the
        compare-and-set races otherwise (exporter render threads and
        the loop thread both publish peaks) and a stale writer could
        regress the high-water mark it promises never regresses."""
        v = float(v)
        with self._lock:
            if self._v is None or v > self._v:
                self._v = v

    @property
    def value(self) -> Optional[float]:
        return self._v

    def snapshot(self):
        return self._v


class Histogram:
    """Streaming distribution with reservoir percentiles.

    Exact ``count``/``sum``/``min``/``max``; percentiles come from a
    bounded uniform reservoir (Algorithm R), so p50/p90/p99 over an
    unbounded stream cost O(reservoir) memory.  The replacement RNG is
    seeded per instrument — re-analyzing the same run reproduces the
    same percentiles bit for bit.

    ``buckets`` (optional, sorted upper bounds) additionally keeps
    EXACT per-bucket counts, so the Prometheus exporter can render a
    true cumulative ``_bucket{le=...}`` family external alerting can
    ``rate()`` — something the reservoir cannot reconstruct.  The bounds are fixed for the instrument's lifetime.
    """

    __slots__ = ("_lock", "_res", "_cap", "_rng", "count", "sum",
                 "min", "max", "_bounds", "_bucket_counts")

    def __init__(self, reservoir: int = 512, seed: int = 0,
                 buckets: Optional[Sequence[float]] = None):
        self._lock = threading.Lock()
        self._res: List[float] = []
        self._cap = max(1, int(reservoir))
        self._rng = random.Random(seed)
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._bounds: Optional[Tuple[float, ...]] = (
            tuple(sorted(float(b) for b in buckets)) if buckets else None)
        # one slot per bound plus the +Inf overflow slot
        self._bucket_counts: Optional[List[int]] = (
            [0] * (len(self._bounds) + 1) if self._bounds else None)

    def observe(self, v) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            if self._bucket_counts is not None:
                self._bucket_counts[
                    bisect.bisect_left(self._bounds, v)] += 1
            if len(self._res) < self._cap:
                self._res.append(v)
            else:
                j = self._rng.randrange(self.count)
                if j < self._cap:
                    self._res[j] = v

    def bucket_counts(self):
        """``(bounds, cumulative_counts)`` — counts[i] is the number of
        observations ``<= bounds[i]`` (the Prometheus ``le`` contract;
        the implicit ``+Inf`` bucket is :attr:`count`).  ``None`` when
        the instrument was built without bounds."""
        if self._bounds is None:
            return None
        with self._lock:
            raw = list(self._bucket_counts)
        cum, running = [], 0
        for c in raw[:-1]:
            running += c
            cum.append(running)
        return self._bounds, cum

    def percentiles(self, qs: Sequence[float] = (50.0, 90.0, 99.0)):
        """Reservoir percentiles (nearest-rank); [] -> all None."""
        with self._lock:
            data = list(self._res)
        return nearest_rank_percentiles(data, qs)

    @property
    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None

    def snapshot(self):
        p50, p90, p99 = self.percentiles((50.0, 90.0, 99.0))
        out = {"count": self.count,
               "sum": round(self.sum, 6),
               "min": self.min, "max": self.max,
               "mean": (round(self.mean, 6)
                        if self.count else None),
               "p50": p50, "p90": p90, "p99": p99}
        bc = self.bucket_counts()
        if bc is not None:
            out["buckets"] = {"le": list(bc[0]), "counts": bc[1]}
        return out


class Rolling:
    """Fixed-window rolling statistics — the last ``window``
    observations only.

    The :mod:`~apex_tpu_torch.telemetry.watchdog` anomaly rules compare each
    fresh sample against a ROLLING baseline (median of the recent past),
    which a :class:`Histogram` reservoir cannot provide: a reservoir
    remembers the whole run, so a step-time regression an hour in would
    be judged against hour-old samples and never look anomalous.  Median
    (not mean) so the compile-sized outliers that seed the window do not
    drag the baseline."""

    __slots__ = ("_buf", "_cap", "_idx", "count")

    def __init__(self, window: int = 32):
        self._buf: List[float] = []
        self._cap = max(1, int(window))
        self._idx = 0
        self.count = 0

    def observe(self, v) -> None:
        v = float(v)
        self.count += 1
        if len(self._buf) < self._cap:
            self._buf.append(v)
        else:
            self._buf[self._idx] = v
            self._idx = (self._idx + 1) % self._cap
    # NOTE: single-consumer by design (the watchdog folds on whichever
    # thread emitted the event, under the Watchdog lock) — no lock here.

    @property
    def full(self) -> bool:
        return len(self._buf) >= self._cap

    def median(self) -> Optional[float]:
        if not self._buf:
            return None
        return nearest_rank_percentiles(self._buf, (50.0,))[0]

    @property
    def mean(self) -> Optional[float]:
        return sum(self._buf) / len(self._buf) if self._buf else None

    @property
    def total(self) -> float:
        return sum(self._buf)


class _NoopInstrument:
    """Shared disabled instrument: accepts every instrument method as a
    no-op, so disabled-registry call sites stay guard-free."""

    __slots__ = ()
    value = None
    count = 0
    mean = None

    def inc(self, n: int = 1) -> None:
        pass

    def set(self, v) -> None:
        pass

    def set_max(self, v) -> None:
        pass

    def observe(self, v) -> None:
        pass

    def percentiles(self, qs=(50.0, 90.0, 99.0)):
        return [None for _ in qs]

    def snapshot(self):
        return None


_NOOP = _NoopInstrument()


class MetricsRegistry:
    """Named instrument factory + snapshot.

    ``counter(name)`` / ``gauge(name)`` / ``histogram(name)`` create on
    first use and return the same instrument afterwards (thread-safe).
    ``enabled=False`` makes every accessor return the shared no-op
    instrument — the strict-no-op contract of the disabled telemetry
    path.
    """

    def __init__(self, enabled: bool = True, reservoir: int = 512):
        self.enabled = bool(enabled)
        self._reservoir = reservoir
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}

    def _get(self, table, name: str, factory):
        if not self.enabled:
            return _NOOP
        with self._lock:
            inst = table.get(name)
            if inst is None:
                inst = table[name] = factory()
            return inst

    def counter(self, name: str):
        return self._get(self._counters, name, Counter)

    def gauge(self, name: str):
        return self._get(self._gauges, name, Gauge)

    def histogram(self, name: str,
                  buckets: Optional[Sequence[float]] = None):
        # Deterministic per-name seed (crc32, not hash(): str hashing is
        # salted per process): same run, same reservoir.  Bucket bounds
        # bind on FIRST creation (fixed-per-histogram contract); omitted,
        # `*_s` names get the shared latency ladder (default_buckets).
        import zlib
        if buckets is None:
            buckets = default_buckets(name)
        return self._get(
            self._hists, name,
            lambda: Histogram(self._reservoir,
                              seed=zlib.crc32(name.encode()),
                              buckets=buckets))

    def snapshot(self) -> dict:
        """One nested dict of every instrument's current value."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._hists)
        return {
            "counters": {k: v.snapshot() for k, v in counters.items()},
            "gauges": {k: v.snapshot() for k, v in gauges.items()},
            "histograms": {k: v.snapshot() for k, v in hists.items()},
        }
