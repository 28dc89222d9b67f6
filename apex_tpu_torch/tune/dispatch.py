"""The dispatch-time consult: the hot-path half of the tuner.

Counterpart of ``apex_tpu/tune/dispatch.py``.  Each tunable kernel's
wrapper calls :func:`kernel_config` when the caller left its tile
arguments at None and the call runs the kernel (a CUDA tensor): never on
the CPU, never for the plain version.  A hit returns the cached config of
this card; a miss, or any cache problem, returns None and the kernel runs
its rule's tile, so the cache can only choose among tiles the kernel
has, never break a call.  Dispatch only reads: tuning is an explicit
:func:`apex_tpu_torch.tune.measure.tune_kernel` or CLI run.

JAX consults once per trace; the port's wrappers run every eager step,
so the consult is memoized in the process per ``(kernel, version,
bucket, params)``: after its first, a consult is one dict lookup and a
counter.  The memo is dropped when the store's view moves
(``store._STATE["gen"]``: a write, a reload, a new default directory) and by :func:`reset_stats`; a change of
``APEX_TPU_TUNE_CACHE`` alone is seen after one of those.  A CUDA graph
keeps the tile it was captured with: its replays launch what the capture
recorded, whatever the cache says later.

Telemetry: a fresh consult (the first of a key, or after the memo
dropped) sets the ``tuned_kernel_pct`` gauge of the active recorder (the
share of consulted kernels whose latest fresh consult hit), and the
first consult of each ``(kernel, bucket)`` in the process emits one
``tune`` event with ``phase="dispatch"``, as in JAX.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

from . import store

__all__ = ["kernel_config", "dispatch_stats", "reset_stats",
           "coverage_line"]

_lock = threading.Lock()
#: latest fresh consult's outcome per kernel (True: a tuned config)
_LATEST: Dict[str, bool] = {}
#: cumulative consult counters per kernel
_COUNTS: Dict[str, Dict[str, int]] = {}
#: (kernel, bucket) pairs already announced by a ``tune`` event
_ANNOUNCED: set = set()
#: (kernel, version, bucket, params) -> (config or None, counters, slot)
_MEMO: Dict[tuple, tuple] = {}
_MEMO_GEN = [-1]


def _valid(cfg, params) -> bool:
    """JAX's checks: the entry's keys are exactly ``params`` and every
    value a positive int (a JSON ``true`` is an int subclass: refused)."""
    return set(cfg) == set(params) and all(
        isinstance(v, int) and not isinstance(v, bool) and v > 0
        for v in cfg.values())


def kernel_config(kernel: str, version: int, bucket, *,
                  params: Tuple[str, ...] = (), key=None
                  ) -> Optional[Dict[str, int]]:
    """The tuned config for ``(this card, kernel, version, bucket)``, or
    None (run the rule).  With ``params``, an entry whose key set
    differs (a partial entry, a hand-edited extra key) or with a bool or
    non-positive value is a miss.  ``bucket`` may be a function giving
    the bucket string, called only when the memo misses; then ``key``
    (the call's shape, hashable) keys the memo, so a repeated consult
    builds no string.  The returned dict is shared by every consult of
    the key: read it, do not change it.  Never raises."""
    memo_key = (kernel, version, bucket if key is None else key, params)
    if _MEMO_GEN[0] == store._STATE["gen"]:
        ent = _MEMO.get(memo_key)
        if ent is not None:
            ent[1][ent[2]] += 1
            return ent[0]
    if callable(bucket):
        bucket = bucket()
    cfg = store.lookup(kernel, version, bucket)
    if cfg is not None and params and not _valid(cfg, params):
        cfg = None
    hit = cfg is not None
    slot = "hits" if hit else "misses"
    with _lock:
        if _MEMO_GEN[0] != store._STATE["gen"]:
            _MEMO.clear()
            _MEMO_GEN[0] = store._STATE["gen"]
        _LATEST[kernel] = hit
        counts = _COUNTS.setdefault(kernel, {"hits": 0, "misses": 0})
        counts[slot] += 1
        _MEMO[memo_key] = (cfg, counts, slot)
        pct = 100.0 * sum(_LATEST.values()) / len(_LATEST)
        announce = (kernel, bucket) not in _ANNOUNCED
        if announce:
            _ANNOUNCED.add((kernel, bucket))
    try:
        from ..telemetry import get_recorder
        rec = get_recorder()
        if rec is not None:
            rec.metrics.gauge("tuned_kernel_pct").set(pct)
            if announce:
                rec.event("tune", phase="dispatch", kernel=kernel,
                          bucket=bucket, hit=hit,
                          config=(dict(cfg) if cfg else None))
    except Exception:           # telemetry must never break dispatch
        pass
    return cfg


def dispatch_stats() -> Dict[str, object]:
    """Consult counters, ``{"tuned_kernel_pct", "by_kernel": {name:
    {"hits", "misses", "tuned"}}, "consulted": [[kernel, bucket], ...]}``:
    what the gauge reports, readable without a recorder (the trainers'
    closing ``tune:`` line, tests), and every bucket consulted since
    :func:`reset_stats`."""
    with _lock:
        by = {k: {"hits": v["hits"], "misses": v["misses"],
                  "tuned": _LATEST.get(k, False)}
              for k, v in _COUNTS.items()}
        pct = (100.0 * sum(_LATEST.values()) / len(_LATEST)
               if _LATEST else None)
        consulted = sorted([k, b] for k, b in _ANNOUNCED)
    return {"tuned_kernel_pct": pct, "by_kernel": by,
            "consulted": consulted}


def reset_stats() -> None:
    """Clear the counters, the announcements and the memo."""
    with _lock:
        _LATEST.clear()
        _COUNTS.clear()
        _ANNOUNCED.clear()
        _MEMO.clear()
        _MEMO_GEN[0] = -1


def coverage_line() -> Optional[str]:
    """The trainers' closing ``tune:`` line (JAX's ImageNet example's):
    the share of consulted kernels that ran a tuned config, and which;
    None when no kernel consulted."""
    ts = dispatch_stats()
    if not ts["by_kernel"]:
        return None
    tuned = sorted(k for k, v in ts["by_kernel"].items() if v["tuned"])
    hits = sum(v["hits"] for v in ts["by_kernel"].values())
    consults = hits + sum(v["misses"] for v in ts["by_kernel"].values())
    return (f"tune: {ts['tuned_kernel_pct']:.0f}% of consulted kernels "
            f"tuned ({', '.join(tuned) or 'none'}); {hits} of {consults} "
            f"consults hit")
