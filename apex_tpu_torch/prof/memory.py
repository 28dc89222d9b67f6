"""Live device memory — counterpart of the live half of
``apex_tpu/prof/memory.py`` (its ``device_memory``,
``update_device_memory_gauges`` and ``record_memory``).

Each function reads the CUDA caching allocator
(``torch.cuda.memory_allocated`` / ``max_memory_allocated``) and the
card's size (``get_device_properties(...).total_memory``): host reads
that synchronize nothing, made only for devices this process already
initialized, so no call here creates a CUDA context.  On the CPU there
is nothing to read and each returns empty.

The XLA memory ledger of the JAX module (``harvest_memory``,
``live_buffer_walk``, ``stats_from_analysis``) is not ported yet
(ROADMAP queue 1 item 2, the ``prof`` slice, on ``torch.profiler``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

__all__ = ["device_memory", "update_device_memory_gauges", "record_memory"]


def device_memory() -> List[Dict[str, Any]]:
    """Per-device allocator numbers of this process:
    ``[{"id", "kind", "bytes_in_use", "bytes_limit",
    "peak_bytes_in_use"}]`` (bytes), empty on the CPU or before CUDA is
    initialized."""
    out: List[Dict[str, Any]] = []
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return out
    for i in range(torch.cuda.device_count()):
        props = torch.cuda.get_device_properties(i)
        out.append({"id": i, "kind": props.name,
                    "bytes_in_use": int(torch.cuda.memory_allocated(i)),
                    "bytes_limit": int(props.total_memory),
                    "peak_bytes_in_use": int(
                        torch.cuda.max_memory_allocated(i))})
    return out


def update_device_memory_gauges(recorder) -> bool:
    """Publish the devices' summed memory into the recorder's registry
    (``hbm_bytes_in_use``, ``hbm_peak_bytes_in_use`` as a high-water
    mark, ``hbm_bytes_limit``, ``hbm_headroom_pct``: the JAX package's
    gauge names).  Returns True when there was a device to read."""
    devs = device_memory()
    if not devs:
        return False
    in_use = sum(d["bytes_in_use"] for d in devs)
    limit = sum(d["bytes_limit"] for d in devs)
    recorder.metrics.gauge("hbm_bytes_in_use").set(in_use)
    recorder.metrics.gauge("hbm_peak_bytes_in_use").set_max(
        sum(d["peak_bytes_in_use"] or d["bytes_in_use"] for d in devs))
    if limit:
        recorder.metrics.gauge("hbm_bytes_limit").set(limit)
        recorder.metrics.gauge("hbm_headroom_pct").set(
            100.0 * max(0.0, 1.0 - in_use / limit))
    return True


def record_memory(recorder, stats: dict,
                  limit_bytes: Optional[int] = None,
                  **fields) -> Optional[dict]:
    """Emit one ``memory`` event (``phase="harvest"``) with ``stats``
    (a byte dict with ``peak_bytes``, e.g.
    :meth:`apex_tpu_torch.runtime.StepPipeline.memory_stats`): the event
    the ``memory_headroom`` watchdog rule folds.  ``limit_bytes``
    defaults to the smallest card's memory (a peak is one card's
    footprint); with a limit the event carries ``headroom_pct``.  The
    ``peak_hbm_bytes`` gauge keeps the highest peak recorded.  Returns
    the event's fields (None with no recorder)."""
    if recorder is None:
        return None
    stats = dict(stats)
    if limit_bytes is None:
        limits = [d["bytes_limit"] for d in device_memory()
                  if d["bytes_limit"]]
        limit_bytes = min(limits) if limits else None
    ev = {"phase": "harvest", **stats, **fields}
    if limit_bytes:
        ev["bytes_limit"] = int(limit_bytes)
        ev["headroom_pct"] = round(
            100.0 * max(0.0, 1.0 - stats.get("peak_bytes", 0)
                        / limit_bytes), 2)
    recorder.metrics.gauge("peak_hbm_bytes").set_max(
        stats.get("peak_bytes", 0))
    recorder.event("memory", **ev)
    return ev
