"""The device-memory ledger and the live memory reads — counterpart of
``apex_tpu/prof/memory.py``.

1. **the walk** (:func:`live_buffer_walk`) — the analytic walk of
   :mod:`.analysis` over one call on fake tensors, keeping each storage
   live from the op that makes it until its last reference dies (a
   storage the call did not make — an argument or a closed-over
   parameter — lives throughout), and recording the running total's peak
   and the live set at the peak, each storage attributed to the
   :func:`~apex_tpu_torch.prof.capture.region_path` region that made it
   (a backward op's region is its forward's).  Nothing runs on a device.
2. **the allocator** — on the card, :func:`harvest_memory` with
   ``xla=True`` (JAX's "ask the runtime") runs the call ONCE for real
   under ``torch.cuda.reset_peak_memory_stats`` and the allocator's
   history: its peak is ``torch.cuda.max_memory_allocated`` of that call,
   and the history replayed gives the peak of the bytes its tensors
   asked for, before the allocator rounds them up to its blocks
   (:func:`stats_from_snapshot`; the walk counts the same bytes).  That
   call consumes what the call consumes: pass a state it can spend.
3. **the join** — :func:`apex_tpu_torch.prof.roofline.mfu_ledger` takes
   ``memory=`` and adds the peak column, per region from the walk.
4. **live reads** — :func:`device_memory`,
   :func:`update_device_memory_gauges` and :func:`record_memory` read the CUDA caching allocator
   (``memory_allocated``/``max_memory_allocated``) and the card's size:
   host reads that synchronize nothing, made only for devices this
   process already initialized, so none creates a CUDA context.  On the
   CPU there is nothing to read and each returns empty.

CLI::

    python -m apex_tpu_torch.prof.memory --fn mymod:make_step [--json]
"""

from __future__ import annotations

import json
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import torch

from .capture import region_path

__all__ = ["MemoryHarvest", "harvest_memory", "live_buffer_walk",
           "stats_from_snapshot", "format_harvest", "device_memory",
           "update_device_memory_gauges", "record_memory", "main"]


@dataclass
class MemoryHarvest:
    """One call's memory ledger.

    ``peak_bytes`` is the headline: the allocator's peak over one real
    call on the card (``source="allocator"``), else the walk's peak
    (``source="walk"``).  ``walk_peak_bytes`` is always the walk's.
    ``by_region`` maps each region to the bytes of its storages live at
    the walk's peak, ``top_allocations`` the largest of them.
    ``requested_peak_bytes`` (the allocator only) is the peak of the
    call's history replayed in requested bytes: the allocator's own
    account of what the walk counts, and a bound of ``peak_bytes``
    from below."""
    peak_bytes: int
    argument_bytes: int
    output_bytes: int
    temp_bytes: int
    generated_code_bytes: int
    source: str                  # "allocator" | "walk"
    walk_peak_bytes: int
    by_region: Dict[str, int] = field(default_factory=dict)
    top_allocations: List[Dict[str, Any]] = field(default_factory=list)
    requested_peak_bytes: Optional[int] = None

    @property
    def peak_gb(self) -> float:
        return self.peak_bytes / 1e9


def _storage_bytes(tensors, skip=()) -> int:
    seen, total = set(skip), 0
    for t in tensors:
        s = t.untyped_storage()
        if s._cdata not in seen:
            seen.add(s._cdata)
            total += s.nbytes()
    return total


def live_buffer_walk(fn, *args, region_depth: int = 1, top: int = 8,
                     **kwargs) -> Dict[str, Any]:
    """The walk of one call of ``fn(*args, **kwargs)`` (the module
    docstring): ``{"peak_bytes", "argument_bytes", "output_bytes",
    "by_region", "top_allocations"}``; ``<arguments>`` holds the
    storages the call did not make."""
    from .analysis import _Walk, _run

    walk = _run(fn, args, kwargs, _Walk(memory=True))
    by_region: Dict[str, int] = {}
    allocs: List[Dict[str, Any]] = []
    for nbytes, region, shape, dtype in walk.snap.values():
        if region != "<arguments>":
            region = region_path(region, depth=region_depth)
        by_region[region] = by_region.get(region, 0) + nbytes
        allocs.append({"bytes": int(nbytes), "region": region,
                       "shape": list(shape), "dtype": dtype})
    allocs.sort(key=lambda a: -a["bytes"])
    arg_bytes = sum(e[0] for e in walk.arguments.values())
    out_bytes = _storage_bytes(walk.outputs, skip=walk.arguments)
    return {"peak_bytes": int(walk.peak), "argument_bytes": int(arg_bytes),
            "output_bytes": int(out_bytes), "by_region": by_region,
            "top_allocations": allocs[:max(1, top)]}


def stats_from_snapshot(snapshot, *, peak_bytes: int, argument_bytes: int,
                        output_bytes: int, requested_bytes: int = 0
                        ) -> Optional[Dict[str, int]]:
    """One call's allocator record -> JAX's byte dict (``argument``,
    ``output``, ``temp``, ``generated_code``, ``alias`` and ``peak``
    bytes): ``peak_bytes`` is ``max_memory_allocated`` over the call,
    ``argument_bytes`` what was allocated before it, temps the rest of
    the peak.  ``snapshot`` (``torch.cuda.memory._snapshot()`` with the
    call's history recorded) adds ``allocations``, the number of blocks
    the call allocated, and ``requested_peak_bytes``: the history
    replayed (each ``alloc`` adds its requested size, each
    ``free_requested`` takes it away) from ``requested_bytes``, the
    requested bytes live before the call, at its highest.  None when
    it recorded no allocation."""
    allocs, live = 0, int(requested_bytes)
    requested_peak = live
    for trace in snapshot.get("device_traces", []):
        for ev in trace:
            if ev.get("action") == "alloc":
                allocs += 1
                live += ev["size"]
                requested_peak = max(requested_peak, live)
            elif ev.get("action") == "free_requested":
                live -= ev["size"]
    if not allocs and not peak_bytes:
        return None
    return {"argument_bytes": int(argument_bytes),
            "output_bytes": int(output_bytes),
            "temp_bytes": max(0, int(peak_bytes) - int(argument_bytes)
                              - int(output_bytes)),
            "generated_code_bytes": 0, "alias_bytes": 0,
            "peak_bytes": int(peak_bytes), "allocations": allocs,
            "requested_peak_bytes": requested_peak}


def _cuda_device(args, kwargs) -> Optional[torch.device]:
    from .analysis import _tensors
    for t in _tensors((args, kwargs)):
        if t.is_cuda:
            return t.device
    return None


def _allocator_memory(fn, dev, args, kwargs) -> Optional[Dict[str, int]]:
    """Run ``fn`` once on the card under the allocator's peak and
    history (see :func:`harvest_memory`)."""
    from .analysis import _tensors
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    requested = torch.cuda.memory_stats(dev).get(
        "requested_bytes.all.current", 0)
    arg_keys = {t.untyped_storage()._cdata for t in _tensors((args, kwargs))}
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.memory._record_memory_history(context=None,
                                             max_entries=1_000_000)
    try:
        out = fn(*args, **kwargs)
        torch.cuda.synchronize(dev)
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    peak = torch.cuda.max_memory_allocated(dev)
    outs = _storage_bytes(_tensors(out), skip=arg_keys)
    return stats_from_snapshot(snap, peak_bytes=peak, argument_bytes=before,
                               output_bytes=outs, requested_bytes=requested)


def harvest_memory(fn, *args, xla: bool = False, region_depth: int = 1,
                   top: int = 8, **kwargs) -> MemoryHarvest:
    """The memory ledger of ONE call of ``fn(*args, **kwargs)``.

    The per-region attribution (and without ``xla``, the totals) comes
    from :func:`live_buffer_walk`, on fake tensors.  With ``xla`` and a
    CUDA tensor among the arguments, the totals come from the allocator
    over one real call (``source="allocator"``): the call runs, so pass
    a state it may consume.  On the CPU ``xla`` falls back to the walk,
    as JAX's falls back where no ``memory_analysis`` exists."""
    w = live_buffer_walk(fn, *args, region_depth=region_depth, top=top,
                         **kwargs)
    dev = _cuda_device(args, kwargs) if xla else None
    stats = _allocator_memory(fn, dev, args, kwargs) if dev else None
    if stats is not None:
        return MemoryHarvest(
            peak_bytes=stats["peak_bytes"],
            argument_bytes=stats["argument_bytes"],
            output_bytes=stats["output_bytes"],
            temp_bytes=stats["temp_bytes"],
            generated_code_bytes=0, source="allocator",
            walk_peak_bytes=w["peak_bytes"], by_region=w["by_region"],
            top_allocations=w["top_allocations"],
            requested_peak_bytes=stats["requested_peak_bytes"])
    return MemoryHarvest(
        peak_bytes=w["peak_bytes"], argument_bytes=w["argument_bytes"],
        output_bytes=w["output_bytes"],
        temp_bytes=max(0, w["peak_bytes"] - w["argument_bytes"]
                       - w["output_bytes"]),
        generated_code_bytes=0, source="walk",
        walk_peak_bytes=w["peak_bytes"], by_region=w["by_region"],
        top_allocations=w["top_allocations"])


# -- live device memory -------------------------------------------------------

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


def record_memory(recorder, harvest_or_stats,
                  limit_bytes: Optional[int] = None,
                  **fields) -> Optional[dict]:
    """Emit one ``memory`` event (``phase="harvest"``): the event the
    ``memory_headroom`` watchdog rule folds.  ``harvest_or_stats`` is a
    :class:`MemoryHarvest` or a byte dict with ``peak_bytes`` (e.g.
    :meth:`apex_tpu_torch.runtime.StepPipeline.memory_stats`).
    ``limit_bytes`` defaults to the smallest card's memory (a peak is one
    card's footprint); with a limit the event carries ``headroom_pct``.
    The ``peak_hbm_bytes`` gauge keeps the highest peak recorded.
    Returns the event's fields (None with no recorder)."""
    if recorder is None:
        return None
    if isinstance(harvest_or_stats, MemoryHarvest):
        h = harvest_or_stats
        stats = {"peak_bytes": h.peak_bytes,
                 "argument_bytes": h.argument_bytes,
                 "output_bytes": h.output_bytes,
                 "temp_bytes": h.temp_bytes,
                 "generated_code_bytes": h.generated_code_bytes,
                 "source": h.source}
    else:
        stats = dict(harvest_or_stats)
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


# -- CLI ----------------------------------------------------------------------

def format_harvest(h: MemoryHarvest) -> str:
    """Human-readable ledger (the CLI's default output)."""
    lines = [f"memory ledger ({h.source}): peak "
             f"{h.peak_bytes / 1e6:.3f} MB  (args "
             f"{h.argument_bytes / 1e6:.3f}, outputs "
             f"{h.output_bytes / 1e6:.3f}, temps "
             f"{h.temp_bytes / 1e6:.3f}, code "
             f"{h.generated_code_bytes / 1e6:.3f})"]
    if h.source != "walk":
        lines.append(f"walk peak (no allocator rounding or caching): "
                     f"{h.walk_peak_bytes / 1e6:.3f} MB")
    lines.append("{:<30} {:>12}".format("region @ walk peak", "MB"))
    for name, b in sorted(h.by_region.items(), key=lambda kv: -kv[1]):
        lines.append("{:<30} {:>12.3f}".format(name[:30], b / 1e6))
    lines.append("top allocations at peak:")
    for a in h.top_allocations:
        lines.append(f"  {a['bytes'] / 1e6:10.3f} MB  {a['region']}  "
                     f"{a['dtype']}{a['shape']}")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    """``python -m apex_tpu_torch.prof.memory``: one target's memory
    ledger (``--fn module:callable`` returning ``(fn, example_args)``,
    the ``prof.analysis`` convention)."""
    import argparse

    from .analysis import DEFAULT_FN, _load_target

    ap = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.prof.memory",
        description="Peak device-memory ledger with per-region "
                    "attribution.")
    ap.add_argument("--fn", default=DEFAULT_FN,
                    help="module:callable returning (fn, example_args)")
    ap.add_argument("--region-depth", type=int, default=1)
    ap.add_argument("--top", type=int, default=8)
    ap.add_argument("--allocator", action="store_true",
                    help="on the card, run the call once under the "
                         "allocator's peak (it consumes its state)")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    fn, ex = _load_target(args.fn)()
    h = harvest_memory(fn, *ex, xla=args.allocator,
                       region_depth=args.region_depth, top=args.top)
    if args.json:
        from dataclasses import asdict
        print(json.dumps(asdict(h), indent=1))
    else:
        print(format_harvest(h))
    return 0


if __name__ == "__main__":  # pragma: no cover - exercised via subprocess
    sys.exit(main())
