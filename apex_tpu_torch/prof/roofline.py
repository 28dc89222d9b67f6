"""Per-region roofline attribution and the MFU ledger — counterpart of
``apex_tpu/prof/roofline.py``.

1. **cost harvest** (:func:`harvest_costs`) — the FLOPs and bytes of one
   call from the analytic walk
   (:func:`apex_tpu_torch.prof.analysis.profile_function`: a fake-tensor
   dispatch walk, with each hand-written kernel's formula), grouped per
   :func:`~apex_tpu_torch.prof.capture.region_path` region; the matmul
   split (:data:`apex_tpu_torch.prof.ledger.COMPUTE_OPS`) is the MFU
   numerator.  Nothing runs on a device and no graph is captured, so a
   captured step's own graphs are untouched.
2. **peaks** (:func:`load_peaks`) — an explicit peaks file, else the
   card's data-sheet peaks by its name; never a TPU's.
3. **MFU ledger** (:func:`mfu_ledger`) — the harvest joined with
   measured step time: each region's roofline time
   (``max(flops / peak_flops, bytes / peak_bw)``), its boundedness, its
   modeled share of the measured step and achieved FLOP/s, and the gap
   section read from :func:`apex_tpu_torch.prof.timeline.analyze`.  Its
   JSON is JAX's, key for key (``schema_version`` the timeline's), so
   :mod:`.regress` diffs a port ledger as it diffs a JAX one.

The MFU denominator is one number, the bf16 dense tensor-core peak, as
in JAX: an fp32 product (the tied LM head) is held to it too.

CLI::

    python -m apex_tpu_torch.prof.roofline --fn mymod:make_step \\
        --timeline run.jsonl [--peaks peaks.json] [--json]
"""

from __future__ import annotations

import json
import os
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import torch

from .capture import region_path
from .costs import HBM_BYTES_PER_S, PEAK_OPS
from .ledger import COMPUTE_OPS

__all__ = ["CostHarvest", "harvest_costs", "mfu_ledger", "format_ledger",
           "load_peaks", "DEVICE_PEAKS", "DEFAULT_HBM_GB_S", "main"]

#: data-sheet peaks by card name: (dense bf16 FLOP/s, HBM GB/s) — the
#: H100 SXM's, the ones the kernel table's bounds use (:mod:`.costs`)
DEVICE_PEAKS = {"H100": (PEAK_OPS[torch.bfloat16], HBM_BYTES_PER_S / 1e9)}

#: the bandwidth a peaks file that names none gets: the H100's data
#: sheet (every ledger records which source its bandwidth used)
DEFAULT_HBM_GB_S = HBM_BYTES_PER_S / 1e9


@dataclass
class CostHarvest:
    """One call's harvested costs.

    ``flops``/``bytes`` are the walk's totals (``source="dispatch"``;
    the port has no compiler cost model to prefer), as are
    ``jaxpr_flops``/``jaxpr_bytes`` (JAX's field names).
    ``matmul_flops`` counts :data:`~apex_tpu_torch.prof.ledger.COMPUTE_OPS`
    only: the MFU numerator.  ``by_region`` maps each region to its
    ``{"flops", "bytes", "matmul_flops", "ops"}`` row.  ``counter_flops``
    is FlopCounterMode's count of the same call when harvested with
    ``xla=True`` (the cross-check; None otherwise)."""
    flops: float
    bytes: Optional[float]
    source: str
    matmul_flops: float
    jaxpr_flops: float
    jaxpr_bytes: float
    by_region: Dict[str, Dict[str, float]] = field(default_factory=dict)
    counter_flops: Optional[float] = None

    @property
    def coverage_pct(self) -> float:
        """The share of the total FLOPs the region rows account for."""
        if not self.flops:
            return 0.0
        attributed = sum(r["flops"] for r in self.by_region.values())
        return 100.0 * attributed / self.flops


def harvest_costs(fn, *args, xla: bool = True, region_depth: int = 1,
                  prof=None, **kwargs) -> CostHarvest:
    """Harvest the FLOPs and bytes of ONE call of ``fn(*args)`` from the
    analytic walk, per region (``region_depth`` leading scope
    components); ``prof`` reuses a ``profile_function`` result.  With
    ``xla`` (JAX's name for its compiler's cross-check), FlopCounterMode
    counts the same call into ``counter_flops``.  Pure analysis on fake
    tensors: nothing runs on the device, no state is consumed."""
    from .analysis import profile_function

    if prof is None:
        prof = profile_function(fn, *args, xla_cost=xla, **kwargs)
    by_region: Dict[str, Dict[str, float]] = {}
    matmul = 0.0
    for r in prof.records:
        row = by_region.setdefault(
            region_path(r.name, depth=region_depth),
            {"flops": 0.0, "bytes": 0.0, "matmul_flops": 0.0, "ops": 0})
        row["flops"] += r.flops * r.count
        row["bytes"] += r.bytes * r.count
        row["ops"] += r.count
        if r.op in COMPUTE_OPS:
            row["matmul_flops"] += r.flops * r.count
            matmul += r.flops * r.count
    return CostHarvest(
        flops=prof.total_flops, bytes=prof.total_bytes, source="dispatch",
        matmul_flops=matmul, jaxpr_flops=prof.total_flops,
        jaxpr_bytes=prof.total_bytes, by_region=by_region,
        counter_flops=prof.xla_cost.get("flops"))


# -- peaks --------------------------------------------------------------------

def _peaks_file(path: str) -> Optional[Dict[str, Any]]:
    """A peaks file's numbers in JAX's calibration format
    (``measured_matmul_tflops`` or ``peak_bf16_tflops``, a measured
    loop-fusion bandwidth under ``resnet50.prof_measured``), or None."""
    cand = (os.path.join(path, "BENCH_EXTRA.json") if os.path.isdir(path)
            else path)
    try:
        with open(cand) as f:
            extra = json.load(f)
    except (OSError, ValueError):
        return None
    tflops = extra.get("measured_matmul_tflops") \
        or extra.get("peak_bf16_tflops")
    if not tflops:
        return None
    src = ("measured_matmul_tflops" if extra.get("measured_matmul_tflops")
           else "peak_bf16_tflops")
    bw, bw_src = DEFAULT_HBM_GB_S, "default_h100_hbm"
    if extra.get("hbm_gb_s"):
        bw, bw_src = float(extra["hbm_gb_s"]), "hbm_gb_s"
    prof = (extra.get("resnet50") or {}).get("prof_measured") or {}
    for row in prof.get("by_category", []):
        if row.get("category") == "loop fusion" and row.get("gb_per_s"):
            bw, bw_src = float(row["gb_per_s"]), "measured_loop_fusion"
            break
    return {"flops": float(tflops) * 1e12, "hbm_gb_s": bw,
            "source": f"{os.path.basename(cand)}:{src}", "bw_source": bw_src}


def load_peaks(path: Optional[str] = None) -> Dict[str, Any]:
    """Roofline ceilings ``{"flops": FLOP/s, "hbm_gb_s", "source",
    "bw_source"}``: from the peaks file ``path`` (or a directory holding
    ``BENCH_EXTRA.json``) when it is readable, else the data sheet of
    CUDA device 0 by its name (:data:`DEVICE_PEAKS`).  With neither (no
    file and no card, or a card it has no data sheet for) it raises: a
    ledger is never held to another device's peaks."""
    if path:
        peaks = _peaks_file(path)
        if peaks is not None:
            return peaks
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"no peaks file{f' at {path!r}' if path else ''} and no CUDA "
            f"device to take data-sheet peaks from; pass --peaks FILE")
    name = torch.cuda.get_device_name(0)
    for key, (flops, bw) in DEVICE_PEAKS.items():
        if key in name:
            return {"flops": flops, "hbm_gb_s": bw,
                    "source": f"data_sheet:{name}",
                    "bw_source": f"data_sheet:{name}"}
    raise ValueError(f"no data-sheet peaks for {name!r} (known: "
                     f"{sorted(DEVICE_PEAKS)}); pass a peaks file")


# -- the MFU ledger -----------------------------------------------------------

def mfu_ledger(harvest: CostHarvest, *, step_time_s: Optional[float] = None,
               timeline: Optional[Dict[str, Any]] = None,
               peaks: Optional[Dict[str, Any]] = None,
               best_window_step_s: Optional[float] = None,
               top: Optional[int] = None,
               memory=None) -> Dict[str, Any]:
    """Join one :class:`CostHarvest` with measured time into the
    per-region MFU ledger (JAX's keys and arithmetic).

    ``step_time_s`` is the measured seconds per step; with a
    ``timeline`` (a :func:`apex_tpu_torch.prof.timeline.analyze` result)
    it defaults to the stream's ``elapsed / steps``.  ``peaks`` is a
    :func:`load_peaks` dict (loaded when omitted).  ``memory`` is a
    :class:`apex_tpu_torch.prof.memory.MemoryHarvest` of the same step:
    the ledger gains a ``memory`` section and each region a
    ``peak_hbm_mb`` column.  Each region's roofline time is normalized
    onto the measured step; the ``gap`` section splits the distance to
    the best window and the stream's compile, loader and dispatch
    time."""
    peaks = dict(peaks or load_peaks())
    peak_f = float(peaks["flops"])
    peak_bw = float(peaks.get("hbm_gb_s") or DEFAULT_HBM_GB_S) * 1e9
    if step_time_s is None and timeline:
        steps = timeline.get("steps") or 0
        elapsed = timeline.get("elapsed_s") or 0.0
        if steps and elapsed:
            step_time_s = elapsed / steps

    mem_by_region: Dict[str, float] = {}
    if memory is not None:
        mem_by_region = dict(getattr(memory, "by_region", None)
                             or (memory.get("by_region", {})
                                 if isinstance(memory, dict) else {}))

    regions: List[Dict[str, Any]] = []
    modeled_total = 0.0
    for name, row in harvest.by_region.items():
        t_compute = row["flops"] / peak_f
        t_memory = row["bytes"] / peak_bw if row["bytes"] else 0.0
        modeled = max(t_compute, t_memory)
        modeled_total += modeled
        entry = {
            "region": name,
            "flops_g": round(row["flops"] / 1e9, 6),
            "matmul_flops_g": round(row["matmul_flops"] / 1e9, 6),
            "bytes_gb": round(row["bytes"] / 1e9, 6),
            "ops": int(row["ops"]),
            "intensity": (round(row["flops"] / row["bytes"], 2)
                          if row["bytes"] else None),
            "bound": ("compute" if t_compute >= t_memory else "memory"),
            "_modeled_s": modeled,
        }
        if name in mem_by_region:
            entry["peak_hbm_mb"] = round(mem_by_region[name] / 1e6, 3)
        regions.append(entry)
    model_scale = ((step_time_s / modeled_total)
                   if step_time_s and modeled_total else None)
    for r in regions:
        modeled = r.pop("_modeled_s")
        if model_scale:
            t = modeled * model_scale
            r["modeled_ms"] = round(t * 1e3, 3)
            r["share_pct"] = round(100.0 * modeled * model_scale
                                   / step_time_s, 1) if step_time_s else None
            r["achieved_tflops"] = (round(r["flops_g"] / 1e3 / t, 4)
                                    if t > 0 else None)
            r["mfu_pct"] = (round(100.0 * r["matmul_flops_g"] * 1e9
                                  / t / peak_f, 1)
                            if t > 0 else None)
    regions.sort(key=lambda r: -(r.get("modeled_ms") or r["flops_g"]))
    if top:
        dropped = max(0, len(regions) - top)
        regions = regions[:top]
    else:
        dropped = 0

    out: Dict[str, Any] = {
        "schema_version": _schema_version(),
        "source": harvest.source,
        "peaks": {"tflops": round(peak_f / 1e12, 1),
                  "hbm_gb_s": round(peak_bw / 1e9, 1),
                  "ridge_intensity": round(peak_f / peak_bw, 1),
                  "source": peaks.get("source"),
                  "bw_source": peaks.get("bw_source")},
        "total": {
            "flops_g": round(harvest.flops / 1e9, 6),
            "matmul_flops_g": round(harvest.matmul_flops / 1e9, 6),
            "bytes_gb": (round(harvest.bytes / 1e9, 6)
                         if harvest.bytes else None),
            "intensity": (round(harvest.flops / harvest.bytes, 2)
                          if harvest.bytes else None),
        },
        "coverage_pct": round(harvest.coverage_pct, 1),
        "regions": regions,
        "regions_dropped": dropped,
    }
    if memory is not None:
        get = (lambda k: getattr(memory, k, None)
               if not isinstance(memory, dict) else memory.get(k))
        peak_b = float(get("peak_bytes") or 0)
        out["total"]["peak_hbm_gb"] = round(peak_b / 1e9, 6)
        out["memory"] = {
            "peak_hbm_gb": round(peak_b / 1e9, 6),
            "source": get("source"),
            "argument_gb": round(float(get("argument_bytes") or 0)
                                 / 1e9, 6),
            "output_gb": round(float(get("output_bytes") or 0) / 1e9, 6),
            "temp_gb": round(float(get("temp_bytes") or 0) / 1e9, 6),
            "walk_peak_gb": round(float(get("walk_peak_bytes") or 0)
                                  / 1e9, 6),
            "top_allocations": list(get("top_allocations") or [])[:8],
        }
    if step_time_s:
        out["total"]["step_ms"] = round(step_time_s * 1e3, 3)
        out["total"]["achieved_tflops"] = round(
            harvest.flops / step_time_s / 1e12, 4)
        out["total"]["mfu_pct"] = round(
            100.0 * harvest.matmul_flops / step_time_s / peak_f, 1)
        out["model_scale"] = (round(model_scale, 2) if model_scale else None)

    gap: Dict[str, Any] = {}
    if best_window_step_s and step_time_s:
        gap["steady_vs_best_pct"] = round(
            max(0.0, 100.0 * (1.0 - best_window_step_s / step_time_s)), 1)
    if timeline:
        att = timeline.get("attribution") or {}
        rt = timeline.get("retraces") or {}
        elapsed = float(timeline.get("elapsed_s") or 0.0)
        compile_s = float(rt.get("compile_s") or 0.0)
        gap.update({
            "compile_pct": (round(100.0 * compile_s / elapsed, 2)
                            if elapsed else None),
            "loader_stall_pct": att.get("loader_stall_pct"),
            "dispatch_gap_pct": att.get("dispatch_gap_pct"),
            "host_other_pct": att.get("gap_minus_loader_pct"),
        })
    if gap:
        out["gap"] = gap
    return out


def _schema_version() -> str:
    from .timeline import SCHEMA_VERSION
    return SCHEMA_VERSION


def _fmt_g(v) -> str:
    return f"{v:10.3f}" if v is not None else "       n/a"


def format_ledger(ledger: Dict[str, Any]) -> str:
    """Human-readable ledger (the CLI's default output; JAX's text)."""
    lines: List[str] = []
    t = ledger["total"]
    pk = ledger["peaks"]
    lines.append(
        f"roofline ledger ({ledger['source']}; peaks {pk['tflops']} TFLOP/s"
        f" / {pk['hbm_gb_s']} GB/s [{pk['source']}])")
    head = (f"total: {t['flops_g']} GFLOP ({t['matmul_flops_g']} matmul)"
            + (f", {t['bytes_gb']} GB" if t.get("bytes_gb") else ""))
    if t.get("step_ms"):
        head += (f" in {t['step_ms']} ms -> {t['achieved_tflops']} TFLOP/s"
                 f" ({t['mfu_pct']}% MFU vs measured peak)")
    lines.append(head)
    mem = ledger.get("memory")
    if mem:
        lines.append(
            f"peak HBM: {mem['peak_hbm_gb']} GB [{mem['source']}] "
            f"(args {mem['argument_gb']}, outputs {mem['output_gb']}, "
            f"temps {mem['temp_gb']}; walk {mem['walk_peak_gb']})")
    lines.append(f"region coverage: {ledger['coverage_pct']}% of total flops")
    lines.append("{:<26} {:>10} {:>10} {:>8} {:>9} {:>7}  {}".format(
        "region", "GFLOP", "GB", "ms", "TFLOP/s", "MFU%", "bound"))
    for r in ledger["regions"]:
        lines.append("{:<26} {} {} {:>8} {:>9} {:>7}  {}".format(
            r["region"][:26], _fmt_g(r["flops_g"]), _fmt_g(r["bytes_gb"]),
            r.get("modeled_ms", ""), r.get("achieved_tflops", ""),
            r.get("mfu_pct", ""), r["bound"]))
    if ledger.get("regions_dropped"):
        lines.append(f"... {ledger['regions_dropped']} smaller regions "
                     f"not shown")
    gap = ledger.get("gap")
    if gap:
        parts = [f"{k.replace('_pct', '')} {v}%"
                 for k, v in gap.items() if v is not None]
        lines.append("gap attribution: " + ", ".join(parts))
    return "\n".join(lines)


# -- CLI ----------------------------------------------------------------------

def main(argv: Optional[Sequence[str]] = None) -> int:
    """``python -m apex_tpu_torch.prof.roofline``: harvest one target's
    costs and print its MFU ledger, optionally joined with a telemetry
    stream (step time and gap attribution) and a peaks file.  The
    target follows ``prof.analysis``: ``--fn module:callable`` returning
    ``(fn, example_args)``."""
    import argparse

    from .analysis import DEFAULT_FN

    ap = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.prof.roofline",
        description="Per-region roofline attribution / MFU ledger.")
    ap.add_argument("--fn", default=DEFAULT_FN,
                    help="module:callable returning (fn, example_args)")
    ap.add_argument("--timeline", default=None, metavar="RUN_JSONL",
                    help="telemetry stream: step timing + gap attribution")
    ap.add_argument("--peaks", default=None,
                    help="peaks file (JAX's BENCH_EXTRA.json format, or a "
                         "dir holding one); default: the card's data sheet")
    ap.add_argument("--step-ms", type=float, default=None,
                    help="measured step time (overrides --timeline)")
    ap.add_argument("--region-depth", type=int, default=1)
    ap.add_argument("--top", type=int, default=None)
    ap.add_argument("--no-xla", action="store_true",
                    help="skip the FlopCounterMode cross-check")
    ap.add_argument("--memory", action="store_true",
                    help="also harvest the memory ledger (prof.memory) "
                         "and join it as the memory section")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    from .analysis import _load_target

    fn, ex = _load_target(args.fn)()
    harvest = harvest_costs(fn, *ex, xla=not args.no_xla,
                            region_depth=args.region_depth)
    mem = None
    if args.memory:
        from . import memory as memory_mod
        mem = memory_mod.harvest_memory(fn, *ex,
                                        region_depth=args.region_depth)
    tl = None
    if args.timeline:
        from . import timeline as timeline_mod
        tl = timeline_mod.analyze(timeline_mod.load_events(args.timeline))
    ledger = mfu_ledger(
        harvest,
        step_time_s=(args.step_ms / 1e3 if args.step_ms else None),
        timeline=tl, peaks=load_peaks(args.peaks), top=args.top,
        memory=mem)
    if args.json:
        print(json.dumps(ledger, indent=1))
    else:
        print(format_ledger(ledger))
    return 0


if __name__ == "__main__":  # pragma: no cover - exercised via subprocess
    sys.exit(main())
