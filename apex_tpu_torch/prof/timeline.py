"""Offline timeline analyzer of a telemetry stream — counterpart of
``apex_tpu/prof/timeline.py``::

    python -m apex_tpu_torch.prof.timeline run.jsonl
    python -m apex_tpu_torch.prof.timeline run.jsonl --chrome trace.json
    python -m apex_tpu_torch.prof.timeline run.jsonl --json

From the stream alone: step-time percentiles (from consecutive window
starts: what the host loop lived through), stall and gap attribution
(``loader_stall_pct`` from the same ``LoaderStats.as_dict()`` snapshot
the trainers print), the loss-scale trajectory with its skips and
growths, captures (``retrace`` events: first captures, same-signature
recaptures and captures of new signatures apart), the memory peak,
watchdog alerts, collective bytes per step, and (schema 1.2) the
serving requests.  The analysis dict and its ``SCHEMA_VERSION`` are the
JAX package's, so either analyzer reads either package's stream the
same.  Pure host JSON: it runs wherever the stream can be copied.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional, Sequence

__all__ = ["SCHEMA_VERSION", "load_events", "analyze", "format_report",
           "check_schema_version", "main"]

#: Version of the ANALYSIS dict this module emits (``analyze()`` /
#: ``--json``).  ``major.minor``: the major bumps only when an existing
#: field changes meaning or disappears; adding fields bumps the minor.
#: ``prof.regress`` diffs two analyses across commits, so it refuses
#: inputs whose major it does not understand (see
#: :func:`check_schema_version`) instead of silently comparing
#: incompatible numbers.
SCHEMA_VERSION = "1.2"      # 1.1: + memory section
#                             1.2: + requests section


def check_schema_version(obj: Dict[str, Any], where: str = "input") -> None:
    """Reject an analysis dict from a FUTURE schema major with a clear
    error (old majors and missing versions pass — forward tools must
    read old artifacts, old tools must not misread new ones)."""
    ver = obj.get("schema_version")
    if ver is None:
        return
    try:
        major = int(str(ver).split(".")[0])
    except (ValueError, AttributeError):
        raise ValueError(
            f"{where}: unparseable schema_version {ver!r} "
            f"(expected 'major.minor', e.g. {SCHEMA_VERSION!r})")
    supported = int(SCHEMA_VERSION.split(".")[0])
    if major > supported:
        raise ValueError(
            f"{where}: schema_version {ver} is a FUTURE major (this "
            f"analyzer understands <= {supported}.x) — regenerate the "
            f"summary with this repo's `python -m apex_tpu_torch.prof.timeline "
            f"--json`, or upgrade apex_tpu to diff it")


def load_events(path: str) -> List[dict]:
    """Parse a JSONL telemetry stream; torn tail lines (a run killed
    mid-write) are skipped, not fatal.  ``path`` may be a glob, and a
    rotated set (``run.jsonl`` + ``run.jsonl.1`` … from
    ``telemetry.start(path, max_bytes=...)``) is re-assembled in
    segment order automatically
    (:func:`apex_tpu_torch.telemetry.expand_stream_paths`)."""
    from ..telemetry.events import _iter_events
    return _iter_events(path)


def _percentiles(samples: Sequence[float],
                 qs=(50.0, 90.0, 99.0)) -> List[Optional[float]]:
    # same definition as the in-run Histogram reservoirs
    from ..telemetry.metrics import nearest_rank_percentiles
    return nearest_rank_percentiles(samples, qs)


def analyze(events: List[dict]) -> Dict[str, Any]:
    """Distill one stream into the attribution dict ``format_report``
    prints."""
    windows = [e for e in events if e.get("kind") == "window"]
    metrics_ev: Dict[int, dict] = {}
    for e in events:
        if e.get("kind") == "metrics":      # last fetch of a step wins
            metrics_ev[int(e.get("step", 0))] = e
    scale_ev = [e for e in events if e.get("kind") == "scale"]
    retrace_ev = [e for e in events if e.get("kind") == "retrace"]
    coll_ev = [e for e in events if e.get("kind") == "collective"]
    loader_ev = [e for e in events if e.get("kind") == "loader"]
    waits = [e for e in events if e.get("kind") == "loader_wait"]
    summary = next((e for e in events if e.get("kind") == "summary"), None)
    run_ev = next((e for e in events if e.get("kind") == "run"), None)

    alert_ev = [e for e in events if e.get("kind") == "alert"]

    out: Dict[str, Any] = {
        "schema_version": SCHEMA_VERSION,
        "meta": (run_ev or {}).get("meta", {}),
        "n_events": len(events),
    }

    # -- step timing --------------------------------------------------------
    steps = sum(int(w.get("n_valid", 0)) for w in windows)
    out["steps"] = steps
    out["windows"] = len(windows)
    if windows:
        starts = [float(w["t"]) - float(w.get("dur", 0.0)) for w in windows]
        # elapsed: first dispatch start -> last event that fences device
        # work (the final metric fetch), else the last dispatch return.
        t_end = max([float(w["t"]) for w in windows]
                    + [float(e["t"]) for e in metrics_ev.values()])
        elapsed = max(t_end - starts[0], 1e-9)
        per_step: List[float] = []
        for i in range(1, len(windows)):
            n = int(windows[i - 1].get("n_valid", 1)) or 1
            per_step += [(starts[i] - starts[i - 1]) / n] * n
        p50, p90, p99 = _percentiles(per_step)
        dur_total = sum(float(w.get("dur", 0.0)) for w in windows)
        gap_total = sum(float(w.get("gap", 0.0)) for w in windows)
        out["elapsed_s"] = round(elapsed, 4)
        out["steps_per_s"] = round(steps / elapsed, 2)
        out["step_time"] = {
            "mean_ms": (round(1e3 * sum(per_step) / len(per_step), 3)
                        if per_step else None),
            "p50_ms": round(1e3 * p50, 3) if p50 is not None else None,
            "p90_ms": round(1e3 * p90, 3) if p90 is not None else None,
            "p99_ms": round(1e3 * p99, 3) if p99 is not None else None,
            "samples": len(per_step),
        }
        # -- attribution ----------------------------------------------------
        wait_total = sum(float(e.get("dur", 0.0)) for e in waits)
        loader_stats = (loader_ev[-1].get("stats", {}) if loader_ev else {})
        out["attribution"] = {
            # the % of wall the host spent inside dispatch calls
            "dispatch_pct": round(100.0 * dur_total / elapsed, 2),
            # host time between dispatches (fetches, loader, glue)
            "dispatch_gap_pct": round(100.0 * gap_total / elapsed, 2),
            # consumer wait measured by the loader itself, as % of the
            # STREAM's elapsed window (the same seconds LoaderStats
            # counts; its own loader_stall_pct uses its own clock)
            "loader_wait_pct": round(100.0 * wait_total / elapsed, 2),
            "gap_minus_loader_pct": round(
                100.0 * max(0.0, gap_total - wait_total) / elapsed, 2),
            # the number the trainers print — read
            # from the SAME as_dict() snapshot, so they agree exactly
            "loader_stall_pct": float(
                loader_stats.get("loader_stall_pct", 0.0)),
        }
        out["loader"] = loader_stats or None

    # -- loss scale ---------------------------------------------------------
    trajectory: List[List[float]] = []
    for step in sorted(metrics_ev):
        e = metrics_ev[step]
        scales = e.get("loss_scale") or []
        for j, s in enumerate(scales):
            trajectory.append([step + j, float(s)])
    skips = sorted(int(e.get("step", -1)) for e in scale_ev
                   if e.get("event") == "skip")
    grows = sorted(int(e.get("step", -1)) for e in scale_ev
                   if e.get("event") == "grow")
    out["loss_scale"] = {
        "trajectory": trajectory,
        "skip_steps": skips,
        "grow_steps": grows,
        "final": trajectory[-1][1] if trajectory else None,
    }

    # -- retraces -----------------------------------------------------------
    # A cache-growth event is one of: the program's first compile, a
    # known-benign re-specialization (same shape signature — jit
    # re-caching on the donated state's returned sharding), or a TRUE
    # retrace (a never-seen signature).
    first_compiles = [e for e in retrace_ev if e.get("first")]
    respecs = [e for e in retrace_ev
               if not e.get("first") and not e.get("new_sig", True)]
    true_retraces = [e for e in retrace_ev
                     if not e.get("first") and e.get("new_sig", True)]
    out["retraces"] = {
        "compiles": len(first_compiles),
        "respecializations": len(respecs),
        "retraces": len(true_retraces),
        "by_signature": sorted({str(e.get("sig")) for e in true_retraces}),
        # host seconds spent inside dispatches that grew the jit cache
        # (each retrace event carries its dispatch's dur) — the compile
        # share of the steady-vs-best gap the roofline ledger reports.
        "compile_s": round(sum(float(e.get("dur", 0.0))
                               for e in retrace_ev), 4),
    }

    # -- memory ledger events -------------------------------------
    mem_ev = [e for e in events if e.get("kind") == "memory"]
    if mem_ev:
        peaks = [float(e.get("peak_bytes", 0) or 0) for e in mem_ev]
        heads = [float(e["headroom_pct"]) for e in mem_ev
                 if e.get("headroom_pct") is not None]
        out["memory"] = {
            "events": len(mem_ev),
            "peak_hbm_gb": round(max(peaks) / 1e9, 6) if peaks else None,
            "min_headroom_pct": (round(min(heads), 2) if heads else None),
            "source": mem_ev[-1].get("source"),
        }

    # -- watchdog alerts ------------------------------------------------------
    by_rule: Dict[str, int] = {}
    for e in alert_ev:
        rule = str(e.get("rule", "?"))
        by_rule[rule] = by_rule.get(rule, 0) + 1
    out["alerts"] = {
        "total": len(alert_ev),
        "by_rule": by_rule,
        "steps": sorted({int(e["step"]) for e in alert_ev
                         if e.get("step") is not None})[:64],
    }

    # -- collectives --------------------------------------------------------
    # Events fire at TRACE time — once per reduce call per COMPILE.  The
    # hot and tail programs (and any re-specialization) of a pipeline
    # each re-record the same per-step collectives, so a group of
    # identical events divides by the number of observed compiles
    # (cache-growth events), ceil'd — two genuinely distinct reduce
    # calls of the same signature inside ONE step survive the division
    # instead of collapsing to one.  Without compile events the stream
    # came from a single trace, so every event counts.
    compiles_seen = max(1, len(retrace_ev))
    groups: Dict[tuple, List[dict]] = {}
    for e in coll_ev:
        key = (e.get("op"), json.dumps(e.get("axis")),
               int(e.get("bytes", 0)), int(e.get("n", 0)))
        groups.setdefault(key, []).append(e)
    colls = []
    for evs in groups.values():
        e = evs[0]
        mult = -(-len(evs) // compiles_seen)         # ceil
        b = int(e.get("bytes", 0)) * mult
        colls.append({
            "op": e.get("op"), "axis": e.get("axis"),
            "n_per_step": int(e.get("n", 0)) * mult,
            "bytes_per_step": b,
            "total_gb": round(b * steps / 1e9, 4),
            "dtype": e.get("dtype"),
        })
    colls.sort(key=lambda c: -c["bytes_per_step"])
    out["collectives"] = {
        "per_step_bytes": sum(c["bytes_per_step"] for c in colls),
        "total_gb": round(sum(c["bytes_per_step"] for c in colls)
                          * steps / 1e9, 4),
        "by_op": colls,
        # Per-mesh-axis attribution: the axis name(s) each
        # collective carries split the traffic per mesh dimension
        # (dp vs fsdp vs tp) instead of one undifferentiated pool — a
        # multi-axis psum is labeled with the joined axes (its bytes
        # cross every one of them as one HLO collective).
        "by_axis": _axis_totals(colls, steps),
    }

    # -- serving requests ----------------------------------------
    # Present only when the stream came from the serving engine (has
    # `done` serving events): TTFT/TPOT/e2e/queue-wait percentiles over
    # EVERY finished request plus the batch-size-vs-TPOT join — the
    # schema-1.2 addition `prof.requests` computes in full detail.
    from .requests import request_stats
    req = request_stats(events)
    if req is not None:
        out["requests"] = req

    if summary is not None:
        out["summary"] = {k: v for k, v in summary.items()
                          if k not in ("t", "kind")}
    return out


def axis_label(axis) -> str:
    """Canonical label of a collective's mesh axis field: a bare name
    stays itself, a multi-axis tuple joins with '+' (one HLO collective
    crossing several axes)."""
    if isinstance(axis, (list, tuple)):
        return "+".join(str(a) for a in axis)
    return str(axis)


def _axis_totals(colls, steps: int) -> Dict[str, Dict[str, Any]]:
    """Aggregate per-collective rows into per-axis byte totals."""
    out: Dict[str, Dict[str, Any]] = {}
    for c in colls:
        d = out.setdefault(axis_label(c.get("axis")),
                           {"bytes_per_step": 0, "n_per_step": 0,
                            "ops": set()})
        d["bytes_per_step"] += c["bytes_per_step"]
        d["n_per_step"] += c["n_per_step"]
        d["ops"].add(c["op"])
    return {k: {"bytes_per_step": v["bytes_per_step"],
                "n_per_step": v["n_per_step"],
                "total_gb": round(v["bytes_per_step"] * steps / 1e9, 4),
                "ops": sorted(v["ops"])}
            for k, v in sorted(out.items())}


def _fmt_pct(v) -> str:
    return f"{v:6.2f}%" if v is not None else "   n/a"


def format_report(a: Dict[str, Any]) -> str:
    """Human-readable report (the CLI's default output)."""
    lines: List[str] = []
    meta = a.get("meta") or {}
    head = ", ".join(f"{k}={v}" for k, v in sorted(meta.items()))
    lines.append(f"telemetry timeline — {a.get('n_events', 0)} events"
                 + (f" ({head})" if head else ""))
    st = a.get("step_time")
    if st:
        lines.append(
            f"steps: {a['steps']} over {a['windows']} windows in "
            f"{a['elapsed_s']:.3f}s  ({a['steps_per_s']} steps/s)")
        lines.append(
            f"step time: mean {st['mean_ms']} ms  p50 {st['p50_ms']}  "
            f"p90 {st['p90_ms']}  p99 {st['p99_ms']} ms "
            f"({st['samples']} samples)")
    att = a.get("attribution")
    if att:
        lines.append("attribution (% of wall):")
        lines.append(f"  dispatch         {_fmt_pct(att['dispatch_pct'])}")
        lines.append(f"  dispatch gap     "
                     f"{_fmt_pct(att['dispatch_gap_pct'])}"
                     f"   (loader wait {_fmt_pct(att['loader_wait_pct'])},"
                     f" other {_fmt_pct(att['gap_minus_loader_pct'])})")
        lines.append(f"  loader stall     "
                     f"{_fmt_pct(att['loader_stall_pct'])}"
                     f"   (LoaderStats.as_dict, = the example's "
                     f"'loader: stall' line)")
    ls = a.get("loss_scale") or {}
    traj = ls.get("trajectory") or []
    if traj:
        distinct = []
        for step, s in traj:
            if not distinct or distinct[-1][1] != s:
                distinct.append((step, s))
        path = " -> ".join(f"{s:g}@{int(t)}" for t, s in distinct[:12])
        lines.append(f"loss scale: final {ls['final']:g}  ({path}"
                     + (" ..." if len(distinct) > 12 else "") + ")")
        lines.append(f"  skips at steps {ls['skip_steps'] or '[]'}  "
                     f"growth at {ls['grow_steps'] or '[]'}")
    rt = a.get("retraces") or {}
    lines.append(f"compiles: {rt.get('compiles', 0)}  "
                 f"re-specializations: {rt.get('respecializations', 0)}  "
                 f"retraces: {rt.get('retraces', 0)}"
                 + (f"  ({rt['compile_s']}s compiling)"
                    if rt.get("compile_s") else "")
                 + (f"  signatures: {rt['by_signature']}"
                    if rt.get("retraces") else ""))
    mem = a.get("memory") or {}
    if mem.get("peak_hbm_gb") is not None:
        head = (f", min headroom {mem['min_headroom_pct']}%"
                if mem.get("min_headroom_pct") is not None else "")
        lines.append(f"peak HBM: {mem['peak_hbm_gb']} GB "
                     f"[{mem.get('source')}]{head}")
    al = a.get("alerts") or {}
    if al.get("total"):
        rules = ", ".join(f"{k} x{v}"
                          for k, v in sorted(al["by_rule"].items()))
        lines.append(f"health: {al['total']} watchdog alert(s) ({rules})"
                     + (f" at steps {al['steps'][:8]}"
                        if al.get("steps") else ""))
    rq = a.get("requests") or {}
    if rq:
        t, tp = rq.get("ttft") or {}, rq.get("tpot") or {}
        lines.append(f"serving: {rq['n_requests']} requests, "
                     f"{rq['tokens_out']} tokens out  "
                     f"ttft p50/p99 {t.get('p50_ms')}/{t.get('p99_ms')} ms"
                     f"  tpot p50/p99 {tp.get('p50_ms')}/{tp.get('p99_ms')}"
                     f" ms  (waterfalls: python -m apex_tpu_torch.prof.requests)")
    co = a.get("collectives") or {}
    if co.get("by_op"):
        lines.append(f"collectives: "
                     f"{co['per_step_bytes'] / 1e6:.3f} MB/step, "
                     f"{co['total_gb']} GB over the run")
        for c in co["by_op"][:8]:
            lines.append(f"  {c['op']:<14} axis={c['axis']} "
                         f"{c['bytes_per_step'] / 1e6:.3f} MB/step "
                         f"x{c['n_per_step']} ({c['dtype']}) "
                         f"total {c['total_gb']} GB")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.prof.timeline",
        description="Analyze an apex_tpu telemetry JSONL stream.")
    p.add_argument("stream", help="path to the run's .jsonl event stream "
                                  "(a glob or any member of a rotated "
                                  "set loads the whole set in order)")
    p.add_argument("--json", action="store_true",
                   help="emit the analysis as JSON instead of the report")
    p.add_argument("--chrome", metavar="OUT",
                   help="also export a Chrome trace_event file "
                        "(open in Perfetto / chrome://tracing)")
    args = p.parse_args(argv)
    events = load_events(args.stream)
    if not events:
        print(f"no events in {args.stream}", file=sys.stderr)
        return 1
    a = analyze(events)
    if args.chrome:
        from ..telemetry import to_chrome_trace
        n = to_chrome_trace(events, args.chrome)
        print(f"wrote {n} chrome trace events to {args.chrome}",
              file=sys.stderr)
    try:
        if args.json:
            print(json.dumps(a, indent=1))
        else:
            print(format_report(a))
    except BrokenPipeError:       # `... | head` is a supported consumer
        try:
            sys.stdout.close()
        except Exception:
            pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
