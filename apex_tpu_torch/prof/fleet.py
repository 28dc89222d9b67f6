"""Multi-rank telemetry merge and straggler attribution — counterpart
of ``apex_tpu/prof/fleet.py``.

Each rank of a data-parallel run (``python -m
apex_tpu_torch.parallel.multiproc``) records its own stream, stamped
with its ``process_index``.  Every rank runs the same window sequence,
so the window indices are a shared ruler:

* :func:`load_fleet` loads N streams (paths, globs, rotated sets);
* :func:`align_clocks` aligns them from each stream's ``anchor_unix``
  and the median difference of their window starts;
* :func:`analyze_fleet` gives each rank's step time and skew, the
  slowest rank per window (and whether one rank is the consistent
  straggler), a modeled wait-vs-wire split per collective (wire: bytes
  over a link rate; wait: the ranks' arrival spread), and the loader
  stall's asymmetry;
* :func:`to_fleet_chrome_trace` writes one Chrome lane per rank on the
  aligned clock.

Pure host JSON::

    python -m apex_tpu_torch.prof.fleet 'run_rank*.jsonl'
    python -m apex_tpu_torch.prof.fleet r0.jsonl r1.jsonl --chrome fleet.json

:func:`synthetic_fleet` makes the JAX package's deterministic fixture (a
slow host named on every window).
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from typing import Any, Dict, List, Optional, Sequence

from ..telemetry.events import (_iter_events, chrome_events,
                                expand_stream_paths)
from .timeline import SCHEMA_VERSION, analyze as _analyze_timeline

__all__ = ["HostStream", "load_fleet", "align_clocks", "analyze_fleet",
           "to_fleet_chrome_trace", "synthetic_fleet", "format_report",
           "main", "DEFAULT_ICI_GB_S"]

#: fallback inter-chip link bandwidth for the modeled wire half of the
#: wait-vs-wire split: the JAX package's default, kept so both
#: analyzers agree on one stream; pass the link's own rate with
#: ``--ici-gb-s`` / ``analyze_fleet(ici_gb_s=...)``.
DEFAULT_ICI_GB_S = 100.0


class HostStream:
    """One host's loaded stream: events + the identity its ``run``
    event stamped (``process_index``/``process_count``/``anchor_unix``/
    ``run_id``).  ``host`` falls back to load order when the stream
    predates the stamps (or two streams claim the same index)."""

    def __init__(self, path: Optional[str], events: List[dict],
                 fallback_index: int):
        self.path = path
        self.events = events
        run = next((e for e in events if e.get("kind") == "run"), {})
        self.run_id = run.get("run_id")
        self.anchor_unix: Optional[float] = run.get("anchor_unix")
        pi = run.get("process_index")
        self.host: int = int(pi) if pi is not None else fallback_index
        pc = run.get("process_count")
        self.process_count: Optional[int] = (int(pc) if pc is not None
                                             else None)
        #: window step -> (dispatch start in STREAM time, dur, n_valid)
        self.windows: Dict[int, tuple] = {}
        for e in events:
            if e.get("kind") != "window":
                continue
            t = float(e.get("t", 0.0))
            dur = float(e.get("dur", 0.0))
            self.windows[int(e.get("step", 0))] = (
                t - dur, dur, int(e.get("n_valid", 1)))

    def abs_start(self, step: int) -> Optional[float]:
        """Window dispatch start on the anchor-based absolute clock
        (stream time when the stream has no anchor)."""
        w = self.windows.get(step)
        if w is None:
            return None
        return (self.anchor_unix or 0.0) + w[0]


def load_fleet(paths_or_globs: Sequence[str]) -> List[HostStream]:
    """Load N per-host streams.  Each argument may be a concrete path,
    a glob (``'run_host*.jsonl'``), or any member of a rotated set;
    rotated segments group back onto their base stream.  Returns
    streams sorted by host index.  Raises ``ValueError`` when nothing
    matched, and de-duplicates host indices by load order (a re-used
    index would silently fold two hosts into one skew row)."""
    bases: List[str] = []
    seen = set()
    for arg in paths_or_globs:
        for seg in expand_stream_paths(arg):
            base = seg
            m = re.match(r"^(.+)\.(\d+)$", seg)
            if m:
                base = m.group(1)
            if base not in seen:
                seen.add(base)
                bases.append(base)
    streams: List[HostStream] = []
    for i, base in enumerate(bases):
        try:
            events = _iter_events(base)
        except OSError:
            continue         # an unmatched glob resolves to no streams
        if events:
            streams.append(HostStream(base, events, fallback_index=i))
    if not streams:
        raise ValueError(
            f"no telemetry events found under {list(paths_or_globs)!r}")
    used: set = set()
    for i, s in enumerate(streams):
        if s.host in used:          # duplicate stamp: keep streams apart
            s.host = max(used) + 1
        used.add(s.host)
    streams.sort(key=lambda s: s.host)
    return streams


def align_clocks(streams: List[HostStream]) -> Dict[int, Dict[str, Any]]:
    """Per-host clock correction onto the reference host's clock.

    Coarse: each stream's ``anchor_unix`` maps stream time onto the
    wall clock.  Fine: for every window step both hosts dispatched, the
    difference of anchor-based dispatch starts vs the reference host is
    collected; its MEDIAN is that host's residual clock skew (median,
    not mean — a straggler window shifts the tail, not the middle), and
    is subtracted by the aligned clock.  Returns ``{host: {"offset_s"
    (add to the host's absolute time), "clock_skew_s", "common_windows",
    "anchored"}}``."""
    if not streams:
        return {}
    ref = streams[0]
    out: Dict[int, Dict[str, Any]] = {}
    for s in streams:
        deltas: List[float] = []
        for step, (_t0, _dur, _n) in s.windows.items():
            r = ref.abs_start(step)
            mine = s.abs_start(step)
            if r is not None and mine is not None:
                deltas.append(r - mine)
        deltas.sort()
        skew = deltas[len(deltas) // 2] if deltas else 0.0
        out[s.host] = {
            "offset_s": skew,
            "clock_skew_s": round(-skew, 6) if s is not ref else 0.0,
            "common_windows": len(deltas),
            "anchored": s.anchor_unix is not None,
        }
    return out


def analyze_fleet(streams: List[HostStream], *,
                  ici_gb_s: float = DEFAULT_ICI_GB_S) -> Dict[str, Any]:
    """Distill N aligned host streams into the fleet attribution dict
    (``--json`` / :func:`format_report`).

    Sections: ``hosts`` (per-host timeline analysis joined with clock
    skew), ``windows`` (per common window: the slowest host, its
    dispatch dur, and the skew it imposed), ``straggler`` (who was
    slowest how often, and whether one host is the consistent
    straggler), ``collectives`` (per-op wait-vs-wire split), and
    ``loader`` (stall asymmetry).
    """
    align = align_clocks(streams)
    per_host: List[Dict[str, Any]] = []
    for s in streams:
        tl = _analyze_timeline(s.events)
        att = tl.get("attribution") or {}
        st = tl.get("step_time") or {}
        per_host.append({
            "host": s.host,
            "run_id": s.run_id,
            "path": s.path,
            "steps": tl.get("steps", 0),
            "windows": tl.get("windows", 0),
            "steps_per_s": tl.get("steps_per_s"),
            "step_time_mean_ms": st.get("mean_ms"),
            "step_time_p90_ms": st.get("p90_ms"),
            "dispatch_pct": att.get("dispatch_pct"),
            "loader_stall_pct": att.get("loader_stall_pct", 0.0),
            "clock_skew_ms": round(
                1e3 * align[s.host]["clock_skew_s"], 3),
            "alerts": (tl.get("alerts") or {}).get("total", 0),
        })

    # -- per-window straggler attribution ------------------------------------
    common = set(streams[0].windows)
    for s in streams[1:]:
        common &= set(s.windows)
    windows: List[Dict[str, Any]] = []
    slow_counts: Dict[int, int] = {}
    arrival_skews: List[float] = []
    for step in sorted(common):
        durs = {s.host: s.windows[step][1] for s in streams}
        starts = {s.host: (s.abs_start(step) or 0.0)
                  + align[s.host]["offset_s"] for s in streams}
        slowest = max(durs, key=lambda h: durs[h])
        ds = sorted(durs.values())
        median_dur = ds[len(ds) // 2]
        arrival = max(starts.values()) - min(starts.values())
        arrival_skews.append(arrival)
        slow_counts[slowest] = slow_counts.get(slowest, 0) + 1
        windows.append({
            "step": step,
            "slowest_host": slowest,
            "slowest_dur_ms": round(durs[slowest] * 1e3, 3),
            "median_dur_ms": round(median_dur * 1e3, 3),
            "skew_ms": round((durs[slowest] - median_dur) * 1e3, 3),
            "arrival_skew_ms": round(arrival * 1e3, 3),
        })
    straggler: Dict[str, Any] = {"by_host": {str(h): n for h, n
                                             in sorted(slow_counts.items())}}
    if windows:
        top_host, top_n = max(slow_counts.items(), key=lambda kv: kv[1])
        straggler.update({
            "host": top_host,
            "windows_slowest": top_n,
            "windows_total": len(windows),
            "fraction": round(top_n / len(windows), 3),
            # one machine losing >= 2/3 of the races is a machine
            # problem, not noise — the drain candidate
            "consistent": top_n >= max(2, (2 * len(windows)) // 3),
            "mean_skew_ms": round(
                sum(w["skew_ms"] for w in windows) / len(windows), 3),
        })

    # -- per-collective wait-vs-wire split -----------------------------------
    # Host streams cannot time the fabric; the split is MODELED, and
    # says so: wire = bytes / link bandwidth (the unavoidable floor),
    # wait = the mean aligned dispatch-start spread (the slowest host's
    # lateness, which every collective in the window inherits — in
    # lock-step SPMD a collective cannot complete before its last
    # participant arrives).  wait >> wire means buy scheduling, not
    # bandwidth.
    mean_arrival = (sum(arrival_skews) / len(arrival_skews)
                    if arrival_skews else 0.0)
    coll_groups: Dict[tuple, Dict[str, Any]] = {}
    for s in streams:
        tl_coll: Dict[tuple, dict] = {}
        for e in s.events:
            if e.get("kind") != "collective":
                continue
            key = (e.get("op"), json.dumps(e.get("axis")),
                   int(e.get("bytes", 0)))
            tl_coll[key] = e                 # one per compile; last wins
        for key, e in tl_coll.items():
            g = coll_groups.setdefault(key, {
                "op": e.get("op"), "axis": e.get("axis"),
                "bytes_per_step": int(e.get("bytes", 0)),
                "participants": e.get("participants"),
                "hosts": 0})
            g["hosts"] += 1
    collectives: List[Dict[str, Any]] = []
    for g in coll_groups.values():
        # topology-aware wire bytes per host (ring schedules): an N-way
        # all-reduce moves ~2(N-1)/N x the payload per link, a
        # reduce-scatter / all-gather (N-1)/N; participants rides each
        # collective event from parallel._note_collective exactly for
        # this.
        p = g.get("participants")
        if p and p > 1:
            factor = ((p - 1) / p if g["op"] in ("psum_scatter",
                                                 "reduce_scatter",
                                                 "all_gather")
                      else 2.0 * (p - 1) / p)
        else:
            factor = 1.0
        wire_s = g["bytes_per_step"] * factor / (ici_gb_s * 1e9)
        g["wire_factor"] = round(factor, 3)
        wait_s = mean_arrival
        g.update({
            "wire_ms_modeled": round(wire_s * 1e3, 4),
            "wait_ms_modeled": round(wait_s * 1e3, 4),
            "wait_pct": round(100.0 * wait_s / (wait_s + wire_s), 1)
            if (wait_s + wire_s) > 0 else None,
        })
        collectives.append(g)
    collectives.sort(key=lambda c: -c["bytes_per_step"])
    # Per-mesh-axis traffic split: the axis names riding
    # every collective event from parallel._note_collective attribute
    # wire/wait per mesh dimension (dp vs fsdp vs tp) — "is the FSDP
    # gather or the DP psum eating the step" becomes one read.
    from .timeline import axis_label
    by_axis: Dict[str, Dict[str, Any]] = {}
    for g in collectives:
        d = by_axis.setdefault(axis_label(g.get("axis")), {
            "bytes_per_step": 0, "wire_ms_modeled": 0.0, "ops": set()})
        d["bytes_per_step"] += g["bytes_per_step"]
        d["wire_ms_modeled"] = round(
            d["wire_ms_modeled"] + (g.get("wire_ms_modeled") or 0.0), 4)
        d["ops"].add(g["op"])
    by_axis = {k: {"bytes_per_step": v["bytes_per_step"],
                   "wire_ms_modeled": v["wire_ms_modeled"],
                   "ops": sorted(v["ops"])}
               for k, v in sorted(by_axis.items())}

    # -- loader-stall asymmetry ----------------------------------------------
    stalls = {h["host"]: float(h["loader_stall_pct"] or 0.0)
              for h in per_host}
    loader: Dict[str, Any] = {"by_host": {str(h): round(v, 2) for h, v
                                          in sorted(stalls.items())}}
    if stalls:
        worst = max(stalls, key=lambda h: stalls[h])
        spread = max(stalls.values()) - min(stalls.values())
        loader.update({
            "worst_host": worst,
            "spread_pct_points": round(spread, 2),
            # one host stalling while the rest stream is an input-path
            # asymmetry (bad disk, hot shard, noisy neighbor) — the
            # whole lock-step mesh runs at that host's pace
            "asymmetric": spread > 10.0,
        })

    return {
        "schema_version": SCHEMA_VERSION,
        "n_hosts": len(streams),
        "hosts": per_host,
        "alignment": {str(h): a for h, a in sorted(align.items())},
        "windows": windows,
        "straggler": straggler,
        "collectives": {"ici_gb_s_modeled": ici_gb_s,
                        "mean_arrival_skew_ms": round(mean_arrival * 1e3,
                                                      4),
                        "by_op": collectives,
                        "by_axis": by_axis},
        "loader": loader,
    }


def to_fleet_chrome_trace(streams: List[HostStream], out_path: str) -> int:
    """Merged Chrome trace: one ``pid`` lane per host, all on the
    aligned clock (earliest aligned event is ``ts == 0``).  Open in
    Perfetto — the fleet timeline the per-host files could never
    show."""
    align = align_clocks(streams)
    bases = []
    for s in streams:
        bases.append((s.anchor_unix or 0.0) + align[s.host]["offset_s"])
    t0 = min(bases) if bases else 0.0
    out: List[dict] = []
    n = 0
    for s, base in zip(streams, bases):
        evs = chrome_events(
            s.events, pid=s.host,
            host=f"host {s.host}"
                 + (f" of {s.process_count}" if s.process_count else ""),
            t_offset_s=base - t0)
        n += sum(1 for e in evs if e["ph"] != "M")
        out.extend(evs)
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump({"traceEvents": out, "displayTimeUnit": "ms"}, f)
    return n


# -- synthetic fixture --------------------------------------------------------

def synthetic_fleet(n_hosts: int = 4, n_windows: int = 12, k: int = 4,
                    *, slow_host: int = 2, slow_factor: float = 1.6,
                    base_dur_s: float = 0.040,
                    clock_err_s: Optional[Sequence[float]] = None,
                    stall_host: Optional[int] = None,
                    seed: int = 0,
                    dir: Optional[str] = None):
    """Deterministic N-host stream fixture (the tests'): host ``slow_host`` dispatches every window
    ``slow_factor`` x slower, ``stall_host`` (default: the slow host)
    reports an asymmetric loader stall, and each host's wall-clock
    anchor carries an injected error (``clock_err_s``, default ±40 ms
    alternating) the aligner must recover.  Jitter is seeded — the same
    fixture analyses identically everywhere.

    Returns a list of per-host event lists, or (with ``dir``) writes
    ``host<i>.jsonl`` files and returns their paths."""
    import random
    rng = random.Random(seed)
    if clock_err_s is None:
        clock_err_s = [((-1) ** h) * 0.040 * (1 + h // 2)
                       for h in range(n_hosts)]
    if stall_host is None:
        stall_host = slow_host
    anchor_base = 1_700_000_000.0       # any fixed epoch; never "now"
    fleet: List[List[dict]] = []
    global_t = [0.5]                     # true time the window starts
    for h in range(n_hosts):
        events: List[dict] = []
        anchor = anchor_base + clock_err_s[h]

        def ev(t_global, kind, **fields):
            # stream time is true time since this host's recorder
            # opened; the ANCHOR carries the clock error, exactly as a
            # skewed time.time() would
            events.append({"t": round(t_global, 6), "kind": kind,
                           **fields})
        ev(0.0, "run", run_id=f"fleet-fixture-{seed}",
           meta={"example": "synthetic"}, process_index=h,
           process_count=n_hosts, anchor_unix=round(anchor, 6),
           segment=0)
        ev(0.2, "collective", op="psum", axis="data",
           bytes=4_000_000, n=2, dtype="float32", participants=n_hosts)
        fleet.append(events)

    t = global_t[0]
    for w in range(n_windows):
        durs = []
        for h in range(n_hosts):
            dur = base_dur_s * (slow_factor if h == slow_host else 1.0)
            dur *= 1.0 + 0.02 * rng.random()       # 2% jitter, seeded
            durs.append(dur)
        for h in range(n_hosts):
            start = t + 0.001 * rng.random()       # dispatch jitter
            end = start + durs[h]
            fleet[h].append({"t": round(end, 6), "kind": "window",
                             "step": w * k, "k": k, "n_valid": k,
                             "dur": round(durs[h], 6),
                             "gap": 0.002, "program": "hot"})
            if h == stall_host:
                fleet[h].append({"t": round(end + 0.001, 6),
                                 "kind": "loader_wait",
                                 "dur": round(0.35 * durs[h], 6),
                                 "qdepth": 0})
        # the fleet advances at the SLOWEST host's pace (lock-step SPMD)
        t += max(durs) + 0.004
    for h in range(n_hosts):
        stall_pct = 35.0 if h == stall_host else 4.0
        fleet[h].append({"t": round(t, 6), "kind": "loader",
                         "phase": "exhausted",
                         "stats": {"loader_stall_pct": stall_pct,
                                   "consumer_wait_s": 0.0,
                                   "produce_s": 0.1, "stage_s": 0.05,
                                   "mean_queue_depth": 1.5,
                                   "batches": n_windows}})
        fleet[h].append({"t": round(t + 0.01, 6), "kind": "summary",
                         "events": {"window": n_windows}, "metrics": {}})
    if dir is None:
        return fleet
    import os
    paths = []
    for h, events in enumerate(fleet):
        p = os.path.join(dir, f"host{h}.jsonl")
        with open(p, "w", encoding="utf-8") as f:
            for e in events:
                f.write(json.dumps(e) + "\n")
        paths.append(p)
    return paths


# -- report / CLI -------------------------------------------------------------

def _fmt(v, unit="", width=8, prec=2):
    if v is None:
        return " " * (width - 3) + "n/a"
    return f"{v:{width}.{prec}f}{unit}"


def format_report(a: Dict[str, Any]) -> str:
    """Human-readable fleet report (the CLI's default output)."""
    lines: List[str] = []
    lines.append(f"fleet timeline — {a['n_hosts']} hosts, "
                 f"{len(a.get('windows') or [])} common windows")
    lines.append("{:<6} {:>8} {:>10} {:>10} {:>10} {:>10} {:>7}".format(
        "host", "steps", "steps/s", "step ms", "stall %", "skew ms",
        "alerts"))
    for h in a.get("hosts", []):
        lines.append("{:<6} {:>8} {:>10} {:>10} {:>10} {:>10} {:>7}".format(
            h["host"], h["steps"],
            h["steps_per_s"] if h["steps_per_s"] is not None else "n/a",
            h["step_time_mean_ms"] if h["step_time_mean_ms"] is not None
            else "n/a",
            h["loader_stall_pct"], h["clock_skew_ms"], h["alerts"]))
    st = a.get("straggler") or {}
    if st.get("windows_total"):
        verdict = ("CONSISTENT straggler — drain/replace candidate"
                   if st.get("consistent") else "no consistent straggler")
        lines.append(
            f"straggler: host {st['host']} slowest in "
            f"{st['windows_slowest']}/{st['windows_total']} windows "
            f"({100 * st['fraction']:.0f}%) — {verdict}")
        by = ", ".join(f"host {h}: {n}"
                       for h, n in (st.get("by_host") or {}).items())
        lines.append(f"  slowest-per-window counts: {by}")
    co = a.get("collectives") or {}
    if co.get("by_op"):
        lines.append(
            f"collectives (modeled @ {co['ici_gb_s_modeled']} GB/s link, "
            f"arrival skew {co['mean_arrival_skew_ms']} ms):")
        for c in co["by_op"][:8]:
            lines.append(
                f"  {c['op']:<14} {c['bytes_per_step'] / 1e6:8.3f} MB/step"
                f"  wire {c['wire_ms_modeled']} ms"
                f"  wait {c['wait_ms_modeled']} ms"
                f"  ({c['wait_pct']}% wait)")
    lo = a.get("loader") or {}
    if lo.get("by_host"):
        flag = (" — ASYMMETRIC input path"
                if lo.get("asymmetric") else "")
        lines.append(
            f"loader stall by host: {lo['by_host']} "
            f"(spread {lo.get('spread_pct_points')} pts, worst host "
            f"{lo.get('worst_host')}){flag}")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.prof.fleet",
        description="Merge N per-host telemetry streams: clock "
                    "alignment, straggler attribution, wait-vs-wire, "
                    "loader asymmetry, fleet Chrome trace.")
    p.add_argument("streams", nargs="+",
                   help="per-host .jsonl paths / globs / rotated sets "
                        "(quote globs so the shell does not pre-expand "
                        "rotated segments into duplicates)")
    p.add_argument("--json", action="store_true",
                   help="emit the analysis as JSON instead of the report")
    p.add_argument("--chrome", metavar="OUT",
                   help="write a merged Chrome trace_event file with "
                        "one pid lane per host (Perfetto)")
    p.add_argument("--ici-gb-s", type=float, default=DEFAULT_ICI_GB_S,
                   help=f"modeled link bandwidth for the wire half of "
                        f"the wait-vs-wire split "
                        f"(default {DEFAULT_ICI_GB_S})")
    args = p.parse_args(argv)
    try:
        streams = load_fleet(args.streams)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if len(streams) < 2:
        print(f"warning: only {len(streams)} stream(s) matched — the "
              f"fleet view needs one per host (single-stream analysis: "
              f"python -m apex_tpu_torch.prof.timeline)", file=sys.stderr)
    a = analyze_fleet(streams, ici_gb_s=args.ici_gb_s)
    if args.chrome:
        n = to_fleet_chrome_trace(streams, args.chrome)
        print(f"wrote {n} chrome trace events "
              f"({len(streams)} pid lanes) to {args.chrome}",
              file=sys.stderr)
    try:
        if args.json:
            print(json.dumps(a, indent=1))
        else:
            print(format_report(a))
    except BrokenPipeError:
        try:
            sys.stdout.close()
        except Exception:
            pass
    return 0


if __name__ == "__main__":  # pragma: no cover - exercised via subprocess
    sys.exit(main())
