"""Per-request serving analysis — TTFT/TPOT percentiles, request
waterfalls and SLO goodput from a telemetry stream; counterpart of
``apex_tpu/prof/requests.py``.

The serving engine emits a ``done`` ``serving`` event for every
finished request (``ttft_s``, ``tpot_s``, ``total_s``, ``queue_wait_s``)
and, for sampled requests, a ``span`` tree (a ``request`` root with
``queue``, ``prefill`` and ``decode_step`` children).  This module
reads both back:

* percentiles over every request (exact, from the ``done`` events, with
  the registry's nearest-rank definition);
* goodput against an SLO spec (:func:`apex_tpu_torch.telemetry.slo.
  evaluate`, the online engine's own predicate);
* the mean decode-step time by batch size;
* per-request waterfalls, exportable as a Chrome trace with one lane a
  request (``--chrome``).

Usage::

    python -m apex_tpu_torch.prof.requests serve.jsonl
    python -m apex_tpu_torch.prof.requests serve.jsonl --slo 'ttft_p99<200ms,tpot_p99<30ms'

Several streams merge onto the first one's clock through
:mod:`apex_tpu_torch.prof.fleet`'s alignment.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional, Sequence

from ..telemetry.events import _iter_events, chrome_events
from ..telemetry.metrics import nearest_rank_percentiles
from ..telemetry.slo import evaluate as evaluate_slo

__all__ = ["load_request_events", "request_stats", "build_waterfalls",
           "analyze", "to_request_chrome_trace", "format_report", "main"]

_PCT_QS = (50.0, 90.0, 99.0)
#: report metric -> field name on the ``done`` serving event
_METRICS = (("ttft", "ttft_s"), ("tpot", "tpot_s"),
            ("e2e", "total_s"), ("queue_wait", "queue_wait_s"))


def load_request_events(streams: Sequence[str]) -> List[dict]:
    """Load one or more stream arguments into a single event list on a
    common clock.  One argument loads directly (rotated segments
    reassemble, stream time untouched).  Several arguments go through
    :func:`~apex_tpu_torch.prof.fleet.load_fleet` +
    :func:`~apex_tpu_torch.prof.fleet.align_clocks`: every host's events are
    shifted onto host 0's stream clock (anchor delta + residual window
    skew) and tagged with their ``host`` index, so cross-host request
    sets sort into one timeline."""
    streams = list(streams)
    if len(streams) == 1:
        return _iter_events(streams[0])
    from .fleet import align_clocks, load_fleet
    hosts = load_fleet(streams)
    corr = align_clocks(hosts)
    ref_anchor = hosts[0].anchor_unix or 0.0
    merged: List[dict] = []
    for s in hosts:
        off = ((s.anchor_unix or 0.0) - ref_anchor
               + float(corr.get(s.host, {}).get("offset_s", 0.0) or 0.0))
        for e in s.events:
            e = dict(e)
            e["t"] = round(float(e.get("t", 0.0)) + off, 6)
            e.setdefault("host", s.host)
            merged.append(e)
    merged.sort(key=lambda e: float(e.get("t", 0.0)))
    return merged


def _dones(events: Sequence[dict]) -> List[dict]:
    return [e for e in events
            if e.get("kind") == "serving" and e.get("phase") == "done"
            and e.get("total_s") is not None]


def request_stats(events: Sequence[dict]) -> Optional[Dict[str, Any]]:
    """Percentile summary over every finished request in ``events``
    (``None`` when the stream holds no serving ``done`` events) — the
    ``requests`` section :func:`apex_tpu_torch.prof.timeline.analyze` embeds
    (timeline schema 1.2)."""
    dones = _dones(events)
    if not dones:
        return None
    out: Dict[str, Any] = {"n_requests": len(dones)}
    toks = [int(e.get("n_tokens", 0)) for e in dones]
    out["tokens_out"] = sum(toks)
    for name, field in _METRICS:
        vals = [float(e[field]) for e in dones
                if e.get(field) is not None]
        p50, p90, p99 = nearest_rank_percentiles(vals, _PCT_QS)
        out[name] = {
            "n": len(vals),
            "mean_ms": (round(1e3 * sum(vals) / len(vals), 3)
                        if vals else None),
            "p50_ms": round(1e3 * p50, 3) if p50 is not None else None,
            "p90_ms": round(1e3 * p90, 3) if p90 is not None else None,
            "p99_ms": round(1e3 * p99, 3) if p99 is not None else None,
        }
    # the continuous-batching cost curve: mean decode-step duration by
    # how many sequences shared the step (a decode event's ``dur`` IS
    # the per-token latency every member of that batch experienced)
    by_bs: Dict[int, List[float]] = {}
    for e in events:
        if e.get("kind") == "serving" and e.get("phase") == "decode":
            by_bs.setdefault(int(e.get("active", 0)), []).append(
                float(e.get("dur", 0.0)))
    out["batch_tpot"] = [
        {"batch_size": bs, "steps": len(durs),
         "mean_step_ms": round(1e3 * sum(durs) / len(durs), 3)}
        for bs, durs in sorted(by_bs.items()) if bs > 0]
    return out


def build_waterfalls(events: Sequence[dict],
                     limit: Optional[int] = None
                     ) -> List[Dict[str, Any]]:
    """Reassemble the sampled ``span`` events into per-request
    waterfalls: one entry per trace id, spans sorted by start time
    (``start = t - dur``; the emitter stamps ``t`` at span END).  Only
    sampled requests appear here — the percentile sections above cover
    every request regardless of sampling."""
    by_trace: Dict[str, List[dict]] = {}
    for e in events:
        if e.get("kind") == "span" and e.get("trace"):
            by_trace.setdefault(str(e["trace"]), []).append(e)
    out: List[Dict[str, Any]] = []
    for trace, spans in by_trace.items():
        rows = []
        for e in spans:
            dur = float(e.get("dur", 0.0))
            row = {"name": e.get("name"),
                   "span": e.get("span"), "parent": e.get("parent"),
                   "start_s": round(float(e.get("t", 0.0)) - dur, 6),
                   "dur_ms": round(1e3 * dur, 3)}
            for k in ("slot", "bucket", "batch_size", "prompt_len",
                      "n_tokens", "step", "host"):
                if k in e:
                    row[k] = e[k]
            rows.append(row)
        rows.sort(key=lambda r: (r["start_s"], -r["dur_ms"]))
        root = next((r for r in rows if r.get("parent") is None
                     and r["name"] == "request"), None)
        out.append({
            "trace": trace,
            "n_spans": len(rows),
            "start_s": rows[0]["start_s"] if rows else None,
            "e2e_ms": root["dur_ms"] if root else None,
            "decode_steps": sum(1 for r in rows
                                if r["name"] == "decode_step"),
            "spans": rows,
        })
    out.sort(key=lambda w: (w["start_s"] is None, w["start_s"]))
    return out[:limit] if limit is not None else out


def analyze(events: Sequence[dict],
            slo: Optional[str] = None) -> Dict[str, Any]:
    """Distill a loaded event list into the per-request report dict
    (``format_report`` / ``--json``).  ``slo`` adds a goodput section
    evaluated with the online engine's own predicate."""
    dones = _dones(events)
    run = next((e for e in events if e.get("kind") == "run"), {})
    out: Dict[str, Any] = {
        "n_events": len(events),
        "run_id": run.get("run_id"),
        "requests": request_stats(events),
        "waterfalls": build_waterfalls(events),
    }
    out["n_sampled"] = len(out["waterfalls"])
    if slo and dones:
        out["slo"] = evaluate_slo(slo, dones)
    # the engine's own closing summary, when the stream has one — the
    # its reservoir percentiles sit beside the exact ones above
    summary = next((e for e in reversed(events)
                    if e.get("kind") == "summary"), None)
    if summary is not None and summary.get("slo") is not None:
        out["slo_online"] = summary["slo"]
    return out


def to_request_chrome_trace(events: Sequence[dict], out_path: str,
                            max_lanes: int = 64) -> int:
    """Export the sampled waterfalls as a Chrome ``trace_event`` file
    with ONE process lane per request (lane name = trace id) — open in
    Perfetto and each request reads as its own queue/prefill/decode
    waterfall.  Returns the number of non-metadata trace events; lanes
    beyond ``max_lanes`` are dropped (earliest requests win)."""
    falls = build_waterfalls(events)
    by_trace: Dict[str, List[dict]] = {}
    for e in events:
        if e.get("kind") == "span" and e.get("trace"):
            by_trace.setdefault(str(e["trace"]), []).append(e)
    out: List[dict] = []
    for lane, w in enumerate(falls[:max_lanes]):
        out.extend(chrome_events(by_trace[w["trace"]], pid=lane,
                                 host=f"req {w['trace']}"))
    n = sum(1 for e in out if e["ph"] != "M")
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump({"traceEvents": out, "displayTimeUnit": "ms"}, f)
    return n


def _fmt_row(name: str, d: Optional[Dict[str, Any]]) -> str:
    if not d or not d.get("n"):
        return f"  {name:<11} (no samples)"
    return (f"  {name:<11} mean {d['mean_ms']:>9.3f}  "
            f"p50 {d['p50_ms']:>9.3f}  p90 {d['p90_ms']:>9.3f}  "
            f"p99 {d['p99_ms']:>9.3f} ms  ({d['n']} requests)")


def format_report(a: Dict[str, Any]) -> str:
    """Human-readable report (the CLI's default output)."""
    lines: List[str] = []
    rid = f" (run {a['run_id']})" if a.get("run_id") else ""
    st = a.get("requests")
    if not st:
        return (f"no finished serving requests in the stream "
                f"({a.get('n_events', 0)} events){rid}")
    lines.append(f"serving requests — {st['n_requests']} finished, "
                 f"{st['tokens_out']} tokens out, "
                 f"{a.get('n_sampled', 0)} traced{rid}")
    for name, _field in _METRICS:
        lines.append(_fmt_row(name, st.get(name)))
    bt = st.get("batch_tpot") or []
    if bt:
        curve = "  ".join(f"bs{r['batch_size']}={r['mean_step_ms']:.3f}ms"
                          f"(x{r['steps']})" for r in bt)
        lines.append(f"decode step by batch size: {curve}")
    slo = a.get("slo")
    if slo:
        verdict = ("met" if slo["met"] else "MISSED"
                   ) if slo["met"] is not None else "n/a"
        lines.append(f"slo [{slo['spec']}]: goodput "
                     f"{slo['goodput_pct']}% of target "
                     f"{slo['target_pct']}% — {verdict}")
        for o in slo.get("objectives", []):
            ach = (f"{1e3 * o['achieved_s']:.3f} ms"
                   if o.get("achieved_s") is not None else "n/a")
            mark = "ok" if o["ok"] else "VIOLATED"
            lines.append(f"  {o['objective']:<24} achieved {ach:>12}  "
                         f"{mark}")
    for w in a.get("waterfalls", [])[:8]:
        lines.append(f"trace {w['trace']}: {w['n_spans']} spans, "
                     f"{w['decode_steps']} decode steps, "
                     f"e2e {w['e2e_ms']} ms")
        for r in w["spans"][:6]:
            extra = "".join(f" {k}={r[k]}" for k in
                            ("slot", "bucket", "batch_size",
                             "prompt_len", "n_tokens") if k in r)
            lines.append(f"    {r['name']:<12} +{r['start_s']:.6f}s  "
                         f"{r['dur_ms']:>9.3f} ms{extra}")
        if w["n_spans"] > 6:
            lines.append(f"    ... {w['n_spans'] - 6} more spans")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.prof.requests",
        description="Per-request serving analysis of an apex_tpu "
                    "telemetry stream: TTFT/TPOT percentiles, SLO "
                    "goodput, traced-request waterfalls.")
    p.add_argument("streams", nargs="+",
                   help="one or more .jsonl event streams (globs and "
                        "rotated sets expand; several hosts merge onto "
                        "host 0's clock)")
    p.add_argument("--slo", metavar="SPEC",
                   help="evaluate goodput against a spec, e.g. "
                        "'ttft_p99<200ms,tpot_p99<30ms'")
    p.add_argument("--json", action="store_true",
                   help="emit the analysis as JSON instead of the report")
    p.add_argument("--chrome", metavar="OUT",
                   help="export sampled requests as a Chrome trace_event "
                        "file, one process lane per request")
    p.add_argument("--lanes", type=int, default=64,
                   help="max request lanes in the Chrome export "
                        "(default 64)")
    args = p.parse_args(argv)
    try:
        events = load_request_events(args.streams)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if not events:
        print(f"no events in {args.streams}", file=sys.stderr)
        return 1
    a = analyze(events, slo=args.slo)
    if args.chrome:
        n = to_request_chrome_trace(events, args.chrome,
                                    max_lanes=args.lanes)
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
    raise SystemExit(main())
