"""Cross-run regression differ — counterpart of
``apex_tpu/prof/regress.py``.

Diffs two summaries (``python -m apex_tpu_torch.prof.timeline ...
--json`` outputs, schema-versioned: a future major is refused) and exits
non-zero when a metric regressed past its tolerance.  The direction
comes from the metric's name (times, stalls, gaps, retraces, alerts:
lower is better; rates, goodput: higher is better; anything else is
reported and never fails); the default tolerance is 10% relative, per
metric with ``--tol`` (longest substring wins); ``*_pct`` metrics get 2
points of absolute slack.  Exit codes: 0 none, 1 regressions, 2 a usage
or schema error.

::

    python -m apex_tpu_torch.prof.timeline base.jsonl --json > base.json
    python -m apex_tpu_torch.prof.timeline cur.jsonl  --json > cur.json
    python -m apex_tpu_torch.prof.regress base.json cur.json \\
        --tol steps_per_s=5 --tol p99_ms=25
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .timeline import check_schema_version

__all__ = ["flatten_metrics", "diff_summaries", "main"]

#: default relative tolerance, percent
DEFAULT_TOL_PCT = 10.0
#: absolute slack (same unit as the metric) for percentage-point
#: metrics — noise floor for near-zero stall/gap percentages
PCT_POINT_SLACK = 2.0

# Name patterns -> direction.  HIGHER-better is checked first
# ("steps_per_s" is throughput); the rate pattern requires per_s/per_sec
# to end a word so "ms_per_step_o2" (a time) cannot match it.
import re as _re

_HIGHER_RE = _re.compile(
    r"per_s(ec)?(_|$|\.)|img_s|it_s(_|$)|tok_s|tflops|mfu|speedup|gb_s"
    r"|(^|_)bw(_|$)|coverage|img/s|goodput")
_LOWER_RE = _re.compile(
    r"_ms(_|$|\.)|(^|\.)ms_|(^|_)time|stall|gap|retrace|skips|alert"
    r"|overhead|wall|compile|(^|_)dur(_|$)|wait|spread|_s$|_s\."
    r"|burn_(short|long|rate)")
# keys that are identifiers/config, never compared even though numeric
_SKIP_FRAGMENTS = ("schema_version", "batch", "seq", "iters", "n_params",
                   "n_tensors", "n_leaves", "n_buckets", "image_size",
                   "samples", "n_events", "windows", "reservoir", "count",
                   "n_dense", "heads", "head_dim", "tolerance", "gate",
                   # run length is config, not performance: two streams
                   # of different step counts must not diff on elapsed
                   "elapsed", "steps_traced")


def flatten_metrics(obj: Any, prefix: str = "") -> Dict[str, float]:
    """Flatten nested dicts into dotted numeric leaves; lists, strings,
    bools, and None are skipped (trajectories and labels are not
    metrics)."""
    out: Dict[str, float] = {}
    if not isinstance(obj, dict):
        return out
    for k, v in obj.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_metrics(v, key))
        elif isinstance(v, bool) or v is None:
            continue
        elif isinstance(v, (int, float)):
            out[key] = float(v)
    return out


def _direction(key: str) -> Optional[str]:
    kl = key.lower()
    for frag in _SKIP_FRAGMENTS:
        if frag in kl:
            return None
    if _HIGHER_RE.search(kl):
        return "higher"
    if _LOWER_RE.search(kl):
        return "lower"
    return None


def _tol_for(key: str, tols: Dict[str, float], default: float) -> float:
    """Most specific (longest) substring override wins."""
    best: Tuple[int, float] = (-1, default)
    for frag, pct in tols.items():
        if frag in key and len(frag) > best[0]:
            best = (len(frag), pct)
    return best[1]


def diff_summaries(base: Dict[str, Any], cur: Dict[str, Any], *,
                   tolerances: Optional[Dict[str, float]] = None,
                   default_tol_pct: float = DEFAULT_TOL_PCT
                   ) -> Dict[str, Any]:
    """Compare two summary dicts; returns ``{"regressions": [...],
    "improvements": [...], "unchanged": n, "skipped": n}`` where each
    entry is ``{metric, base, cur, ratio, tol_pct, direction}``.

    Only metrics present in BOTH inputs are judged.  A lower-is-better
    metric regresses when ``cur > base * (1 + tol) + slack``; a
    higher-is-better one when ``cur < base * (1 - tol) - slack``
    (``slack`` is :data:`PCT_POINT_SLACK` for ``*pct*`` keys, else 0 —
    so integer counters like retraces/alerts fail on ANY increase from
    zero).

    The result dict is schema-versioned like ``timeline --json``:
    CI consumes ``--json`` output and annotates
    regressions machine-readably instead of parsing stderr, and
    :func:`~apex_tpu_torch.prof.timeline.check_schema_version` protects it
    from a future tool's incompatible diff shape the same way."""
    from .timeline import SCHEMA_VERSION
    tolerances = tolerances or {}
    fb, fc = flatten_metrics(base), flatten_metrics(cur)
    regressions: List[dict] = []
    improvements: List[dict] = []
    unchanged = skipped = 0
    for key in sorted(set(fb) & set(fc)):
        direction = _direction(key)
        if direction is None:
            skipped += 1
            continue
        b, c = fb[key], fc[key]
        tol = _tol_for(key, tolerances, default_tol_pct) / 100.0
        slack = PCT_POINT_SLACK if "pct" in key.lower() else 0.0
        entry = {"metric": key, "base": b, "cur": c,
                 "ratio": (round(c / b, 4) if b else None),
                 "tol_pct": round(tol * 100.0, 2), "direction": direction}
        if direction == "lower":
            if c > b * (1.0 + tol) + slack:
                regressions.append(entry)
            elif c < b * (1.0 - tol) - slack:
                improvements.append(entry)
            else:
                unchanged += 1
        else:
            if c < b * (1.0 - tol) - slack:
                regressions.append(entry)
            elif c > b * (1.0 + tol) + slack:
                improvements.append(entry)
            else:
                unchanged += 1
    return {"schema_version": SCHEMA_VERSION,
            "regressions": regressions, "improvements": improvements,
            "unchanged": unchanged, "skipped": skipped}


def _load(path: str) -> Dict[str, Any]:
    with open(path, encoding="utf-8") as f:
        obj = json.load(f)
    if not isinstance(obj, dict):
        raise ValueError(f"{path}: expected a JSON object summary")
    if isinstance(obj.get("parsed"), dict):
        # a wrapper that keeps its summary under "parsed", next to run
        # metadata: diff the summary
        obj = obj["parsed"]
    check_schema_version(obj, where=path)
    return obj


def _fmt(entry: dict) -> str:
    arrow = {"lower": "^", "higher": "v"}[entry["direction"]]
    ratio = (f" ({entry['ratio']}x)" if entry["ratio"] is not None else "")
    return (f"  {arrow} {entry['metric']}: {entry['base']:g} -> "
            f"{entry['cur']:g}{ratio}  [tol {entry['tol_pct']}%]")


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.prof.regress",
        description="Diff two timeline summaries; exit 1 on "
                    "regressions past per-metric tolerances.")
    p.add_argument("base", help="baseline summary JSON "
                               "(timeline --json output)")
    p.add_argument("current", help="current summary JSON")
    p.add_argument("--tol", action="append", default=[],
                   metavar="METRIC=PCT",
                   help="per-metric tolerance override (substring match, "
                        "longest wins); repeatable")
    p.add_argument("--tol-default", type=float, default=DEFAULT_TOL_PCT,
                   help=f"default relative tolerance in percent "
                        f"(default {DEFAULT_TOL_PCT})")
    p.add_argument("--json", action="store_true",
                   help="emit the full diff as JSON")
    args = p.parse_args(argv)

    tols: Dict[str, float] = {}
    for spec in args.tol:
        name, _, pct = spec.partition("=")
        try:
            tols[name] = float(pct)
        except ValueError:
            print(f"error: --tol expects METRIC=PCT, got {spec!r}",
                  file=sys.stderr)
            return 2
    try:
        base, cur = _load(args.base), _load(args.current)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    diff = diff_summaries(base, cur, tolerances=tols,
                          default_tol_pct=args.tol_default)
    if args.json:
        print(json.dumps(diff, indent=1))
    else:
        n_reg = len(diff["regressions"])
        print(f"regress: {args.base} -> {args.current}: "
              f"{n_reg} regression(s), {len(diff['improvements'])} "
              f"improvement(s), {diff['unchanged']} within tolerance, "
              f"{diff['skipped']} unclassified")
        for e in diff["regressions"]:
            print(_fmt(e))
        if diff["improvements"]:
            print("improvements:")
            for e in diff["improvements"][:12]:
                print(_fmt(e))
    return 1 if diff["regressions"] else 0


if __name__ == "__main__":  # pragma: no cover - exercised via subprocess
    sys.exit(main())
