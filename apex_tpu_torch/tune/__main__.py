"""``python -m apex_tpu_torch.tune`` — the tuner's CLI.

Counterpart of ``python -m apex_tpu.tune``, with its subcommands and
flags::

    # tune one family at its main-path shape (or --shape k=v,...)
    python -m apex_tpu_torch.tune kernel flash_attention
    python -m apex_tpu_torch.tune kernel quantized_matmul --shape m=1024

    # tune every family, each candidate order from a roofline ledger's
    # verdicts (python -m apex_tpu_torch.prof.roofline --json output)
    python -m apex_tpu_torch.tune ledger LEDGER.json

    # the cached table, and the entries a TUNE_VERSION bump stranded
    python -m apex_tpu_torch.tune show
    python -m apex_tpu_torch.tune prune

Results go to the config cache (``--cache`` overrides where; see
:mod:`apex_tpu_torch.tune.store`), keyed by (card, kernel, version,
bucket); every family's wrapper consults it on its kernel path.
Measuring needs the card; ``--interpret`` runs the plain versions on the
CPU (the determinism tests).  Dispatch itself never tunes.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

from . import measure, registry, store

__all__ = ["main"]


def _parse_shape(specs) -> dict:
    """``k=v[,k=v...]`` (repeatable) -> a shape dict; ints, bools and
    floats parsed, anything else kept as a string (dtype names)."""
    out = {}
    for spec in specs or ():
        for part in spec.split(","):
            if not part.strip():
                continue
            key, eq, val = part.partition("=")
            if not eq:
                raise SystemExit(f"--shape expects k=v, got {part!r}")
            v = val.strip()
            if v.lower() in ("true", "false"):
                out[key.strip()] = v.lower() == "true"
                continue
            for conv in (int, float):
                try:
                    out[key.strip()] = conv(v)
                    break
                except ValueError:
                    pass
            else:
                out[key.strip()] = v
    return out


def _result_row(res) -> dict:
    return {"kernel": res.kernel, "version": res.version,
            "bucket": res.bucket, "device_kind": res.device_kind,
            "bound": res.bound, "config": res.config,
            "default_config": res.default_config,
            "best_ms": res.best_ms, "default_ms": res.default_ms,
            "tuned_over_default": res.tuned_over_default,
            "candidates": res.candidates,
            "rejected_constraint": res.rejected_constraint,
            "rejected_oracle": res.rejected_oracle,
            "rejected_kernel": res.rejected_kernel,
            "truncated": res.truncated,
            "stored": res.stored, "source": res.source}


def _print_result(res) -> None:
    print(f"{res.kernel} [{res.bucket}] on {res.device_kind} "
          f"({res.bound}-bound priority, {res.source}):")
    print(f"  default {res.default_config} -> {res.default_ms} ms")
    print(f"  tuned   {res.config} -> {res.best_ms} ms "
          f"({res.tuned_over_default}x default; {res.candidates} "
          f"measured, {res.rejected_constraint} constraint-rejected, "
          f"{res.rejected_oracle} oracle-rejected, {res.rejected_kernel} "
          f"refused by the kernels, {res.truncated} truncated)")


def _show(args) -> int:
    rows = store.entries(args.cache)
    if args.json:
        print(json.dumps(rows, indent=1))
        return 0
    if not rows:
        print(f"no tuned configs at {store.cache_path(args.cache)}")
        return 0
    print(f"config cache: {store.cache_path(args.cache)}")
    print("{:<24} {:<17} {:>3}  {:<44} {}".format(
        "device", "kernel", "ver", "bucket", "config"))
    for row in rows:
        meta = row.get("meta") or {}
        extra = ""
        if meta.get("best_ms") is not None:
            extra = (f"  [{meta.get('default_ms')} -> "
                     f"{meta.get('best_ms')} ms, {meta.get('source')}]")
        print("{:<24} {:<17} {:>3}  {:<44} {}{}".format(
            row.get("device_kind", "?"), row.get("kernel", "?"),
            row.get("version", "?"), row.get("bucket", "?"),
            json.dumps(row.get("config")), extra))
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.tune",
        description="Per-card kernel-config tuner.")
    sub = ap.add_subparsers(dest="cmd", required=True)

    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--cache", default=None, metavar="PATH",
                        help="config-cache file or directory (default: "
                             "APEX_TPU_TUNE_CACHE, the compilation-cache "
                             "directory, or ~/.cache/apex_tpu)")
    common.add_argument("--json", action="store_true")

    tune_common = argparse.ArgumentParser(add_help=False, parents=[common])
    tune_common.add_argument("--shape", action="append", default=[],
                             metavar="K=V[,K=V...]",
                             help="shape overrides (repeatable)")
    tune_common.add_argument("--iters", type=int, default=5)
    tune_common.add_argument("--reps", type=int, default=3)
    tune_common.add_argument("--seed", type=int, default=0,
                             help="candidate-order seed")
    tune_common.add_argument("--max-candidates", type=int, default=None)
    tune_common.add_argument("--interpret", action="store_true",
                             help="run the plain versions on the CPU "
                                  "(measuring otherwise needs the card)")
    tune_common.add_argument("--no-store", action="store_true",
                             help="measure and report only")

    pk = sub.add_parser("kernel", parents=[tune_common],
                        help="tune one registered family")
    pk.add_argument("name", help="registered family name")
    pk.add_argument("--bound", choices=("compute", "memory"), default=None,
                    help="candidate-order override")

    pl_ = sub.add_parser("ledger", parents=[tune_common],
                         help="tune every family, each candidate order "
                              "from a roofline ledger")
    pl_.add_argument("path", help="mfu_ledger JSON (python -m "
                                  "apex_tpu_torch.prof.roofline --json)")

    sub.add_parser("show", parents=[common],
                   help="print the cached config table")
    sub.add_parser("prune", parents=[common],
                   help="drop entries whose family bumped its "
                        "TUNE_VERSION")

    args = ap.parse_args(argv)

    if args.cmd == "prune":
        n = store.prune_stale(registry.registered_versions(),
                              path=args.cache)
        msg = {"pruned": n, "cache": store.cache_path(args.cache)}
        print(json.dumps(msg) if args.json
              else f"pruned {n} stale entr(ies) from {msg['cache']}")
        return 0
    if args.cmd == "show":
        return _show(args)

    kwargs = dict(seed=args.seed, iters=args.iters, reps=args.reps,
                  max_candidates=args.max_candidates,
                  interpret=args.interpret,
                  store_result=not args.no_store, path=args.cache)
    shape = _parse_shape(args.shape) or None
    if args.cmd == "ledger" and shape is not None:
        # one shape dict cannot fit six families' keys
        print("error: --shape applies to `kernel NAME`, not `ledger` "
              "(each registered kernel has its own shape keys)",
              file=sys.stderr)
        return 2
    try:
        if args.cmd == "kernel":
            results = [measure.tune_kernel(args.name, shape,
                                           bound=args.bound, **kwargs)]
        else:
            with open(args.path, encoding="utf-8") as f:
                ledger = json.load(f)
            results = measure.tune_from_ledger(ledger, **kwargs)
    except (RuntimeError, KeyError, OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.json:
        print(json.dumps([_result_row(r) for r in results], indent=1))
    else:
        for r in results:
            _print_result(r)
        if not args.no_store:
            print(f"persisted to {store.cache_path(args.cache)}")
    return 0


if __name__ == "__main__":  # pragma: no cover - exercised via subprocess
    sys.exit(main())
