"""The trainers' telemetry flags (the JAX examples' ``--telemetry``,
``--metrics-port``, ``--metrics-textfile``, ``--watchdog``), shared by
the LM, ImageNet and DCGAN trainers.

The recorder is installed before the trainer builds its pipeline, so
``StepPipeline``, ``DeferredMetrics``, ``PrefetchLoader`` and the
checkpoint manager find it; the caller closes it in a ``finally`` (a run
that dies still writes its ``summary`` and the watchdog's last alerts)
and prints the ``health:`` line.  ``--watchdog`` defaults on with
``--telemetry``; alone it folds the events without writing a stream.  A
``{rank}`` in the stream path becomes the process's rank, so each rank
under the spawner (``python -m apex_tpu_torch.parallel.multiproc``),
which hands every rank the same arguments, writes its own stream.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional


def add_flags(p: argparse.ArgumentParser) -> None:
    """The four flags, with the JAX examples' environment defaults."""
    env = os.environ
    p.add_argument("--telemetry", default=env.get("APEX_TPU_TELEMETRY")
                   or None, metavar="PATH",
                   help="record the telemetry event stream (JSONL) to "
                        "PATH ('{rank}' becomes the rank); read it with "
                        "python -m apex_tpu_torch.prof.timeline PATH.  "
                        "Default: APEX_TPU_TELEMETRY")
    p.add_argument("--metrics-port", type=int, metavar="PORT",
                   default=(int(env["APEX_TPU_METRICS_PORT"])
                            if env.get("APEX_TPU_METRICS_PORT") else None),
                   help="serve live Prometheus metrics on "
                        "http://localhost:PORT/metrics (0: any free port). "
                        "Default: APEX_TPU_METRICS_PORT")
    p.add_argument("--metrics-textfile", metavar="PATH",
                   default=env.get("APEX_TPU_METRICS_TEXTFILE") or None,
                   help="an atomically replaced Prometheus textfile.  "
                        "Default: APEX_TPU_METRICS_TEXTFILE")
    p.add_argument("--watchdog", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="the run-health rules over the events (alerts in "
                        "the stream, a health: line at exit); on by "
                        "default with --telemetry")


def stream_path(args) -> Optional[str]:
    """``--telemetry`` with ``{rank}`` filled in."""
    if not args.telemetry:
        return None
    if "{rank}" not in args.telemetry:
        return args.telemetry
    from ..parallel.multiproc import process_identity
    return args.telemetry.replace("{rank}", str(process_identity()[0]))


def start(args, example: str, log=print, **meta):
    """Install the recorder the flags ask for; None when they ask for
    none."""
    use_watchdog = (args.watchdog if args.watchdog is not None
                    else bool(args.telemetry))
    if not (args.telemetry or use_watchdog or args.metrics_port is not None
            or args.metrics_textfile):
        return None
    from .. import telemetry
    rec = telemetry.start(stream_path(args) or os.devnull,
                          watchdog=use_watchdog, example=example,
                          export_port=args.metrics_port,
                          export_textfile=args.metrics_textfile, **meta)
    if rec.exporter is not None:
        log(f"metrics export: {rec.exporter.describe()}")
    return rec


def finish(rec, args, log=print, extras: str = "") -> None:
    """Close the recorder (the ``summary`` event, the exporter's last
    render) and print the stream's path and the ``health:`` line."""
    if rec is None:
        return
    wd = rec.watchdog
    rec.close()
    if args.telemetry:
        log(f"telemetry: {rec.path} (python -m "
            f"apex_tpu_torch.prof.timeline to analyze)")
    if wd is not None:
        peak = rec.metrics.gauge("peak_hbm_bytes").value
        if peak:
            extras = f"  peak-hbm {peak / 1e6:.1f}MB" + extras
        if rec.exporter is not None:
            extras += f"  export {rec.exporter.describe()}"
        log(f"health: {wd.format_line()}{extras}")
