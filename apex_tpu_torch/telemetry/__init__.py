"""Run telemetry — counterpart of ``apex_tpu/telemetry``: a structured
event stream that can be tailed live and read offline, a metrics
registry, the run-health watchdog, the Prometheus export, request
tracing and the SLO engine.

* :class:`Recorder` / :func:`start` — thread-safe JSONL event stream in
  the JAX package's schema (windows, captures as ``retrace`` events, the
  deferred metric reads, the loader, checkpoints, collectives, serving);
* :class:`MetricsRegistry` — counters, gauges, reservoir histograms;
* :class:`Watchdog` — the twelve rules folding events into debounced
  ``alert`` events (``telemetry.start(path, watchdog=True)``);
* :class:`PrometheusExporter` — textfile and ``GET /metrics``;
* :class:`Tracer` — sampled per-request span trees;
* :class:`SLOEngine` — goodput and burn rates against a spec;
* :func:`to_chrome_trace` — Chrome ``trace_event`` export (Perfetto).

Offline: ``python -m apex_tpu_torch.prof.timeline run.jsonl`` (and
``prof.requests``, ``prof.fleet``, ``prof.regress``).

Instrumented code finds the active recorder through
:func:`get_recorder`; with none installed each site costs one global
read, and a run is bit for bit what it is without telemetry.  The
environment variables are the JAX package's: ``APEX_TPU_TELEMETRY``,
``APEX_TPU_WATCHDOG``, ``APEX_TPU_METRICS_PORT``,
``APEX_TPU_METRICS_TEXTFILE``, ``APEX_TPU_TRACE_SAMPLE``,
``APEX_TPU_SLO``.
"""

from .events import (Recorder, get_recorder, set_recorder,  # noqa: F401
                     start, start_from_env, to_chrome_trace,
                     expand_stream_paths)
from .export import PrometheusExporter, attach_exporter     # noqa: F401
from .metrics import (Counter, Gauge, Histogram,            # noqa: F401
                      MetricsRegistry, Rolling)
from .slo import SLOEngine, SLOSpec, parse_slo              # noqa: F401
from .tracing import Tracer                                 # noqa: F401
from .watchdog import Watchdog                              # noqa: F401

__all__ = ["Recorder", "get_recorder", "set_recorder", "start",
           "start_from_env", "to_chrome_trace", "expand_stream_paths",
           "PrometheusExporter", "attach_exporter", "Counter", "Gauge",
           "Histogram", "MetricsRegistry", "Rolling", "Watchdog",
           "Tracer", "SLOEngine", "SLOSpec", "parse_slo"]
