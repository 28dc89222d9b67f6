"""Profiling: the offline readers of the telemetry stream and the live
device-memory reads — counterpart of part of ``apex_tpu/prof``.

* :mod:`.timeline` — ``python -m apex_tpu_torch.prof.timeline run.jsonl``:
  step-time percentiles, stall and gap attribution, the loss-scale
  trajectory, captures, alerts, collective bytes;
* :mod:`.requests` — per-request serving analysis (TTFT/TPOT
  percentiles, span waterfalls, SLO goodput);
* :mod:`.fleet` — merges per-rank streams, aligns their clocks and
  names the straggler;
* :mod:`.regress` — diffs two summaries and exits non-zero past a
  tolerance;
* :mod:`.memory` — the CUDA allocator's reads (``device_memory``,
  ``update_device_memory_gauges``, ``record_memory``).

Like the JAX package's, the CLI modules are not imported here (``python
-m`` would import them twice); import them explicitly.  The capture and
trace parsing, the analysis, roofline and XLA memory ledger, the ledger
and ``trace_count`` are not ported yet (ROADMAP queue 1 item 2, on
``torch.profiler``).
"""
