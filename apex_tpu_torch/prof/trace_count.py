"""Capture-count assertions — counterpart of
``apex_tpu/prof/trace_count.py``.

JAX counts a jitted callable's traces; the port's unit is a CUDA-graph
capture, the program a step replays (on the CPU, where nothing is
captured, a program's first run for a signature, the port's
``retrace``).  :func:`trace_count` reads the counters that exist:

* a :class:`apex_tpu_torch.runtime.StepPipeline`: ``stats["captures"]``
  (its hot and tail loops) on CUDA; on the CPU, the window signatures
  each loop has run (``_sigs_seen``);
* a :class:`apex_tpu_torch.serving.ServingEngine`: ``stats["captures"]``
  (recaptures included) on CUDA; on the CPU, the AOT table's entries;
* a :class:`apex_tpu_torch.cache.Captured` step: one capture.

Usage (the shape the tests pin)::

    pipe = runtime.StepPipeline(step_fn, k)
    with assert_trace_count(pipe, 1):        # the first window captures
        state, reader = pipe.run(state, windows)
    with assert_trace_count(pipe, 0):        # steady state: no recapture
        pipe.step_window(state, window)
"""

from __future__ import annotations

import contextlib

__all__ = ["trace_count", "assert_trace_count"]


def trace_count(obj) -> int:
    """Captures ``obj`` has made so far (the module docstring); anything
    else raises ``TypeError``."""
    from ..cache import Captured
    from ..runtime import StepPipeline
    from ..serving.engine import ServingEngine
    if isinstance(obj, Captured):
        return 1
    if isinstance(obj, StepPipeline):
        if obj._graphs:
            return sum(obj.stats["captures"].values())
        return sum(len(sigs) for sigs in obj._sigs_seen.values())
    if isinstance(obj, ServingEngine):
        if obj.device.type == "cuda":
            return obj.stats["captures"]
        return len(obj._aot)
    raise TypeError(
        f"{obj!r} has no tracing cache — pass a runtime.StepPipeline, a "
        f"serving.ServingEngine or a cache.Captured step itself (not a "
        f"wrapper around one)")


@contextlib.contextmanager
def assert_trace_count(jitted, expect: int, *, exact: bool = True):
    """Assert that exactly (or, with ``exact=False``, at most)
    ``expect`` NEW captures of ``jitted`` happen inside the block:
    ``assert_trace_count(pipe, 1)`` around a run pins "one capture",
    ``assert_trace_count(engine, 0)`` around serving "no recapture"."""
    before = trace_count(jitted)
    yield
    got = trace_count(jitted) - before
    name = getattr(jitted, "__name__", repr(jitted))
    if got > expect:
        raise AssertionError(
            f"{name} traced {got} time(s) in this block, expected "
            f"{'exactly' if exact else 'at most'} {expect} — a retrace "
            f"per call usually means a Python scalar or a dtype/shape "
            f"varies across calls (jaxlint J004)")
    if exact and got < expect:
        raise AssertionError(
            f"{name} traced {got} time(s) in this block, expected exactly "
            f"{expect} — fewer traces than expected (not invoked enough, "
            f"or a signature was already cached before the block)")
