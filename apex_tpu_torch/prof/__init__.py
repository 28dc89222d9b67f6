"""Profiling — counterpart of ``apex_tpu/prof``, on ``torch.profiler``.

The three stages of the reference's pyprof:

1. capture — :mod:`.capture`: named ranges (``record_function`` and
   NVTX) that mark the regions, and ``torch.profiler`` traces written
   to a directory;
2. parse — :mod:`.parse`: the trace's device kernels, each joined to the
   ranges that launched it (backward kernels through the autograd
   sequence number to their forward op), its step and its kind;
3. prof — :mod:`.analysis`: analytic FLOPs and bytes per op from a
   fake-tensor dispatch walk, each hand-written kernel counted once by
   its formula (:mod:`.costs`), and
   :func:`~apex_tpu_torch.prof.parse.attach_measured` joining measured
   time onto them.

And :mod:`.trace_count` (``assert_trace_count``: one CUDA-graph capture,
no recapture), :mod:`.roofline` (the per-region MFU ledger on the
card's peaks), :mod:`.ledger` (measured against intrinsic traffic),
:mod:`.memory` (the memory ledger: the walk's live storages, the
allocator's peak, the live reads), and the telemetry readers
:mod:`.timeline`, :mod:`.requests`, :mod:`.fleet` and :mod:`.regress`.

The names imported here are the JAX package's; the runnable modules
``timeline``, ``roofline``, ``memory``, ``requests``, ``fleet`` and
``regress`` are not imported here (``python -m`` would import them
twice): import them explicitly.
"""

from .analysis import OpRecord, Profile, profile_function
from .capture import MARKERS, annotate, dump_markers, init, scope, trace
from .ledger import loader_ledger
from .parse import KernelRecord, TraceProfile, attach_measured, parse_trace
from .trace_count import assert_trace_count, trace_count

__all__ = ["OpRecord", "Profile", "profile_function", "MARKERS", "annotate",
           "dump_markers", "init", "scope", "trace", "loader_ledger",
           "KernelRecord", "TraceProfile", "attach_measured", "parse_trace",
           "assert_trace_count", "trace_count"]
