"""Named ranges and device-trace capture — counterpart of
``apex_tpu/prof/capture.py`` (the ``pyprof.nvtx`` stage).

* :func:`scope` / :func:`annotate` — a ``torch.profiler.record_function``
  range (a ``user_annotation`` in the profiler's trace) and an NVTX range
  on CUDA, around a block or a function.  The names are the regions the
  roofline and memory ledgers attribute to (:func:`region_path`): the
  analytic walk (:mod:`.analysis`) reads them from this thread's stack of
  open scopes, and :mod:`.parse` from the ranges enclosing each kernel's
  launch in the trace.
* :func:`init` — reference API parity: after it, :func:`annotate` records
  a call marker with its arguments' shapes into :data:`MARKERS`, and both
  emit the telemetry ``marker`` event when a recorder is active.
* :func:`trace` — ``torch.profiler.profile`` over the block (CPU and
  CUDA activities, input shapes recorded), its Chrome trace written to
  ``<logdir>/plugins/profile/<timestamp>/<host>.trace.json.gz``, the
  layout :func:`apex_tpu_torch.prof.parse.parse_trace` reads.

A backward op runs from the autograd engine, outside the forward's
ranges; :mod:`.parse` joins it to its forward op by the autograd
sequence number both carry, and the analytic walk stamps each autograd
node with the scope that made it.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import re
import socket
import threading
import time
from typing import Callable, List

import torch

__all__ = ["MARKERS", "init", "scope", "annotate", "trace", "dump_markers",
           "region_path", "current_scope"]

MARKERS: List[dict] = []
_enabled = False
_stack = threading.local()

# JAX folds transform wrappers around user scope names
# (``transpose(jvp(blockA))``) and adds call machinery (``pjit``,
# ``scan``); :func:`region_path` peels them as JAX's does, so a path from
# either package maps to the same region.
_TRANSFORM_WRAP_RE = re.compile(
    r"^(?:jit|pjit|jvp|vjp|transpose|vmap|pmap|remat|checkpoint|rematted"
    r"|custom_[a-z_]+|named)\((.*)\)$")
_TRANSFORM_BARE = frozenset(
    ("jit", "pjit", "jvp", "vjp", "transpose", "vmap", "pmap", "scan",
     "while", "cond", "remat", "checkpoint", "rematted", "named", "body",
     "branch", "branches"))


def _peel(component: str) -> str:
    prev = None
    while prev != component:
        prev = component
        m = _TRANSFORM_WRAP_RE.match(component)
        if m:
            component = m.group(1)
    if component in _TRANSFORM_BARE or component.startswith("custom_"):
        return ""
    if component.startswith("conv_general_dilated"):
        return ""
    return component


def region_path(scope: str, depth: int = 1) -> str:
    """The leading ``depth`` user scope components of a ``/``-joined
    scope path (``blockA/mm`` -> ``blockA`` at depth 1); ``<unattributed>``
    for none.  JAX's transform wrappers and call machinery are peeled
    (``transpose(jvp(blockA))/mm`` -> ``blockA``), as in the JAX
    package."""
    parts = []
    for p in scope.split("/"):
        p = _peel(p.strip())
        if p:
            parts.append(p)
    if not parts:
        return "<unattributed>"
    return "/".join(parts[:max(1, depth)])


def current_scope(node=None) -> str:
    """The ``/``-joined names of this thread's open scopes ('' for
    none); with ``node`` (an autograd node running its backward), only
    those opened inside that node's backward."""
    names = getattr(_stack, "names", ())
    if node is None:
        return "/".join(names)
    nodes = getattr(_stack, "nodes", ())
    return "/".join(n for n, nd in zip(names, nodes) if nd is node)


def init(enable_markers: bool = True) -> None:
    """Reference ``pyprof.nvtx.init()`` parity: turn the call markers of
    :func:`annotate` (and the telemetry ``marker`` events) on or off."""
    global _enabled
    _enabled = enable_markers


def _arg_marker(fn_name: str, args, kwargs) -> dict:
    def describe(x):
        if hasattr(x, "shape") and hasattr(x, "dtype"):
            return {"shape": tuple(int(s) for s in x.shape),
                    "dtype": str(x.dtype)}
        if isinstance(x, (int, float, bool, str)) or x is None:
            return {"value": x}
        return {"type": type(x).__name__}
    return {"op": fn_name,
            "args": [describe(a) for a in args],
            "kwargs": {k: describe(v) for k, v in kwargs.items()}}


@functools.lru_cache(maxsize=None)
def _nvtx() -> bool:
    return torch.cuda.is_available()


@contextlib.contextmanager
def _range(name: str):
    names = getattr(_stack, "names", None)
    if names is None:
        names = _stack.names = []
        _stack.nodes = []
    names.append(name)
    # a scope opened inside a backward belongs to the node running it
    _stack.nodes.append(torch._C._current_autograd_node())
    nvtx = _nvtx()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
        names.pop()
        _stack.nodes.pop()


@contextlib.contextmanager
def scope(name: str):
    """A named range around the block (see the module docstring); after
    :func:`init`, also a ``marker`` event in an active telemetry
    stream."""
    if _enabled:
        from .. import telemetry as _telemetry
        rec = _telemetry.get_recorder()
        if rec is not None:
            rec.event("marker", op=name, args=[], kwargs={})
    with _range(name):
        yield


def annotate(name: str = None) -> Callable:
    """Decorator: run the function under a named range; after
    :func:`init`, record a call marker (and a telemetry ``marker``
    event) with the arguments' shapes per call."""
    def deco(fn):
        scope_name = name or getattr(fn, "__name__", "fn")

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if _enabled:
                marker = _arg_marker(scope_name, args, kwargs)
                MARKERS.append(marker)
                from .. import telemetry as _telemetry
                rec = _telemetry.get_recorder()
                if rec is not None:
                    rec.event("marker", **marker)
            with _range(scope_name):
                return fn(*args, **kwargs)
        return wrapped
    return deco


def _run_dir(logdir: str) -> str:
    stamp = time.strftime("%Y_%m_%d_%H_%M_%S")
    base = os.path.join(logdir, "plugins", "profile", stamp)
    run, i = base, 0
    while os.path.exists(run):
        i += 1
        run = f"{base}_{i}"
    os.makedirs(run)
    return run


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with ``torch.profiler`` (CPU and, where there
    is a card, CUDA activities; input shapes recorded) and write its
    Chrome trace under ``logdir/plugins/profile/<timestamp>/``.  Yields
    the profiler (its ``step()`` marks steps, which :mod:`.parse` reads
    as run ids)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts, record_shapes=True)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        prof.stop()
        run = _run_dir(logdir)
        prof.export_chrome_trace(os.path.join(
            run, f"{socket.gethostname()}.trace.json.gz"))


def dump_markers(path: str) -> None:
    """Write the collected markers as JSON lines."""
    with open(path, "w") as f:
        for m in MARKERS:
            f.write(json.dumps(m) + "\n")

