"""Step pipelining: K training steps per host call, from CUDA graphs —
counterpart of ``apex_tpu/runtime.py``.

JAX makes the program, not the step, the unit of host dispatch: one
compiled ``lax.scan`` runs K steps over a ``[K, ...]`` batch window.  The
port makes it one CUDA graph:

* :class:`StepPipeline` captures :func:`~apex_tpu_torch.training.
  chain_steps` of the step function over a window once per (K, window
  signature) (:func:`apex_tpu_torch.cache.warmup`), then replays it: one
  host call runs K steps and every kernel in them.  The training state
  lives in the graph's static tensors; the captured region ends by
  copying the new state into them, so a replay advances K steps in
  place;
* :func:`stage_windows` groups a batch stream into windows and stages
  them through :class:`apex_tpu_torch.data.PrefetchLoader`, so the
  host-to-device copy of window N+1 overlaps window N;
* :class:`DeferredMetrics` hands each window's stacked metrics back one
  window behind: their copy to pinned host memory is queued right
  behind the window's work, so reading them waits for that window and
  never for the one dispatched after it.

A ragged tail (fewer than K real batches) pads to the same ``[K, ...]``
shape and runs in a second graph, captured on the first tail, whose
steps are gated by a ``valid [K]`` mask on the device (``torch.where``
on every state leaf), so a padded step leaves the state as the last real
step left it.  A dynamic loss scale's overflow skip is a ``torch.where``
inside the step, as it is in JAX, so no window reads a value back.

On the CPU :class:`StepPipeline` runs the same window functions eagerly
(nothing is captured) and returns fresh state.

A data-parallel step (``make_train_step(axis_name=...)``, whose
``step_fn.process_group`` names its group) is captured with its
collectives inside the graph when the group's backend is NCCL: the warm
run issues them first on the capture stream, which makes the
communicators before the capture begins.  Any other backend on CUDA
raises: gloo's CUDA collectives wait on the host and cannot be captured,
and the pipeline never runs eagerly in their place.

``wrap=`` is JAX's ``shard_map`` hook: ``wrap(fn)`` turns a window
function ``(state, window, valid) -> (state, metrics)`` into this rank's.
JAX's wrap places the global window on the mesh; the port runs one
process a rank, so its wrap takes this rank's slice of the window (the
LM trainer's ``--sp`` slices ``[K, B, T']`` on T, JAX's ``P(None, None,
"sp")``; :meth:`~apex_tpu_torch.parallel.mesh.MeshTrainStep.
pipeline_wrap` slices the batch axis over the data axes).  Both window
functions and their captures run wrapped.

Telemetry (:mod:`apex_tpu_torch.telemetry`): ``telemetry=`` pins a
recorder, else each call reads the active one.  The hooks sit at the host
boundaries, never in a captured body (whose Python runs once, at
capture): :meth:`StepPipeline.step_window` times the replay call and
emits a ``window`` event (``dur`` the host time of the call, ``gap`` the
host time since the last one returned) with the ``window_dispatch_s`` and
``window_gap_s`` histograms, ``steps_dispatched`` and ``steps_per_s``;
each capture (on the CPU, a program's first run or a new window
signature) emits JAX's ``retrace`` event; :meth:`WindowMetrics.fetch`
hands the values of its one read to the recorder
(``observe_window_metrics``: the ``metrics`` event and the loss-scale
``scale`` events); ``memory_stats()`` records the ``memory`` event.  With
no recorder each site reads one global.

Usage::

    from apex_tpu_torch import runtime

    pipe = runtime.StepPipeline(step_fn, k=8).warmup(state, window)
    reader = runtime.DeferredMetrics()
    for window, n_valid in runtime.stage_windows(batches, k=8):
        state, metrics = pipe.step_window(state, window, n_valid)
        prev = reader.push(metrics, n_valid)
        if prev is not None:
            host = prev.fetch()        # one read, one window behind
    final = reader.last()

On CUDA the state a call returns is the graph's own: the next call
overwrites it in place, as JAX's donated state is consumed.
"""

from __future__ import annotations

import signal as _signal
import threading
import time
from typing import Any, Callable, Iterable, Iterator, NamedTuple, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from . import cache as _cache
from .telemetry import events as _events
from .training import chain_steps

__all__ = ["StepPipeline", "DeferredMetrics", "WindowMetrics",
           "GracefulShutdown", "stage_windows", "window_batches", "mark",
           "seconds_between", "round_steps"]


class GracefulShutdown:
    """Preemption drain: the first SIGTERM/SIGINT requests a clean stop at
    the next window boundary (``draining`` turns True); a second one
    restores the previous handler and re-raises the signal.

        with runtime.GracefulShutdown() as stop:
            for window, n_valid in windows:
                state, metrics = pipe.step_window(state, window, n_valid)
                if stop.draining:
                    break

    The flag is a ``threading.Event``; outside the main thread (where
    ``signal.signal`` raises) nothing is installed and :meth:`request`
    is the trigger.  The first request emits a ``drain`` event on the
    recorder (``telemetry``, else the active one)."""

    def __init__(self, signals=(_signal.SIGTERM, _signal.SIGINT), *,
                 telemetry=None):
        self._telemetry = telemetry
        self.signals = tuple(signals)
        self._drain = threading.Event()
        self._prev: dict = {}
        self._installed = False
        self.reason: Optional[str] = None

    @property
    def draining(self) -> bool:
        """True once a drain has been requested (signal or programmatic)."""
        return self._drain.is_set()

    def request(self, reason: str = "programmatic") -> None:
        """Trigger the drain without a signal; the first reason stays."""
        first = not self._drain.is_set()
        self.reason = self.reason or reason
        self._drain.set()
        if first:
            rec = (self._telemetry if self._telemetry is not None
                   else _events.get_recorder())
            if rec is not None:
                rec.event("drain", reason=reason)

    def _handler(self, signum, frame):
        del frame
        try:
            name = _signal.Signals(signum).name
        except ValueError:
            name = str(signum)
        if self._drain.is_set():
            self.uninstall()
            _signal.raise_signal(signum)
            return
        self.request(f"signal:{name}")

    def install(self) -> "GracefulShutdown":
        """Install the handlers (idempotent).  Returns ``self``."""
        if self._installed:
            return self
        for sig in self.signals:
            try:
                self._prev[sig] = _signal.signal(sig, self._handler)
            except (ValueError, OSError):     # not the main thread
                continue
        self._installed = True
        return self

    def uninstall(self) -> None:
        """Restore the previous handlers (idempotent)."""
        if not self._installed:
            return
        for sig, prev in self._prev.items():
            try:
                _signal.signal(sig, prev)
            except (ValueError, OSError):
                continue
        self._prev.clear()
        self._installed = False

    def __enter__(self) -> "GracefulShutdown":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()


def _select_tree(flag, new, old):
    """Per-leaf ``where(flag, new, old)``: the carry gate of a padded
    step (``flag`` a 0-dim device bool, so nothing is read back)."""
    n_leaves, spec = pytree.tree_flatten(new)
    o_leaves = pytree.tree_leaves(old)
    return pytree.tree_unflatten(
        [torch.where(flag, n, o) if isinstance(n, torch.Tensor) else n
         for n, o in zip(n_leaves, o_leaves)], spec)


def _copy_tree(dst, src) -> None:
    """Copy every tensor leaf of ``src`` into the same leaf of ``dst``, in
    one ``torch._foreach_copy_`` (a few launches for the whole state)."""
    pairs = [(d, s) for d, s in zip(pytree.tree_leaves(dst),
                                    pytree.tree_leaves(src))
             if isinstance(d, torch.Tensor) and d is not s]
    if pairs:
        torch._foreach_copy_([d for d, _ in pairs], [s for _, s in pairs])


def _window_sig(window) -> str:
    """JAX's signature string of a window: ``dtype[shape]`` of its first
    16 leaves."""
    def one(x):
        dtype = str(getattr(x, "dtype", type(x).__name__))
        return f"{dtype.replace('torch.', '')}{list(getattr(x, 'shape', ()))}"
    return "|".join(one(x) for x in pytree.tree_leaves(window)[:16])


def _device_of(tree) -> torch.device:
    return next((x.device for x in pytree.tree_leaves(tree)
                 if isinstance(x, torch.Tensor)), torch.device("cpu"))


class StepPipeline:
    """K training steps per host call (see the module docstring).

    ``step_fn(state, batch) -> (state, metrics)`` is the amp step of
    :func:`apex_tpu_torch.training.make_train_step`.  Two window
    functions back a pipeline, each ``(state, window, valid) -> (state,
    metrics stacked on K)``:

    * the **hot loop** (``loop``): K steps, nothing masked;
    * the **tail loop** (``tail_loop``): the same with each step's state
      gated by ``valid``, run for a ragged window (``n_valid < k``).

    On CUDA each is captured once per window signature (:meth:`warmup`,
    or at its first call, counted in ``stats["captures"]``) into a graph
    whose body copies each step's new state into its static input; every
    call replays (``stats["replays"]``).  The hot and tail graphs share one
    memory pool.  The window is copied into the graph's static input,
    so the pipeline keeps no reference to the caller's (JAX's
    ``donate_window`` has nothing to donate here).
    """

    def __init__(self, step_fn: Callable, k: int, *,
                 wrap: Optional[Callable] = None,
                 telemetry=None):
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.k = int(k)
        self._wrap = wrap
        self._step_fn = step_fn
        self._telemetry = telemetry
        self._t_last_dispatch: Optional[float] = None
        # program -> the window signatures captured (on the CPU, run)
        self._sigs_seen: dict = {"hot": set(), "tail": set()}

        #: the window functions, run eagerly on the CPU and captured on CUDA
        self.loop = self._window_fn("hot")
        self.tail_loop = self._window_fn("tail")
        self._graphs: dict = {}       # (program, window signature) -> graph
        self._pool = None
        self._valid: dict = {}        # (device, n_valid) -> bool [K]
        self.stats = {"captures": {"hot": 0, "tail": 0}, "replays": 0,
                      "steps": 0}

    def _window_fn(self, program: str, commit: Optional[Callable] = None):
        """The ``(state, window, valid) -> (state, metrics)`` function of
        ``program``, through ``wrap`` when given: the hot loop's K steps,
        or the tail loop's with each step's state gated by ``valid``;
        ``commit`` as in :func:`~apex_tpu_torch.training.chain_steps`."""
        fn = self._window_fn_unwrapped(program, commit)
        return fn if self._wrap is None else self._wrap(fn)

    def _window_fn_unwrapped(self, program: str,
                             commit: Optional[Callable] = None):
        # a local, not self: a closure over self would make a reference
        # cycle, and the collector could free a dropped pipeline's graphs
        # in the middle of another capture
        inner = self._step_fn

        def step_fn(state, batch):
            out = inner(state, batch)
            _events._end_noted_step()
            return out
        if program == "hot":
            chained = chain_steps(step_fn, commit)

            def hot(state, window, valid):
                del valid                 # full window: nothing to mask
                return chained(state, window)
            return hot

        def masked_step(state, xs):
            batch, valid = xs
            new_state, metrics = step_fn(state, batch)
            # a padded step runs, but leaves the state as it found it
            return _select_tree(valid, new_state, state), metrics
        chained_masked = chain_steps(masked_step, commit)

        def tail(state, window, valid):
            return chained_masked(state, (window, valid))
        return tail

    def _valid_mask(self, n_valid: int, device) -> torch.Tensor:
        key = (device, n_valid)
        mask = self._valid.get(key)
        if mask is None:
            mask = self._valid[key] = torch.from_numpy(
                np.arange(self.k) < n_valid).to(device)
        return mask

    def _program(self, n_valid: Optional[int]):
        if n_valid is None or n_valid >= self.k:
            return "hot", self.k
        if n_valid < 1:
            raise ValueError(f"n_valid must be >= 1, got {n_valid}")
        return "tail", n_valid

    def _check_capturable(self) -> None:
        group = getattr(self._step_fn, "process_group", None)
        if group is None:
            return
        import torch.distributed as dist
        backend = dist.get_backend(group)
        if backend != "nccl":
            raise RuntimeError(
                f"a step whose collectives run on {backend!r} cannot be "
                f"captured on CUDA (its CUDA collectives wait on the "
                f"host); use NCCL, or run the step function eagerly "
                f"without a StepPipeline")

    def _rec(self):
        return (self._telemetry if self._telemetry is not None
                else _events.get_recorder())

    def _note_retrace(self, rec, program: str, sig: str, n_traces: int,
                      dur: float) -> None:
        """JAX's ``retrace`` event for a capture (on the CPU, a
        program's first run or a new window signature): ``first`` on the
        program's first, ``new_sig`` for a window signature it has not
        seen; a not-first new signature counts in ``retraces``."""
        seen = self._sigs_seen[program]
        first, new_sig = not seen, sig not in seen
        seen.add(sig)
        rec.event("retrace", program=program, step=self.stats["steps"],
                  n_traces=n_traces, first=first, new_sig=new_sig, sig=sig,
                  dur=round(dur, 6))
        if not first and new_sig:
            rec.metrics.counter("retraces").inc()

    def _capture(self, program: str, state, window, valid):
        self._check_capturable()

        def body(state, window, valid):
            # each step's new state is copied into the static input state
            # and the next step reads that: one new state is live at a
            # time, so a K-step graph needs one step's memory
            def commit(new_state):
                _copy_tree(state, new_state)
                return state
            return self._window_fn(program, commit)(state, window, valid)[1]
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        rec = self._rec()
        if rec is None:
            graph = _cache.warmup(body, state, window, valid, pool=self._pool)
        else:
            # the warm run's first step notes the step's collectives once
            t0 = time.perf_counter()
            with _events._pipeline_notes(True):
                graph = _cache.warmup(body, state, window, valid,
                                      pool=self._pool)
            self._note_retrace(rec, program, _window_sig(window),
                               self.stats["captures"][program] + 1,
                               time.perf_counter() - t0)
        self.stats["captures"][program] += 1
        return graph

    def warmup(self, state, window, *, tail: bool = False
               ) -> "StepPipeline":
        """Capture the hot loop for this ``(state, window)`` signature
        before step 0 (and the tail loop with ``tail=True``), so no call
        captures.  Nothing is advanced: the capture runs on static copies
        of ``state`` and ``window``.  On the CPU it does nothing.
        Returns ``self``."""
        device = _device_of(state)
        if device.type != "cuda":
            return self
        sig = _cache.signature(window)
        for program in (("hot", "tail") if tail else ("hot",)):
            if (program, sig) not in self._graphs:
                self._graphs[(program, sig)] = self._capture(
                    program, state, window,
                    self._valid_mask(self.k, device))
        return self

    def step_window(self, state, window, n_valid: Optional[int] = None):
        """Run one window: K steps, one host call on CUDA.

        ``window`` is the batch tree stacked on a leading K axis;
        ``n_valid`` (default K) marks a ragged tail whose padded steps do
        not advance the state.  Returns ``(state, metrics)``, the metrics
        stacked ``[K]`` on the device (read them through
        :class:`DeferredMetrics`); on CUDA the state is the graph's
        static state, which the next call advances in place."""
        program, n = self._program(n_valid)
        device = _device_of(state)
        valid = self._valid_mask(n, device)
        rec = self._rec()
        if rec is None:
            out = self._run_window(program, state, window, valid, device)
            self.stats["steps"] += n
            return out
        step0 = self.stats["steps"]
        t0 = time.perf_counter()
        gap = (0.0 if self._t_last_dispatch is None
               else t0 - self._t_last_dispatch)
        out = self._run_window(program, state, window, valid, device, rec)
        t1 = time.perf_counter()
        self._t_last_dispatch = t1
        self.stats["steps"] += n
        # dur: the host time of the call (the device may still run);
        # gap: host time since the last call returned
        rec.event("window", step=step0, k=self.k, n_valid=n,
                  dur=round(t1 - t0, 6), gap=round(gap, 6),
                  program=program)
        rec.metrics.histogram("window_dispatch_s").observe(t1 - t0)
        rec.metrics.histogram("window_gap_s").observe(gap)
        rec.metrics.counter("steps_dispatched").inc(n)
        rec.metrics.gauge("steps_per_s").set(n / max(t1 - t0 + gap, 1e-9))
        return out

    def _run_window(self, program, state, window, valid, device, rec=None):
        if device.type != "cuda":
            fn = self.loop if program == "hot" else self.tail_loop
            # a program's first run for a window signature is the CPU's
            # counterpart of a capture (``prof.trace_count`` counts them)
            sig = _window_sig(window)
            seen = self._sigs_seen[program]
            if rec is None:
                seen.add(sig)
                return fn(state, window, valid)
            if sig in seen:
                with _events._pipeline_notes(False):
                    return fn(state, window, valid)
            t0 = time.perf_counter()
            with _events._pipeline_notes(True):
                out = fn(state, window, valid)
            self._note_retrace(rec, program, sig, len(seen) + 1,
                               time.perf_counter() - t0)
            return out
        key = (program, _cache.signature(window))
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._graphs[key] = self._capture(program, state,
                                                      window, valid)
        metrics = graph(state, window, valid)
        self.stats["replays"] += 1
        # the graph rewrites its outputs at the next replay; the reader
        # holds this window's one window longer
        metrics = pytree.tree_map(
            lambda x: x.clone() if isinstance(x, torch.Tensor) else x,
            metrics)
        return graph.static_args[0], metrics

    def memory_stats(self, *, emit: bool = True) -> Optional[dict]:
        """The CUDA allocator's counts for this process (bytes):
        ``peak_bytes`` (``max_memory_allocated``), ``allocated_bytes``,
        ``reserved_bytes``; None on the CPU or before a capture.  Host
        reads, no synchronization.  ``emit`` also records them on the
        recorder (the ``memory`` event against the card's memory and the
        ``peak_hbm_bytes`` gauge, :func:`apex_tpu_torch.prof.memory.
        record_memory`)."""
        if not self._graphs:
            return None
        device = next(iter(self._graphs.values())).device
        stats = {"peak_bytes": torch.cuda.max_memory_allocated(device),
                 "allocated_bytes": torch.cuda.memory_allocated(device),
                 "reserved_bytes": torch.cuda.memory_reserved(device),
                 "source": "cuda_allocator"}
        rec = self._rec() if emit else None
        if rec is not None:
            from .prof import memory as _memory
            _memory.record_memory(rec, stats)
        return stats

    def run(self, state, windows: Iterable, *,
            steps: Optional[int] = None,
            on_metrics: Optional[Callable] = None,
            on_window: Optional[Callable] = None, manager=None,
            start_step: int = 0, loader_state: Optional[Callable] = None,
            drain: bool = False, log: Callable = print,
            unit: str = "step"):
        """Drive the pipeline over ``(window, n_valid)`` pairs (the
        :func:`stage_windows` protocol) until ``steps`` steps have run
        (None: until ``windows`` ends), and close ``windows`` when it has
        ``close``.  ``on_metrics`` sees each :class:`WindowMetrics` one
        window behind, and the last one after the loop; ``on_window(n)``
        runs after each window with the steps run so far.

        The trainers' checkpointing and drain: steps count from
        ``start_step`` (a resumed run's).  With ``manager`` (a
        :class:`~apex_tpu_torch.checkpoint.CheckpointManager`) each window
        ends in ``manager.maybe_save`` at its global step, with
        ``loader_state(step)`` taken at that boundary when given; the run
        ends with a blocking save at the stopping step, unless that step
        was just saved, and closes the manager.  ``drain`` installs a
        :class:`GracefulShutdown` for the run: after a signal the state is
        saved at once and the loop stops at the window's end.  Returns
        ``(state, reader)``; the run stopped at ``start_step +
        reader.steps_pushed``.  ``log`` gets the drain and final-save lines,
        which name a step ``unit``."""
        def save_kw(step):
            return ({} if loader_state is None
                    else {"loader_state": loader_state(step)})

        reader = DeferredMetrics(telemetry=self._telemetry)
        stop = (GracefulShutdown(telemetry=self._telemetry).install()
                if drain else None)
        step = start_step
        try:
            for window, n_valid in windows:
                if steps is not None and reader.steps_pushed >= steps:
                    break
                state, metrics = self.step_window(state, window, n_valid)
                prev = reader.push(metrics, n_valid)
                if prev is not None and on_metrics is not None:
                    on_metrics(prev)
                if on_window is not None:
                    on_window(reader.steps_pushed)
                step = start_step + reader.steps_pushed
                if stop is not None and stop.draining:
                    if manager is not None:
                        manager.save(step, state, block=True,
                                     **save_kw(step))
                    log(f"drain: stopping at {unit} {step} ({stop.reason})")
                    break
                if manager is not None:
                    manager.maybe_save(step, state, **save_kw(step))
        finally:
            if stop is not None:
                stop.uninstall()
            if hasattr(windows, "close"):
                windows.close()
        if on_metrics is not None:
            for wm in reader.flush():
                on_metrics(wm)
        if manager is not None:
            if manager.last_saved != step:
                manager.save(step, state, block=True, **save_kw(step))
            manager.close()
            log(f"checkpoint: {unit} {step} saved under "
                f"{manager.directory}")
        return state, reader


def round_steps(steps: int, k: int, flag: str, log=print) -> int:
    """``steps`` rounded up to a multiple of ``k``, with a note when it
    moves (the JAX examples' rule: the device loop runs whole windows)."""
    rounded = -(-steps // k) * k
    if rounded != steps:
        log(f"note: {flag} {steps} rounded up to {rounded} (multiple of "
            f"--steps-per-call {k})")
    return rounded


# float64 holds each of these exactly, so one stacked read carries them
_EXACT_IN_F64 = (torch.float32, torch.float16, torch.bfloat16, torch.bool,
                 torch.int8, torch.uint8, torch.int16, torch.int32,
                 torch.float64)


def mark(device=None):
    """A point on the device's timeline: a timing CUDA event recorded now
    on the current stream of ``device`` (a CUDA device), else the host
    clock.  :func:`seconds_between` two marks gives the device's time
    between them, gaps the host left included."""
    device = torch.device("cpu") if device is None else torch.device(device)
    if device.type != "cuda":
        return time.perf_counter()
    event = torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(device))
    return event


def seconds_between(start, end) -> float:
    """Seconds from mark ``start`` to mark ``end`` (waits for ``end``)."""
    if isinstance(end, float):
        return end - start
    end.synchronize()
    return start.elapsed_time(end) / 1e3


class _Read(NamedTuple):
    """A device-to-host read in flight: the tree's leaves and structure,
    ``(leaf indices, host vector)`` per group, and the mark after the
    copies (a timing event on the card, the host clock otherwise)."""
    leaves: list
    spec: Any
    parts: list
    done: Any


def _start_read(tree) -> _Read:
    """Copy every tensor leaf of ``tree`` to the host, asynchronously on
    the current stream: the leaves of one device are packed into one
    float64 vector (float64 holds each exactly) and copied into pinned
    memory in one read; leaves that float64 does not hold, such as
    int64, go in one more read per dtype.  Started when a window is
    dispatched, so reading it later waits for that window only."""
    leaves, spec = pytree.tree_flatten(tree)
    groups: dict = {}
    for i, x in enumerate(leaves):
        if isinstance(x, torch.Tensor):
            kind = "f64" if x.dtype in _EXACT_IN_F64 else x.dtype
            groups.setdefault((x.device, kind), []).append(i)
    parts, cuda = [], None
    for (device, kind), idx in groups.items():
        flat = torch.cat([leaves[i].reshape(-1).double() if kind == "f64"
                          else leaves[i].reshape(-1) for i in idx])
        if device.type == "cuda":
            host = torch.empty(flat.shape, dtype=flat.dtype,
                               pin_memory=True)
            host.copy_(flat, non_blocking=True)
            flat, cuda = host, device
        parts.append((idx, flat))
    return _Read(leaves, spec, parts, mark(cuda))


def _finish_read(read: _Read):
    """Wait for ``read``'s copies; the tree with numpy leaves (bf16 as
    fp32)."""
    if not isinstance(read.done, float):
        read.done.synchronize()
    out = list(read.leaves)
    for idx, flat in read.parts:
        at = 0
        for i in idx:
            p = read.leaves[i]
            vals = flat[at:at + p.numel()].reshape(p.shape)
            at += p.numel()
            out[i] = (vals.float() if p.dtype == torch.bfloat16
                      else vals.to(p.dtype)).numpy()
    return pytree.tree_unflatten(out, read.spec)


class WindowMetrics(NamedTuple):
    """One window's stacked per-step metrics, still on the device.
    ``step`` is the global index of its first step, ``n_valid`` how many
    leading entries are real, ``read`` their copy to the host started at
    :meth:`DeferredMetrics.push` (None: :meth:`fetch` starts it),
    ``telemetry`` the recorder the read's values go to (None: none)."""
    step: int
    n_valid: int
    metrics: Any
    read: Any = None
    telemetry: Any = None

    def fetch(self):
        """The window's metrics on the host (numpy, stacked ``[K]``):
        one device-to-host read, which waits for this window's work only
        (entries past ``n_valid`` are padding).  With a recorder the
        read's values, and its host seconds, go to
        ``observe_window_metrics``: the telemetry rides this read and
        makes none of its own."""
        read = self.read if self.read is not None else _start_read(
            self.metrics)
        if self.telemetry is None:
            return _finish_read(read)
        t0 = time.perf_counter()
        vals = _finish_read(read)
        self.telemetry.observe_window_metrics(
            self.step, self.n_valid, vals, time.perf_counter() - t0)
        return vals

    @property
    def end(self):
        """The :func:`mark` after the window's work and its read (set by
        :meth:`DeferredMetrics.push`): the trainers time windows from one
        window's ``end`` to the next's."""
        return self.read.done


class DeferredMetrics:
    """One-window-behind metric reader: ``push`` stores the window just
    dispatched, starts its one read to the host, and returns the
    previous window's :class:`WindowMetrics`; :meth:`flush` hands back
    the last one, so every pushed window is returned exactly once.
    ``telemetry`` pins the recorder each window's :meth:`WindowMetrics.
    fetch` reports to; None takes the active one at push time."""

    def __init__(self, telemetry=None):
        self._telemetry = telemetry
        self._held: Optional[WindowMetrics] = None
        self._next_step = 0
        self._flushed = False

    def push(self, metrics, n_valid: int) -> Optional[WindowMetrics]:
        """Record a freshly dispatched window and start its metrics' copy
        to the host behind its work; returns the previous window's
        handles (None on the first push)."""
        rec = (self._telemetry if self._telemetry is not None
               else _events.get_recorder())
        prev, self._held = self._held, WindowMetrics(
            self._next_step, n_valid, metrics, _start_read(metrics), rec)
        self._next_step += n_valid
        self._flushed = False
        return prev

    def flush(self) -> list:
        """``[the newest window]`` if ``push`` has not handed it back and
        no flush has, else ``[]``."""
        if self._held is None or self._flushed:
            return []
        self._flushed = True
        return [self._held]

    def last(self) -> Optional[Any]:
        """Fetch the newest window's metrics (waits for the device) and
        mark the reader drained."""
        if self._held is None:
            return None
        self._flushed = True
        return self._held.fetch()

    @property
    def steps_pushed(self) -> int:
        return self._next_step


def _stack(xs):
    if isinstance(xs[0], torch.Tensor):
        return torch.stack(xs)
    return np.stack(xs)


def _assemble_window(group, k: int, transform: Optional[Callable]):
    """One ``(window, n_valid)`` from a group of at most ``k`` batches:
    ``transform`` each, pad with the transformed last batch, stack."""
    items, n_valid = group
    if transform is not None:
        items = [transform(b) for b in items]
    if len(items) < k:
        items = items + [items[-1]] * (k - len(items))
    flat = [pytree.tree_flatten(b) for b in items]
    spec = flat[0][1]
    window = pytree.tree_unflatten(
        [_stack(list(xs)) for xs in zip(*(leaves for leaves, _ in flat))],
        spec)
    return window, n_valid


def _group_batches(batches: Iterable, k: int, pad_tail: bool) -> Iterator:
    """``(list of at most k batches, n_valid)`` groups, untransformed."""
    buf = []
    for b in batches:
        buf.append(b)
        if len(buf) == k:
            yield buf, k
            buf = []
    if buf and pad_tail:
        yield buf, len(buf)


def window_batches(batches: Iterable, k: int, *,
                   transform: Optional[Callable] = None,
                   pad_tail: bool = True) -> Iterator:
    """Group a batch stream into stacked ``[k, ...]`` windows on the
    caller's thread; yields ``(window, n_valid)``.  A final ragged group
    is padded by repeating its last batch (``n_valid`` counts the real
    ones), or dropped with ``pad_tail=False``."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    for group in _group_batches(batches, k, pad_tail):
        yield _assemble_window(group, k, transform)


def stage_windows(batches: Iterable, k: int, *,
                  transform: Optional[Callable] = None,
                  pad_tail: bool = True, depth: int = 2,
                  device=None, workers: int = 1):
    """:func:`window_batches` through a
    :class:`~apex_tpu_torch.data.PrefetchLoader`: ``workers`` threads
    assemble whole windows, and the staging thread moves them to
    ``device`` (default CUDA; ``"cpu"`` on a host without one), so the
    copy of window N+1 overlaps window N.  Returns the loader: iterate it
    for ``(window, n_valid)`` pairs, and ``close()`` it (or use it as a
    context manager) when abandoning the stream early."""
    from .data import PrefetchLoader

    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    return PrefetchLoader(_group_batches(batches, k, pad_tail),
                          depth=depth, device=device,
                          transform=lambda g: _assemble_window(
                              g, k, transform),
                          workers=workers)
