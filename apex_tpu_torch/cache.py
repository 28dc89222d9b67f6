"""Warm start: the kernels' build cache and CUDA-graph capture —
counterpart of ``apex_tpu/cache.py``.

JAX pays two cold-start taxes that the port pays in its own currency:

* the **first-run build**: here the ``nvcc`` builds of ``csrc/*.cu`` and
  the Triton compiles, where JAX compiles XLA programs.  :func:`enable`
  points both at one directory (the counterpart of JAX's persistent
  compilation cache), so a second process start loads instead of
  building;
* the **per-step dispatch**: where JAX runs an ahead-of-time compiled
  executable, the port replays a CUDA graph.  :func:`warmup` runs a step
  function once on a side stream (every Triton kernel compiles, every
  ctypes library loads, every lazily allocated buffer exists), then
  captures it over static copies of its arguments and returns a
  :class:`Captured`: calling it copies new arguments into the static
  inputs and replays, one host call for every kernel of the step.

On the CPU there is nothing to capture: :func:`warmup` returns the step
function itself, so the same entry points run the plain step bodies.

Usage::

    from apex_tpu_torch import cache
    cache.enable("~/.cache/apex_tpu_torch")      # once, at startup

    step = cache.warmup(fn, *args)                # capture before step 0
    out = step(*new_args)                         # copy in, replay

A captured step is the program, as a compiled executable is in JAX: its
Python body runs at capture only, so it must not read device values on
the host (no ``.item()``, no branch on a tensor).  A kernel wrapper's
launch counter (``_build.COUNTED``) counts what runs on the card: the
warm run adds its launches as the wrapper makes them, the capture adds
none (it records, it launches nothing), and each replay adds every
launch it recorded.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from . import _build

__all__ = ["enable", "is_enabled", "cache_dir", "TensorSpec", "abstractify",
           "signature", "warmup", "Captured", "WARM_RUNS"]

#: eager runs of a step on the capture stream before it is captured
WARM_RUNS = 1

_STATE = {"dir": None}
_CAPTURE_STREAMS: dict = {}      # device -> the stream graphs capture on


def enable(path: str) -> str:
    """Keep the CUDA libraries, the Triton kernels and the tuner's
    configs under ``path`` (created if missing): the libraries in
    ``path`` itself, Triton's cache in ``path/triton``, and
    ``path/tune_configs.json`` as the tune store's default
    (:func:`apex_tpu_torch.tune.store.set_default_dir`, as JAX's
    ``cache.enable`` does; ``APEX_TPU_TUNE_CACHE`` still wins).  A
    library already loaded in this process stays loaded; one built under
    ``path`` by an earlier process is loaded from there instead of
    rebuilt.  Returns the resolved path."""
    from .tune import store as _tune_store
    path = os.path.abspath(os.path.expanduser(path))
    os.makedirs(path, exist_ok=True)
    _build.set_build_dir(path)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(path, "triton")
    _tune_store.set_default_dir(path)
    _STATE["dir"] = path
    return path


def is_enabled() -> bool:
    return _STATE["dir"] is not None


def cache_dir() -> Optional[str]:
    """The directory :func:`enable` installed (None when disabled)."""
    return _STATE["dir"]


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape, dtype and device of a tensor: what a captured graph is
    specialized on (the counterpart of ``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    device: torch.device = torch.device("cpu")


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty((0,), dtype)).dtype


def abstractify(tree):
    """The tree with every tensor (or numpy array) replaced by its
    :class:`TensorSpec`; other leaves (plain ints, bools) pass through."""
    def one(leaf):
        if isinstance(leaf, TensorSpec):
            return leaf
        if isinstance(leaf, torch.Tensor):
            return TensorSpec(tuple(leaf.shape), leaf.dtype, leaf.device)
        if isinstance(leaf, np.ndarray):
            return TensorSpec(tuple(leaf.shape), _torch_dtype(leaf.dtype))
        return leaf
    return pytree.tree_map(one, tree)


def signature(tree, limit: int = 16, *,
              static: Tuple = ()) -> Tuple[str, ...]:
    """Shape/dtype signature of a tree's leading ``limit`` leaves, the
    lookup key of a table of captured steps: ``"float32[2, 3]"`` as the
    JAX package writes it, with ``"@cuda:0"`` appended for a tensor off
    the CPU (a graph takes only its own device's tensors).  ``static``
    appends parameters that specialize a capture without being tensors
    (the serving engine's kind and bucket) as ``"static:<repr>"``, so two
    calls whose tensors agree but whose bucket differs key apart."""
    sig = []
    for leaf in pytree.tree_leaves(abstractify(tree))[:limit]:
        if isinstance(leaf, TensorSpec):
            s = f"{str(leaf.dtype).replace('torch.', '')}{list(leaf.shape)}"
            if leaf.device.type != "cpu":
                s += f"@{leaf.device}"
        else:
            s = (f"{getattr(leaf, 'dtype', type(leaf).__name__)}"
                 f"{list(getattr(leaf, 'shape', ()))}")
        sig.append(s)
    return tuple(sig) + tuple(f"static:{v!r}" for v in static)


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The one side stream graphs of ``device`` are warmed and captured
    on, so the libraries' per-stream workspaces (cuBLAS) exist before a
    capture begins."""
    stream = _CAPTURE_STREAMS.get(device)
    if stream is None:
        stream = _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return stream


class Captured:
    """``fn`` captured in one CUDA graph over static copies of its
    arguments (see :func:`warmup`).

    ``static_args`` are the graph's inputs and ``out`` its outputs, both
    rewritten in place by every replay; ``launches`` maps each kernel
    wrapper the graph holds to its launches a replay (added to the
    wrapper's counter at every replay), ``routes`` each wrapper with a
    ``routes`` dict to its launches a replay by route.  Calling the
    object copies each tensor argument into its static input
    (``non_blocking``, so a pinned host tensor copies asynchronously),
    skipping an argument that is that static input already, replays the
    graph and returns ``out``.
    Non-tensor arguments were fixed at capture and must not change.
    """

    def __init__(self, fn, args: tuple, device: torch.device, pool=None):
        leaves, self._spec = pytree.tree_flatten(args)
        self._static = [
            torch.as_tensor(x).detach().to(device, copy=True)
            if isinstance(x, (torch.Tensor, np.ndarray)) else x
            for x in leaves]
        self._tensors = [i for i, x in enumerate(self._static)
                         if isinstance(x, torch.Tensor)]
        self._others = [i for i, x in enumerate(self._static)
                        if not isinstance(x, torch.Tensor)]
        self.static_args = pytree.tree_unflatten(self._static, self._spec)
        self.device = device
        stream = _capture_stream(device)
        with torch.cuda.device(device):
            stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(stream):
                for _ in range(WARM_RUNS):
                    fn(*self.static_args)
            self.graph = torch.cuda.CUDAGraph()
            before = {w: w.launches for w in _build.COUNTED}
            routes = {w: dict(w.routes) for w in _build.COUNTED
                      if hasattr(w, "routes")}
            # thread_local: a loader thread may stage windows on its own
            # stream while this thread captures
            with torch.cuda.graph(self.graph, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"):
                self.out = fn(*self.static_args)
            torch.cuda.current_stream(device).wait_stream(stream)
        # the wrappers counted what the capture recorded: take it back,
        # and add it at each replay, which launches it
        self.launches = {w: w.launches - before.get(w, 0)
                         for w in _build.COUNTED
                         if w.launches != before.get(w, 0)}
        for w, n in self.launches.items():
            w.launches -= n
        # a wrapper's launches by route (``flash_fwd_kernel.routes``) alike
        self.routes = {w: {r: w.routes[r] - n for r, n in was.items()
                           if w.routes[r] != n}
                       for w, was in routes.items()}
        for w, moved in self.routes.items():
            for r, n in moved.items():
                w.routes[r] -= n

    def __call__(self, *args):
        leaves, spec = pytree.tree_flatten(args)
        if spec != self._spec:
            raise ValueError(f"arguments {spec} do not match the captured "
                             f"{self._spec}")
        for i in self._tensors:
            new, static = leaves[i], self._static[i]
            if new is not static:
                static.copy_(torch.as_tensor(new), non_blocking=True)
        for i in self._others:
            if leaves[i] != self._static[i]:
                raise ValueError(f"argument {i} is {leaves[i]!r}; the graph "
                                 f"was captured with {self._static[i]!r}")
        self.graph.replay()
        for w, n in self.launches.items():
            w.launches += n
        for w, moved in self.routes.items():
            for r, n in moved.items():
                w.routes[r] += n
        return self.out


def warmup(fn, *args, device=None, pool=None) -> Any:
    """Capture ``fn(*args)`` for this signature before step 0.

    On CUDA (``device``, default the device of the first tensor in
    ``args``): run ``fn`` once on a side stream, so every kernel is
    built and every lazily made buffer exists, then capture it over
    static copies of ``args`` on ``device`` (pinned or pageable host
    arguments are copied there) and return the :class:`Captured` step.
    ``pool`` (``torch.cuda.graph_pool_handle()``) shares one memory pool
    among graphs that never run at once.  A capture that fails raises.

    On the CPU: return ``fn`` itself, the plain step body."""
    leaves = pytree.tree_leaves(args)
    if device is None:
        device = next((x.device for x in leaves
                       if isinstance(x, torch.Tensor)), torch.device("cpu"))
    device = torch.device(device)
    if device.type != "cuda":
        return fn
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return Captured(fn, args, device, pool)
