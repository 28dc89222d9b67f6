"""Input pipeline: synthetic ImageNet batches, their normalization, and
the multi-worker prefetch loader with asynchronous staging to the card —
counterpart of ``synthetic_imagenet``, ``normalize_images``,
``IMAGENET_MEAN``/``IMAGENET_STD``, ``LoaderError``, ``LoaderStats``,
``format_loader_line`` and ``PrefetchLoader`` of ``apex_tpu/data.py``.

The bytes come from the JAX package's counter-based lattice (block ``i``
of 8 bytes is ``splitmix64(seed + i)``, little-endian; the labels ride
on the same lattice after the image block), in this module's own numpy
copy, so a batch here is the JAX example's batch byte for byte.

:class:`PrefetchLoader` is the JAX loader's worker pool, with the
reference's ``data_prefetcher`` as its staging step: a staging thread
copies each finished batch to pinned memory and then to the card with
``non_blocking=True`` on a side stream, and the consumer's stream waits
on an event recorded after the copy, so the host-to-device copy of batch
N+1 overlaps the work on batch N.  Not ported yet: the native C++ tier,
augmentation and ``directory_imagenet`` (real data).
"""

from __future__ import annotations

import queue
import sys
import threading
import time
from typing import Callable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ._device import resolve_device

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

_MASK = 0xFFFFFFFFFFFFFFFF


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 over a uint64 lattice (wrapping arithmetic)."""
    with np.errstate(over="ignore"):
        z = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def synth_bytes(nbytes: int, seed: int) -> np.ndarray:
    """``nbytes`` pseudorandom bytes: block ``i`` of 8 is
    ``splitmix64(seed + i)`` in little-endian order."""
    if nbytes < 0:
        raise ValueError(f"nbytes must be >= 0, got {nbytes}")
    if sys.byteorder != "little":
        raise RuntimeError("synth_bytes assumes a little-endian host")
    lattice = (np.arange((nbytes + 7) // 8, dtype=np.uint64)
               + np.uint64(int(seed) & _MASK))
    return _splitmix64(lattice).view(np.uint8)[:nbytes]


def synthetic_imagenet(batch_size: int, image_size: int = 224,
                       num_classes: int = 1000, steps: int = 100,
                       seed: int = 0
                       ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """``steps`` batches of uint8 NHWC images and int32 labels,
    deterministic in ``(seed, step)``: the JAX stream's counter ranges."""
    nbytes = batch_size * image_size * image_size * 3
    for step in range(steps):
        base = (seed * 0x9E3779B97F4A7C15
                + step * (nbytes // 8 + batch_size + 2)) & _MASK
        imgs = synth_bytes(nbytes, base).reshape(batch_size, image_size,
                                                 image_size, 3)
        lab_base = (base + nbytes // 8 + 1) & _MASK
        with np.errstate(over="ignore"):
            lattice = (np.uint64(lab_base)
                       + np.arange(batch_size, dtype=np.uint64))
        labels = (_splitmix64(lattice)
                  % np.uint64(num_classes)).astype(np.int32)
        yield imgs, labels


def normalize_images(u8_batch, mean: Sequence[float] = IMAGENET_MEAN,
                     std: Sequence[float] = IMAGENET_STD) -> torch.Tensor:
    """uint8 NHWC (a tensor on any device, or a numpy array) to fp32
    NHWC on the same device, ``x * (1 / (255 * std)) + (-mean / std)``
    per channel in fp32: the JAX package's native normalize, the same
    arithmetic in the same order."""
    x = torch.as_tensor(u8_batch)
    mean_t = torch.tensor(mean, dtype=torch.float32, device=x.device)
    std_t = torch.tensor(std, dtype=torch.float32, device=x.device)
    if mean_t.numel() != x.shape[-1] or std_t.numel() != x.shape[-1]:
        raise ValueError("mean/std length must equal the channel count")
    scale = 1.0 / (255.0 * std_t)
    bias = -mean_t / std_t
    return x.float() * scale + bias


_THREAD_NAME = "apex-tpu-torch-prefetch"


class LoaderError:
    """Producer-side exception in transit to the consumer (a class of its
    own, so no batch can be mistaken for it)."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


class LoaderStats:
    """Thread-safe input-engine counters (seconds unless noted):
    ``produce_s`` worker time in ``transform`` (summed over workers);
    ``producer_stall_s`` worker time blocked on back-pressure;
    ``stage_s`` staging-thread time issuing the copies to the device;
    ``consumer_wait_s`` consumer time blocked on an empty queue (the time
    the training loop loses to input); ``batches`` delivered, ``staged``
    staged, ``mean_queue_depth`` at delivery.
    ``as_dict()["loader_stall_pct"]`` is the consumer wait as a percent of
    the wall time since the first delivery."""

    def __init__(self):
        self._lock = threading.Lock()
        self._t0: Optional[float] = None
        self.batches = 0
        self.staged = 0
        self.produce_s = 0.0
        self.producer_stall_s = 0.0
        self.stage_s = 0.0
        self.consumer_wait_s = 0.0
        self._depth_sum = 0
        self._depth_samples = 0

    def _add(self, field: str, dt: float) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + dt)

    def _start(self) -> None:
        with self._lock:
            if self._t0 is None:
                self._t0 = time.perf_counter()

    def _delivered(self, qdepth: int) -> None:
        with self._lock:
            self.batches += 1
            self._depth_sum += qdepth
            self._depth_samples += 1

    def _staged_one(self) -> None:
        with self._lock:
            self.staged += 1

    def as_dict(self) -> dict:
        """One consistent read of every counter, taken under the lock."""
        with self._lock:
            elapsed = (time.perf_counter() - self._t0) if self._t0 else 0.0
            depth = (self._depth_sum / self._depth_samples
                     if self._depth_samples else 0.0)
            return {
                "batches": self.batches,
                "staged": self.staged,
                "elapsed_s": round(elapsed, 3),
                "produce_s": round(self.produce_s, 3),
                "producer_stall_s": round(self.producer_stall_s, 3),
                "stage_s": round(self.stage_s, 3),
                "consumer_wait_s": round(self.consumer_wait_s, 3),
                "mean_queue_depth": round(depth, 2),
                "loader_stall_pct": (
                    round(100.0 * self.consumer_wait_s / elapsed, 2)
                    if elapsed > 0 else 0.0),
            }


def format_loader_line(stats: dict) -> str:
    """The one-line loader report the trainers print (the JAX package's
    ``loader: stall X%`` line)."""
    return (f"loader: stall {stats['loader_stall_pct']:.2f}% "
            f"wait {stats['consumer_wait_s']:.2f}s "
            f"produce {stats['produce_s']:.2f}s "
            f"stage {stats['stage_s']:.2f}s "
            f"depth {stats['mean_queue_depth']:.1f} "
            f"over {stats['batches']} batches")


class _Staged:
    """A staged batch and the event its copies to the card end at
    (``None`` on the CPU)."""

    __slots__ = ("item", "event")

    def __init__(self, item, event):
        self.item = item
        self.event = event


def _is_array(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


class PrefetchLoader:
    """Wrap an iterable of host batches in a worker pool and a staging
    thread (the JAX loader's pipeline; see the module docstring).

    * ``workers`` threads pull items off the shared source (under a lock)
      and run ``transform`` on them in parallel;
    * a staging thread takes finished batches in source order and moves
      every array leaf to ``device``: on CUDA through pinned memory with a non-blocking
      copy on a side stream, ended by an event the consumer's current
      stream waits on before the batch is handed over; on the CPU as a
      tensor;
    * bounded queues (``depth`` staged batches, ``workers + depth`` host
      batches) apply back-pressure end to end.

    ``device`` defaults to CUDA and raises without a GPU; pass
    ``device="cpu"`` to load onto the CPU.  A producer-side exception
    reaches the consumer in place of its batch, after every earlier one.
    Abandoning the iteration (``break``) or :meth:`close` stops and joins
    the threads; the loader is also a context manager.  ``telemetry`` is
    not ported yet (it raises)."""

    def __init__(self, it, depth: int = 2,
                 transform: Optional[Callable] = None,
                 device=None, workers: int = 1, telemetry=None):
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        if telemetry is not None:
            raise NotImplementedError("telemetry= is not ported yet")
        self._it = it
        self._depth = max(1, depth)
        self._transform = transform
        self._device = resolve_device(device)
        self._workers = workers
        self.stats = LoaderStats()
        self._live: list = []  # (stop Event, [Thread], Queue, sentinel)

    def close(self) -> None:
        """Stop every pipeline this loader started: set the stop events,
        drop staged batches and join the threads."""
        live, self._live = self._live, []
        for stop, threads, q, sentinel in live:
            stop.set()
            _drain(q)
            for t in threads:
                t.join(timeout=5)
            _drain(q)
            try:
                q.put_nowait(sentinel)
            except queue.Full:
                pass

    def __enter__(self) -> "PrefetchLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _stage(self, item, stream):
        """Move every array leaf of ``item`` to the device; returns a
        :class:`_Staged`."""
        dev = self._device
        if dev.type != "cuda":
            return _Staged(pytree.tree_map(
                lambda x: torch.as_tensor(x).to(dev) if _is_array(x) else x,
                item), None)

        def one(x):
            if not _is_array(x):
                return x
            t = torch.as_tensor(x)
            if t.device.type == "cpu" and not t.is_pinned():
                t = t.pin_memory()
            return t.to(dev, non_blocking=True)
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            item = pytree.tree_map(one, item)
            event = torch.cuda.Event()
            event.record(stream)
        return _Staged(item, event)

    def _hand_over(self, staged: _Staged):
        """The consumer's side of a staged batch: its current stream waits
        for the copies, and the batch's memory is marked as used there."""
        if staged.event is None:
            return staged.item
        current = torch.cuda.current_stream(self._device)
        current.wait_event(staged.event)
        for x in pytree.tree_leaves(staged.item):
            if isinstance(x, torch.Tensor) and x.is_cuda:
                x.record_stream(current)
        return staged.item

    def __iter__(self) -> Iterator:
        depth, workers = self._depth, self._workers
        transform = self._transform
        stats = self.stats
        q: "queue.Queue" = queue.Queue(maxsize=depth)
        sentinel = object()
        stop = threading.Event()
        src = iter(self._it)
        src_lock = threading.Lock()
        cond = threading.Condition()
        # guarded by ``cond``: next sequence number, count at exhaustion,
        # finished host batches by sequence number, batches staged
        st = {"seq": 0, "done": None, "ready": {}, "staged_n": 0}
        lookahead = workers + depth

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def work():
            while not stop.is_set():
                with cond:
                    while (st["seq"] - st["staged_n"] >= lookahead
                           and not stop.is_set()):
                        t0 = time.perf_counter()
                        cond.wait(0.1)
                        stats._add("producer_stall_s",
                                   time.perf_counter() - t0)
                    if stop.is_set():
                        return
                with src_lock:
                    with cond:
                        if st["done"] is not None:
                            return
                    seq = st["seq"]
                    try:
                        item = next(src)
                    except StopIteration:
                        with cond:
                            st["done"] = seq
                            cond.notify_all()
                        return
                    except BaseException as e:
                        with cond:
                            st["ready"][seq] = LoaderError(e)
                            st["done"] = seq + 1
                            st["seq"] = seq + 1
                            cond.notify_all()
                        return
                    st["seq"] = seq + 1
                out = item
                if transform is not None:
                    t0 = time.perf_counter()
                    try:
                        out = transform(item)
                    except BaseException as e:
                        out = LoaderError(e)
                    stats._add("produce_s", time.perf_counter() - t0)
                with cond:
                    st["ready"][seq] = out
                    cond.notify_all()

        def stage():
            stream = (torch.cuda.Stream(self._device)
                      if self._device.type == "cuda" else None)
            while not stop.is_set():
                item, got, exhausted = None, False, False
                with cond:
                    while not stop.is_set():
                        ready = st["ready"]
                        if st["staged_n"] in ready:
                            item, got = ready.pop(st["staged_n"]), True
                            break
                        if st["done"] is not None \
                                and st["staged_n"] >= st["done"]:
                            exhausted = True
                            break
                        cond.wait(0.1)
                    if stop.is_set():
                        return
                    if got:
                        st["staged_n"] += 1
                        cond.notify_all()
                if exhausted:
                    put(sentinel)
                    return
                if isinstance(item, LoaderError):
                    put(item)
                    put(sentinel)
                    return
                t0 = time.perf_counter()
                try:
                    staged = self._stage(item, stream)
                except BaseException as e:
                    put(LoaderError(e))
                    put(sentinel)
                    return
                stats._add("stage_s", time.perf_counter() - t0)
                stats._staged_one()
                if not put(staged):
                    return

        threads = [threading.Thread(target=work, daemon=True,
                                    name=f"{_THREAD_NAME}-w{i}")
                   for i in range(workers)]
        threads.append(threading.Thread(target=stage, daemon=True,
                                        name=_THREAD_NAME))
        for t in threads:
            t.start()
        handle = (stop, threads, q, sentinel)
        self._live.append(handle)
        try:
            while True:
                stats._start()
                t0 = time.perf_counter()
                item = q.get()
                stats._add("consumer_wait_s", time.perf_counter() - t0)
                if item is sentinel:
                    break
                if isinstance(item, LoaderError):
                    raise item.exc
                stats._delivered(q.qsize())
                yield self._hand_over(item)
        finally:
            stop.set()
            with cond:
                cond.notify_all()
            _drain(q)
            if handle in self._live:
                self._live.remove(handle)


def _drain(q: "queue.Queue") -> None:
    while True:
        try:
            q.get_nowait()
        except queue.Empty:
            return
