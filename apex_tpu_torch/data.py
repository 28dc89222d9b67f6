"""Input pipeline: synthetic and directory ImageNet batches, their
normalization and augmentation, and the multi-worker prefetch loader
with asynchronous staging to the card — counterpart of
``apex_tpu/data.py``.

* :func:`synthetic_imagenet` draws its bytes from the JAX package's
  counter-based lattice (block ``i`` of 8 bytes is ``splitmix64(seed +
  i)``, little-endian; the labels ride on the same lattice after the
  image block) through the host runtime (:mod:`apex_tpu_torch.native`),
  so a batch here is the JAX example's batch byte for byte;
* :func:`directory_imagenet` streams ``root/<class>/*.{npy,jpg,jpeg,png}``
  as a :class:`DirectoryImagenet`, a cursor over a deterministic
  schedule (per-epoch ``RandomState(seed + epoch)`` shuffle, ``drop_last``,
  host-shard slices), so :meth:`~DirectoryImagenet.state_dict` and
  :meth:`~DirectoryImagenet.resume` replay the identical remaining
  stream; with ``decode=False`` it yields :class:`BatchFiles` that
  :func:`load_batch` decodes in the loader's workers;
* :func:`augment_images` is the random crop, flip and normalize in one
  native pass (``native.crop_flip_normalize``).

:class:`PrefetchLoader` is the JAX loader's worker pool, with the
reference's ``data_prefetcher`` as its staging step: a staging thread
copies each finished batch to pinned memory and then to the card with
``non_blocking=True`` on a side stream, and the consumer's stream waits
on an event recorded after the copy, so the host-to-device copy of batch
N+1 overlaps the work on batch N.  ``ordered=False`` delivers in
completion order; :meth:`PrefetchLoader.state_dict` rewinds the source
to the delivered count.  ``host_shard=True`` takes the stream's shard
from :func:`apex_tpu_torch.parallel.multiproc.process_identity`.

Telemetry: with a recorder (``telemetry=``, else the active one) the
loader emits JAX's events from its own threads: ``stage`` for each batch
staged (and the ``stage_s`` histogram), ``loader_wait`` for each
delivery (the ``loader_wait_s`` histogram and the ``loader_queue_depth``
gauge), and a ``loader`` snapshot of :class:`LoaderStats` when the
stream ends or the loader closes (the ``loader_stall_pct`` gauge, the
number the trainers print).
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import (Callable, Iterator, NamedTuple, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch
from torch.utils import _pytree as pytree

from . import native
from ._device import resolve_device
from .telemetry import events as _events

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

_MASK = 0xFFFFFFFFFFFFFFFF


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
        imgs = native.synth_bytes(nbytes, base).reshape(
            batch_size, image_size, image_size, 3)
        lab_base = (base + nbytes // 8 + 1) & _MASK
        with np.errstate(over="ignore"):
            lattice = (np.uint64(lab_base)
                       + np.arange(batch_size, dtype=np.uint64))
        labels = (native._splitmix64(lattice)
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


def augment_images(u8_batch: np.ndarray, out_size: int,
                   rng: np.random.RandomState, flip: bool = True,
                   mean: Sequence[float] = IMAGENET_MEAN,
                   std: Sequence[float] = IMAGENET_STD) -> np.ndarray:
    """Random crop, random horizontal flip and normalize of a uint8 NHWC
    batch in one native pass (:func:`native.crop_flip_normalize`); only
    the per-image offsets and flips are drawn in Python, from ``rng``,
    in the JAX package's order."""
    n, h, w, _ = u8_batch.shape
    offsets = np.stack([rng.randint(0, h - out_size + 1, n),
                        rng.randint(0, w - out_size + 1, n)],
                       axis=1).astype(np.int32)
    flips = ((rng.rand(n) < 0.5).astype(np.uint8) if flip
             else np.zeros(n, np.uint8))
    return native.crop_flip_normalize(u8_batch, out_size, offsets, flips,
                                      mean, std)


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

    ``ordered=True`` (the default) delivers in source order, ``False`` in
    completion order.  ``device`` defaults to CUDA and raises without a
    GPU; pass ``device="cpu"`` to load onto the CPU.  A producer-side
    exception reaches the consumer in place of its batch, after every
    earlier one (ordered).  Abandoning the iteration (``break``) or
    :meth:`close` stops and joins the threads; the loader is also a
    context manager.  ``telemetry`` pins a recorder (see the module
    docstring); None takes the active one at each event."""

    def __init__(self, it, depth: int = 2,
                 transform: Optional[Callable] = None,
                 device=None, workers: int = 1, ordered: bool = True,
                 telemetry=None):
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        self._it = it
        self._telemetry = telemetry
        self._depth = max(1, depth)
        self._transform = transform
        self._device = resolve_device(device)
        self._workers = workers
        self._ordered = bool(ordered)
        self.stats = LoaderStats()
        self._live: list = []  # (stop Event, [Thread], Queue, sentinel)

    def _rec(self):
        return (self._telemetry if self._telemetry is not None
                else _events.get_recorder())

    def _emit_loader_snapshot(self, phase: str) -> None:
        """One ``loader`` event with the same ``LoaderStats.as_dict()``
        snapshot the trainers print, and the ``loader_stall_pct``
        gauge."""
        rec = self._rec()
        if rec is not None:
            stats = self.stats.as_dict()
            rec.event("loader", phase=phase, stats=stats)
            rec.metrics.gauge("loader_stall_pct").set(
                stats["loader_stall_pct"])

    def close(self) -> None:
        """Stop every pipeline this loader started: set the stop events,
        drop staged batches and join the threads."""
        live, self._live = self._live, []
        if live:
            self._emit_loader_snapshot("close")
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

    def state_dict(self) -> dict:
        """Resume state: ``delivered``, the batches the consumer received
        (the pipeline runs ahead of it), and, when the source has the
        resume protocol (:class:`DirectoryImagenet`), ``source``, its
        ``state_dict(consumed=delivered)``: the source rewound to the
        delivery boundary.  Rebuild the stream, ``resume`` it with that
        and wrap it in a fresh loader.  Needs ``ordered=True``: in
        completion order the delivered batches are no prefix of the
        source, so no cursor can rewind to them."""
        if not self._ordered:
            raise ValueError(
                "PrefetchLoader.state_dict() needs ordered=True: "
                "completion-order delivery has no prefix cursor, so a "
                "delivered-count resume would skip in-flight batches and "
                "replay delivered ones")
        delivered = self.stats.batches
        out = {"delivered": int(delivered)}
        sd = getattr(self._it, "state_dict", None)
        if sd is not None:
            try:
                out["source"] = sd(consumed=delivered)
            except TypeError:
                out["source"] = sd()
        return out

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
        transform, ordered = self._transform, self._ordered
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
                item, got, exhausted, seq_no = None, False, False, None
                with cond:
                    while not stop.is_set():
                        ready = st["ready"]
                        if ordered:
                            if st["staged_n"] in ready:
                                item, got = ready.pop(st["staged_n"]), True
                                break
                        elif ready:
                            item, got = ready.pop(min(ready)), True
                            break
                        if st["done"] is not None \
                                and st["staged_n"] >= st["done"]:
                            exhausted = True
                            break
                        cond.wait(0.1)
                    if stop.is_set():
                        return
                    if got:
                        seq_no = st["staged_n"]
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
                dt = time.perf_counter() - t0
                stats._add("stage_s", dt)
                stats._staged_one()
                rec = self._rec()
                if rec is not None:
                    # on the staging thread, never on the training loop
                    rec.event("stage", seq=seq_no, dur=round(dt, 6))
                    rec.metrics.histogram("stage_s").observe(dt)
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
                dt = time.perf_counter() - t0
                stats._add("consumer_wait_s", dt)
                if item is sentinel:
                    self._emit_loader_snapshot("exhausted")
                    break
                if isinstance(item, LoaderError):
                    raise item.exc
                qdepth = q.qsize()
                stats._delivered(qdepth)
                rec = self._rec()
                if rec is not None:
                    rec.event("loader_wait", dur=round(dt, 6),
                              qdepth=qdepth)
                    rec.metrics.histogram("loader_wait_s").observe(dt)
                    rec.metrics.gauge("loader_queue_depth").set(qdepth)
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


class BatchFiles(NamedTuple):
    """The files of one batch, undecoded: yielded by
    :func:`directory_imagenet` with ``decode=False`` so the source stays
    cheap under the loader's lock and :func:`load_batch` decodes in the
    workers.  ``seq`` is the batch's global sequence number (monotonic
    across epochs, equal to the stream's cursor), so a resumed stream
    yields the same descriptor and a per-batch augment seed mixed from
    it replays the same draws."""
    paths: Tuple[str, ...]
    labels: np.ndarray            # int32 [batch]
    image_size: int
    seq: int = 0


def _load_image(path: str, image_size: int) -> np.ndarray:
    """One HWC uint8 image: ``.npy`` as stored, JPEG/PNG through PIL
    (imported here, at use); resized nearest-neighbour to
    ``image_size`` square when it differs."""
    if path.endswith(".npy"):
        img = np.load(path)
    else:
        from PIL import Image
        img = np.asarray(Image.open(path).convert("RGB"))
    if img.shape[:2] != (image_size, image_size):
        ys = np.linspace(0, img.shape[0] - 1, image_size).astype(int)
        xs = np.linspace(0, img.shape[1] - 1, image_size).astype(int)
        img = img[ys][:, xs]
    return img.astype(np.uint8)


def load_batch(task: BatchFiles) -> Tuple[np.ndarray, np.ndarray]:
    """Decode one :class:`BatchFiles` into ``(uint8 NHWC batch, int32
    labels)``: the workers' half of the ``decode=False`` protocol."""
    imgs = np.stack([_load_image(p, task.image_size) for p in task.paths])
    return imgs, task.labels


class DirectoryImagenet:
    """Resumable batch stream over an ImageNet-style directory (the class
    behind :func:`directory_imagenet`).

    The batch sequence is a function of the constructor's arguments and
    one integer, ``cursor``, the batches this stream has yielded: the
    epoch, its shuffle (``RandomState(seed + epoch)``), the host-shard
    slice and the global ``seq`` (= cursor) all follow from it, so
    :meth:`state_dict` / :meth:`resume` put a new stream on the same
    remaining batches, and :meth:`skip` fast-forwards by index math
    alone.  The object is its own single-pass iterator; :meth:`close`
    releases the decode pool.  ``host_shard=(index, count)`` keeps every
    ``count``-th batch from ``index`` (after cutting each epoch to a
    multiple of ``count`` batches, so every process takes as many steps);
    ``host_shard=True`` is this process's ``(rank, world size)``."""

    def __init__(self, root: str, batch_size: int, image_size: int = 224,
                 shuffle: bool = True, seed: int = 0,
                 drop_last: bool = True, workers: int = 8,
                 epochs: Optional[int] = 1, decode: bool = True,
                 host_shard: Union[None, bool, Tuple[int, int]] = None):
        if host_shard is True:
            from .parallel.multiproc import process_identity
            host_shard = process_identity()
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        if not classes:
            raise ValueError(f"no class subdirectories under {root}")
        samples = []
        for label, c in enumerate(classes):
            cdir = os.path.join(root, c)
            for f in sorted(os.listdir(cdir)):
                if f.lower().endswith((".npy", ".jpg", ".jpeg", ".png")):
                    samples.append((os.path.join(cdir, f), label))
        if not samples:
            raise ValueError(f"no samples under {root}")
        index, count = host_shard if host_shard else (0, 1)
        if not 0 <= index < count:
            raise ValueError(f"host_shard index {index} not in [0, {count})")
        self._samples = samples
        self.batch_size = int(batch_size)
        self.image_size = int(image_size)
        self.shuffle = bool(shuffle)
        self.seed = int(seed)
        self.drop_last = bool(drop_last)
        self.workers = int(workers)
        self.decode = bool(decode)
        self.host_shard = (int(index), int(count))
        self.epochs = epochs
        stop = (len(samples) - batch_size + 1) if drop_last \
            else len(samples)
        starts = list(range(0, stop, batch_size))
        usable = len(starts) - len(starts) % count
        self._local_starts = starts[index:usable:count]
        #: batches already yielded (also the ``seq`` of the next one)
        self.cursor = 0
        self._epoch_cached: Optional[int] = None
        self._epoch_samples = None
        self._pool = None
        self._closed = False

    @property
    def batches_per_epoch(self) -> int:
        return len(self._local_starts)

    def state_dict(self, consumed: Optional[int] = None) -> dict:
        """The stream's resume state; ``consumed`` (the batches the
        training loop has taken) replaces the cursor, which a prefetching
        loader runs ahead of."""
        cursor = self.cursor if consumed is None else int(consumed)
        return {"cursor": cursor, "seed": self.seed,
                "shuffle": self.shuffle, "batch_size": self.batch_size,
                "host_shard": list(self.host_shard),
                "batches_per_epoch": self.batches_per_epoch,
                "n_samples": len(self._samples)}

    def resume(self, state: dict) -> "DirectoryImagenet":
        """Put this stream at ``state``'s cursor; raises ``ValueError``
        when the recorded schedule (seed, shuffle, batch size, shard,
        batches an epoch, sample count) differs from this stream's."""
        for key, mine in (("seed", self.seed), ("shuffle", self.shuffle),
                          ("batch_size", self.batch_size),
                          ("host_shard", list(self.host_shard)),
                          ("batches_per_epoch", self.batches_per_epoch),
                          ("n_samples", len(self._samples))):
            if key in state and state[key] != mine:
                raise ValueError(
                    f"loader resume mismatch: checkpoint {key}="
                    f"{state[key]!r}, stream has {mine!r} — the resumed "
                    f"stream must be built with the same dataset and "
                    f"schedule arguments as the saved run")
        self.cursor = int(state["cursor"])
        return self

    def skip(self, n_batches: int) -> "DirectoryImagenet":
        """Fast-forward ``n_batches`` (index math, no decode)."""
        self.cursor += int(n_batches)
        return self

    def _epoch_order(self, epoch: int):
        if self._epoch_cached != epoch:
            if self.shuffle:
                order = np.random.RandomState(
                    self.seed + epoch).permutation(len(self._samples))
                self._epoch_samples = [self._samples[i] for i in order]
            else:
                self._epoch_samples = self._samples
            self._epoch_cached = epoch
        return self._epoch_samples

    def _release_pool(self, wait: bool) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=wait)
            self._pool = None

    def close(self) -> None:
        """Release the decode pool; iterating after close yields
        nothing."""
        self._closed = True
        self._release_pool(wait=False)

    def __iter__(self) -> "DirectoryImagenet":
        return self

    def __next__(self):
        if self._closed:
            raise StopIteration
        bpe = self.batches_per_epoch
        if bpe == 0 or (self.epochs is not None
                        and self.cursor >= self.epochs * bpe):
            self._release_pool(wait=True)
            raise StopIteration
        epoch, pos = divmod(self.cursor, bpe)
        start = self._local_starts[pos]
        batch = self._epoch_order(epoch)[start:start + self.batch_size]
        labels = np.asarray([label for _, label in batch], np.int32)
        seq = self.cursor
        self.cursor += 1
        paths = tuple(p for p, _ in batch)
        if not self.decode:
            return BatchFiles(paths, labels, self.image_size, seq)
        if self.workers > 1 and self._pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(max_workers=self.workers)
        load = lambda p: _load_image(p, self.image_size)  # noqa: E731
        imgs = (self._pool.map(load, paths) if self._pool is not None
                else map(load, paths))
        return np.stack(list(imgs)), labels


def directory_imagenet(root: str, batch_size: int, image_size: int = 224,
                       shuffle: bool = True, seed: int = 0,
                       drop_last: bool = True, workers: int = 8,
                       epochs: Optional[int] = 1, decode: bool = True,
                       host_shard: Union[None, bool,
                                         Tuple[int, int]] = None
                       ) -> DirectoryImagenet:
    """Batches from ``root/<class_name>/*.{npy,jpg,jpeg,png}`` (``.npy``
    holds HWC uint8; JPEG and PNG decode through PIL): a
    :class:`DirectoryImagenet`.  ``epochs`` passes (None: forever), a
    fresh shuffle each; ``decode=True`` yields ``(uint8 NHWC, int32
    labels)`` decoded by ``workers`` threads, ``decode=False``
    :class:`BatchFiles` for :func:`load_batch` in a loader's
    ``transform``; ``host_shard`` as in the class."""
    return DirectoryImagenet(root, batch_size, image_size=image_size,
                             shuffle=shuffle, seed=seed,
                             drop_last=drop_last, workers=workers,
                             epochs=epochs, decode=decode,
                             host_shard=host_shard)
