"""Checkpoint and resume: single-file states and the async directory
engine — counterpart of ``apex_tpu/checkpoint.py``.

Two tiers, in the JAX package's formats:

* **v1, one file** — :func:`save_checkpoint` / :func:`load_checkpoint`
  write any tree of tensors (dicts, lists, tuples, NamedTuples such as
  :class:`~apex_tpu_torch.training.TrainState`) to one ``.npz`` keyed by
  the leaves' paths, with the amp state and extras beside them;
* **v2, a directory per step** — :class:`CheckpointManager` writes
  ``step_%08d/shard_00000_of_00001.npz`` and its
  ``manifest_00000_of_00001.json`` (format, version, step, per-file
  crc32, the loader state), each published by writing ``.tmp`` and
  ``os.replace``, the manifest last; :func:`load_checkpoint_dir` restores
  the newest *valid* step (a missing manifest, a truncated or corrupted
  shard, a mid-write ``.tmp`` are skipped, as JAX's
  ``_validate_step_dir`` skips them).

Leaf encoding is JAX's: numpy has no bf16, so a bf16 leaf is stored as
its 16-bit payload (``uint16``) under the key suffix
``@dtype=bfloat16``; the bits go ``view(int16)`` → ``view(uint16)`` and
back, never through fp32.  Leaf paths are the port's own (the
``state_dict`` names under the NamedTuple fields, ``/``-joined).

The async save (:meth:`CheckpointManager.save`) starts every CUDA leaf's
copy into pinned host memory (``non_blocking``) on the **current
stream** before waiting on any of them, and records one event after
them; the writer thread waits on that event, then serializes, fsyncs
and publishes.  Starting the copies on the current stream orders them
before anything queued later on it — the next replay of a captured
:class:`~apex_tpu_torch.runtime.StepPipeline`, which overwrites the
state it returned in place — so a checkpoint never holds half of one
window and half of the next.  The train loop pays only for starting
the copies.

Usage (the trainers' ``--checkpoint-dir/--checkpoint-every/--resume``)::

    mgr = checkpoint.CheckpointManager(dir, keep=3, every_steps=500)
    restored = mgr.restore(like=init_state)      # None on a fresh start
    ...
    for window ...:
        state, metrics = pipe.step_window(state, window, n)
        mgr.maybe_save(step, state, loader_state=stream.state_dict(...))
    mgr.save(step, state, block=True)            # final, synchronous
    mgr.close()

Not ported yet, each raising ``NotImplementedError``: ``procs`` other
than ``(0, 1)`` (cross-process shards, ROADMAP queue 1 "Data
parallel"), restoring a ``bucket_layout`` state at another shard count
(the zero1 reshard, "Sharding") and ``telemetry=`` ("Observability and
tuning").
"""

from __future__ import annotations

import json
import os
import queue
import re
import shutil
import threading
import time
import uuid
import zlib
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

__all__ = ["save_checkpoint", "load_checkpoint", "CheckpointManager",
           "Restored", "load_checkpoint_dir", "latest_checkpoint",
           "list_checkpoints", "bucket_layout", "CheckpointError",
           "open_for_training"]

_DTYPE_TAG = "@dtype="
_JSON_PREFIX = "__extrajson__/"
_STEP_DIR_RE = re.compile(r"^step_(\d{8,})$")
_MANIFEST_VERSION = 1

_DATA_PARALLEL = 'ROADMAP queue 1, "Data parallel"'
_SHARDING = 'ROADMAP queue 1, "Sharding"'
_OBSERVABILITY = 'ROADMAP queue 1, "Observability and tuning"'


class CheckpointError(RuntimeError):
    """A checkpoint could not be written or no valid one could be read."""


# -- leaf encoding --------------------------------------------------------------

def _encode(t: torch.Tensor) -> Tuple[np.ndarray, Optional[str]]:
    """A host tensor as the array npz stores and its dtype tag: bf16 as
    its raw 16 bits (``uint16``, tag ``bfloat16``), the rest as they
    are."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), None


def _decode(arr: np.ndarray, tag: Optional[str]) -> torch.Tensor:
    """The stored array as a CPU tensor (a bf16 tag reinterprets the
    16-bit payload, no ``ml_dtypes`` needed)."""
    arr = np.require(arr, requirements="C")   # keeps a 0-dim array 0-dim
    if tag is None:
        return torch.from_numpy(arr)
    if tag == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    raise CheckpointError(f"checkpoint leaf dtype {tag!r} is not one the "
                          f"port reads")


def _path_key(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx",
                                                  getattr(p, "name", p))))
                    for p in path)


def _host_array(leaf) -> Tuple[np.ndarray, Optional[str]]:
    if isinstance(leaf, torch.Tensor):
        return _encode(leaf.detach().cpu().contiguous())
    return np.asarray(leaf), None


def _flatten_with_paths(tree) -> dict:
    """``{key: array}`` of ``tree``'s leaves, read to the host now."""
    out = {}
    for path, leaf in pytree.tree_flatten_with_path(tree)[0]:
        if leaf is None:              # an empty field (no model state)
            continue
        arr, tag = _host_array(leaf)
        key = _path_key(path)
        out[key if tag is None else key + _DTYPE_TAG + tag] = arr
    return out


class _Snapshot(NamedTuple):
    """The host copies of a tree's leaves: ``(key, host tensor or
    array)`` pairs, the event the CUDA copies end at (None: none), the
    timing events around them, and the pinned buffer the copies fill."""
    leaves: list
    done: Any
    timing: Any
    buffer: Any = None


#: byte alignment of each leaf in a snapshot's pinned buffer
_ALIGN = 64


def _span(leaf: torch.Tensor) -> int:
    return -(-leaf.numel() * leaf.element_size() // _ALIGN) * _ALIGN


def _pinned_bytes(tree) -> int:
    """The bytes of the pinned buffer a snapshot of ``tree`` takes."""
    return sum(_span(x) for x in pytree.tree_leaves(tree)
               if isinstance(x, torch.Tensor) and x.is_cuda)


def _pinned(nbytes: int) -> torch.Tensor:
    return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)


def _snapshot(tree, take: Callable = _pinned) -> _Snapshot:
    """Start every CUDA leaf's copy into one pinned host buffer of
    ``take(nbytes)``, on the current stream (nothing is waited on here);
    CPU leaves are cloned."""
    flat = [(_path_key(path), leaf) for path, leaf in
            pytree.tree_flatten_with_path(tree)[0] if leaf is not None]
    nbytes = _pinned_bytes(tree)
    if not nbytes:
        return _Snapshot(
            [(key, leaf.detach().clone() if isinstance(leaf, torch.Tensor)
              else np.asarray(leaf)) for key, leaf in flat], None, None)
    buf = take(nbytes)
    stream = None
    pairs, at = [], 0
    for key, leaf in flat:
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            if stream is None:
                stream = torch.cuda.current_stream(leaf.device)
                start = torch.cuda.Event(enable_timing=True)
                start.record(stream)
            n = leaf.numel() * leaf.element_size()
            host = buf[at:at + n].view(leaf.dtype).view(leaf.shape)
            host.copy_(leaf.detach(), non_blocking=True)
            at += _span(leaf)
            pairs.append((key, host))
        elif isinstance(leaf, torch.Tensor):
            pairs.append((key, leaf.detach().clone()))
        else:
            pairs.append((key, np.asarray(leaf)))
    done = torch.cuda.Event(enable_timing=True)
    done.record(stream)
    return _Snapshot(pairs, done, (start, done), buf)


def _materialize(snap: _Snapshot) -> dict:
    """Wait for the snapshot's copies; ``{key: array}`` as npz stores
    them."""
    if snap.done is not None:
        snap.done.synchronize()
    out = {}
    for key, val in snap.leaves:
        if isinstance(val, torch.Tensor):
            arr, tag = _encode(val.contiguous())
            if tag is not None:
                key = key + _DTYPE_TAG + tag
        else:
            arr = val
        out[key] = arr
    return out


# -- extras ---------------------------------------------------------------------

def _encode_extra(key: str, value):
    """One ``**extra`` value as ``(npz key, array)``: arrays and numeric
    scalars as arrays, ``str``/``bool``/``None``/dicts/lists as tagged
    JSON bytes; raises ``TypeError`` on anything else."""
    if isinstance(value, (bool, str)) or value is None \
            or isinstance(value, (dict, list, tuple)):
        try:
            payload = json.dumps(value)
        except (TypeError, ValueError) as e:
            raise TypeError(
                f"checkpoint extra {key!r} is not serializable: {e} — "
                f"pass arrays, numeric scalars, or JSON-compatible "
                f"values") from e
        return (_JSON_PREFIX + key,
                np.frombuffer(payload.encode("utf-8"), np.uint8))
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    arr = np.asarray(value)
    if arr.dtype == object:
        raise TypeError(
            f"checkpoint extra {key!r} has object dtype "
            f"({type(value).__name__}) — pass arrays, numeric scalars, "
            f"or JSON-compatible values")
    return key, arr


def _decode_extras(raw: dict) -> dict:
    out = {}
    for k, v in raw.items():
        if k.startswith(_JSON_PREFIX):
            out[k[len(_JSON_PREFIX):]] = json.loads(
                bytes(np.asarray(v, np.uint8)).decode("utf-8"))
        else:
            out[k] = v.numpy() if isinstance(v, torch.Tensor) else v
    return out


def _split_raw_arrays(arrays: dict):
    """Split a loaded ``{key: array}`` into (state leaves as tensors, amp
    state, raw extras)."""
    amp_state, extra_raw, plain = {}, {}, {}
    for k, v in arrays.items():
        tag = None
        if _DTYPE_TAG in k:
            k, tag = k.split(_DTYPE_TAG, 1)
        if k.startswith("__amp__/"):
            amp_state[k[len("__amp__/"):]] = v
        elif k.startswith("__extra__/"):
            extra_raw[k[len("__extra__/"):]] = (v if tag is None
                                                else _decode(v, tag))
        else:
            plain[k] = _decode(v, tag)
    return plain, amp_state, extra_raw


def _rebuild(plain: dict, like, *, buckets: Optional[dict] = None,
             context: str = "checkpoint"):
    """Match ``plain`` (key -> CPU tensor) against the template ``like``:
    every leaf must be there with the template's dtype and shape; each
    restored tensor is put on the template leaf's device."""
    flat, spec = pytree.tree_flatten_with_path(like)
    consumed = set()
    leaves = []
    for path, leaf in flat:
        if leaf is None:
            leaves.append(None)
            continue
        key = _path_key(path)
        if key not in plain:
            raise KeyError(f"{context} missing leaf {key!r}")
        consumed.add(key)
        t = plain[key]
        if isinstance(leaf, torch.Tensor):
            if t.dtype != leaf.dtype:
                raise ValueError(
                    f"dtype mismatch for {key!r}: checkpoint {t.dtype}, "
                    f"template {leaf.dtype} — restore with the same "
                    f"opt_level used at save time (reference checkpointing "
                    f"rule)")
            if tuple(t.shape) != tuple(leaf.shape):
                if buckets and t.dim() == 1 and leaf.dim() == 1:
                    raise NotImplementedError(
                        f"{context}: flat bucket {key!r} was saved padded "
                        f"for {buckets.get('num_shards')} shard(s) and the "
                        f"template differs; restoring at another shard "
                        f"count (the zero1 reshard) is not ported yet "
                        f"({_SHARDING})")
                raise ValueError(
                    f"shape mismatch for {key!r}: checkpoint "
                    f"{tuple(t.shape)}, template {tuple(leaf.shape)}")
            t = t.to(leaf.device)
        leaves.append(t)
    unconsumed = set(plain) - consumed
    if unconsumed:
        raise KeyError(
            "{} holds {} array(s) with no matching template leaf (e.g. "
            "{!r}) — the template tree does not match the model that was "
            "saved".format(context, len(unconsumed), sorted(unconsumed)[0]))
    return pytree.tree_unflatten(leaves, spec)


# -- v1: one file ---------------------------------------------------------------

def save_checkpoint(path: str, state, amp_state: Optional[dict] = None,
                    **extra) -> None:
    """Write ``state`` (any tree of tensors) and the optional amp
    ``state_dict`` to ``path`` (.npz), published atomically.  ``extra``
    values may be arrays, numeric scalars or JSON-compatible values; all
    come back from :func:`load_checkpoint` with their Python types."""
    arrays = _flatten_with_paths(state)
    if amp_state:
        for k, v in _flatten_with_paths(amp_state).items():
            arrays["__amp__/" + k] = v
    for k, v in extra.items():
        ek, ev = _encode_extra(k, v)
        arrays["__extra__/" + ek] = ev
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load_checkpoint(path: str, like):
    """Restore a tree shaped like ``like`` from ``path``; returns
    ``(state, amp_state_dict, extra_dict)``.  Dtypes and shapes must
    match the template; each tensor lands on its template leaf's
    device."""
    with np.load(path, allow_pickle=False) as data:
        arrays = {k: data[k] for k in data.files}
    plain, amp_state, extra_raw = _split_raw_arrays(arrays)
    return _rebuild(plain, like), amp_state, _decode_extras(extra_raw)


# -- v2: a directory per step ---------------------------------------------------

def _step_dir_name(step: int) -> str:
    return f"step_{int(step):08d}"


def _shard_file_name(shard: int, n_shards: int) -> str:
    return f"shard_{shard:05d}_of_{n_shards:05d}.npz"


def _manifest_file_name(shard: int, n_shards: int) -> str:
    return f"manifest_{shard:05d}_of_{n_shards:05d}.json"


def _crc32_file(path: str) -> str:
    crc = 0
    with open(path, "rb") as f:
        # large reads: a thread checking a shard beside a busy one waits
        # for the GIL at each read, so few reads keep it from stretching
        for chunk in iter(lambda: f.read(1 << 26), b""):
            crc = zlib.crc32(chunk, crc)
    return f"{crc & 0xFFFFFFFF:08x}"


def bucket_layout(store, num_shards: int) -> dict:
    """Manifest descriptor of a bucketed state's flat buckets (each
    bucket's true size and the shard count it was padded for), from the
    :class:`~apex_tpu_torch.multi_tensor.BucketStore` the optimizer
    packs with.  Recorded by :meth:`CheckpointManager.save`; a restore at
    the same count needs nothing of it."""
    return store.shard_layout(num_shards)


class Restored(NamedTuple):
    """One restored v2 checkpoint."""
    state: Any
    amp_state: dict
    extra: dict
    loader_state: Optional[dict]
    step: int
    run_id: Optional[str] = None


def list_checkpoints(directory: str):
    """Sorted ``(step, step_dir)`` pairs under ``directory`` (not
    validated; see :func:`latest_checkpoint`)."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = _STEP_DIR_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, name)))
    return sorted(out)


def _validate_step_dir(step_dir: str) -> Optional[dict]:
    """The merged manifest of one step directory when every manifest part
    is there and every shard's crc32 matches; None otherwise."""
    manifests = []
    try:
        names = os.listdir(step_dir)
    except OSError:
        return None
    for name in names:
        if name.startswith("manifest_") and name.endswith(".json"):
            try:
                with open(os.path.join(step_dir, name),
                          encoding="utf-8") as f:
                    manifests.append(json.load(f))
            except (OSError, json.JSONDecodeError):
                return None
    if not manifests:
        return None
    n_shards = manifests[0].get("n_shards")
    if len(manifests) != n_shards:
        return None
    merged = {"parts": sorted(manifests, key=lambda m: m.get("shard", 0)),
              "step": manifests[0].get("step"),
              "version": manifests[0].get("version")}
    if merged["version"] is None or merged["version"] > _MANIFEST_VERSION:
        return None
    for part in merged["parts"]:
        fpath = os.path.join(step_dir, part.get("file", ""))
        if not os.path.isfile(fpath):
            return None
        try:
            if _crc32_file(fpath) != part.get("file_crc32"):
                return None
        except OSError:
            return None
    return merged


def _find_latest_valid(directory: str):
    """The newest valid step directory and its merged manifest."""
    for _, step_dir in reversed(list_checkpoints(directory)):
        manifest = _validate_step_dir(step_dir)
        if manifest is not None:
            return step_dir, manifest
    return None, None


def latest_checkpoint(directory: str) -> Optional[str]:
    """The newest VALID step directory under ``directory``, or None; an
    invalid newer step (a torn write, a missing manifest) falls back to
    the previous valid one."""
    return _find_latest_valid(directory)[0]


def load_checkpoint_dir(path: str, like, *, step: Optional[int] = None
                        ) -> Restored:
    """Restore a :class:`Restored` from a v2 checkpoint: ``path`` is the
    root (the newest valid step, or ``step``) or one ``step_*``
    directory.  Leaves are held to ``like``'s dtypes and shapes and put
    on its devices."""
    step_dir, manifest = path, None
    if not _STEP_DIR_RE.match(os.path.basename(os.path.normpath(path))):
        if step is not None:
            step_dir = os.path.join(path, _step_dir_name(step))
        else:
            step_dir, manifest = _find_latest_valid(path)
            if step_dir is None:
                raise CheckpointError(f"no valid checkpoint under {path!r}")
    if manifest is None:
        manifest = _validate_step_dir(step_dir)
    if manifest is None:
        raise CheckpointError(
            f"checkpoint {step_dir!r} is missing, incomplete, or fails its "
            f"checksums")
    return _load_validated(step_dir, manifest, like)


def _load_validated(step_dir: str, manifest: dict, like) -> Restored:
    """Load one step directory whose ``manifest`` was just returned by
    :func:`_validate_step_dir` (its checksums are not read again)."""
    arrays: dict = {}
    for part in manifest["parts"]:
        with np.load(os.path.join(step_dir, part["file"]),
                     allow_pickle=False) as data:
            for k in data.files:
                arrays[k] = data[k]
    plain, amp_state, extra_raw = _split_raw_arrays(arrays)
    part0 = manifest["parts"][0]
    state = _rebuild(plain, like, buckets=part0.get("buckets"),
                     context=f"checkpoint {os.path.basename(step_dir)}")
    extra = dict(part0.get("extra") or {})
    extra.update(_decode_extras(extra_raw))
    return Restored(state=state, amp_state=amp_state, extra=extra,
                    loader_state=part0.get("loader"),
                    step=int(manifest["step"]), run_id=part0.get("run_id"))


def open_for_training(directory: Optional[str], like, *,
                      every_steps: int, resume: bool,
                      log: Callable = print, unit: str = "step"):
    """The trainers' ``--checkpoint-dir``/``--checkpoint-every``/
    ``--resume``: a :class:`CheckpointManager` saving every
    ``every_steps`` under ``directory`` (None without a directory) and,
    under ``resume``, the newest valid checkpoint restored against
    ``like`` (None for a fresh start), logged with the trainer's name
    for a step (``unit``); the manager reserves its pinned buffer while
    the trainer warms up.  Returns ``(manager, restored)``."""
    if not directory:
        return None, None
    mgr = CheckpointManager(directory, every_steps=max(1, every_steps))
    restored = mgr.restore(like=like) if resume else None
    if restored is not None:
        log(f"resumed at {unit} {restored.step} (run {mgr.run_id}) from "
            f"{directory}")
    mgr.reserve(like)
    return mgr, restored


class _Pending(NamedTuple):
    step: int
    snapshot: Optional[_Snapshot]   # None: a wait() fence
    arrays: dict                    # amp state and extras, host arrays
    manifest: dict
    done: threading.Event
    t_enqueue: float


class CheckpointManager:
    """Async checkpoint engine over a directory (see the module docstring).

    * :meth:`save` starts the device-to-host copies and returns; one
      writer thread waits for them, serializes, fsyncs and publishes
      (``.tmp`` then ``os.replace``, the manifest last).  ``block=True``
      (or ``async_write=False``) writes on the caller's thread, after
      everything queued before it.
    * ``keep`` newest valid checkpoints survive; older step directories
      go after each publish.
    * ``max_pending`` bounds the queued snapshots (host memory): a save
      beyond it waits for the writer.
    * A writer error is re-raised on the caller's thread at the next
      :meth:`save`, :meth:`wait` or :meth:`close`.
    * Each save's copies fill one pinned host buffer, which the manager
      keeps for the next save; :meth:`reserve` pins the first one in the
      background.

    ``stats`` holds the last save's numbers: ``bytes``, ``snapshot_s``
    (the caller's time to start the copies, a reservation still running
    included), ``d2h_s`` (the copies' device time; None without CUDA
    leaves) and ``write_s`` (wait, serialize, fsync and publish)."""

    def __init__(self, directory: str, *, keep: int = 3,
                 every_steps: Optional[int] = None,
                 async_write: bool = True,
                 procs: Optional[Tuple[int, int]] = None,
                 run_id: Optional[str] = None,
                 max_pending: int = 2, fsync: bool = True,
                 telemetry=None):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        if every_steps is not None and every_steps < 1:
            raise ValueError(f"every_steps must be >= 1, got {every_steps}")
        if procs is not None and tuple(procs) != (0, 1):
            raise NotImplementedError(
                f"procs={tuple(procs)}: per-process shards are not ported "
                f"yet ({_DATA_PARALLEL}); one process writes (0, 1)")
        if telemetry is not None:
            raise NotImplementedError(
                f"telemetry= is not ported yet ({_OBSERVABILITY})")
        self.directory = directory
        self.keep = int(keep)
        self.every_steps = every_steps
        self.async_write = bool(async_write)
        self.procs = (0, 1)
        self.run_id = run_id or uuid.uuid4().hex[:12]
        self.max_pending = max(1, int(max_pending))
        self.fsync = bool(fsync)
        self.stats: dict = {}
        self._last_saved: Optional[int] = None
        self._error: Optional[BaseException] = None
        self._q: "queue.Queue[Optional[_Pending]]" = queue.Queue()
        self._writer: Optional[threading.Thread] = None
        self._closed = False
        self._known_valid: set = set()
        self._reserving: Optional[threading.Thread] = None
        # one pinned snapshot buffer kept for the next save: the manager
        # owns it, so neither an emptied host cache (every CUDA graph
        # capture empties it) nor another size's request takes it
        self._spare: Optional[torch.Tensor] = None
        self._spare_lock = threading.Lock()
        os.makedirs(directory, exist_ok=True)

    def reserve(self, like) -> None:
        """Pin the host buffer a save of ``like`` takes, on a thread of its
        own, and keep it for the first save, which then pins nothing on
        the caller's thread.  A save waits for a reservation still
        running."""
        nbytes = _pinned_bytes(like)
        if nbytes and self._reserving is None:
            self._reserving = threading.Thread(
                target=lambda: self._keep_buffer(_pinned(nbytes)),
                daemon=True, name="apex-tpu-torch-ckpt-reserve")
            self._reserving.start()

    def _join_reservation(self) -> None:
        if self._reserving is not None:
            self._reserving.join()
            self._reserving = None

    def _take_buffer(self, nbytes: int) -> torch.Tensor:
        with self._spare_lock:
            buf, self._spare = self._spare, None
        return buf if buf is not None and buf.numel() == nbytes \
            else _pinned(nbytes)

    def _keep_buffer(self, buf: Optional[torch.Tensor]) -> None:
        if buf is not None:
            with self._spare_lock:
                self._spare = buf

    @property
    def last_saved(self) -> Optional[int]:
        return self._last_saved

    def maybe_save(self, step: int, state, **kw) -> bool:
        """Save iff ``every_steps`` is set and ``step`` is at least that
        far past the last save (a fresh run anchors at 0, so save steps
        stay on one grid across kill and resume).  Returns True when a
        save was made."""
        if self.every_steps is None:
            return False
        if step - (self._last_saved or 0) < self.every_steps:
            return False
        self.save(step, state, **kw)
        return True

    def save(self, step: int, state, *, amp_state: Optional[dict] = None,
             loader_state: Optional[dict] = None,
             bucket_layout: Optional[dict] = None,
             block: bool = False, **extra) -> None:
        """Checkpoint ``state`` at ``step``: the caller pays for starting
        the copies to the host; the writer thread does the rest
        (``block=True``: this thread).  ``extra`` round-trips as in
        :func:`save_checkpoint`."""
        self._raise_pending_error()
        if self._closed:
            raise CheckpointError("CheckpointManager is closed")
        t0 = time.perf_counter()
        self._join_reservation()
        snap = _snapshot(state, self._take_buffer)
        arrays = {}
        if amp_state:
            for k, v in _flatten_with_paths(amp_state).items():
                arrays["__amp__/" + k] = v
        for k, v in extra.items():
            ek, ev = _encode_extra(k, v)
            arrays["__extra__/" + ek] = ev
        snapshot_s = time.perf_counter() - t0
        manifest = {
            "format": "apex_tpu-ckpt-v2",
            "version": _MANIFEST_VERSION,
            "step": int(step),
            "shard": 0, "n_shards": 1,
            "file": _shard_file_name(0, 1),
            "run_id": self.run_id,
            "world": {"process_count": 1,
                      "device_count": max(1, torch.cuda.device_count())},
            "wall_time": time.time(),
            "loader": loader_state,
            "buckets": bucket_layout,
            "extra": {k: v for k, v in extra.items()
                      if isinstance(v, (str, bool, int, float, type(None)))},
        }
        pending = _Pending(int(step), snap, arrays, manifest,
                           threading.Event(), time.perf_counter())
        self.stats = {"step": int(step), "snapshot_s": snapshot_s}
        self._last_saved = int(step)
        if block or not self.async_write:
            self.wait()
            self._write_one(pending)
            self._raise_pending_error()
            return
        self._ensure_writer()
        while (self._q.qsize() >= self.max_pending and self._writer is not None
               and self._writer.is_alive()):
            time.sleep(0.005)
        self._q.put(pending)

    def _ensure_writer(self) -> None:
        if self._writer is None or not self._writer.is_alive():
            self._writer = threading.Thread(
                target=self._writer_loop, daemon=True,
                name="apex-tpu-torch-ckpt-writer")
            self._writer.start()

    def _writer_loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            if item.snapshot is None:
                item.done.set()        # a wait() fence
                continue
            try:
                self._write_one(item)
            except BaseException as e:  # surfaced on the caller's thread
                self._error = e
            finally:
                item.done.set()

    def _sync_file(self, f) -> None:
        if self.fsync:
            f.flush()
            os.fsync(f.fileno())

    def _write_one(self, pending: _Pending) -> None:
        t0 = time.perf_counter()
        arrays = _materialize(pending.snapshot)
        arrays.update(pending.arrays)
        timing = pending.snapshot.timing
        step_dir = os.path.join(self.directory, _step_dir_name(pending.step))
        os.makedirs(step_dir, exist_ok=True)
        manifest = dict(pending.manifest)
        manifest["leaves"] = {k: {"shape": list(v.shape),
                                  "dtype": v.dtype.name}
                              for k, v in arrays.items()}
        shard_path = os.path.join(step_dir, manifest["file"])
        tmp = shard_path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
            self._sync_file(f)
        os.replace(tmp, shard_path)
        manifest["file_bytes"] = os.path.getsize(shard_path)
        manifest["file_crc32"] = _crc32_file(shard_path)
        mpath = os.path.join(step_dir, _manifest_file_name(0, 1))
        mtmp = mpath + ".tmp"
        with open(mtmp, "w", encoding="utf-8") as f:
            json.dump(manifest, f, indent=1)
            self._sync_file(f)
        os.replace(mtmp, mpath)        # the commit point
        self._known_valid.add(step_dir)
        self._prune()
        if self.stats.get("step") == pending.step:
            self.stats.update(
                bytes=int(sum(a.nbytes for a in arrays.values())),
                d2h_s=(timing[0].elapsed_time(timing[1]) / 1e3
                       if timing is not None else None),
                write_s=time.perf_counter() - t0)
        del arrays                     # views of the buffer
        self._keep_buffer(pending.snapshot.buffer)
        pending.done.set()

    def _prune(self) -> None:
        """Keep the ``keep`` newest valid checkpoints; drop older step
        directories (never a newer one, which may still be committing)."""
        entries = list_checkpoints(self.directory)
        valid = []
        for s, sd in entries:
            if sd in self._known_valid or _validate_step_dir(sd) is not None:
                self._known_valid.add(sd)
                valid.append((s, sd))
        if not valid:
            return
        survivors = valid[-self.keep:]
        oldest_kept = survivors[0][0]
        keep_dirs = {sd for _, sd in survivors}
        for s, step_dir in entries:
            if step_dir in keep_dirs or s >= oldest_kept:
                continue
            shutil.rmtree(step_dir, ignore_errors=True)
            self._known_valid.discard(step_dir)

    def latest_step(self) -> Optional[int]:
        found = latest_checkpoint(self.directory)
        if found is None:
            return None
        return int(_STEP_DIR_RE.match(os.path.basename(found)).group(1))

    def restore(self, like, *, step: Optional[int] = None,
                required: bool = False) -> Optional[Restored]:
        """Restore the newest valid checkpoint (or ``step``) against the
        template ``like``; None when there is none (a fresh start) unless
        ``required``.  The run id becomes the saved run's."""
        self.wait()
        try:
            restored = load_checkpoint_dir(self.directory, like, step=step)
        except CheckpointError:
            if required:
                raise
            return None
        self._last_saved = restored.step
        if restored.run_id:
            self.run_id = restored.run_id
        return restored

    def _raise_pending_error(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise CheckpointError(
                f"checkpoint writer failed: {type(err).__name__}: {err}"
            ) from err

    @property
    def pending(self) -> int:
        """Writes enqueued and not yet published."""
        return self._q.qsize()

    #: seconds :meth:`wait` and :meth:`close` give the writer before
    #: declaring the storage hung
    drain_timeout_s: float = 300.0

    def wait(self) -> None:
        """Block until every enqueued write has published; re-raises a
        writer failure here, and raises when the writer makes no
        progress within ``drain_timeout_s``."""
        if self._writer is not None and self._writer.is_alive():
            fence = threading.Event()
            self._q.put(_Pending(-1, None, {}, {}, fence,
                                 time.perf_counter()))
            if not fence.wait(timeout=self.drain_timeout_s):
                raise CheckpointError(
                    f"checkpoint writer did not drain within "
                    f"{self.drain_timeout_s:.0f}s — storage is hung; "
                    f"pending checkpoints are NOT published")
        self._raise_pending_error()

    def close(self) -> None:
        """Drain pending writes and stop the writer (idempotent);
        re-raises a writer failure."""
        if self._closed:
            return
        self._closed = True
        self._join_reservation()
        if self._writer is not None and self._writer.is_alive():
            self._q.put(None)
            self._writer.join(timeout=self.drain_timeout_s)
            if self._writer.is_alive():
                raise CheckpointError(
                    f"checkpoint writer still running after "
                    f"{self.drain_timeout_s:.0f}s at close — storage is "
                    f"hung; pending checkpoints are NOT published")
        self._spare = None
        self._raise_pending_error()

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
