"""Weight hot-swap: a watcher on a :class:`~apex_tpu_torch.checkpoint.
CheckpointManager` directory — counterpart of
``apex_tpu/serving/hotswap.py``.

A training job publishes ``step_*/`` directories (the shard, then the
manifest that commits it); the serving side adopts each new one without
failing a request in flight.  Two halves, of different cost:

* **staging** (slow, off the serving loop): :meth:`WeightWatcher.
  poll_once` finds the newest VALID step newer than the adopted one, by
  the rules of :func:`~apex_tpu_torch.checkpoint.latest_checkpoint` (a
  mid-write ``.tmp``, a truncated or corrupted shard, a missing manifest
  are never adopted) and loads it against the serving template, so the
  staged tensors already sit on the template's device; ``extract`` maps the
  :class:`~apex_tpu_torch.checkpoint.Restored` to the model's weights
  (for a trainer's ``TrainState``,
  :func:`apex_tpu_torch.convert.gpt_params_from_train_state`);
* **swap** (on the serving loop): :meth:`WeightWatcher.take` hands the
  staged weights over between scheduler steps
  (:meth:`~apex_tpu_torch.serving.engine.ServingEngine.step`), so no
  request sees a half-updated model.

A step that is newer than the adopted one but invalid, or that fails to
load, is recorded in ``last_error`` and tried again at a later poll (an
invalid one once its files change); it never takes the serving loop
down.  ``telemetry=`` is not ported yet
(ROADMAP queue 1, "Observability and tuning"); it raises.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Optional, Tuple

from ..checkpoint import (_load_validated, _validate_step_dir,
                          list_checkpoints)

__all__ = ["WeightWatcher"]


def _files_of(step_dir: str):
    """The names, sizes and modification times of a step directory's
    files (None when it cannot be listed)."""
    try:
        return tuple(sorted((e.name, e.stat().st_size, e.stat().st_mtime_ns)
                            for e in os.scandir(step_dir)))
    except OSError:
        return None


class WeightWatcher:
    """Watch a checkpoint directory and stage new weights for a swap.

    ``like`` is the template tree the checkpoint is loaded against (its
    dtypes, shapes and devices); ``extract`` maps the
    :class:`~apex_tpu_torch.checkpoint.Restored` to the weights handed
    out (default ``r.state``: the checkpoint is the weights).
    :meth:`poll_once` checks synchronously, :meth:`start` runs a
    background poll every ``poll_every_s``; either way :meth:`take`
    returns a staged ``(step, weights)`` at most once a checkpoint.
    ``initial_step``: the step the served weights came from, when they
    came from this directory, so it is not staged again.  ``load_s``
    holds the last staging's seconds (validation, load and ``extract``)."""

    def __init__(self, directory: str, like, *,
                 extract: Optional[Callable] = None,
                 poll_every_s: float = 1.0,
                 initial_step: Optional[int] = None, telemetry=None):
        if telemetry is not None:
            raise NotImplementedError(
                'telemetry= is not ported yet (ROADMAP queue 1, '
                '"Observability and tuning")')
        self.directory = directory
        self._like = like
        self._extract = extract or (lambda restored: restored.state)
        self.poll_every_s = float(poll_every_s)
        self._lock = threading.Lock()
        self._staged: Optional[Tuple[int, Any]] = None
        #: the newest step staged or taken so far
        self.adopted_step: Optional[int] = initial_step
        self.initial_step = initial_step
        self.last_error: Optional[str] = None
        self.load_s: Optional[float] = None
        # step directory -> its files when it last failed validation: an
        # unchanged failed step is not read again
        self._invalid: dict = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def extract(self, restored) -> Any:
        """The weights of a restored checkpoint (``extract=``)."""
        return self._extract(restored)

    def _newer(self, step: int) -> bool:
        return self.adopted_step is None or step > self.adopted_step

    def poll_once(self) -> bool:
        """Check the directory once; stage the newest valid checkpoint
        when it is newer than anything adopted.  Returns True when
        something was staged.  Only steps newer than the adopted one are
        validated, each once, and a step that failed is validated again
        only when its files change: with nothing new a poll lists the
        directory and reads no shard."""
        t0 = time.perf_counter()
        found = manifest = None
        for i, (step, step_dir) in enumerate(
                reversed(list_checkpoints(self.directory))):
            if not self._newer(step):
                break
            files = _files_of(step_dir)
            if self._invalid.get(step_dir) != files:
                manifest = _validate_step_dir(step_dir)
                if manifest is not None:
                    found = (step, step_dir)
                    break
                self._invalid[step_dir] = files
            if i == 0:
                # a newer step that is not valid (yet): torn, corrupted or
                # still being written; retried at the next poll
                self.last_error = (f"step {step}: missing, incomplete or "
                                   f"failing its checksums")
        if found is None:
            return False
        step, step_dir = found
        try:
            weights = self.extract(
                _load_validated(step_dir, manifest, self._like))
        except Exception as e:
            self.last_error = f"step {step}: {type(e).__name__}: {e}"
            return False
        with self._lock:
            self._staged = (step, weights)
            self.adopted_step = step
        self._invalid.clear()
        self.load_s = time.perf_counter() - t0
        return True

    def take(self) -> Optional[Tuple[int, Any]]:
        """The staged ``(step, weights)``, at most once a checkpoint: the
        serving loop's swap point."""
        with self._lock:
            staged, self._staged = self._staged, None
        return staged

    def start(self) -> "WeightWatcher":
        """Start the background poll thread (idempotent)."""
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name="apex-tpu-torch-weight-watcher")
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception as e:
                self.last_error = f"{type(e).__name__}: {e}"
            self._stop.wait(self.poll_every_s)

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "WeightWatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
