"""The legacy ``OptimWrapper`` (reference ``apex/amp/opt.py:9-103``) —
counterpart of ``apex_tpu/amp/opt.py``: one dynamic scaler per loss,
the losses taken in turn, a step skipped when any of them overflowed.
It reads each loss's overflow flag on the host (one read a loss, as the
reference does); ``amp.initialize`` + ``amp.scale_loss`` reads none.
"""

from __future__ import annotations

import contextlib

from ._amp_state import maybe_print
from .loss_scaler import LossScaler


class OptimWrapper:
    def __init__(self, optimizer, amp_handle, num_loss):
        self._optimizer = optimizer
        self._amp_handle = amp_handle
        self._num_loss = num_loss
        self._loss_idx = 0
        self._skip_next = [False] * num_loss
        self._loss_scaler = [LossScaler("dynamic") for _ in range(num_loss)]

    @contextlib.contextmanager
    def scale_loss(self, loss):
        if not self._amp_handle.is_active():
            yield loss
            return
        scaler = self._loss_scaler[self._loss_idx]
        if hasattr(self._optimizer, "_prepare_amp_backward"):
            self._optimizer._prepare_amp_backward()
        yield scaler.scale_loss(loss)
        if hasattr(self._optimizer, "_post_amp_backward"):
            self._optimizer._post_amp_backward(scaler)
        self._skip_next[self._loss_idx] = scaler.update_scale_sync()
        self._loss_idx = (self._loss_idx + 1) % self._num_loss

    def step(self, closure=None):
        if not self._amp_handle.is_active():
            return self._optimizer.step(closure)
        if any(self._skip_next):
            maybe_print("Gradient overflow, skipping update")
            self._skip_next = [False] * self._num_loss
            if hasattr(self._optimizer, "_drop_master_grads"):
                self._optimizer._drop_master_grads()
            return None
        return self._optimizer.step(closure)

    def __getattr__(self, attr):
        return getattr(self._optimizer, attr)

    @property
    def loss_scale(self):
        if self._num_loss == 1:
            return self._loss_scaler[0].loss_scale()
        raise NotImplementedError("Current loss scale is ambiguous with "
                                  "multiple losses")
