"""``amp.scale_loss``: the backward context of the imperative API —
counterpart of ``apex_tpu/amp/handle.py`` (reference
``apex/amp/handle.py:13-155``)::

    with amp.scale_loss(loss, optimizer) as scaled_loss:
        scaled_loss.backward()
    optimizer.step()

On entry each optimizer stashes the fp32 master gradients it already
holds (``_prepare_amp_backward``); the block's ``backward()`` leaves
scaled gradients in the model's ``.grad``.  On exit each optimizer moves
them into fp32 master gradients, unscaled, adding the stash in fp32
(``unscale_with_stashed``), and clears ``.grad``, so a second loss's
backward starts from nothing (``_post_amp_backward``).  Then the loss's
scaler runs its state machine on the device and hands its overflow flag
to the optimizers, which fold it into the next ``step()``'s update as a
skip mask: the step is skipped, and no host read is made.

``delay_unscale=True`` leaves the scaled gradients in ``.grad``, where
the next backward adds to them (accumulation in the model's dtype, as
in the reference); ``delay_overflow_check=True`` leaves the scale and
the flag as they are.
"""

from __future__ import annotations

import contextlib

from . import autocast
from ._amp_state import _amp_state
from .loss_scaler import LossScaler

#: re-exported for ``from apex_tpu_torch.amp import disable_casts``
disable_casts = autocast.disable_casts


@contextlib.contextmanager
def scale_loss(loss, optimizers, loss_id: int = 0, model=None,
               delay_unscale: bool = False,
               delay_overflow_check: bool = False):
    """Yield ``loss`` times the ``loss_id``-th scaler's scale (fp32), and
    run the unscale, the scale update and the skip hand-off on exit."""
    del model                       # the reference's signature
    if (_amp_state.opt_properties is None
            or not _amp_state.opt_properties.enabled):
        yield loss
        return
    opt_list = (list(optimizers) if isinstance(optimizers, (list, tuple))
                else [optimizers])
    loss_scaler = _amp_state.loss_scalers[loss_id]
    for opt in opt_list:
        if hasattr(opt, "_prepare_amp_backward"):
            opt._prepare_amp_backward()

    yield loss_scaler.scale_loss(loss)

    if delay_unscale:
        for opt in opt_list:
            if hasattr(opt, "_delay_amp_backward"):
                opt._delay_amp_backward()
        return
    for opt in opt_list:
        if hasattr(opt, "_post_amp_backward"):
            opt._post_amp_backward(loss_scaler)
    if not delay_overflow_check:
        flag = loss_scaler.update_scale_deferred()
        if flag is not None:
            for opt in opt_list:
                if hasattr(opt, "_note_pending_overflow"):
                    opt._note_pending_overflow(flag, loss_id)
    # the weight casts of this iteration are dropped (handle.py:153-155)
    autocast.clear_cast_cache()


class AmpHandle:
    """The legacy handle API (reference ``handle.py:167-270``)."""

    def __init__(self, loss_scale="dynamic", enable_caching=True,
                 verbose=False):
        del verbose                     # the reference's signature
        self._enable_caching = enable_caching
        self._loss_scaler = LossScaler(loss_scale)
        self._is_active = True

    def is_active(self):
        return self._is_active

    @contextlib.contextmanager
    def _disable_casts(self):
        with autocast.disable_casts():
            yield

    def wrap_optimizer(self, optimizer, num_loss=1):
        from .opt import OptimWrapper
        return OptimWrapper(optimizer, self, num_loss)

    @contextlib.contextmanager
    def scale_loss(self, loss, optimizer):
        if not self.is_active():
            yield loss
            return
        if hasattr(optimizer, "_prepare_amp_backward"):
            optimizer._prepare_amp_backward()
        yield self._loss_scaler.scale_loss(loss)
        if hasattr(optimizer, "_post_amp_backward"):
            optimizer._post_amp_backward(self._loss_scaler)
        flag = self._loss_scaler.update_scale_deferred()
        if flag is not None and hasattr(optimizer, "_note_pending_overflow"):
            optimizer._note_pending_overflow(flag, 0)
        if not self._enable_caching:
            autocast.clear_cast_cache()

    @property
    def loss_scale(self):
        return self._loss_scaler.loss_scale()

    def _clear_cache(self):
        autocast.clear_cast_cache()

    def _deactivate(self):
        self._is_active = False


class NoOpHandle:
    def is_active(self):
        return False

    @contextlib.contextmanager
    def _disable_casts(self):
        yield

    def wrap_optimizer(self, optimizer, num_loss=1):
        return optimizer

    @contextlib.contextmanager
    def scale_loss(self, loss, optimizer):
        yield loss

    @property
    def loss_scale(self):
        return 1.0

    def _deactivate(self):
        pass
