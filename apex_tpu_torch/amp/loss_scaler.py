"""Loss scaling, static and dynamic, as functional state on the device.

Counterpart of the functional core of ``apex_tpu/amp/loss_scaler.py:40-228``
(reference ``apex/amp/scaler.py``): dynamic scaling starts at 2**16
(capped by ``max_loss_scale``), doubles after ``scale_window`` clean
steps, halves on overflow (floored at ``min_loss_scale``).  The state is
three tensors on the device, ``unscale`` raises the overflow flag as a
device bool, and ``update_scale`` is a chain of ``torch.where`` selects:
no step reads a value back to the host.  ``store=`` (a
:class:`~apex_tpu_torch.multi_tensor.BucketStore`) runs the unscale and
its overflow check over flat buckets.  The imperative API waits.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import multi_tensor as mta


class LossScalerState(NamedTuple):
    """State of one loss scaler, all 0-dim tensors on the device."""
    loss_scale: torch.Tensor     # fp32
    unskipped: torch.Tensor      # int32: clean steps since the last change
    overflow: torch.Tensor       # bool: overflow seen this step


def all_finite(tree, store=None) -> torch.Tensor:
    """Device-side AND of ``isfinite`` over a gradient tree; with
    ``store`` (or a ``Packed`` tree), one reduction a bucket."""
    return mta.tree_finite(tree, store=store)


class LossScaler:
    """Static or dynamic loss scaler::

        scaler = LossScaler("dynamic")
        state = scaler.init(device)
        loss = scaler.scale_loss(loss, state)
        grads, state = scaler.unscale(grads, state)   # sets state.overflow
        state = scaler.update_scale(state)            # new scale, flag reset
    """

    def __init__(self, loss_scale, init_scale=2.**16, scale_factor=2.,
                 scale_window=2000, min_loss_scale=None,
                 max_loss_scale=2.**24):
        if loss_scale == "dynamic":
            self.dynamic = True
            self._initial_scale = min(max_loss_scale, init_scale)
        else:
            self.dynamic = False
            self._initial_scale = float(loss_scale)
        self._scale_factor = scale_factor
        self._scale_window = scale_window
        self._min_loss_scale = min_loss_scale
        self._max_loss_scale = max_loss_scale

    def init(self, device=None) -> LossScalerState:
        return LossScalerState(
            loss_scale=torch.tensor(self._initial_scale,
                                    dtype=torch.float32, device=device),
            unskipped=torch.tensor(0, dtype=torch.int32, device=device),
            overflow=torch.tensor(False, device=device))

    def scale_loss(self, loss, state: LossScalerState):
        if not self.dynamic and self._initial_scale == 1.0:
            return loss
        return loss.float() * state.loss_scale

    def unscale(self, grads, state: LossScalerState, *, store=None):
        """Divide grads by the scale, in fp32; a dynamic scaler records
        non-finite results in the returned state's ``overflow``.  A static
        scale of 1.0 leaves fp32 grads as they are (dividing by one is
        the identity).  ``store`` runs the sweep and the check per
        bucket; a ``Packed`` ``grads`` stays packed."""
        leaves = (grads.data if isinstance(grads, mta.Packed)
                  else mta.flatten_tree(grads)[0])
        if not self.dynamic and self._initial_scale == 1.0 and all(
                g.dtype == torch.float32 for g in leaves):
            return grads, state
        out, overflow = mta.multi_tensor_scale(
            grads, 1.0 / state.loss_scale, out_dtype=torch.float32,
            store=store)
        if self.dynamic:
            state = state._replace(
                overflow=torch.logical_or(state.overflow, overflow))
        return out, state

    def update_scale(self, state: LossScalerState) -> LossScalerState:
        """The scale state machine: on overflow scale / factor (floored)
        and the window restarts; after ``scale_window`` clean steps scale
        * factor (capped); the overflow flag is reset."""
        cleared = torch.zeros_like(state.overflow)
        if not self.dynamic:
            return state._replace(overflow=cleared)
        shrunk = state.loss_scale / self._scale_factor
        if self._min_loss_scale is not None:
            shrunk = torch.clamp(shrunk, min=self._min_loss_scale)
        window_full = (state.unskipped + 1) >= self._scale_window
        grown = torch.clamp(state.loss_scale * self._scale_factor,
                            max=self._max_loss_scale)
        new_scale = torch.where(
            state.overflow, shrunk,
            torch.where(window_full, grown, state.loss_scale))
        new_unskipped = torch.where(
            torch.logical_or(state.overflow, window_full),
            torch.zeros_like(state.unskipped), state.unskipped + 1)
        return LossScalerState(loss_scale=new_scale.float(),
                               unskipped=new_unskipped.to(torch.int32),
                               overflow=cleared)
