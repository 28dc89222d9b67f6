"""Loss scaling, static and dynamic, as functional state on the device,
with the imperative API of the reference beside it.

Counterpart of ``apex_tpu/amp/loss_scaler.py`` (reference
``apex/amp/scaler.py``): dynamic scaling starts at 2**16 (capped by
``max_loss_scale``), doubles after ``scale_window`` clean steps, halves
on overflow (floored at ``min_loss_scale``).  The state is three tensors
on the device, ``unscale`` raises the overflow flag as a device bool, and
``update_scale`` is a chain of ``torch.where`` selects: no step reads a
value back to the host.  ``store=`` (a
:class:`~apex_tpu_torch.multi_tensor.BucketStore`) runs the unscale and
its overflow check over flat buckets.

**Imperative API** (``amp.scale_loss`` and the fused optimizer classes):
every method that takes ``state`` also runs without it on the scaler's
own state (made on the device of the first tensor it sees), and then
keeps the result.  ``unscale_with_stashed`` is the fp32 axpby of
gradient accumulation, ``update_scale_deferred`` runs the state machine
and hands back the overflow flag as a device bool for the optimizer to
fold into its update (no host read), ``update_scale_sync`` reads it (one
read), ``loss_scale()`` reads the scale, and ``state_dict`` is the
reference's ``{"loss_scale", "unskipped"}``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

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
        self._state: Optional[LossScalerState] = None

    def _live(self, device) -> LossScalerState:
        """The scaler's own state, on ``device`` (made there at first
        use, moved there after a ``load_state_dict``)."""
        device = torch.device("cpu") if device is None else device
        if self._state is None:
            self._state = self.init(device)
        elif self._state.loss_scale.device != torch.device(device):
            self._state = LossScalerState(
                *(x.to(device) for x in self._state))
        return self._state

    def init(self, device=None) -> LossScalerState:
        return LossScalerState(
            loss_scale=torch.tensor(self._initial_scale,
                                    dtype=torch.float32, device=device),
            unskipped=torch.tensor(0, dtype=torch.int32, device=device),
            overflow=torch.tensor(False, device=device))

    def scale_loss(self, loss, state: Optional[LossScalerState] = None):
        if not self.dynamic and self._initial_scale == 1.0:
            return loss
        if state is None:
            state = self._live(loss.device)
        return loss.float() * state.loss_scale

    def _resolve(self, state, tree):
        """``(state, explicit)``: the given state, or the scaler's own on
        the device of ``tree``'s first tensor."""
        if state is not None:
            return state, True
        leaves = (tree.data if isinstance(tree, mta.Packed)
                  else mta.flatten_tree(tree)[0])
        return self._live(leaves[0].device if leaves else None), False

    def _finish(self, overflow, state, explicit):
        if self.dynamic:
            state = state._replace(
                overflow=torch.logical_or(state.overflow, overflow))
        if not explicit:
            self._state = state
        return state

    def unscale(self, grads, state: Optional[LossScalerState] = None, *,
                scale=None, store=None):
        """Divide grads by the scale (``scale``, default the state's), in
        fp32; a dynamic scaler records non-finite results in the returned
        state's ``overflow``.  A static scale of 1.0 leaves fp32 grads as
        they are (dividing by one is the identity).  ``store`` runs the
        sweep and the check per bucket; a ``Packed`` ``grads`` stays
        packed.  Without ``state``, the scaler's own is read and kept."""
        state, explicit = self._resolve(state, grads)
        leaves = (grads.data if isinstance(grads, mta.Packed)
                  else mta.flatten_tree(grads)[0])
        if (scale is None and not self.dynamic
                and self._initial_scale == 1.0
                and all(g.dtype == torch.float32 for g in leaves)):
            return grads, state
        s = state.loss_scale if scale is None else scale
        out, overflow = mta.multi_tensor_scale(
            grads, 1.0 / s, out_dtype=torch.float32, store=store)
        return out, self._finish(overflow, state, explicit)

    def unscale_with_stashed(self, new_grads, stashed_grads,
                             state: Optional[LossScalerState] = None, *,
                             scale=None, store=None):
        """Gradient accumulation: ``new / scale + stashed`` in fp32 (one
        axpby over the leaves, or the buckets with ``store``),
        overflow-checked (reference ``scaler.py:152-189``)."""
        state, explicit = self._resolve(state, new_grads)
        s = state.loss_scale if scale is None else scale
        out, overflow = mta.multi_tensor_axpby(
            new_grads, stashed_grads, 1.0 / s, 1.0,
            out_dtype=torch.float32, store=store)
        return out, self._finish(overflow, state, explicit)

    def clear_overflow_state(self, state: Optional[LossScalerState] = None):
        explicit = state is not None
        if state is None:
            if self._state is None:
                return None
            state = self._state
        state = state._replace(overflow=torch.zeros_like(state.overflow))
        if not explicit:
            self._state = state
        return state

    def update_scale(self, state: Optional[LossScalerState] = None
                     ) -> LossScalerState:
        """The scale state machine: on overflow scale / factor (floored)
        and the window restarts; after ``scale_window`` clean steps scale
        * factor (capped); the overflow flag is reset.  Without
        ``state``, the scaler's own is advanced."""
        if state is None:
            if self._state is None:
                return None
            self._state = self._advance(self._state)
            return self._state
        return self._advance(state)

    def _advance(self, state: LossScalerState) -> LossScalerState:
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

    # -- imperative / checkpoint API (reference parity) ----------------------
    def loss_scale(self) -> float:
        """The current scale as a Python float (one host read)."""
        if self._state is None:
            return float(self._initial_scale)
        return float(self._state.loss_scale)

    def update_scale_sync(self) -> bool:
        """Advance the scaler's own state and return whether the step must
        be skipped: one host read of the overflow flag (reference
        ``scaler.py:199-200``)."""
        if self._state is None:
            return False
        should_skip = self.dynamic and bool(self._state.overflow)
        self.update_scale()
        return should_skip

    def update_scale_deferred(self) -> Optional[torch.Tensor]:
        """Advance the scaler's own state as :meth:`update_scale_sync`
        does, but hand back the overflow flag it had as a device bool
        (None for a static scaler, which never skips): the optimizer
        folds it into its update's skip mask, so nothing is read."""
        if self._state is None:
            return None
        flag = self._state.overflow if self.dynamic else None
        self.update_scale()
        return flag

    @property
    def state(self) -> Optional[LossScalerState]:
        return self._state

    @state.setter
    def state(self, s: LossScalerState):
        self._state = s

    def state_dict(self) -> dict:
        """``{"loss_scale": float, "unskipped": int}``, the reference's
        and the JAX package's format (``frontend.py:361-370``)."""
        if self._state is None:
            return {"loss_scale": float(self._initial_scale),
                    "unskipped": 0}
        return {"loss_scale": float(self._state.loss_scale),
                "unskipped": int(self._state.unskipped)}

    def load_state_dict(self, sd: dict) -> None:
        device = (None if self._state is None
                  else self._state.loss_scale.device)
        self._state = LossScalerState(
            loss_scale=torch.tensor(float(sd["loss_scale"]),
                                    dtype=torch.float32, device=device),
            unskipped=torch.tensor(int(sd["unskipped"]), dtype=torch.int32,
                                   device=device),
            overflow=torch.tensor(False, device=device))
