"""The legacy loss scalers — counterpart of
``apex_tpu/bf16_utils/loss_scaler.py`` (reference
``apex/fp16_utils/loss_scaler.py``): ``LossScaler`` a static scale whose
overflow check is a no-op; ``DynamicLossScaler`` starts at 2**32, halves
on overflow (floored at 1), doubles every ``scale_window`` clean
iterations.  The scale lives on the host, as in the reference; the
overflow check is one device reduction over the whole tree and one read.
"""

from __future__ import annotations

from ..amp.loss_scaler import all_finite


class LossScaler:
    """Static loss scaler (reference ``loss_scaler.py:10-44``)."""

    def __init__(self, scale=1.0):
        self.cur_scale = float(scale)

    def has_overflow(self, params_or_grads) -> bool:
        return False

    def _has_inf_or_nan(self, x) -> bool:
        return False

    def update_scale(self, overflow: bool) -> None:
        pass

    @property
    def loss_scale(self) -> float:
        return self.cur_scale

    def scale_gradient(self, grads):
        return [g * self.cur_scale for g in grads]

    def backward(self, loss, retain_graph: bool = False) -> None:
        (loss.float() * self.loss_scale).backward(retain_graph=retain_graph)


class DynamicLossScaler(LossScaler):
    """Dynamic loss scaler (reference ``loss_scaler.py:46-131``)."""

    def __init__(self, init_scale=2.**32, scale_factor=2., scale_window=1000):
        super().__init__(init_scale)
        self.cur_iter = 0
        self.last_overflow_iter = -1
        self.scale_factor = scale_factor
        self.scale_window = scale_window

    def has_overflow(self, params_or_grads) -> bool:
        """One device reduction over the tree, one read."""
        return not bool(all_finite(params_or_grads))

    def _has_inf_or_nan(self, x) -> bool:
        return not bool(x.isfinite().all())

    def update_scale(self, overflow: bool) -> None:
        if overflow:
            self.cur_scale = max(self.cur_scale / self.scale_factor, 1.0)
            self.last_overflow_iter = self.cur_iter
        elif (self.cur_iter - self.last_overflow_iter) % \
                self.scale_window == 0:
            self.cur_scale *= self.scale_factor
        self.cur_iter += 1
