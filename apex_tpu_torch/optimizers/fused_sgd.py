"""FusedSGD — counterpart of ``apex_tpu/optimizers/fused_sgd.py``
(reference ``apex/optimizers/fused_sgd.py:6-217``): momentum, dampening,
nesterov and weight decay before or after the momentum, through
:func:`~apex_tpu_torch.optimizers.functional.sgd_update`.

``materialize_master_grads=False`` (amp-wired with masters) keeps the
scaled model-dtype gradients as they came from the backward and divides
by the scale inside the update (``grad_scale``), so no fp32 master
gradient is made (reference ``:139-214``).  The scale stays a device
tensor (the scaler's at the backward), and the overflow check still
runs on the device; a pending overflow skips the step as in the base
class.  Accumulation over two losses still needs the fp32 sum, so a
stash takes the materialized path.
"""

from __future__ import annotations

from . import functional as F
from .base import FusedOptimizer


class FusedSGD(FusedOptimizer):
    def __init__(self, params, lr=1e-3, momentum=0.0, dampening=0.0,
                 weight_decay=0.0, nesterov=False,
                 wd_after_momentum=False, materialize_master_grads=True,
                 set_grad_none=False, bucketed=False):
        del set_grad_none
        if nesterov and (momentum <= 0 or dampening != 0):
            raise ValueError("Nesterov momentum requires a momentum and zero "
                             "dampening")
        defaults = dict(lr=lr, momentum=momentum, dampening=dampening,
                        weight_decay=weight_decay, nesterov=nesterov,
                        wd_after_momentum=wd_after_momentum)
        self.materialize_master_grads = materialize_master_grads
        #: the scale the kept gradients carry (a device tensor), or 1.0
        self.most_recent_scale = 1.0
        self.scale_set_by_backward = False
        super().__init__(params, defaults, bucketed=bucketed)

    def _init_state(self, params, group):
        return F.sgd_init(params, group["momentum"], store=group["_store"])

    def _update(self, grads, state, params, *, group, lr, grad_scale,
                apply_mask):
        d = group
        return F.sgd_update(
            grads, state, params, lr=lr, momentum=d["momentum"],
            dampening=d["dampening"], nesterov=d["nesterov"],
            weight_decay=d["weight_decay"],
            wd_after_momentum=d["wd_after_momentum"],
            grad_scale=grad_scale, apply_mask=apply_mask,
            store=d["_store"])

    def _fused_unscale(self) -> bool:
        return (not self.materialize_master_grads
                and any(m is not None for m in self._models))

    def _post_amp_backward(self, loss_scaler) -> None:
        if not self._fused_unscale() or self._stashed is not None:
            super()._post_amp_backward(loss_scaler)
            self.most_recent_scale = 1.0
            self.scale_set_by_backward = True
            return
        kept = []
        for i, g in enumerate(self.param_groups):
            grads, store = self._model_grads(i), g["_store"]
            if store is not None:
                grads = store.pack(grads)
            kept.append(grads)
        device = g["params"][0].device
        scale = loss_scaler._live(device).loss_scale.clone()
        for grads, g in zip(kept, self.param_groups):
            # the overflow check, on the device (the product is dropped)
            loss_scaler.unscale(grads, scale=scale, store=g["_store"])
        self._master_grads = kept
        self.most_recent_scale = scale
        self.scale_set_by_backward = True
        self._scaled_in_grad = False
        self._clear_model_grads()

    def _take_grad_scale(self):
        scale = self.most_recent_scale if self.scale_set_by_backward else 1.0
        self.most_recent_scale = 1.0
        self.scale_set_by_backward = False
        return scale
