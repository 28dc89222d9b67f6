"""FusedAdam — counterpart of ``apex_tpu/optimizers/fused_adam.py``
(reference ``apex/optimizers/fused_adam.py:5-134``): Adam, or AdamW
(``adam_w_mode``, the default), through
:func:`~apex_tpu_torch.optimizers.functional.adam_update`; no AMSGrad."""

from __future__ import annotations

from . import functional as F
from .base import FusedOptimizer


class FusedAdam(FusedOptimizer):
    def __init__(self, params, lr=1e-3, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-8, adam_w_mode=True,
                 weight_decay=0.0, amsgrad=False, set_grad_none=True,
                 bucketed=False):
        del set_grad_none             # zero_grad(set_to_none=) decides
        if amsgrad:
            raise RuntimeError("FusedAdam does not support the AMSGrad "
                               "variant (reference parity).")
        defaults = dict(lr=lr, bias_correction=bias_correction, betas=betas,
                        eps=eps, weight_decay=weight_decay,
                        adam_w_mode=adam_w_mode)
        super().__init__(params, defaults, bucketed=bucketed)

    def _init_state(self, params, group):
        return F.adam_init(params, store=group["_store"])

    def _update(self, grads, state, params, *, group, lr, grad_scale,
                apply_mask):
        d = group
        return F.adam_update(
            grads, state, params, lr=lr, beta1=d["betas"][0],
            beta2=d["betas"][1], eps=d["eps"],
            weight_decay=d["weight_decay"], adam_w_mode=d["adam_w_mode"],
            bias_correction=d["bias_correction"], grad_scale=grad_scale,
            apply_mask=apply_mask, store=d["_store"])
