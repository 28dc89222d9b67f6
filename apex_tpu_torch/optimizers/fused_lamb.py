"""FusedLAMB — counterpart of ``apex_tpu/optimizers/fused_lamb.py``
(reference ``apex/optimizers/fused_lamb.py:4-175``): the global gradient
norm over all of a group's gradients, then each tensor's trust ratio,
through :func:`~apex_tpu_torch.optimizers.functional.lamb_update`."""

from __future__ import annotations

from . import functional as F
from .base import FusedOptimizer


class FusedLAMB(FusedOptimizer):
    def __init__(self, params, lr=1e-3, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-6, weight_decay=0.01,
                 amsgrad=False, adam_w_mode=True, grad_averaging=True,
                 set_grad_none=True, max_grad_norm=1.0, use_nvlamb=False,
                 bucketed=False):
        del set_grad_none
        if amsgrad:
            raise RuntimeError("FusedLAMB does not support the AMSGrad "
                               "variant.")
        defaults = dict(lr=lr, bias_correction=bias_correction, betas=betas,
                        eps=eps, weight_decay=weight_decay,
                        adam_w_mode=adam_w_mode,
                        grad_averaging=grad_averaging,
                        max_grad_norm=max_grad_norm, use_nvlamb=use_nvlamb)
        super().__init__(params, defaults, bucketed=bucketed)

    def _init_state(self, params, group):
        return F.lamb_init(params, store=group["_store"])

    def _update(self, grads, state, params, *, group, lr, grad_scale,
                apply_mask):
        d = group
        return F.lamb_update(
            grads, state, params, lr=lr, beta1=d["betas"][0],
            beta2=d["betas"][1], eps=d["eps"],
            weight_decay=d["weight_decay"], adam_w_mode=d["adam_w_mode"],
            bias_correction=d["bias_correction"],
            grad_averaging=d["grad_averaging"],
            max_grad_norm=d["max_grad_norm"], use_nvlamb=d["use_nvlamb"],
            grad_scale=grad_scale, apply_mask=apply_mask,
            store=d["_store"])
