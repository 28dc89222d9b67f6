"""FusedNovoGrad — counterpart of ``apex_tpu/optimizers/
fused_novograd.py`` (reference ``apex/optimizers/fused_novograd.py:
4-210``): the second moment one scalar a tensor (an EMA of its gradient's
L2 or max norm), through :func:`~apex_tpu_torch.optimizers.functional.
novograd_update`."""

from __future__ import annotations

from . import functional as F
from .base import FusedOptimizer


class FusedNovoGrad(FusedOptimizer):
    def __init__(self, params, lr=1e-3, bias_correction=True,
                 betas=(0.95, 0.98), eps=1e-8, weight_decay=0.0,
                 amsgrad=False, reg_inside_moment=False, grad_averaging=True,
                 norm_type=2, init_zero=False, set_grad_none=True,
                 bucketed=False):
        del set_grad_none
        if amsgrad:
            raise RuntimeError("FusedNovoGrad does not support the AMSGrad "
                               "variant.")
        if norm_type not in (2, float("inf"), "inf"):
            raise RuntimeError("FusedNovoGrad only supports l2/inf norm")
        defaults = dict(lr=lr, bias_correction=bias_correction, betas=betas,
                        eps=eps, weight_decay=weight_decay,
                        grad_averaging=grad_averaging,
                        norm_type=2 if norm_type == 2 else 0,
                        init_zero=init_zero,
                        reg_inside_moment=reg_inside_moment)
        super().__init__(params, defaults, bucketed=bucketed)

    def _init_state(self, params, group):
        return F.novograd_init(params, store=group["_store"])

    def _update(self, grads, state, params, *, group, lr, grad_scale,
                apply_mask):
        d = group
        return F.novograd_update(
            grads, state, params, lr=lr, beta1=d["betas"][0],
            beta2=d["betas"][1], eps=d["eps"],
            weight_decay=d["weight_decay"],
            grad_averaging=d["grad_averaging"],
            norm_type=2 if d["norm_type"] == 2 else "inf",
            init_zero=d["init_zero"],
            adam_w_mode=not d["reg_inside_moment"],
            bias_correction=d["bias_correction"], grad_scale=grad_scale,
            apply_mask=apply_mask, store=d["_store"])
