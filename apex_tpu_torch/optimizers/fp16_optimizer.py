"""``FP16_Optimizer``, the fused flavor (legacy) — counterpart of
``apex_tpu/optimizers/fp16_optimizer.py`` (reference
``apex/optimizers/fp16_optimizer.py:4-250``): it wraps a fused optimizer
over bf16 parameters with fp32 masters and an amp ``LossScaler``;
``backward(loss)`` scales and backpropagates, then unscales into the
master gradients; ``step()`` skips when a master gradient is not finite
or the scaler saw an overflow (one read), advancing a dynamic scale
either way, else steps and copies the masters into the model.
"""

from __future__ import annotations

import torch

from ..amp.loss_scaler import LossScaler, all_finite


class FP16_Optimizer:
    def __init__(self, init_optimizer, static_loss_scale=1.0,
                 dynamic_loss_scale=False, dynamic_loss_args=None,
                 verbose=True):
        self.optimizer = init_optimizer
        self.loss_scaler = (LossScaler("dynamic", **(dynamic_loss_args or {}))
                            if dynamic_loss_scale
                            else LossScaler(static_loss_scale))
        self.overflow = False
        self.first_closure_call_this_step = True
        self.verbose = verbose
        init_optimizer._attach_masters()

    def backward(self, loss, update_master_grads: bool = True) -> None:
        self.loss_scaler.scale_loss(loss.float()).backward()
        if update_master_grads:
            self.update_master_grads()

    def update_master_grads(self) -> None:
        self.optimizer._post_amp_backward(self.loss_scaler)

    def step(self, closure=None):
        if closure is not None:
            closure()
        opt = self.optimizer
        grads = opt._master_grads
        if grads is None:
            raise ValueError("step() before backward()/update_master_grads()")
        bad = torch.logical_not(torch.stack([all_finite(g) for g in grads])
                                .all())
        state = self.loss_scaler.state
        if state is not None:
            bad = torch.logical_or(bad, state.overflow.to(bad.device))
            self.loss_scaler.state = state._replace(overflow=bad)
            self.loss_scaler.update_scale()
        self.overflow = bool(bad)                 # the one read a step
        if self.overflow:
            if self.verbose:
                print("OVERFLOW! Skipping step. Reducing loss scale to "
                      f"{self.loss_scaler.loss_scale()}")
            opt._drop_master_grads()
            return None
        return opt.step()

    def clip_master_grads(self, max_norm, norm_type=2.0) -> float:
        from ..bf16_utils.bf16util import clip_grad_norm
        opt = self.optimizer
        if opt._master_grads is None:
            return 0.0
        opt._master_grads, total = clip_grad_norm(opt._master_grads,
                                                  max_norm, norm_type)
        return float(total)

    def zero_grad(self, set_grads_to_None: bool = False) -> None:
        self.optimizer.zero_grad(set_to_none=set_grads_to_None)

    def state_dict(self) -> dict:
        return {"loss_scaler": self.loss_scaler.state_dict(),
                "overflow": self.overflow,
                "optimizer_state_dict": self.optimizer.state_dict()}

    def load_state_dict(self, sd: dict) -> None:
        self.loss_scaler.load_state_dict(sd["loss_scaler"])
        self.overflow = sd["overflow"]
        self.optimizer.load_state_dict(sd["optimizer_state_dict"])

    @property
    def loss_scale(self) -> float:
        return self.loss_scaler.loss_scale()

    @property
    def state(self):
        return self.optimizer._fstate

    @property
    def param_groups(self):
        return self.optimizer.param_groups
