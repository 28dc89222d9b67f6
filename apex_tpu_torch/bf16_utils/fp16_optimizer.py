"""``FP16_Optimizer``, the general legacy master-weight wrapper —
counterpart of ``apex_tpu/bf16_utils/fp16_optimizer.py`` (reference
``apex/fp16_utils/fp16_optimizer.py:13-643``).

It wraps a fused optimizer over the model's (bf16) parameters, gives it
fp32 masters, and runs the reference's flow: ``backward(loss)`` scales
the loss and backpropagates, ``update_master_grads()`` unscales the
model's gradients into fp32 master gradients (the overflow check: one
reduction and one read with a ``DynamicLossScaler``), ``step()`` skips
on overflow and updates the scale, else steps and copies the masters
into the model; ``clip_master_grads`` and ``state_dict`` as in the
reference.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils import _pytree as pytree

from ..multi_tensor import multi_tensor_scale
from .bf16util import clip_grad_norm
from .loss_scaler import DynamicLossScaler, LossScaler


class FP16_Optimizer:
    def __init__(self, init_optimizer, static_loss_scale: float = 1.0,
                 dynamic_loss_scale: bool = False,
                 dynamic_loss_args: Optional[dict] = None,
                 verbose: bool = True):
        self.optimizer = init_optimizer
        self.loss_scaler = (DynamicLossScaler(**(dynamic_loss_args or {}))
                            if dynamic_loss_scale
                            else LossScaler(static_loss_scale))
        self.overflow = False
        self.first_closure_call_this_step = True
        self.verbose = verbose
        init_optimizer._attach_masters()

    @property
    def loss_scale(self) -> float:
        return self.loss_scaler.loss_scale

    def backward(self, loss, update_master_grads: bool = True) -> None:
        """``(loss * scale).backward()`` (reference ``:462-524``)."""
        self.loss_scaler.backward(loss)
        if update_master_grads:
            self.update_master_grads()

    def update_master_grads(self) -> None:
        """The model's scaled ``.grad`` into fp32 master gradients,
        unscaled; sets ``overflow`` (reference ``:525-580``)."""
        opt = self.optimizer
        grads = [opt._model_grads(i) for i in range(len(opt.param_groups))]
        self.overflow = (isinstance(self.loss_scaler, DynamicLossScaler)
                         and self.loss_scaler.has_overflow(
                             pytree.tree_leaves(grads)))
        opt._master_grads = [
            multi_tensor_scale(g, 1.0 / self.loss_scaler.loss_scale,
                               out_dtype=torch.float32)[0] for g in grads]
        opt._clear_model_grads()

    def clip_master_grads(self, max_norm, norm_type=2.0) -> float:
        """Clip the fp32 master gradients by their global norm; the norm
        before clipping as a float (reference ``:424-446``)."""
        opt = self.optimizer
        if opt._master_grads is None:
            return 0.0
        opt._master_grads, total = clip_grad_norm(opt._master_grads,
                                                  max_norm, norm_type)
        return float(total)

    def step(self, closure=None):
        if closure is not None:
            closure()
        if self.overflow:
            if self.verbose:
                scaler = self.loss_scaler
                print("OVERFLOW! Skipping step. Reducing loss scale to "
                      f"{scaler.loss_scale / scaler.scale_factor}")
            self.loss_scaler.update_scale(True)
            self.optimizer._drop_master_grads()
            return None
        if isinstance(self.loss_scaler, DynamicLossScaler):
            self.loss_scaler.update_scale(False)
        return self.optimizer.step()

    def zero_grad(self, set_grads_to_None: bool = True) -> None:
        self.optimizer.zero_grad(set_to_none=set_grads_to_None)

    def state_dict(self) -> dict:
        dynamic = isinstance(self.loss_scaler, DynamicLossScaler)
        sd = {"loss_scaler_scale": self.loss_scaler.loss_scale,
              "dynamic": dynamic, "overflow": self.overflow,
              "first_closure_call_this_step":
                  self.first_closure_call_this_step,
              "optimizer_state_dict": self.optimizer.state_dict()}
        if dynamic:
            sd["cur_iter"] = self.loss_scaler.cur_iter
            sd["last_overflow_iter"] = self.loss_scaler.last_overflow_iter
        return sd

    def load_state_dict(self, sd: dict) -> None:
        self.loss_scaler.cur_scale = sd["loss_scaler_scale"]
        if sd["dynamic"] and isinstance(self.loss_scaler, DynamicLossScaler):
            self.loss_scaler.cur_iter = sd["cur_iter"]
            self.loss_scaler.last_overflow_iter = sd["last_overflow_iter"]
        self.overflow = sd["overflow"]
        self.first_closure_call_this_step = sd["first_closure_call_this_step"]
        self.optimizer.load_state_dict(sd["optimizer_state_dict"])

    @property
    def state(self):
        return self.optimizer._fstate

    @property
    def param_groups(self):
        return self.optimizer.param_groups
