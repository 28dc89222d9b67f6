"""The fused updates as ``(init, update)`` gradient transformations —
counterpart of ``apex_tpu/optimizers/transforms.py``, which returns
optax ``GradientTransformation``s (the port has no optax; the pair is
:class:`~apex_tpu_torch.parallel.LARC.GradientTransformation`)::

    tx = fused_adam(lr=1e-3, weight_decay=0.01)
    state = tx.init(params)
    updates, state = tx.update(grads, state, params)
    params = {k: p + updates[k] for k, p in params.items()}

``update`` returns ``new - old`` in fp32, stored in each parameter's
dtype (optax's protocol); ``lr`` is a number or a schedule of the
device-side step count.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..multi_tensor import flatten_tree
from ..parallel.LARC import GradientTransformation
from . import functional as F

__all__ = ["fused_adam", "fused_lamb", "fused_novograd", "fused_sgd"]


def _lr_at(lr, step):
    return lr(step) if callable(lr) else lr


def _delta(new_params, params):
    news, rebuild = flatten_tree(new_params)
    olds = flatten_tree(params)[0]
    return rebuild([(n.float() - p.float()).to(p.dtype)
                    for n, p in zip(news, olds)])


def _make(update_fn, init_fn, lr, kwargs) -> GradientTransformation:
    def update(grads, state, params=None):
        if params is None:
            raise ValueError("the fused transforms require params")
        new_params, new_state = update_fn(
            grads, state, params, lr=_lr_at(lr, state.step), **kwargs)
        return _delta(new_params, params), new_state
    return GradientTransformation(init_fn, update)


def fused_adam(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.0,
               adam_w_mode=True, bias_correction=True):
    return _make(F.adam_update, F.adam_init, lr,
                 dict(beta1=beta1, beta2=beta2, eps=eps,
                      weight_decay=weight_decay, adam_w_mode=adam_w_mode,
                      bias_correction=bias_correction))


def fused_lamb(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-6, weight_decay=0.01,
               adam_w_mode=True, bias_correction=True, grad_averaging=True,
               max_grad_norm=1.0, use_nvlamb=False):
    return _make(F.lamb_update, F.lamb_init, lr,
                 dict(beta1=beta1, beta2=beta2, eps=eps,
                      weight_decay=weight_decay, adam_w_mode=adam_w_mode,
                      bias_correction=bias_correction,
                      grad_averaging=grad_averaging,
                      max_grad_norm=max_grad_norm, use_nvlamb=use_nvlamb))


def fused_novograd(lr=1e-3, beta1=0.95, beta2=0.98, eps=1e-8,
                   weight_decay=0.0, grad_averaging=True, norm_type=2,
                   init_zero=False, adam_w_mode=True, bias_correction=False):
    return _make(F.novograd_update, F.novograd_init, lr,
                 dict(beta1=beta1, beta2=beta2, eps=eps,
                      weight_decay=weight_decay,
                      grad_averaging=grad_averaging, norm_type=norm_type,
                      init_zero=init_zero, adam_w_mode=adam_w_mode,
                      bias_correction=bias_correction))


class SGDWrapperState(NamedTuple):
    inner: F.SGDState
    step: torch.Tensor


def fused_sgd(lr=1e-3, momentum=0.0, dampening=0.0, weight_decay=0.0,
              nesterov=False, wd_after_momentum=False):
    def init(params):
        leaves = flatten_tree(params)[0]
        return SGDWrapperState(
            inner=F.sgd_init(params, momentum),
            step=torch.tensor(0, dtype=torch.int32,
                              device=leaves[0].device if leaves else None))

    def update(grads, state, params=None):
        if params is None:
            raise ValueError("the fused transforms require params")
        new_params, inner = F.sgd_update(
            grads, state.inner, params, lr=_lr_at(lr, state.step),
            momentum=momentum, dampening=dampening, nesterov=nesterov,
            weight_decay=weight_decay, wd_after_momentum=wd_after_momentum)
        return _delta(new_params, params), SGDWrapperState(
            inner=inner, step=state.step + 1)

    return GradientTransformation(init, update)
