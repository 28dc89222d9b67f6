"""Functional optimizer updates over parameter trees.

Counterpart of the leafwise Adam and SGD of ``apex_tpu/optimizers/
functional.py:86-284`` (reference ``csrc/multi_tensor_adam.cu``,
``multi_tensor_sgd_kernel.cu``): ``(grads, state,
params) -> (new_params, new_state)``, pure (new tensors; nothing is
updated in place), fp32 math whatever the storage dtype, and an optional
``apply_mask`` (a device bool) that implements loss-scale step skipping
as a ``torch.where`` select instead of host control flow.  The sweeps are
``torch._foreach_*`` ops in the JAX expression's order, a few launches
for the whole model.  The bucketed path (``store=``), LAMB and NovoGrad
wait; ``store=`` raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from ..multi_tensor import flatten_tree


class AdamState(NamedTuple):
    step: torch.Tensor     # int32, 0-dim, on the parameters' device
    exp_avg: Any           # fp32 tree shaped like the parameters
    exp_avg_sq: Any


def adam_init(params) -> AdamState:
    leaves, rebuild = flatten_tree(params)
    device = leaves[0].device if leaves else None

    def zeros():
        return rebuild([torch.zeros_like(p, dtype=torch.float32)
                        for p in leaves])
    return AdamState(step=torch.tensor(0, dtype=torch.int32, device=device),
                     exp_avg=zeros(), exp_avg_sq=zeros())


def _masked(mask, new, old):
    """new where mask (a 0-dim bool), old otherwise: the step-skip
    select."""
    if mask is None:
        return new
    return [torch.where(mask, n, o.to(n.dtype)) for n, o in zip(new, old)]


def adam_update(grads, state: AdamState, params, *, lr, beta1=0.9,
                beta2=0.999, eps=1e-8, weight_decay=0.0, adam_w_mode=True,
                bias_correction=True, grad_scale=1.0,
                apply_mask: Optional[torch.Tensor] = None):
    """Adam (``adam_w_mode=False``: L2 regularization added to the
    gradient) or AdamW (decoupled decay), with bias correction from the
    device-side step count.  Per element, in fp32::

        g = grad / grad_scale  (+ weight_decay * p without adam_w_mode)
        m = beta1 * m + (1 - beta1) * g
        v = beta2 * v + (1 - beta2) * g^2
        u = (m / bc1) / (sqrt(v / bc2) + eps)  (+ weight_decay * p)
        p = p - lr * u

    Returns ``(new_params, new_state)`` in the containers given."""
    ps, rebuild = flatten_tree(params)
    gs = flatten_tree(grads)[0]
    ms = flatten_tree(state.exp_avg)[0]
    vs = flatten_tree(state.exp_avg_sq)[0]
    step = state.step + (1 if apply_mask is None
                         else apply_mask.to(state.step.dtype))
    if bias_correction:
        t = step.float()
        bc1 = 1.0 - torch.pow(beta1, t)
        bc2 = 1.0 - torch.pow(beta2, t)
    p32 = [p.float() for p in ps]
    g = torch._foreach_div([x.float() for x in gs], grad_scale)
    if not adam_w_mode and weight_decay != 0.0:
        g = torch._foreach_add(g, torch._foreach_mul(p32, weight_decay))
    m_n = torch._foreach_add(torch._foreach_mul(ms, beta1),
                             torch._foreach_mul(g, 1.0 - beta1))
    v_n = torch._foreach_add(
        torch._foreach_mul(vs, beta2),
        torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - beta2))
    m_hat, v_hat = m_n, v_n
    if bias_correction:
        m_hat = torch._foreach_div(m_n, bc1)
        v_hat = torch._foreach_div(v_n, bc2)
    denom = torch._foreach_add(torch._foreach_sqrt(v_hat), eps)
    update = torch._foreach_div(m_hat, denom)
    if adam_w_mode and weight_decay != 0.0:
        update = torch._foreach_add(update,
                                    torch._foreach_mul(p32, weight_decay))
    new_p = torch._foreach_sub(p32, torch._foreach_mul(update, lr))
    new_p = [n.to(p.dtype) for n, p in zip(new_p, ps)]
    new_p = _masked(apply_mask, new_p, ps)
    m_n = _masked(apply_mask, m_n, ms)
    v_n = _masked(apply_mask, v_n, vs)
    _, rebuild_m = flatten_tree(state.exp_avg)
    _, rebuild_v = flatten_tree(state.exp_avg_sq)
    return rebuild(new_p), AdamState(step=step, exp_avg=rebuild_m(m_n),
                                     exp_avg_sq=rebuild_v(v_n))


class SGDState(NamedTuple):
    momentum_buf: Any          # fp32 tree shaped like the parameters
    initialized: torch.Tensor  # bool, 0-dim: a step has been applied


def sgd_init(params, momentum=0.0, *, store=None) -> SGDState:
    if store is not None:
        raise NotImplementedError("the bucketed SGD (store=) is not ported "
                                  "yet")
    leaves, rebuild = flatten_tree(params)
    device = leaves[0].device if leaves else None
    return SGDState(
        momentum_buf=rebuild([torch.zeros_like(p, dtype=torch.float32)
                              for p in leaves]),
        initialized=torch.tensor(False, device=device))


def sgd_update(grads, state: SGDState, params, *, lr, momentum=0.0,
               dampening=0.0, nesterov=False, weight_decay=0.0,
               wd_after_momentum=False, grad_scale=1.0,
               apply_mask: Optional[torch.Tensor] = None, store=None):
    """SGD with momentum, dampening, nesterov and weight decay before or
    after the momentum (``wd_after_momentum``); the first applied step
    sets the momentum buffer to the gradient.  Per element, in fp32::

        g = grad / grad_scale  (+ weight_decay * p before the momentum)
        m = g on the first run, else momentum * m + (1 - dampening) * g
        d = g + momentum * m with nesterov, else m   (g without momentum)
        p = p - lr * (d  (+ weight_decay * p after the momentum))

    Returns ``(new_params, new_state)`` in the containers given."""
    if store is not None:
        raise NotImplementedError("the bucketed SGD (store=) is not ported "
                                  "yet")
    ps, rebuild = flatten_tree(params)
    gs = flatten_tree(grads)[0]
    ms, rebuild_m = flatten_tree(state.momentum_buf)
    first_run = torch.logical_not(state.initialized)
    p32 = [p.float() for p in ps]
    g = torch._foreach_div([x.float() for x in gs], grad_scale)
    if weight_decay != 0.0 and not wd_after_momentum:
        g = torch._foreach_add(g, torch._foreach_mul(p32, weight_decay))
    if momentum != 0.0:
        blended = torch._foreach_add(torch._foreach_mul(ms, momentum),
                                     torch._foreach_mul(g, 1.0 - dampening))
        m_n = [torch.where(first_run, a, b) for a, b in zip(g, blended)]
        d = (torch._foreach_add(g, torch._foreach_mul(m_n, momentum))
             if nesterov else m_n)
    else:
        m_n, d = ms, g
    if weight_decay != 0.0 and wd_after_momentum:
        d = torch._foreach_add(d, torch._foreach_mul(p32, weight_decay))
    new_p = torch._foreach_sub(p32, torch._foreach_mul(d, lr))
    new_p = _masked(apply_mask, [n.to(p.dtype) for n, p in zip(new_p, ps)],
                    ps)
    m_n = _masked(apply_mask, m_n, ms)
    initialized = torch.logical_or(
        state.initialized,
        torch.ones_like(state.initialized) if apply_mask is None
        else apply_mask)
    return rebuild(new_p), SGDState(momentum_buf=rebuild_m(m_n),
                                    initialized=initialized)
