"""LARC, layerwise adaptive rate control — counterpart of
``apex_tpu/parallel/LARC.py`` (reference ``apex/parallel/LARC.py``).

Each parameter's gradient is rewritten with its adaptive rate
``trust_coefficient * |p| / (|g| + weight_decay * |p| + eps)`` (1 where
either norm is 0), clipped to ``min(rate / lr, 1)`` in clip mode, with
the weight decay absorbed into the rewritten gradient, before any base
optimizer takes it.  :func:`larc_gradients` is the pure rewrite;
:func:`larc_transform` wraps it as an ``(init, update)`` pair, the shape
of the optax gradient transformation the JAX package returns (the port
has no optax).  The :class:`LARC` class wraps a fused optimizer class:
it rewrites each group's gradients with the group's own lr and weight
decay, then steps the optimizer with the group weight decay set to 0
(absorbed into the rewrite) and restores it, as the reference does
(``apex_tpu/parallel/LARC.py:43-103``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..multi_tensor import flatten_tree

__all__ = ["GradientTransformation", "LARC", "larc_gradients",
           "larc_transform"]


def larc_gradients(grads, params, *, lr, trust_coefficient=0.02, clip=True,
                   eps=1e-8, weight_decay=0.0):
    """``grads`` rewritten with the LARC adaptive rate, leaf by leaf, in
    fp32 and stored in each gradient's dtype; the container of
    ``grads``.  The norms are one ``_foreach_norm`` each over the whole
    tree; nothing is read back to the host."""
    gs, rebuild = flatten_tree(grads)
    ps = flatten_tree(params)[0]
    if not gs:
        return rebuild([])
    gf = [g.float() for g in gs]
    pf = [p.float() for p in ps]
    g_norm = torch.stack(torch._foreach_norm(gf))
    p_norm = torch.stack(torch._foreach_norm(pf))
    rate = trust_coefficient * p_norm / (g_norm + p_norm * weight_decay
                                         + eps)
    rate = torch.where((p_norm != 0) & (g_norm != 0), rate,
                       torch.ones_like(rate))
    if clip:
        rate = torch.clamp(rate / lr, max=1.0)
    if weight_decay != 0.0:
        gf = torch._foreach_add(gf, torch._foreach_mul(pf, weight_decay))
    new = torch._foreach_mul(gf, list(rate.unbind()))
    return rebuild([n.to(g.dtype) for n, g in zip(new, gs)])


class LARC:
    """Optimizer wrapper (reference class): ``optimizer`` is a
    :class:`~apex_tpu_torch.optimizers.FusedOptimizer`, amp-wired or not;
    its gradients this step (the master gradients ``scale_loss``
    delivered, else the parameters' ``.grad``) are rewritten against
    what it updates (its fp32 masters, else the parameters)."""

    def __init__(self, optimizer, trust_coefficient=0.02, clip=True,
                 eps=1e-8):
        self.optim = optimizer
        self.trust_coefficient = trust_coefficient
        self.eps = eps
        self.clip = clip

    def __getattr__(self, name):
        return getattr(self.optim, name)

    @property
    def param_groups(self):
        return self.optim.param_groups

    def step(self, closure=None):
        from ..multi_tensor.buckets import Packed
        opt = self.optim
        new = []
        for gr, g in zip(opt._step_grads(), opt.param_groups):
            if isinstance(gr, Packed):
                gr = g["_store"].unpack(gr)
            params = (dict(zip(g["param_names"], g["params"]))
                      if "param_names" in g else list(g["params"]))
            new.append(larc_gradients(
                gr, params, lr=g["lr"],
                trust_coefficient=self.trust_coefficient, clip=self.clip,
                eps=self.eps, weight_decay=g.get("weight_decay", 0.0)))
        opt._master_grads = new
        saved = [g.get("weight_decay", 0.0) for g in opt.param_groups]
        saved_default = opt.defaults.get("weight_decay", 0.0)
        for g in opt.param_groups:
            g["weight_decay"] = 0.0
        opt.defaults["weight_decay"] = 0.0
        try:
            return opt.step(closure)
        finally:
            opt.defaults["weight_decay"] = saved_default
            for g, wd in zip(opt.param_groups, saved):
                g["weight_decay"] = wd

    def zero_grad(self, set_to_none: bool = True):
        self.optim.zero_grad(set_to_none)

    def state_dict(self):
        return self.optim.state_dict()

    def load_state_dict(self, sd):
        self.optim.load_state_dict(sd)


class GradientTransformation(NamedTuple):
    """``init(params) -> state`` and ``update(grads, state, params) ->
    (grads, state)``: optax's gradient-transformation pair."""
    init: Callable
    update: Callable


def larc_transform(lr, trust_coefficient=0.02, clip=True, eps=1e-8,
                   weight_decay=0.0) -> GradientTransformation:
    """LARC as a gradient transformation to chain before a base
    optimizer; ``lr`` a number or a schedule (read at step 0, as in
    JAX).  Its state is empty."""
    def init(params):
        del params
        return ()

    def update(grads, state, params=None):
        if params is None:
            raise ValueError("larc_transform requires params")
        lr_v = lr(0) if callable(lr) else lr
        return larc_gradients(grads, params, lr=lr_v,
                              trust_coefficient=trust_coefficient,
                              clip=clip, eps=eps,
                              weight_decay=weight_decay), state

    return GradientTransformation(init, update)
