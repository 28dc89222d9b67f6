"""LARC, layerwise adaptive rate control — counterpart of
``apex_tpu/parallel/LARC.py`` (reference ``apex/parallel/LARC.py``).

Each parameter's gradient is rewritten with its adaptive rate
``trust_coefficient * |p| / (|g| + weight_decay * |p| + eps)`` (1 where
either norm is 0), clipped to ``min(rate / lr, 1)`` in clip mode, with
the weight decay absorbed into the rewritten gradient, before any base
optimizer takes it.  :func:`larc_gradients` is the pure rewrite;
:func:`larc_transform` wraps it as an ``(init, update)`` pair, the shape
of the optax gradient transformation the JAX package returns (the port
has no optax).  The ``LARC`` class, which wraps the fused optimizer
classes, waits for them.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..multi_tensor import flatten_tree

__all__ = ["GradientTransformation", "larc_gradients", "larc_transform"]


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
