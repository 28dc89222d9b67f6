"""Functional optimizer updates over parameter trees.

Counterpart of ``apex_tpu/optimizers/functional.py`` (reference
``csrc/multi_tensor_adam.cu``, ``multi_tensor_sgd_kernel.cu``,
``multi_tensor_lamb.cu``, ``multi_tensor_novograd.cu``): Adam, SGD, LAMB
and NovoGrad as ``(grads, state, params) -> (new_params, new_state)``,
pure (new tensors; nothing is updated in place), fp32 math whatever the
storage dtype, and an optional ``apply_mask`` (a device bool) that
implements loss-scale step skipping as a ``torch.where`` select instead
of host control flow.  The sweeps are ``torch._foreach_*`` ops in the
JAX expression's order, a few launches for the whole model.

**Bucketed mode.**  With ``store=BucketStore(params)`` each update runs
over the store's few flat buffers (``torch._foreach_*`` over the
buckets) instead of the leaves, and the state holds its moments as
:class:`~apex_tpu_torch.multi_tensor.buckets.Packed` buckets.
``params`` and ``grads`` may be trees (packed and unpacked inside the
update) or ``Packed`` values (kept packed).  Adam and SGD run the very
same elementwise ops on the buckets as on the leaves, so their fp32
bucketed trajectories equal the leafwise ones bit for bit; LAMB's and
NovoGrad's per-tensor norms come from the store's per-leaf reductions,
whose sums add in another order (within JAX's own tolerance for them).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from ..multi_tensor import flatten_tree, multi_tensor_l2norm
from ..multi_tensor.buckets import BucketStore, Packed


def _pack_args(store: BucketStore, grads, params):
    """``(fp32 grad buckets, param buckets, params arrived Packed)``."""
    was_packed = isinstance(params, Packed)
    p_in = params if was_packed else store.pack(params)
    g_in = (grads if isinstance(grads, Packed)
            else store.pack(grads, dtype=torch.float32))
    return g_in, p_in, was_packed


def _masked(mask, new, old):
    """new where mask (a 0-dim bool), old otherwise: the step-skip
    select."""
    if mask is None:
        return list(new)
    return [torch.where(mask, n, o.to(n.dtype)) for n, o in zip(new, old)]


def _count_step(step, mask):
    return step + (1 if mask is None else mask.to(step.dtype))


def _corrections(step, beta1, beta2, bias_correction):
    """``(1 - beta1^t, 1 - beta2^t)`` from the device-side step count, or
    None without bias correction."""
    if not bias_correction:
        return None
    t = step.float()
    return 1.0 - torch.pow(beta1, t), 1.0 - torch.pow(beta2, t)


def _plus_decay(xs, p32, weight_decay, decays):
    """``x + weight_decay * p`` for the decayed entries of ``xs``, the
    rest as they are (``decays``: one flag per entry)."""
    idx = [i for i, d in enumerate(decays) if d]
    if weight_decay == 0.0 or not idx:
        return list(xs)
    out = list(xs)
    added = torch._foreach_add([xs[i] for i in idx], torch._foreach_mul(
        [p32[i] for i in idx], weight_decay))
    for i, a in zip(idx, added):
        out[i] = a
    return out


def _step_lists(update_lists, grads, params, store, moments, *,
                apply_mask, **kw):
    """Run ``update_lists`` over the leaves of the trees, or over the
    store's buckets, and apply the skip mask: ``(new params in the
    caller's form, new moments in the state's form)``.  ``moments`` are
    the state's moment containers; ``update_lists(gs, ps, moment_lists,
    decays, **kw)`` (``decays`` one weight-decay flag an entry) returns
    ``(new_p, new_moment_lists)``."""
    if store is not None:
        g_in, p_in, was_packed = _pack_args(store, grads, params)
        ps, gs = list(p_in.data), list(g_in.data)
        mls = [list(m.data) for m in moments]
        new_p, new_ms = update_lists(gs, ps, mls, store.decay_flags, store,
                                     **kw)
        out = Packed(data=tuple(_masked(apply_mask, new_p, ps)),
                     rest=p_in.rest)
        new_ms = [Packed(tuple(_masked(apply_mask, n, o)), ())
                  for n, o in zip(new_ms, mls)]
        return (out if was_packed else store.unpack(out)), new_ms
    ps, rebuild = flatten_tree(params)
    gs = flatten_tree(grads)[0]
    mls, rebuilds = zip(*[flatten_tree(m) for m in moments]) \
        if moments else ((), ())
    new_p, new_ms = update_lists(gs, ps, [list(m) for m in mls],
                                 [True] * len(ps), None, **kw)
    new_ms = [rb(_masked(apply_mask, n, o))
              for n, o, rb in zip(new_ms, mls, rebuilds)]
    return rebuild(_masked(apply_mask, new_p, ps)), new_ms


def _per_leaf_(op_, bufs, vals, store):
    """``op_`` (an in-place foreach op) between every leaf of ``bufs`` and
    its own value: over the leaves ``vals`` holds one 0-dim tensor a
    leaf; with ``store`` one ``[n_leaves_in_bucket]`` vector a bucket,
    applied to the bucket's per-leaf views, so per-tensor scalars need no
    per-element index."""
    if store is None:
        op_(bufs, vals)
        return
    for b, buf, v in zip(store.buckets, bufs, vals):
        op_(list(torch.split(buf, b.sizes)), list(v.unbind()))


def _p32(ps):
    return [p.float() for p in ps]


def _g32(gs, grad_scale):
    return torch._foreach_div([x.float() for x in gs], grad_scale)


def _stored(new_p, ps):
    return [n.to(p.dtype) for n, p in zip(new_p, ps)]


# -- Adam ---------------------------------------------------------------------

class AdamState(NamedTuple):
    step: torch.Tensor     # int32, 0-dim, on the parameters' device
    exp_avg: Any           # fp32 tree shaped like the parameters, or Packed
    exp_avg_sq: Any


def _device_of(params, store):
    if store is not None:
        return store.device
    leaves = flatten_tree(params)[0]
    return leaves[0].device if leaves else None


def _zeros_tree(params):
    leaves, rebuild = flatten_tree(params)
    return rebuild([torch.zeros_like(p, dtype=torch.float32)
                    for p in leaves])


def _moments(params, store):
    return store.zeros() if store is not None else _zeros_tree(params)


def adam_init(params, *, store: Optional[BucketStore] = None) -> AdamState:
    return AdamState(
        step=torch.tensor(0, dtype=torch.int32,
                          device=_device_of(params, store)),
        exp_avg=_moments(params, store), exp_avg_sq=_moments(params, store))


def _adam_lists(gs, ps, mv, decays, store, *, lr, beta1, beta2, eps,
                weight_decay, adam_w_mode, bc, grad_scale):
    del store                       # elementwise: buckets are leaves
    ms, vs = mv
    p32 = _p32(ps)
    g = _g32(gs, grad_scale)
    if not adam_w_mode:
        g = _plus_decay(g, p32, weight_decay, decays)
    m_n = torch._foreach_add(torch._foreach_mul(ms, beta1),
                             torch._foreach_mul(g, 1.0 - beta1))
    v_n = torch._foreach_add(
        torch._foreach_mul(vs, beta2),
        torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - beta2))
    m_hat, v_hat = m_n, v_n
    if bc is not None:
        m_hat = torch._foreach_div(m_n, bc[0])
        v_hat = torch._foreach_div(v_n, bc[1])
    denom = torch._foreach_add(torch._foreach_sqrt(v_hat), eps)
    update = torch._foreach_div(m_hat, denom)
    if adam_w_mode:
        update = _plus_decay(update, p32, weight_decay, decays)
    new_p = torch._foreach_sub(p32, torch._foreach_mul(update, lr))
    return _stored(new_p, ps), [m_n, v_n]


def adam_update(grads, state: AdamState, params, *, lr, beta1=0.9,
                beta2=0.999, eps=1e-8, weight_decay=0.0, adam_w_mode=True,
                bias_correction=True, grad_scale=1.0,
                apply_mask: Optional[torch.Tensor] = None,
                store: Optional[BucketStore] = None):
    """Adam (``adam_w_mode=False``: L2 regularization added to the
    gradient) or AdamW (decoupled decay), with bias correction from the
    device-side step count.  Per element, in fp32::

        g = grad / grad_scale  (+ weight_decay * p without adam_w_mode)
        m = beta1 * m + (1 - beta1) * g
        v = beta2 * v + (1 - beta2) * g^2
        u = (m / bc1) / (sqrt(v / bc2) + eps)  (+ weight_decay * p)
        p = p - lr * u

    Returns ``(new_params, new_state)`` in the containers given;
    ``store`` runs it over the store's buckets (state from
    ``adam_init(params, store=store)``)."""
    step = _count_step(state.step, apply_mask)
    bc = _corrections(step, beta1, beta2, bias_correction)
    new_p, (m_n, v_n) = _step_lists(
        _adam_lists, grads, params, store,
        (state.exp_avg, state.exp_avg_sq), apply_mask=apply_mask, lr=lr,
        beta1=beta1, beta2=beta2, eps=eps, weight_decay=weight_decay,
        adam_w_mode=adam_w_mode, bc=bc, grad_scale=grad_scale)
    return new_p, AdamState(step=step, exp_avg=m_n, exp_avg_sq=v_n)


# -- SGD ----------------------------------------------------------------------

class SGDState(NamedTuple):
    momentum_buf: Any          # fp32 tree shaped like the parameters, or Packed
    initialized: torch.Tensor  # bool, 0-dim: a step has been applied


def sgd_init(params, momentum=0.0, *,
             store: Optional[BucketStore] = None) -> SGDState:
    del momentum                 # the buffer exists either way, as in JAX
    return SGDState(momentum_buf=_moments(params, store),
                    initialized=torch.tensor(
                        False, device=_device_of(params, store)))


def _sgd_lists(gs, ps, mls, decays, store, *, lr, momentum, dampening,
               nesterov, weight_decay, wd_after_momentum, first_run,
               grad_scale):
    del store                       # elementwise: buckets are leaves
    ms, = mls
    p32 = _p32(ps)
    g = _g32(gs, grad_scale)
    if not wd_after_momentum:
        g = _plus_decay(g, p32, weight_decay, decays)
    if momentum != 0.0:
        blended = torch._foreach_add(torch._foreach_mul(ms, momentum),
                                     torch._foreach_mul(g, 1.0 - dampening))
        m_n = [torch.where(first_run, a, b) for a, b in zip(g, blended)]
        d = (torch._foreach_add(g, torch._foreach_mul(m_n, momentum))
             if nesterov else m_n)
    else:
        m_n, d = ms, g
    if wd_after_momentum:
        d = _plus_decay(d, p32, weight_decay, decays)
    new_p = torch._foreach_sub(p32, torch._foreach_mul(d, lr))
    return _stored(new_p, ps), [m_n]


def sgd_update(grads, state: SGDState, params, *, lr, momentum=0.0,
               dampening=0.0, nesterov=False, weight_decay=0.0,
               wd_after_momentum=False, grad_scale=1.0,
               apply_mask: Optional[torch.Tensor] = None,
               store: Optional[BucketStore] = None):
    """SGD with momentum, dampening, nesterov and weight decay before or
    after the momentum (``wd_after_momentum``); the first applied step
    sets the momentum buffer to the gradient.  Per element, in fp32::

        g = grad / grad_scale  (+ weight_decay * p before the momentum)
        m = g on the first run, else momentum * m + (1 - dampening) * g
        d = g + momentum * m with nesterov, else m   (g without momentum)
        p = p - lr * (d  (+ weight_decay * p after the momentum))

    Returns ``(new_params, new_state)`` in the containers given;
    ``store`` runs it over the store's buckets."""
    new_p, (m_n,) = _step_lists(
        _sgd_lists, grads, params, store, (state.momentum_buf,),
        apply_mask=apply_mask, lr=lr, momentum=momentum,
        dampening=dampening, nesterov=nesterov, weight_decay=weight_decay,
        wd_after_momentum=wd_after_momentum,
        first_run=torch.logical_not(state.initialized),
        grad_scale=grad_scale)
    initialized = torch.logical_or(
        state.initialized,
        torch.ones_like(state.initialized) if apply_mask is None
        else apply_mask)
    return new_p, SGDState(momentum_buf=m_n, initialized=initialized)


# -- LAMB ---------------------------------------------------------------------

class LambState(NamedTuple):
    step: torch.Tensor
    exp_avg: Any
    exp_avg_sq: Any


def lamb_init(params, *, store: Optional[BucketStore] = None) -> LambState:
    return LambState(*adam_init(params, store=store))


def _trust_ratio(p_norm, u_norm, use_nvlamb):
    ok = u_norm > 0 if use_nvlamb else (p_norm > 0) & (u_norm > 0)
    return torch.where(ok, p_norm / u_norm, torch.ones_like(p_norm))


def _lamb_lists(gs, ps, mv, decays, store, *, lr, beta1, beta2, eps,
                weight_decay, bc, grad_averaging, max_grad_norm, use_nvlamb,
                grad_scale):
    ms, vs = mv
    beta3 = 1.0 - beta1 if grad_averaging else 1.0
    g = _g32(gs, grad_scale)
    # the global gradient norm for clipping: one l2norm over every grad
    gnorm = multi_tensor_l2norm(g)
    if max_grad_norm is not None and max_grad_norm > 0:
        g = torch._foreach_div(g, torch.where(
            gnorm > max_grad_norm, gnorm / max_grad_norm,
            torch.ones_like(gnorm)))
    p32 = _p32(ps)
    m_n = torch._foreach_add(torch._foreach_mul(ms, beta1),
                             torch._foreach_mul(g, beta3))
    v_n = torch._foreach_add(
        torch._foreach_mul(vs, beta2),
        torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - beta2))
    m_hat, v_hat = m_n, v_n
    if bc is not None:
        m_hat = torch._foreach_div(m_n, bc[0])
        v_hat = torch._foreach_div(v_n, bc[1])
    update = torch._foreach_div(
        m_hat, torch._foreach_add(torch._foreach_sqrt(v_hat), eps))
    update = _plus_decay(update, p32, weight_decay, decays)
    # each tensor's step scaled by lr times its trust ratio |p| / |update|
    if store is None:
        coef = list((lr * _trust_ratio(
            torch.stack(torch._foreach_norm(p32)),
            torch.stack(torch._foreach_norm(update)), use_nvlamb)).unbind())
    else:
        coef = [lr * _trust_ratio(p.sqrt(), u.sqrt(), use_nvlamb)
                for p, u in zip(store.per_leaf_sq_sums(p32),
                                store.per_leaf_sq_sums(update))]
    _per_leaf_(torch._foreach_mul_, update, coef, store)
    new_p = torch._foreach_sub(p32, update)
    return _stored(new_p, ps), [m_n, v_n]


def lamb_update(grads, state: LambState, params, *, lr, beta1=0.9,
                beta2=0.999, eps=1e-6, weight_decay=0.01, adam_w_mode=True,
                bias_correction=True, grad_averaging=True,
                max_grad_norm=1.0, use_nvlamb=False, grad_scale=1.0,
                apply_mask: Optional[torch.Tensor] = None,
                store: Optional[BucketStore] = None):
    """LAMB (reference ``csrc/multi_tensor_lamb.cu``): stage 1 clips by
    the global gradient norm (one l2norm over all grads), updates the
    moments and forms the Adam-style update with decay; stage 2 scales
    each tensor's step by its trust ratio ``|p| / |update|`` (applied
    even where ``|p|`` is 0 with ``use_nvlamb``).  Per element, in fp32::

        g = grad / grad_scale / clip
        m = beta1 * m + beta3 * g        (beta3 = 1 - beta1 with averaging)
        v = beta2 * v + (1 - beta2) * g^2
        u = (m / bc1) / (sqrt(v / bc2) + eps) + weight_decay * p
        p = p - (lr * ratio) * u

    ``adam_w_mode`` is accepted for the reference's signature; the decay
    is always decoupled, as in JAX.  ``store`` runs both stages over the
    store's buckets, the trust ratios from its per-leaf reductions."""
    del adam_w_mode
    step = _count_step(state.step, apply_mask)
    bc = _corrections(step, beta1, beta2, bias_correction)
    new_p, (m_n, v_n) = _step_lists(
        _lamb_lists, grads, params, store,
        (state.exp_avg, state.exp_avg_sq), apply_mask=apply_mask, lr=lr, beta1=beta1, beta2=beta2, eps=eps,
        weight_decay=weight_decay, bc=bc, grad_averaging=grad_averaging,
        max_grad_norm=max_grad_norm, use_nvlamb=use_nvlamb,
        grad_scale=grad_scale)
    return new_p, LambState(step=step, exp_avg=m_n, exp_avg_sq=v_n)


# -- NovoGrad -----------------------------------------------------------------

class NovoGradState(NamedTuple):
    step: torch.Tensor
    exp_avg: Any           # per-element first moment
    exp_avg_sq: Any        # per-TENSOR second moment (a norm, not squared)


def novograd_init(params, *,
                  store: Optional[BucketStore] = None) -> NovoGradState:
    device = _device_of(params, store)
    if store is not None:
        # one scalar a tensor: [n_leaves_in_bucket] vectors in a Packed
        scalars = Packed(data=tuple(
            torch.zeros((len(b.leaf_ids),), device=device)
            for b in store.buckets), rest=())
    else:
        leaves, rebuild = flatten_tree(params)
        scalars = rebuild([torch.zeros((), device=p.device)
                           for p in leaves])
    return NovoGradState(step=torch.tensor(0, dtype=torch.int32,
                                           device=device),
                         exp_avg=_moments(params, store),
                         exp_avg_sq=scalars)


def _novograd_lists(gs, ps, mv, decays, store, *, lr, beta1, beta2, eps,
                    weight_decay, grad_averaging, norm_type, init_zero,
                    adam_w_mode, bc, first, grad_scale):
    ms, vs = mv
    beta3 = 1.0 - beta1 if grad_averaging else 1.0
    g = _g32(gs, grad_scale)
    if store is None:
        g_norms = torch._foreach_norm(
            g, ord=2 if norm_type == 2 else float("inf"))
    elif norm_type == 2:
        g_norms = [s.sqrt() for s in store.per_leaf_sq_sums(g)]
    else:
        g_norms = list(store.per_leaf_max_abs(g))
    blended = torch._foreach_add(torch._foreach_mul(vs, beta2),
                                 torch._foreach_mul(g_norms, 1.0 - beta2))
    v_n = (blended if init_zero else
           [torch.where(first, n, b) for n, b in zip(g_norms, blended)])
    if bc is not None:
        denom = torch._foreach_add(
            torch._foreach_div(v_n, torch.sqrt(bc[1])), eps)
    else:
        denom = torch._foreach_add(v_n, eps)
    p32 = _p32(ps)
    _per_leaf_(torch._foreach_div_, g, denom, store)
    scaled_g = g
    if not adam_w_mode:
        scaled_g = _plus_decay(scaled_g, p32, weight_decay, decays)
    m_n = torch._foreach_add(torch._foreach_mul(ms, beta1),
                             torch._foreach_mul(scaled_g, beta3))
    update = torch._foreach_div(m_n, bc[0]) if bc is not None else m_n
    if adam_w_mode:
        update = _plus_decay(update, p32, weight_decay, decays)
    new_p = torch._foreach_sub(p32, torch._foreach_mul(update, lr))
    return _stored(new_p, ps), [m_n, v_n]


def novograd_update(grads, state: NovoGradState, params, *, lr,
                    beta1=0.95, beta2=0.98, eps=1e-8, weight_decay=0.0,
                    grad_averaging=True, norm_type=2, init_zero=False,
                    adam_w_mode=True, bias_correction=False, grad_scale=1.0,
                    apply_mask: Optional[torch.Tensor] = None,
                    store: Optional[BucketStore] = None):
    """NovoGrad (reference ``csrc/multi_tensor_novograd.cu``): the second
    moment is one scalar a tensor, an EMA of the tensor's gradient norm
    (L2, or max-abs with ``norm_type`` inf), set to the norm itself at
    the first step unless ``init_zero``.  Per element, in fp32::

        v = beta2 * v + (1 - beta2) * |g|     (|g| at the first step)
        s = g / (v / sqrt(bc2) + eps)         (v + eps without correction)
        m = beta1 * m + beta3 * (s  (+ weight_decay * p, L2 mode))
        p = p - lr * (m / bc1  (+ weight_decay * p, decoupled mode))

    ``store`` takes the norms from the store's per-leaf reductions and
    carries ``v`` as ``[n_leaves_in_bucket]`` vectors in a ``Packed``."""
    step = _count_step(state.step, apply_mask)
    bc = _corrections(step, beta1, beta2, bias_correction)
    new_p, (m_n, v_n) = _step_lists(
        _novograd_lists, grads, params, store,
        (state.exp_avg, state.exp_avg_sq), apply_mask=apply_mask, lr=lr, beta1=beta1, beta2=beta2, eps=eps,
        weight_decay=weight_decay, grad_averaging=grad_averaging,
        norm_type=norm_type, init_zero=init_zero, adam_w_mode=adam_w_mode,
        bc=bc, first=step == 1, grad_scale=grad_scale)
    return new_p, NovoGradState(step=step, exp_avg=m_n, exp_avg_sq=v_n)
