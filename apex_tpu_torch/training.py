"""The amp training step: cast, forward, backward, unscale, overflow
check, loss-scale state machine and the skip-masked optimizer update.

Counterpart of ``apex_tpu/training.py:93-429`` (``FunctionalOptimizer``,
``adam``, ``sgd``, ``lamb``, ``novograd`` and their ``bucketed=`` forms,
``TrainState``, ``chain_steps``, ``make_train_step``), with the same
opt-level semantics:

* O0: fp32 end to end.
* O1: fp32 parameters; the loss runs under whatever O1 policy
  ``amp.init()`` has pushed (:mod:`apex_tpu_torch.amp.autocast`), as the
  JAX step traces it, and the weight-cast cache is cleared after each
  step.
* O2: parameters stored ONCE as fp32 masters; the bf16 copy exists only
  inside the step (``amp.convert_params``, norms kept fp32).  The model
  runs on the cast tree through ``torch.func.functional_call`` in the
  caller's ``loss_fn``; ``.to(bf16)`` is differentiable and hands an fp32
  gradient back to each master, as the JAX transpose of the cast does.
* O3: parameters stored bf16, no masters.
* O4: O2's storage and scaling semantics exactly; the int8 routing is a
  property of the model (``quant=``, :mod:`apex_tpu_torch.quant`), and
  the quantized matmul's backward is the straight-through bf16 product,
  so a model without a frozen calibration steps bitwise as O2.

The parameter tree is a mapping of ``state_dict`` names to tensors.
Skipping a step is a device-side ``torch.where`` (``apply_mask``), and
every metric stays a tensor on the device: the step never reads a value
back to the host.  With ``has_model_state`` the loss also returns the
new model state (BatchNorm running statistics), threaded through the
microbatches in order and kept even on a step the dynamic scaler skips,
as in JAX.  Not ported yet: the DDP and mesh arguments (``axis_name``,
``reduce_grads``, ``param_view`` and the all-reduce options); they
raise ``NotImplementedError``.  On one device the JAX step's ``pmean``
of the loss and the model state is the identity, so a one-card caller
passes no ``axis_name``.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple, Optional

import torch
from torch.utils import _pytree as pytree

from .amp import autocast as _autocast
from .amp import policy as _policy
from .amp.loss_scaler import LossScaler, LossScalerState
from .amp.properties import opt_levels
from .multi_tensor import flatten_tree
from .multi_tensor.buckets import cached_store
from .optimizers import functional as F


class FunctionalOptimizer(NamedTuple):
    init: Callable        # params -> state
    update: Callable      # (grads, state, params, apply_mask=) -> (p, s)
    #: declared, not inferred: True iff ``update`` treats every parameter
    #: element on its own (no per-tensor norms or trust ratios), so it
    #: stays right on any flat chunk of the parameters
    elementwise: bool = False


def _bucketed_tx(init_fn, update_fn, *, elementwise) -> FunctionalOptimizer:
    """A :class:`FunctionalOptimizer` over the flat-bucket engine: the
    :class:`~apex_tpu_torch.multi_tensor.BucketStore` is built from the
    first tree of parameters it sees (one per signature,
    :func:`~apex_tpu_torch.multi_tensor.buckets.cached_store`), and the
    state holds its moments as a few ``Packed`` buffers."""
    cell: dict = {}

    def init(params):
        return init_fn(params, store=cached_store(cell, params))

    def update(grads, state, params, **kw):
        return update_fn(grads, state, params,
                         store=cached_store(cell, params), **kw)

    return FunctionalOptimizer(init, update, elementwise=elementwise)


def _tx(init_fn, update_fn, bucketed, elementwise) -> FunctionalOptimizer:
    if bucketed:
        return _bucketed_tx(init_fn, update_fn, elementwise=elementwise)
    return FunctionalOptimizer(init_fn, update_fn, elementwise=elementwise)


def adam(lr=1e-3, *, bucketed=False, **kw) -> FunctionalOptimizer:
    """Adam/AdamW (:func:`optimizers.functional.adam_update`), leafwise or
    over flat buckets (``bucketed=True``, bit for bit the leafwise
    update in fp32); weight decay applies to every parameter."""
    return _tx(F.adam_init, functools.partial(F.adam_update, lr=lr, **kw),
               bucketed, elementwise=True)


def sgd(lr=1e-3, momentum=0.0, *, bucketed=False, **kw
        ) -> FunctionalOptimizer:
    """SGD (:func:`optimizers.functional.sgd_update`), leafwise or over
    flat buckets; weight decay applies to every parameter."""
    return _tx(functools.partial(F.sgd_init, momentum=momentum),
               functools.partial(F.sgd_update, lr=lr, momentum=momentum,
                                 **kw), bucketed, elementwise=True)


def lamb(lr=1e-3, *, bucketed=False, **kw) -> FunctionalOptimizer:
    """LAMB (:func:`optimizers.functional.lamb_update`), leafwise or over
    flat buckets; not elementwise (per-tensor trust ratios)."""
    return _tx(F.lamb_init, functools.partial(F.lamb_update, lr=lr, **kw),
               bucketed, elementwise=False)


def novograd(lr=1e-3, *, bucketed=False, **kw) -> FunctionalOptimizer:
    """NovoGrad (:func:`optimizers.functional.novograd_update`), leafwise
    or over flat buckets; not elementwise (per-tensor norms)."""
    return _tx(F.novograd_init,
               functools.partial(F.novograd_update, lr=lr, **kw), bucketed,
               elementwise=False)


class TrainState(NamedTuple):
    """Carry of the step.  ``params`` is the single source of truth: fp32
    for O0/O1/O2 (O2 casts inside the step), bf16 for O3."""
    params: Any
    opt_state: Any
    scaler: LossScalerState
    model_state: Any = None


def _stack_trees(trees):
    """One tree of ``torch.stack``-ed leaves from a list of trees of one
    structure (the per-step metrics of a window, stacked on K)."""
    flat = [pytree.tree_flatten(t) for t in trees]
    spec = flat[0][1]
    return pytree.tree_unflatten(
        [torch.stack(xs) for xs in zip(*(leaves for leaves, _ in flat))],
        spec)


def chain_steps(step_fn: Callable,
                commit: Optional[Callable] = None) -> Callable:
    """K training steps in order, as one function.

    ``chain_steps(step_fn)(state, batches)`` runs ``step_fn`` over
    ``batches`` (every tensor leaf stacked on a leading K axis) and
    returns ``(state, metrics)``, the per-step metrics stacked on K: the
    JAX ``lax.scan`` over the window, step by step.  It is a plain
    function; capturing it, so that K steps cost one host call, is the
    caller's (:class:`apex_tpu_torch.runtime.StepPipeline`).

    ``commit(new_state) -> state`` (optional) runs after every step and
    its result feeds the next one: the pipeline's capture copies each
    step's state into its static input there, so no more than one new
    state is live at a time and a window needs one step's memory."""
    def chained(state, batches):
        leaves, spec = pytree.tree_flatten(batches)
        per_step = []
        for i in range(leaves[0].shape[0]):
            batch = pytree.tree_unflatten([x[i] for x in leaves], spec)
            state, metrics = step_fn(state, batch)
            if commit is not None:
                state = commit(state)
            per_step.append(metrics)
        return state, _stack_trees(per_step)
    return chained


def make_train_step(loss_fn: Callable, optimizer: FunctionalOptimizer, *,
                    opt_level: str = "O2", loss_scale=None,
                    keep_batchnorm_fp32: Optional[bool] = None,
                    cast_model_type=None, accum_steps: int = 1,
                    norm_predicate=None, scale_window: int = 2000,
                    min_loss_scale=None, max_loss_scale: float = 2.**24,
                    has_model_state: bool = False, reduce_grads: bool = True,
                    **not_ported):
    """Build ``(init_fn, step_fn)`` for one amp training step.

    ``loss_fn(params, batch) -> loss`` (a 0-dim tensor), or with
    ``has_model_state`` ``loss_fn(params, model_state, batch) -> (loss,
    new_model_state)``; ``params`` arrive cast to the compute dtype of
    the opt level.  ``init_fn(params, model_state=None)`` gives the
    :class:`TrainState`; ``step_fn(state, batch)`` gives ``(new_state,
    metrics)`` with ``metrics`` ``{"loss", "loss_scale", "overflow"}``,
    device tensors.

    ``accum_steps=N`` splits every tensor of ``batch`` into N
    microbatches along its leading axis, accumulates the mean of the
    scaled gradients in fp32 (the cast is done once, outside the loop),
    threads the model state through the microbatches in order, and
    unscales, checks and updates once.
    """
    if not_ported:
        raise NotImplementedError(
            f"not ported yet: {sorted(not_ported)} (the data- and "
            f"model-parallel arguments of the JAX step)")
    if not reduce_grads:
        raise NotImplementedError("reduce_grads=False is not ported yet")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    props = opt_levels[opt_level]()
    if loss_scale is not None:
        props.loss_scale = loss_scale
    if keep_batchnorm_fp32 is not None:
        props.keep_batchnorm_fp32 = keep_batchnorm_fp32
    if cast_model_type is not None:
        props.cast_model_type = cast_model_type

    scaler = LossScaler(props.loss_scale, scale_window=scale_window,
                        min_loss_scale=min_loss_scale,
                        max_loss_scale=max_loss_scale)
    cast_dtype = props.cast_model_type
    reduced = cast_dtype is not None and cast_dtype != torch.float32
    cast_in_step = reduced and props.master_weights
    store_cast = reduced and not props.master_weights
    keep_bn = props.keep_batchnorm_fp32
    keep_bn = True if keep_bn is None else keep_bn

    def cast(params):
        return _policy.convert_params(params, cast_dtype,
                                      keep_norm_fp32=keep_bn,
                                      norm_predicate=norm_predicate)

    def init_fn(params, model_state=None) -> TrainState:
        params = dict(params)
        if store_cast:               # O3: reduced precision, no masters
            params = {k: v.detach() for k, v in cast(params).items()}
        device = next(iter(params.values())).device
        return TrainState(params=params, opt_state=optimizer.init(params),
                          scaler=scaler.init(device),
                          model_state=model_state)

    def grads_of(leaves, model_state, batch, scale, view=None):
        """(loss, grads of ``loss * scale`` with respect to ``leaves``,
        new model state); ``view`` maps the leaves to what ``loss_fn``
        takes, inside the differentiated function."""
        with torch.enable_grad():
            p = leaves if view is None else view(leaves)
            if has_model_state:
                loss, new_ms = loss_fn(p, model_state, batch)
            else:
                loss, new_ms = loss_fn(p, batch), model_state
            grads = torch.autograd.grad(loss.float() * scale,
                                        list(leaves.values()),
                                        allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves.values())]
        return loss.detach().float(), grads, new_ms

    def step_fn(state: TrainState, batch):
        scale = state.scaler.loss_scale
        names = list(state.params)
        if accum_steps == 1:
            # under O2 the cast is inside the differentiated function:
            # its backward returns each gradient in the master's dtype
            masters = {k: v.detach().requires_grad_(True)
                       for k, v in state.params.items()}
            loss, grads, new_ms = grads_of(masters, state.model_state,
                                           batch, scale,
                                           cast if cast_in_step else None)
        else:
            leaves, _ = flatten_tree(batch)
            for x in leaves:
                if x.shape[0] % accum_steps:
                    raise ValueError(
                        f"batch leading dim {x.shape[0]} not divisible by "
                        f"accum_steps={accum_steps}")
            # the cast is hoisted out of the microbatch loop; its
            # transpose is an upcast, the identity on the fp32 sum
            cp = state.params
            if cast_in_step:
                cp = cast(cp)
            cp = {k: v.detach().requires_grad_(True) for k, v in cp.items()}
            _, rebuild = flatten_tree(batch)
            parts = [torch.chunk(x, accum_steps) for x in leaves]
            grads = [torch.zeros_like(p, dtype=torch.float32)
                     for p in cp.values()]
            loss = torch.zeros((), dtype=torch.float32, device=scale.device)
            new_ms = state.model_state
            for i in range(accum_steps):
                mb = rebuild([p[i] for p in parts])
                l_i, g_i, new_ms = grads_of(cp, new_ms, mb, scale)
                grads = [a + b.float() / accum_steps
                         for a, b in zip(grads, g_i)]
                loss = loss + l_i / accum_steps
        grads, scaler_state = scaler.unscale(dict(zip(names, grads)),
                                             state.scaler)
        apply_mask = (torch.logical_not(scaler_state.overflow)
                      if scaler.dynamic else None)
        new_params, new_opt = optimizer.update(
            grads, state.opt_state, state.params, apply_mask=apply_mask)
        scaler_state = scaler.update_scale(scaler_state)
        _autocast.clear_cast_cache()
        metrics = {"loss": loss, "loss_scale": scaler_state.loss_scale,
                   "overflow": (torch.logical_not(apply_mask)
                                if apply_mask is not None
                                else torch.zeros_like(scaler_state.overflow))}
        # the new model state is kept even on a skipped step, as in JAX
        return TrainState(params=new_params, opt_state=new_opt,
                          scaler=scaler_state, model_state=new_ms), metrics

    return init_fn, step_fn
