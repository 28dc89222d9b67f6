"""The fused optimizer classes' base — counterpart of
``apex_tpu/optimizers/base.py`` (reference ``apex/optimizers`` with the
amp handshake ``apex/amp/_process_optimizer.py`` injects).

:class:`FusedOptimizer` is a ``torch.optim.Optimizer``: ``step()``,
``zero_grad()``, ``param_groups`` with per-group hyperparameters,
``add_param_group``, ``state_dict``/``load_state_dict``.  Its update is
the port's functional update (:mod:`apex_tpu_torch.optimizers.
functional`), the same ``torch._foreach_*`` chain ``make_train_step``
runs, over each group's parameters as one tree: a ``name -> tensor``
dict when the group has names (``model.named_parameters()``, a mapping,
or names found by ``amp.initialize``), else a list.  ``bucketed=True``
keeps each group's state (and, amp-wired at O2, its fp32 masters) as a
few flat buffers of a :class:`~apex_tpu_torch.multi_tensor.BucketStore`
built from the group's model parameters, laid out as the JAX package's
store lays out the same named tree.

A parameter without a gradient counts as a zero gradient (as
``jax.grad`` and ``make_train_step`` give one): every parameter of a
group is updated each step.

**The amp handshake** (wired by ``amp.initialize``):

* ``_amp_wire``: at O2 the model's parameters are cast (norms kept fp32)
  and the group's ``params`` become fp32 masters; the model parameters
  are kept beside them and receive the masters' values after each step
  (one ``torch._foreach_copy_``, a rounding cast);
* ``_prepare_amp_backward`` / ``_post_amp_backward``: a backward's
  scaled model-dtype ``.grad`` moves into fp32 master gradients,
  unscaled (``LossScaler.unscale``), added in fp32 to any gradients a
  previous loss left (``unscale_with_stashed``), and ``.grad`` is
  cleared, so two losses into one optimizer sum their unscaled
  gradients, each under its own scale;
* ``_note_pending_overflow``: each loss's overflow flag stays a device
  bool; ``step()`` ORs them into one skip mask that the functional
  update applies as a ``torch.where`` select, as ``make_train_step``
  does.  A skipped step leaves masters and state bit-identical (the
  step count too) and reads nothing back to the host.

**Telemetry**: with a recorder, ``step()`` is an ``opt_step`` span (the
host time of the update's launches) and a skipped step is JAX's
``scale`` skip event (``source="optimizer"``) and a ``loss_scale_skips``
count.  The skip mask stays on the device: on CUDA it is copied to
pinned memory behind the update and read by a later ``step()`` once its
event has completed (``Event.query``, which waits for nothing), so the
event of step N lands at a later step; on the CPU it is read at once.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional

import contextlib

import torch

from ..amp import policy as _policy
from ..multi_tensor import flatten_tree
from ..multi_tensor.buckets import BucketStore, Packed
from ..telemetry import events as _events

__all__ = ["FusedOptimizer"]


def _named(params) -> List[dict]:
    """The constructor's ``params`` as torch's list of group dicts, a
    group's names (if any) under ``param_names``: a tensor iterable, an
    iterable of ``(name, tensor)`` pairs, a ``name -> tensor`` mapping,
    or a list of group dicts whose ``params`` is any of these."""
    if isinstance(params, torch.Tensor):
        params = [params]
    if isinstance(params, Mapping):
        params = list(params.items())
    params = list(params)
    if params and all(isinstance(g, dict) for g in params):
        return [dict(g, **_split(g["params"])) for g in params]
    return [_split(params)]


def _split(params) -> dict:
    if isinstance(params, torch.Tensor):
        return {"params": [params]}
    if isinstance(params, Mapping):
        params = list(params.items())
    params = list(params)
    if params and isinstance(params[0], tuple):
        return {"params": [p for _, p in params],
                "param_names": [n for n, _ in params]}
    return {"params": params}


def _tree(group: dict, tensors):
    """``tensors`` (in the group's order) in the group's tree container."""
    if "param_names" in group:
        return dict(zip(group["param_names"], tensors))
    return list(tensors)


def _leaves(tree) -> list:
    return flatten_tree(tree)[0]


class FusedOptimizer(torch.optim.Optimizer):
    """Base: subclasses define ``_init_state(params, group)`` and
    ``_update(grads, state, params, *, group, lr, grad_scale,
    apply_mask) -> (params, state)``, reading their hyperparameters from
    ``group``; ``group["_store"]`` is the group's ``BucketStore`` when
    bucketed, else None."""

    def __init__(self, params, defaults: Dict[str, Any], *,
                 bucketed: bool = False):
        self.bucketed = bool(bucketed)
        self.loss_scaler = None
        self.properties = None
        self._amp_wired = False
        self._norm_predicate = None
        self._fstate: list = []          # functional state, one per group
        self._models: list = []          # model params per group (masters)
        self._masters: list = []         # Packed masters per group (bucketed)
        self._master_grads: Optional[list] = None
        self._stashed: Optional[list] = None
        self._scaled_in_grad = False     # a delayed backward left .grad
        self._pending: list = []         # (device overflow flag, loss_id)
        self._step_count = 0             # step() calls (telemetry)
        self._skip_reads: list = []      # (step, host mask, event or None)
        super().__init__(_named(params), defaults)

    # -- groups --------------------------------------------------------------
    def add_param_group(self, param_group: dict) -> None:
        """Append a group (reference ``_process_optimizer.py:403-479``):
        amp-wired, its parameters are cast as the model's were and it
        gets masters."""
        group = _named([param_group])[0]
        super().add_param_group(group)
        g = self.param_groups[-1]
        g.setdefault("_store", None)
        self._models.append(None)
        self._masters.append(None)
        self._fstate.append(None)
        self._setup_group(len(self.param_groups) - 1)

    def _model_tree(self, i: int):
        g = self.param_groups[i]
        return _tree(g, self._models[i] if self._models[i] is not None
                     else g["params"])

    @torch.no_grad()
    def _setup_group(self, i: int) -> None:
        """(Re)build group ``i``'s store, masters and state from its
        model parameters, after any amp cast."""
        g = self.param_groups[i]
        props = self.properties
        if self._amp_wired:
            if self._models[i] is None:
                self._cast_group(g)
            if props.master_weights and self._models[i] is None:
                self._models[i] = list(g["params"])
        model_tree = self._model_tree(i)
        store = BucketStore(model_tree) if self.bucketed else None
        g["_store"] = store
        if self._models[i] is not None:
            if store is not None:
                # the masters are views of the fp32 buckets
                self._masters[i] = store.pack(model_tree,
                                              dtype=torch.float32)
                g["params"] = _leaves(store.unpack(self._masters[i]))
            else:
                g["params"] = _leaves(_policy.make_master(
                    _leaves(model_tree)))
        self._fstate[i] = self._init_state(self._targets(i), g)

    def _attach_masters(self) -> None:
        """fp32 masters for every group, without amp: the legacy
        ``FP16_Optimizer`` wrappers' masters over bf16 parameters."""
        for i, g in enumerate(self.param_groups):
            if self._models[i] is None:
                self._models[i] = list(g["params"])
                self._setup_group(i)

    def _cast_group(self, g: dict) -> None:
        """Cast ``g``'s parameters in place to the model dtype of the
        wired opt level (norms kept fp32 by name), as ``initialize``
        casts the modules'."""
        cast_type = self.properties.cast_model_type
        if cast_type is None or cast_type == torch.float32:
            return
        keep_bn = self.properties.keep_batchnorm_fp32
        names = g.get("param_names",
                      [f"param_{j}" for j in range(len(g["params"]))])
        cast = _policy.convert_params(
            {n: p.detach() for n, p in zip(names, g["params"])}, cast_type,
            keep_norm_fp32=True if keep_bn is None else keep_bn,
            norm_predicate=self._norm_predicate)
        for p, n in zip(g["params"], names):
            if cast[n].dtype != p.dtype:
                p.data = cast[n]

    def _targets(self, i: int):
        """What group ``i``'s update reads and writes: its Packed fp32
        masters, else the tree of its ``params`` (masters or the model's
        own)."""
        if self._masters[i] is not None:
            return self._masters[i]
        g = self.param_groups[i]
        return _tree(g, g["params"])

    # -- subclass hooks -------------------------------------------------------
    def _init_state(self, params, group):
        raise NotImplementedError

    def _update(self, grads, state, params, *, group, lr, grad_scale,
                apply_mask):
        raise NotImplementedError

    # -- the amp handshake ----------------------------------------------------
    def _amp_wire(self, properties, loss_scaler, names=None,
                  norm_predicate=None) -> None:
        """Wire the opt level (``amp.initialize``): ``names`` maps
        ``id(param)`` to its name in the models (groups without names
        take them when every parameter is found there)."""
        self.properties = properties
        self.loss_scaler = loss_scaler
        self._amp_wired = True
        self._norm_predicate = norm_predicate
        for i, g in enumerate(self.param_groups):
            if names and "param_names" not in g and all(
                    id(p) in names for p in g["params"]):
                g["param_names"] = [names[id(p)] for p in g["params"]]
            self._models[i] = None
            self._masters[i] = None
            self._setup_group(i)

    def _model_grads(self, i: int):
        """Group ``i``'s model gradients as a tree (zeros where a
        parameter has none)."""
        params = (self._models[i] if self._models[i] is not None
                  else self.param_groups[i]["params"])
        return _tree(self.param_groups[i], [
            torch.zeros_like(p) if p.grad is None else p.grad
            for p in params])

    def _clear_model_grads(self) -> None:
        for i, g in enumerate(self.param_groups):
            for p in (self._models[i] or g["params"]):
                p.grad = None

    def _prepare_amp_backward(self) -> None:
        """Stash the master gradients a previous loss left (reference
        ``_process_optimizer.py:134-150``); after a delayed backward the
        scaled ``.grad`` keeps accumulating instead."""
        if self._scaled_in_grad:
            return
        self._stashed = self._master_grads
        self._master_grads = None

    def _delay_amp_backward(self) -> None:
        self._scaled_in_grad = True

    def _post_amp_backward(self, loss_scaler) -> None:
        """Scaled model-dtype ``.grad`` -> fp32 master gradients, unscaled
        (over the buckets when bucketed), plus the stash in fp32; then
        ``.grad`` is cleared (reference ``_process_optimizer.py:153-241``)."""
        out = []
        for i, g in enumerate(self.param_groups):
            grads, store = self._model_grads(i), g["_store"]
            if store is not None:
                grads = store.pack(grads)
            stash = None if self._stashed is None else self._stashed[i]
            if stash is None:
                mg, _ = loss_scaler.unscale(grads, store=store)
            else:
                mg, _ = loss_scaler.unscale_with_stashed(grads, stash,
                                                         store=store)
            out.append(mg)
        self._master_grads = out
        self._stashed = None
        self._scaled_in_grad = False
        self._clear_model_grads()

    def _note_pending_overflow(self, flag: torch.Tensor, loss_id: int
                               ) -> None:
        """A loss's overflow flag (a device bool) for the next step's
        skip mask."""
        self._pending.append((flag, loss_id))

    def _skip_mask(self) -> Optional[torch.Tensor]:
        """``not any(pending flags)`` as a device bool (True applies the
        update), or None when no dynamic scaler handed a flag."""
        if not self._pending:
            return None
        flags = torch.stack([f for f, _ in self._pending])
        self._pending = []
        return torch.logical_not(flags.any())

    def _drop_master_grads(self) -> None:
        self._master_grads = None
        self._stashed = None
        self._scaled_in_grad = False
        self._clear_model_grads()

    # -- step -----------------------------------------------------------------
    def _step_grads(self) -> list:
        """Each group's gradients for this step: the master gradients
        ``scale_loss`` delivered, else the ``.grad`` of the parameters."""
        if self._master_grads is not None:
            return self._master_grads
        return [self._model_grads(i) for i in range(len(self.param_groups))]

    def _take_grad_scale(self):
        """The scale this step's gradients still carry (1.0: none)."""
        return 1.0

    def _apply(self, grads: list, mask, grad_scale=1.0) -> None:
        for i, g in enumerate(self.param_groups):
            new_p, self._fstate[i] = self._update(
                grads[i], self._fstate[i], self._targets(i), group=g,
                lr=g["lr"], grad_scale=grad_scale, apply_mask=mask)
            self._commit(i, new_p)

    def _commit(self, i: int, new_p) -> None:
        """Write group ``i``'s new values in place: the masters (or the
        parameters), then the master -> model copy."""
        g = self.param_groups[i]
        if self._masters[i] is not None:
            torch._foreach_copy_(list(self._masters[i].data),
                                 list(new_p.data))
            model = _leaves(g["_store"].unpack(self._masters[i], cast=True))
            torch._foreach_copy_(_leaves(self._model_tree(i)), model)
            return
        torch._foreach_copy_(g["params"], _leaves(new_p))
        if self._models[i] is not None:
            torch._foreach_copy_(self._models[i], g["params"])

    @torch.no_grad()
    def step(self, closure=None):
        """One update of every group; a pending overflow skips it on the
        device.  Returns the closure's loss."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        mask = self._skip_mask()
        grad_scale = self._take_grad_scale()
        rec = _events.get_recorder()
        step_idx = self._step_count
        self._step_count += 1
        span = (contextlib.nullcontext() if rec is None
                else rec.span("opt_step", step=step_idx))
        with span:
            self._apply(self._step_grads(), mask, grad_scale)
        if rec is not None:
            self._note_skips(rec, mask, step_idx)
        self._master_grads = None
        if self._amp_wired:
            self._clear_model_grads()
        return loss

    def _note_skips(self, rec, mask, step_idx: int) -> None:
        """Queue this step's skip mask for the recorder and emit the
        ``scale`` skip events of every queued mask already on the host
        (see the module docstring): no read waits for the device."""
        if mask is not None:
            if mask.is_cuda:
                host = torch.empty((), dtype=torch.bool, pin_memory=True)
                host.copy_(mask, non_blocking=True)
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(mask.device))
                self._skip_reads.append((step_idx, host, done))
            else:
                self._skip_reads.append((step_idx, mask, None))
        while self._skip_reads and (self._skip_reads[0][2] is None
                                    or self._skip_reads[0][2].query()):
            step, applied, _ = self._skip_reads.pop(0)
            if not bool(applied):
                rec.metrics.counter("loss_scale_skips").inc()
                rec.event("scale", event="skip", step=step,
                          source="optimizer")

    def zero_grad(self, set_to_none: bool = True) -> None:
        """Clear the model's ``.grad`` (set to None, or zeroed) and the
        master gradients and stash (reference ``_process_optimizer.py:
        358-374``)."""
        self._master_grads = None
        self._stashed = None
        self._scaled_in_grad = False
        for i, g in enumerate(self.param_groups):
            for p in (self._models[i] or g["params"]):
                if p.grad is None:
                    continue
                if set_to_none:
                    p.grad = None
                else:
                    p.grad.detach_()
                    p.grad.zero_()

    # -- checkpoints ----------------------------------------------------------
    def master_tree(self, i: int = 0):
        """Group ``i``'s fp32 masters as its tree (unpacked when
        bucketed), or None without masters."""
        if self._models[i] is None:
            return None
        return _tree(self.param_groups[i], self.param_groups[i]["params"])

    def state_dict(self) -> dict:
        """``{"state": [each group's functional state], "lr": [...],
        "defaults": {...}, "master_params": [each group's masters as its
        tree] (amp-wired at O2)}``: masters in tree form, so a bucketed
        checkpoint loads into a leafwise optimizer and back; the state
        stays in its form (trees, or ``Packed`` when bucketed)."""
        sd = {"state": list(self._fstate),
              "lr": [g["lr"] for g in self.param_groups],
              "defaults": dict(self.defaults)}
        if any(m is not None for m in self._models):
            sd["master_params"] = [
                {k: v.detach().clone() for k, v in m.items()}
                if isinstance(m, dict) else [v.detach().clone() for v in m]
                for m in (self.master_tree(i)
                          for i in range(len(self.param_groups)))]
        return sd

    def load_state_dict(self, state_dict: dict) -> None:
        """Restore what :meth:`state_dict` wrote (or the conversion of a
        JAX ``FusedOptimizer``'s, :mod:`apex_tpu_torch.convert`), onto
        the device of the group's parameters."""
        for i, (g, st) in enumerate(zip(self.param_groups,
                                        state_dict["state"])):
            device = g["params"][0].device
            self._fstate[i] = _to(_in_order(st, g.get("param_names")),
                                  device)
        for g, lr in zip(self.param_groups, state_dict.get("lr", [])):
            g["lr"] = lr
        masters = state_dict.get("master_params")
        if masters is None:
            return
        for i, (g, m) in enumerate(zip(self.param_groups, masters)):
            vals = ([m[n] for n in g["param_names"]]
                    if isinstance(m, Mapping) else list(m))
            with torch.no_grad():
                # bucketed, the masters are views of the buckets: this
                # writes the buckets
                torch._foreach_copy_(g["params"], [
                    v.to(p.device, torch.float32)
                    for v, p in zip(vals, g["params"])])
                torch._foreach_copy_(_leaves(self._model_tree(i)),
                                     g["params"])


def _in_order(state, names):
    """``state`` (a functional state) with its ``name -> tensor`` trees in
    the group's order (the update pairs moments and parameters by
    position)."""
    if names is None:
        return state
    return type(state)(*(
        {n: x[n] for n in names} if isinstance(x, Mapping) else x
        for x in state))


def _to(tree, device):
    """Every tensor of ``tree`` (NamedTuples, ``Packed``, dicts, lists)
    on ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to(x, device) for x in tree))
    if isinstance(tree, Mapping):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(x, device) for x in tree)
    return tree
