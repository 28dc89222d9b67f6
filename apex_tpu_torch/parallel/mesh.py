"""One DP x FSDP x TP mesh over the process group, and ZeRO 1-3 on it —
counterpart of ``apex_tpu/parallel/mesh.py``.

:class:`MeshPlan` states the axes once (``MeshPlan(dp=2, fsdp=2)``) and
lays them over the world row-major, as JAX reshapes ``jax.devices()``:
rank ``r`` sits at ``unravel(r, (dp, fsdp, tp))``.  Every rank makes every
axis's process group, in the same order
(:func:`~apex_tpu_torch.parallel.distributed.register_mesh`), so each
axis name and each tuple of them (``plan.data_axes``, ``plan.all_axes``)
is an ``axis_name`` every collective of the port takes.  JAX's
placements become slices: one process is one rank here, so "placing" a
batch (:meth:`MeshPlan.device_put_batch`) takes this rank's rows of the
global batch, over the data axes ``(dp, fsdp)``; ``batch_spec`` and
``flat_spec`` name the axes a dimension is split over, as JAX's
``PartitionSpec``s do.

ZeRO over the ``fsdp`` axis, on the flat buckets of a
:class:`~apex_tpu_torch.multi_tensor.BucketStore`:

  ========  =======================================================
  level     what a rank holds of the state
  ========  =======================================================
  1 / 2     all the parameters; its 1/fsdp chunk of each bucket's
            optimizer state.  Gradients are reduce-scattered over fsdp
            and the chunk summed over dp (the stages coincide)
  3         its 1/fsdp chunk of each parameter bucket and of the
            optimizer state; the full tree exists only inside the step
  ========  =======================================================

ZeRO-3's view (:func:`_gather_view`, ``make_train_step(param_view=)``)
all-gathers each bucket over fsdp inside the differentiated loss; its
backward reduce-scatters the gradient, so the optimizer gets each
chunk's gradient summed over fsdp, then over dp, and divides by the
data world.  ``gather_dtype`` (bf16) sends the buckets on the wire in it
both ways; the fp32 masters stay exact.

The gradients are the mean gradient of the global batch at every level
(each data rank's mean over its rows, averaged over the data world), as
the port's DP step and ``zero1`` take them.  JAX's steps under
``shard_map`` differentiate replicated parameters with the
varying-axes autodiff, which sums their gradient over the mesh before
ZeRO sums it again: JAX's moments hold the mean gradient times a factor
(``tests/test_torch_mesh.py`` measures it), which Adam's update all but
cancels.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from ..multi_tensor.buckets import BucketStore, Packed, cached_store
from .distributed import _all_reduce_, axis_group, register_mesh
from .zero import (Zero1State, _all_gather, _chunk, _pad, _reduce_scatter,
                   _shard_one)

__all__ = ["MeshPlan", "MeshTrainStep", "make_mesh_train_step",
           "zero_sharded", "MeshZeroState"]


class MeshPlan:
    """One declaration of a DP x FSDP x TP mesh over the process group.

    ``dp`` replicas see different data and hold full state; ``fsdp``
    replicas see different data and SHARD state (the ZeRO axis); ``tp``
    replicas see the same data and shard tensors inside the model (use
    ``plan.tp_axis`` with :mod:`apex_tpu_torch.parallel.tensor_parallel`).
    The sizes must multiply to the world's size: the ranks are the
    mesh's devices."""

    def __init__(self, *, dp: int = 1, fsdp: int = 1, tp: int = 1,
                 axis_names: Tuple[str, str, str] = ("dp", "fsdp", "tp")):
        if len(tuple(axis_names)) != 3:
            raise ValueError(f"axis_names must name (dp, fsdp, tp), got "
                             f"{axis_names!r}")
        if min(dp, fsdp, tp) < 1:
            raise ValueError(
                f"axis sizes must be >= 1, got dp={dp} fsdp={fsdp} tp={tp}")
        n = _world_size()
        if n != dp * fsdp * tp:
            raise ValueError(
                f"MeshPlan needs dp*fsdp*tp == the world's size: "
                f"{dp}*{fsdp}*{tp} != {n} rank(s)")
        self.axis_names = tuple(axis_names)
        self.dp, self.fsdp, self.tp = int(dp), int(fsdp), int(tp)
        register_mesh(self.axis_names, (self.dp, self.fsdp, self.tp))
        # every rank makes the data axes' and the mesh's groups too
        for axes in (self.data_axes, self.all_axes):
            axis_group(axes)
        rank = dist.get_rank()
        self.coords = (rank // (self.fsdp * self.tp),
                       rank // self.tp % self.fsdp, rank % self.tp)

    @classmethod
    def auto(cls, *, fsdp: Optional[int] = None, tp: int = 1,
             **kw) -> "MeshPlan":
        """Fill ``dp`` from the world's size: ``fsdp`` defaults to every
        rank ``tp`` leaves (pure FSDP), ``dp`` to the remainder."""
        n = _world_size()
        if fsdp is None:
            if n % tp:
                raise ValueError(f"{n} devices not divisible by tp={tp}")
            fsdp = n // tp
        if n % (fsdp * tp):
            raise ValueError(
                f"{n} devices not divisible by fsdp*tp={fsdp * tp}")
        return cls(dp=n // (fsdp * tp), fsdp=fsdp, tp=tp, **kw)

    # -- axis names ----------------------------------------------------------
    @property
    def dp_axis(self) -> str:
        return self.axis_names[0]

    @property
    def fsdp_axis(self) -> str:
        return self.axis_names[1]

    @property
    def tp_axis(self) -> str:
        return self.axis_names[2]

    @property
    def data_axes(self) -> Tuple[str, ...]:
        """Axes whose replicas consume DIFFERENT data (batch split and
        gradient mean over their product)."""
        return (self.dp_axis, self.fsdp_axis)

    @property
    def all_axes(self) -> Tuple[str, ...]:
        """Every mesh axis: the step's ``axis_name`` (overflow agreement
        and the metric mean span the mesh)."""
        return self.axis_names

    @property
    def world_size(self) -> int:
        return self.dp * self.fsdp * self.tp

    @property
    def data_world(self) -> int:
        """Number of distinct data shards (the gradient-mean divisor)."""
        return self.dp * self.fsdp

    @property
    def data_index(self) -> int:
        """This rank's data shard: row-major over ``(dp, fsdp)``."""
        return self.coords[0] * self.fsdp + self.coords[1]

    @property
    def fsdp_index(self) -> int:
        """This rank's chunk of every ZeRO bucket."""
        return self.coords[1]

    def __repr__(self):
        return (f"MeshPlan({self.dp_axis}={self.dp} x "
                f"{self.fsdp_axis}={self.fsdp} x {self.tp_axis}={self.tp} "
                f"over {self.world_size} device(s))")

    # -- placements ----------------------------------------------------------
    @property
    def batch_spec(self) -> tuple:
        """A batch: the leading axis split over dp x fsdp (JAX's
        ``P(("dp", "fsdp"))``), replicated over tp."""
        return (self.data_axes,)

    @property
    def flat_spec(self) -> tuple:
        """A ZeRO flat bucket (1-D, padded to divide): over fsdp."""
        return (self.fsdp_axis,)

    def _rows(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        n = x.shape[axis]
        if n % self.data_world:
            raise ValueError(f"batch axis of {n} does not split over "
                             f"dp*fsdp = {self.data_world} data shards")
        rows = n // self.data_world
        return x.narrow(axis, self.data_index * rows, rows)

    def device_put_batch(self, batch):
        """This rank's rows of a global batch (every tensor's leading
        axis cut over dp x fsdp, in rank order)."""
        return pytree.tree_map(lambda x: self._rows(x, 0), batch)

    def device_put_window(self, window):
        """This rank's rows of a ``[K, batch, ...]`` window (axis 1)."""
        return pytree.tree_map(lambda x: self._rows(x, 1), window)

    # -- ledger --------------------------------------------------------------
    def state_bytes(self, tree, spec=None) -> dict:
        """Placement ledger of a state tree: the global bytes against the
        bytes this rank holds.  ``spec`` (a tree of the same structure,
        :meth:`MeshTrainStep.state_spec`'s) names each leaf held as its
        1/fsdp chunk by ``fsdp``; leaves without it count as replicated."""
        leaves = pytree.tree_leaves(tree)
        specs = ([None] * len(leaves) if spec is None
                 else pytree.tree_leaves(spec))
        glob = local = 0
        for leaf, sp in zip(leaves, specs):
            if not isinstance(leaf, torch.Tensor):
                continue
            nbytes = leaf.numel() * leaf.element_size()
            local += nbytes
            glob += nbytes * (self.fsdp if sp == self.fsdp_axis else 1)
        return {"global_bytes": glob, "bytes_per_device": local,
                "ratio": round(local / glob, 4) if glob else None}

    def bucket_layout(self, store: BucketStore) -> dict:
        """Checkpoint-manifest bucket descriptor at this plan's shard
        count (:func:`apex_tpu_torch.checkpoint.bucket_layout`): what the
        N -> M reshard on read cuts against."""
        return store.shard_layout(self.fsdp)


def _world_size() -> int:
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("a MeshPlan lays its axes over the process "
                           "group: call apex_tpu_torch.parallel.multiproc."
                           "initialize() first (a group of one serves one "
                           "device)")
    return dist.get_world_size()


# -- ZeRO over the plan -------------------------------------------------------

class MeshZeroState(NamedTuple):
    """Optimizer state of ZeRO-3: one inner state a flat bucket, over this
    rank's chunk of it."""
    inner: Tuple[Any, ...]


def _require_elementwise(tx) -> None:
    if not getattr(tx, "elementwise", False):
        raise ValueError(
            "zero_sharded requires an optimizer that declares "
            "elementwise=True (adam/sgd qualify) — per-tensor-norm "
            "optimizers compute wrong trust ratios on flat chunks; see "
            "parallel.zero.zero1 for the full contract")


def zero_sharded(tx, plan: MeshPlan, *, level: int = 2,
                 decay_flags=None, **store_kw):
    """ZeRO state partitioning over ``plan``'s fsdp axis on flat buckets;
    a :class:`~apex_tpu_torch.training.FunctionalOptimizer`.

    * ``level`` 1/2: parameters whole (a plain tree), this rank's chunk
      of the optimizer state; the gradients reduce-scattered over fsdp,
      the chunk summed over dp, divided by the data world.
    * ``level`` 3: the parameters themselves are this rank's chunks of
      the padded flat buckets (a ``Packed``); build the step through
      :func:`make_mesh_train_step`, whose view gathers them.

    Both run with ``reduce_grads=False`` and ``axis_name=plan.all_axes``.
    ``store_kw`` (``max_bucket_elems``, ``decay_mask``) shape the store
    levels 1/2 pack; level 3 takes packed buckets, and the caller passes
    their store's ``decay_flags`` (a no-decay bucket updates with
    ``weight_decay=0.0``)."""
    from ..training import FunctionalOptimizer

    _require_elementwise(tx)
    if level not in (1, 2, 3):
        raise ValueError(f"zero level must be 1, 2, or 3, got {level}")
    if level < 3:
        return _zero12_tx(tx, plan, FunctionalOptimizer, store_kw)
    return _zero3_tx(tx, plan, FunctionalOptimizer, decay_flags=decay_flags)


def _no_decay(kw, decay: bool) -> dict:
    return kw if decay else {**kw, "weight_decay": 0.0}


def _zero12_tx(tx, plan: MeshPlan, FunctionalOptimizer, store_kw):
    """Whole parameters, sharded state: the bucketed zero1 update over
    the fsdp group, the chunk summed over dp, the mean over the data
    world."""
    cell: dict = {}
    n = plan.fsdp

    def _store(params) -> BucketStore:
        return cached_store(cell, params, **store_kw)

    def init(params):
        packed = _store(params).pack(params)
        return Zero1State(inner=tuple(
            tx.init(_chunk(_pad(b, n), n, plan.fsdp_index).clone())
            for b in packed.data))

    def update(grads, state, params, *, apply_mask=None, **kw):
        store = _store(params)
        fsdp_group = axis_group(plan.fsdp_axis)
        dp_group = axis_group(plan.dp_axis)
        packed_p = store.pack(params)
        packed_g = store.pack(grads, cast=True)
        new_data = list(packed_p.data)
        new_inner = list(state.inner)
        # reverse-topological issue order, as JAX's
        for bi in store.reverse_topological_order():
            flat_new, ni = _shard_one(
                packed_p.data[bi],
                packed_g.data[bi].to(packed_p.data[bi].dtype),
                state.inner[bi], tx, fsdp_group, n, plan.fsdp_index, n,
                plan.fsdp_axis, apply_mask,
                _no_decay(kw, store.decay_flags[bi]),
                pre=(dp_group, plan.dp_axis), denom=plan.data_world)
            new_data[bi] = flat_new
            new_inner[bi] = ni
        out = Packed(data=tuple(new_data), rest=packed_p.rest)
        return store.unpack(out), Zero1State(inner=tuple(new_inner))

    return FunctionalOptimizer(init=init, update=update, elementwise=True)


def _zero3_tx(tx, plan: MeshPlan, FunctionalOptimizer, decay_flags=None):
    """Sharded parameters and state: ``init`` takes this rank's chunks of
    the packed padded parameters; ``update`` gets each chunk's gradient
    summed over fsdp (the view's reduce-scatter), sums it over dp and
    divides by the data world."""

    def init(packed: Packed):
        if not isinstance(packed, Packed):
            raise TypeError(
                "zero level 3 stores params as fsdp-sharded flat buckets "
                "— build the step with make_mesh_train_step(..., zero=3), "
                "whose init packs the tree for you")
        return MeshZeroState(inner=tuple(tx.init(b) for b in packed.data))

    def update(grads: Packed, state, params: Packed, *,
               apply_mask=None, **kw):
        dp_group = axis_group(plan.dp_axis) if plan.dp > 1 else None
        new_data = list(params.data)
        new_inner = list(state.inner)
        for bi in range(len(params.data)):
            g = grads.data[bi].to(params.data[bi].dtype)
            if dp_group is not None:
                g = _all_reduce_(g.clone(memory_format=torch.contiguous_format),
                                 dp_group, "grads", plan.dp_axis)
            g = g / plan.data_world
            decay = decay_flags is None or decay_flags[bi]
            new_p, ni = tx.update(g, state.inner[bi], params.data[bi],
                                  apply_mask=apply_mask,
                                  **_no_decay(kw, decay))
            new_data[bi] = new_p.to(params.data[bi].dtype)
            new_inner[bi] = ni
        return (Packed(data=tuple(new_data), rest=params.rest),
                MeshZeroState(inner=tuple(new_inner)))

    return FunctionalOptimizer(init=init, update=update, elementwise=True)


# -- the step frontend --------------------------------------------------------

class _FsdpGather(torch.autograd.Function):
    """All-gather of this rank's chunk over fsdp; the backward
    reduce-scatters (sums) the gradient back to the chunk."""

    @staticmethod
    def forward(ctx, chunk, group, n, axis_name):
        ctx.group, ctx.n, ctx.axis_name = group, n, axis_name
        return _all_gather(chunk, group, n, axis_name)

    @staticmethod
    def backward(ctx, g):
        return (_reduce_scatter(g, ctx.group, ctx.n, ctx.axis_name,
                                op="reduce_scatter"), None, None, None)


def _gather_view(store: BucketStore, plan: MeshPlan,
                 gather_dtype=None) -> Callable:
    """The ZeRO-3 ``param_view``: each bucket's chunk all-gathered over
    fsdp (in ``gather_dtype`` on the wire when it is narrower than the
    bucket's float dtype, and back), cut to the bucket's size and
    unpacked to the template tree.  Inside the differentiated loss its
    backward is the gradient's reduce-scatter (in the wire dtype)."""
    wire = gather_dtype

    def view(packed: Packed):
        group = axis_group(plan.fsdp_axis)
        full = []
        for bi, b in enumerate(store.buckets):
            buf = packed.data[bi]
            cast = (wire is not None and buf.is_floating_point()
                    and buf.element_size() > torch.empty(
                        (), dtype=wire).element_size())
            sent = buf.to(wire) if cast else buf
            g = _FsdpGather.apply(sent, group, plan.fsdp, plan.fsdp_axis)
            g = g.to(buf.dtype) if cast else g
            full.append(g[:b.size])
        return store.unpack(Packed(data=tuple(full), rest=packed.rest))
    return view


class MeshTrainStep(NamedTuple):
    """Everything :func:`make_mesh_train_step` derived from one plan.

    ``step_fn(state, batch)`` takes this rank's rows
    (:meth:`MeshPlan.device_put_batch`); ``init`` gives this rank's state
    (its chunks of the sharded leaves)."""
    plan: MeshPlan
    zero: int
    init: Callable               # (params, model_state=None) -> TrainState
    step_fn: Callable            # (state, batch) -> (state, metrics)
    state_spec: Callable         # (state) -> TrainState of axis names
    gather_params: Callable      # (state) -> full parameter tree
    store: Any                   # zero-3 bucket store handle (else None)

    def wrap(self, fn, state):
        """A loop function ``(state, window, valid) -> (state, metrics)``
        (the StepPipeline contract) on this rank's rows of each global
        ``[K, batch, ...]`` window (JAX's ``shard_map`` with the window
        batch-sharded)."""
        del state                    # the state is this rank's already
        plan = self.plan

        def wrapped(s, window, valid):
            return fn(s, plan.device_put_window(window), valid)
        return wrapped

    def pipeline_wrap(self, state):
        """The ``wrap=`` argument of
        :class:`~apex_tpu_torch.runtime.StepPipeline`."""
        return lambda fn: self.wrap(fn, state)


def make_mesh_train_step(loss_fn: Callable, tx, plan: MeshPlan, *,
                         zero: int = 2,
                         opt_level: str = "O2",
                         max_bucket_elems: Optional[int] = None,
                         decay_mask=None,
                         gather_dtype=None,
                         has_model_state: bool = False,
                         **train_kw) -> MeshTrainStep:
    """Build a sharded training step from one :class:`MeshPlan`.

    ``loss_fn`` takes the FULL parameter tree; ``tx`` is an elementwise
    :class:`~apex_tpu_torch.training.FunctionalOptimizer`
    (``training.adam``/``training.sgd``); ``zero`` the level (the module
    docstring); ``train_kw`` pass through to
    :func:`~apex_tpu_torch.training.make_train_step` (``loss_scale``,
    ``accum_steps``, ``scale_window``, ...).

    ``zero=3`` needs fp32 storage (O0/O1/O2/O4: the buckets are the
    masters).  ``gather_dtype`` (zero 3 only): the view's wire dtype,
    e.g. ``torch.bfloat16``; None keeps the exact fp32 wire."""
    from .. import training

    if zero not in (1, 2, 3):
        raise ValueError(f"zero level must be 1, 2, or 3, got {zero}")
    if zero == 3 and opt_level not in ("O0", "O1", "O2", "O4"):
        raise ValueError(
            f"zero=3 stores params as fp32 flat buckets (the masters); "
            f"opt_level {opt_level!r} stores reduced precision — use "
            f"O0/O1/O2/O4, or zero<=2 for O3")
    store_kw = {}
    if max_bucket_elems is not None:
        store_kw["max_bucket_elems"] = max_bucket_elems
    if decay_mask is not None:
        store_kw["decay_mask"] = decay_mask
    if zero != 3 and gather_dtype is not None:
        raise ValueError(
            "gather_dtype shapes the ZeRO-3 param_view wire; zero<3 "
            "replicates params and never gathers them — drop the "
            "argument or use zero=3")

    def state_spec(state):
        return _derive_spec(state, plan, zero)

    if zero < 3:
        z_tx = zero_sharded(tx, plan, level=zero, **store_kw)
        init_fn, step_fn = training.make_train_step(
            loss_fn, z_tx, opt_level=opt_level, axis_name=plan.all_axes,
            reduce_grads=False, has_model_state=has_model_state,
            **train_kw)
        return MeshTrainStep(plan=plan, zero=zero, init=init_fn,
                             step_fn=step_fn, state_spec=state_spec,
                             gather_params=lambda state: state.params,
                             store=None)

    # -- zero 3 --------------------------------------------------------------
    _require_elementwise(tx)
    cell: dict = {}              # cached_store signature -> BucketStore
    z3_holder: dict = {}         # id(store) -> (init_fn, step_fn)

    def _build(params_template):
        store = cached_store(cell, params_template, **store_kw)
        built = z3_holder.get(id(store))
        if built is None:
            z_tx = zero_sharded(tx, plan, level=3,
                                decay_flags=store.decay_flags)
            built = training.make_train_step(
                loss_fn, z_tx, opt_level=opt_level,
                axis_name=plan.all_axes, reduce_grads=False,
                has_model_state=has_model_state,
                param_view=_gather_view(store, plan, gather_dtype),
                **train_kw)
            z3_holder.clear()            # one live template at a time
            z3_holder[id(store)] = built
            z3_holder["latest"] = built
        return store, built

    def init(params, model_state=None):
        store, (init_fn, _) = _build(params)
        packed = store.pack(params)
        mine = Packed(
            data=tuple(_chunk(_pad(b, plan.fsdp), plan.fsdp,
                              plan.fsdp_index).clone()
                       for b in packed.data),
            rest=packed.rest)
        return init_fn(mine, model_state)

    def step_fn(state, batch):
        built = z3_holder.get("latest")
        if built is None:
            raise RuntimeError(
                "make_mesh_train_step(zero=3): call ms.init(params) "
                "before using step_fn — the bucket index map is built "
                "from the first init's parameter template")
        return built[1](state, batch)

    def gather_params(state):
        # the full tree from this rank's chunks: an all-gather over fsdp
        # that every rank makes (the export boundary, never in the step)
        store = _latest_store(cell)
        group = axis_group(plan.fsdp_axis)
        full = [_all_gather(state.params.data[bi].detach(), group,
                            plan.fsdp, plan.fsdp_axis)[:b.size]
                for bi, b in enumerate(store.buckets)]
        return store.unpack(Packed(data=tuple(full),
                                   rest=state.params.rest))

    return MeshTrainStep(plan=plan, zero=3, init=init, step_fn=step_fn,
                         state_spec=state_spec,
                         gather_params=gather_params,
                         store=_StoreRef(cell))


def _latest_store(cell: dict) -> BucketStore:
    if not cell:
        raise RuntimeError(
            "ZeRO-3 bucket store not built yet — call ms.init(params) "
            "first")
    return next(reversed(cell.values()))


class _StoreRef:
    """Late-bound handle to the ZeRO-3 BucketStore (built at ``init``):
    ``ms.store()`` returns it, attribute access passes through."""

    def __init__(self, cell):
        self._cell = cell

    def __call__(self) -> BucketStore:
        return _latest_store(self._cell)

    def __getattr__(self, name):
        return getattr(_latest_store(self._cell), name)


def _derive_spec(state, plan: MeshPlan, zero: int):
    """The state's tree of axis names: ``fsdp`` for a leaf a rank holds
    as its chunk (the flat buckets of parameters at zero 3 and of the
    optimizer state), None for a replicated one."""
    from ..training import TrainState

    def flat(leaf):
        return (plan.fsdp_axis if isinstance(leaf, torch.Tensor)
                and leaf.dim() >= 1 else None)
    if zero >= 3:
        params_spec = Packed(
            data=tuple(plan.fsdp_axis for _ in state.params.data),
            rest=tuple(None for _ in state.params.rest))
    else:
        params_spec = pytree.tree_map(lambda _: None, state.params)
    return TrainState(
        params=params_spec,
        opt_state=pytree.tree_map(flat, state.opt_state),
        scaler=pytree.tree_map(lambda _: None, state.scaler),
        model_state=pytree.tree_map(lambda _: None, state.model_state))
