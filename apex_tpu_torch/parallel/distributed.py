"""Data parallelism over ``torch.distributed`` — counterpart of
``apex_tpu/parallel/distributed.py``.

JAX's mesh axis ``"data"`` is a process group here, one device a rank
(:mod:`apex_tpu_torch.parallel.multiproc` makes it).  An ``axis_name``
is ``"data"`` (the default group), a ``ProcessGroup``, an axis of the
mesh :func:`register_mesh` laid over the world (a
:class:`~apex_tpu_torch.parallel.mesh.MeshPlan` registers ``dp``,
``fsdp`` and ``tp``), or a tuple of such axes, which names the group
over their product (JAX's ``axis_name=("dp", "fsdp")``).  Rank lists
(``axis_index_groups``, SyncBatchNorm's ``process_group``, a mesh
axis's groups) become sub-groups made with ``dist.new_group`` the first
time they are used.  Every rank makes every sub-group, in the same
order, as the reference's ``create_syncbn_process_group`` requires, so
every rank must use the same lists and axes in the same order.

Every collective is an ``all_reduce`` or a ``broadcast``: JAX needs no
other (``psum``; its broadcast is a mask and a ``psum``), and they are
what gloo takes on CUDA tensors.  The DDP contract is the JAX one:

* parameters made equal at start (:func:`broadcast_params`, exact);
* gradients averaged by step time (:func:`reduce_gradients`, with the
  reference's ``gradient_predivide_factor`` and
  ``allreduce_always_fp32`` arithmetic);
* ``no_sync`` for gradient accumulation.

There are no backward hooks: as in JAX, the reduction happens where the
caller (or :func:`apex_tpu_torch.training.make_train_step`) asks for it.
:func:`group_psum` is differentiable: its backward all-reduces the
cotangent (the transpose of ``psum`` is ``psum``), which gives
SyncBatchNorm the reference's ``mean_dy`` / ``mean_dy_xmu`` collective.

Each kind of collective has a counter in ``COLLECTIVES`` (registered
with the kernels' in :mod:`apex_tpu_torch._build`, so a captured graph's
replays count what they issue): ``grads`` (:func:`reduce_gradients`),
``bn_stats`` and ``bn_grad`` (:func:`group_psum` forward and backward:
SyncBatchNorm's statistics are its one use in the port), ``state``
(:func:`pmean_tree`), ``overflow`` (:func:`por`) and ``broadcast``;
the sharding primitives add ``reduce_scatter`` and ``all_gather``
(ZeRO-1), ``tp_psum`` (a row-parallel product's sum and its
transpose), ``all_to_all`` (expert dispatch and Ulysses) and
``permute`` (:func:`ppermute`: a pipeline's or a ring's rotation, one a
send-and-receive pair).

Gloo moves only ``all_reduce`` and ``broadcast`` of CUDA tensors.  A
send and receive, an ``all_to_all``, a reduce-scatter or an all-gather
of CUDA tensors over a gloo group raises, unless the caller asks for
:func:`host_staging`: inside it each such collective copies its CUDA
tensors to the host, runs there and copies the result back, and adds
one to ``COLLECTIVES["host_staged"]`` beside its own kind's counter.

Telemetry: with a recorder, each collective issued is noted as JAX's
``collective`` event (``op`` ``psum`` or ``broadcast``, the ``axis``,
the ``bytes`` on the wire, ``n`` tensors, ``dtype``, ``participants``):
one event a :func:`reduce_gradients` or :func:`broadcast_params` call
(its leaves or buckets summed, as JAX sums them), one a
:func:`group_psum`, :func:`por` or :func:`pmean_tree` all-reduce.  JAX
notes at trace time; the port notes when a collective is issued eagerly
or recorded into a graph, never per replay, and inside a
:class:`~apex_tpu_torch.runtime.StepPipeline` only in the first step of
the call that captures (see :mod:`apex_tpu_torch.telemetry.events`).
"""

from __future__ import annotations

import contextlib
import itertools
import math
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn
from torch.utils import _pytree as pytree

from .. import _build

__all__ = ["DistributedDataParallel", "Reducer", "reduce_gradients",
           "broadcast_params", "group_psum", "axis_group", "axis_size",
           "axis_index", "register_mesh", "ppermute", "por", "pmean_tree",
           "COLLECTIVES"]

_WORLD_AXIS = "data"


class _Collective:
    """The launch counter of one kind of collective."""

    def __init__(self, name: str):
        self.__name__ = name

    def __repr__(self):
        return f"<collective {self.__name__}: {self.launches}>"


#: one counter a kind; each adds one where a collective of its kind is
#: issued on the device
COLLECTIVES = {k: _build.counted(_Collective(f"collective_{k}"))
               for k in ("grads", "bn_stats", "bn_grad", "state",
                         "overflow", "broadcast", "reduce_scatter",
                         "all_gather", "tp_psum", "all_to_all",
                         "permute", "host_staged")}

#: whether collectives gloo cannot move on CUDA tensors go through the
#: host (:func:`host_staging`)
_STAGING = {"on": False}


@contextlib.contextmanager
def host_staging():
    """Inside the context, a send and receive, ``all_to_all``,
    reduce-scatter or all-gather of CUDA tensors over a gloo group runs
    on host copies (gloo takes only ``all_reduce`` and ``broadcast`` of
    CUDA tensors, and aborts on the others), each counted once in
    ``COLLECTIVES["host_staged"]``.  Outside it such a call raises."""
    saved = _STAGING["on"]
    _STAGING["on"] = True
    try:
        yield
    finally:
        _STAGING["on"] = saved


def _staged(group, x: torch.Tensor, what: str) -> bool:
    """Whether a ``what`` of ``x`` over ``group`` runs on host copies:
    a CUDA tensor on a gloo group inside :func:`host_staging` (counted);
    outside it, such a call raises."""
    if not x.is_cuda or dist.get_backend(group) != "gloo":
        return False
    if not _STAGING["on"]:
        raise RuntimeError(
            f"gloo moves no {what} of CUDA tensors (only all_reduce and "
            f"broadcast): use NCCL, or stage it through the host inside "
            f"apex_tpu_torch.parallel.distributed.host_staging()")
    COLLECTIVES["host_staged"].launches += 1
    return True

#: rank lists -> this rank's sub-group (made once, by every rank)
_SUBGROUPS: dict = {}

#: the mesh laid over the world: its axis names and sizes, row-major
_MESH: dict = {"names": (), "shape": ()}


def register_mesh(names: Sequence[str], shape: Sequence[int]) -> None:
    """Lay a mesh of axes ``names`` with sizes ``shape`` over the world,
    row-major (JAX's ``Mesh(devices.reshape(shape), names)`` over
    ``jax.devices()``): rank ``r`` sits at ``unravel(r, shape)``.  Each
    name (and a tuple of them) then resolves in :func:`axis_group`.
    Every rank makes every single axis's groups here, in mesh order; a
    tuple's are made at its first use."""
    names, shape = tuple(names), tuple(int(n) for n in shape)
    if len(names) != len(shape) or len(set(names)) != len(names):
        raise ValueError(f"mesh axes {names} and sizes {shape} must pair "
                         f"up, each name once")
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("a mesh needs a process group: call "
                           "apex_tpu_torch.parallel.multiproc.initialize() "
                           "first")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {dict(zip(names, shape))} has "
                         f"{math.prod(shape)} places for {world} ranks")
    _MESH.update(names=names, shape=shape)
    for name in names:
        _mesh_group((name,))


def _mesh_group(axes: tuple):
    """This rank's group over the mesh ``axes`` (in mesh order): the
    ranks that share its coordinates on every other axis."""
    names, shape = _MESH["names"], _MESH["shape"]
    pos = [names.index(a) for a in axes]
    if pos != sorted(pos):
        raise ValueError(f"axes {axes} must follow the mesh's order "
                         f"{names}")
    coords = list(itertools.product(*(range(n) for n in shape)))
    groups: dict = {}
    for rank, c in enumerate(coords):
        key = tuple(x for i, x in enumerate(c) if i not in pos)
        groups.setdefault(key, []).append(rank)
    return _subgroup([groups[k] for k in sorted(groups)])


def axis_group(axis_name, axis_index_groups=None):
    """The process group an ``axis_name`` (and ``axis_index_groups``)
    names: a mesh axis of :func:`register_mesh`, or a tuple of them, its
    group; ``"data"`` otherwise the default group; a ``ProcessGroup``
    itself; None None.  Rank lists give this rank's sub-group of the
    world."""
    if axis_name is None:
        if axis_index_groups:
            raise ValueError("axis_index_groups needs an axis_name")
        return None
    if isinstance(axis_name, (tuple, list)):
        axes = tuple(axis_name)
        if len(axes) == 1:
            return axis_group(axes[0], axis_index_groups)
        unknown = [a for a in axes if a not in _MESH["names"]]
        if unknown:
            raise ValueError(f"axes {unknown} are not axes of the "
                             f"registered mesh {_MESH['names']} "
                             f"(register_mesh / MeshPlan)")
        if axis_index_groups:
            raise ValueError("axis_index_groups need a single axis")
        return _mesh_group(axes)
    if isinstance(axis_name, str):
        if axis_name in _MESH["names"]:
            if axis_index_groups:
                raise ValueError("axis_index_groups are ranks of the "
                                 "world: they need axis_name='data'")
            return _mesh_group((axis_name,))
        if axis_name != _WORLD_AXIS:
            raise ValueError(f"axis_name {axis_name!r}: the port's one "
                             f"unregistered axis is {_WORLD_AXIS!r}; "
                             f"register a mesh (register_mesh, MeshPlan) "
                             f"or pass a ProcessGroup for any other")
        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError(
                f"axis_name={_WORLD_AXIS!r} needs a process group: call "
                f"apex_tpu_torch.parallel.multiproc.initialize() first")
        group = dist.group.WORLD
    else:
        group = axis_name
    if not axis_index_groups:
        return group
    if group is not dist.group.WORLD:
        raise ValueError("axis_index_groups are ranks of the world: they "
                         "need axis_name='data'")
    return _subgroup(axis_index_groups)


def axis_size(axis_name) -> int:
    """The number of ranks on ``axis_name`` (JAX's ``_axis_size``)."""
    return dist.get_world_size(axis_group(axis_name))


def axis_index(axis_name) -> int:
    """This rank's index on ``axis_name`` (JAX's ``lax.axis_index``; a
    tuple's is row-major over its axes)."""
    return dist.get_rank(axis_group(axis_name))


def _subgroup(axis_index_groups):
    key = tuple(tuple(int(r) for r in g) for g in axis_index_groups)
    found = _SUBGROUPS.get(key)
    if found is not None:
        return found
    world, rank = dist.get_world_size(), dist.get_rank()
    if sorted(r for g in key for r in g) != list(range(world)):
        raise ValueError(f"axis_index_groups {[list(g) for g in key]} must "
                         f"hold every rank of the world ({world}) once")
    if len(key) == 1:
        mine = dist.group.WORLD
    else:
        mine = None
        for g in key:                    # every rank makes every group
            pg = dist.new_group(list(g))
            if rank in g:
                mine = pg
    _SUBGROUPS[key] = mine
    return mine


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _note_collective(op: str, axis_name, group, nbytes: int, n: int,
                     dtypes) -> None:
    """One ``collective`` event on the active recorder (see the module
    docstring); ``dtypes`` the set of wire dtypes ("mixed" for more than
    one, as JAX labels them)."""
    from ..telemetry import events as _events
    rec = _events.get_recorder()
    if rec is None or not n or not _events._notes_open():
        return
    axis = ((axis_name,) if isinstance(axis_name, str)
            else tuple(axis_name) if isinstance(axis_name, (tuple, list))
            else ("group",))
    dtype = (next(iter(dtypes)) if len(dtypes) == 1
             else "mixed" if dtypes else None)
    rec.note_collective(op, axis, nbytes, n, dtype=dtype,
                        participants=dist.get_world_size(group))


def _all_reduce_(t: torch.Tensor, group, kind: str,
                 axis_name=None) -> torch.Tensor:
    """Sum ``t`` (owned by the caller, contiguous) over ``group`` in
    place; counts one collective of ``kind`` and, given ``axis_name``,
    notes it (a caller that sums several notes them itself)."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    COLLECTIVES[kind].launches += 1
    if axis_name is not None:
        _note_collective("psum", axis_name, group,
                         t.numel() * t.element_size(), 1,
                         {_dtype_name(t.dtype)})
    return t


def _owned(x: torch.Tensor) -> torch.Tensor:
    return x.detach().clone(memory_format=torch.contiguous_format)


def _shift(x: torch.Tensor, group, step: int, axis_name) -> torch.Tensor:
    """``x`` sent to the rank ``step`` places on (cyclically) and the one
    from the rank ``step`` places back received: one ``batch_isend_irecv``
    pair, counted as one ``permute``."""
    n = dist.get_world_size(group)
    if n == 1:
        return x.clone()
    r = dist.get_rank(group)
    dev = x.device
    x = x.contiguous()
    if _staged(group, x, "send and receive"):
        x = x.cpu()
    out = torch.empty_like(x)
    to = dist.get_global_rank(group, (r + step) % n)
    frm = dist.get_global_rank(group, (r - step) % n)
    for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, x, to, group),
            dist.P2POp(dist.irecv, out, frm, group)]):
        req.wait()
    out = out.to(dev)
    COLLECTIVES["permute"].launches += 1
    _note_collective("ppermute", axis_name, group,
                     x.numel() * x.element_size(), 1,
                     {_dtype_name(x.dtype)})
    return out


class _Rotate(torch.autograd.Function):
    """JAX's ``ppermute`` to the next rank; the backward sends the
    cotangent back one rank."""

    @staticmethod
    def forward(ctx, x, group, axis_name):
        ctx.group, ctx.axis_name = group, axis_name
        return _shift(x, group, 1, axis_name)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1, ctx.axis_name), None, None


def ppermute(x: torch.Tensor, axis_name) -> torch.Tensor:
    """JAX's ring ``ppermute`` (``perm = [(i, (i + 1) % n)]``) over
    ``axis_name``: each rank's ``x`` goes to the next rank and the
    previous rank's comes back; differentiable (the backward rotates the
    cotangent the other way).  The pipeline's and the ring's rotation."""
    group = axis_group(axis_name)
    if group is None:
        raise ValueError("ppermute needs an axis_name (a process group)")
    return _Rotate.apply(x, group, axis_name)


class _PSum(torch.autograd.Function):
    """``psum`` with its transpose: the backward all-reduces the
    cotangent over the same group."""

    @staticmethod
    def forward(ctx, x, group, axis_name):
        ctx.group, ctx.axis_name = group, axis_name
        return _all_reduce_(_owned(x), group, "bn_stats", axis_name)

    @staticmethod
    def backward(ctx, g):
        return (_all_reduce_(_owned(g), ctx.group, "bn_grad",
                             ctx.axis_name), None, None)


def group_psum(x: torch.Tensor, axis_name=_WORLD_AXIS,
               axis_index_groups=None) -> torch.Tensor:
    """``psum`` of ``x`` over ``axis_name``, or over this rank's group of
    ``axis_index_groups``: a new tensor, differentiable (the backward
    is the same sum of the cotangent).

    Sub-groups are native in ``torch.distributed`` (``dist.new_group``),
    so the JAX function's butterfly over ``ppermute`` and its
    all-gather-and-mask fallback for irregular groups have no
    counterpart here: every group size is one ``all_reduce``."""
    group = axis_group(axis_name, axis_index_groups)
    return _PSum.apply(x, group, axis_name)


def por(flag: torch.Tensor, axis_name=_WORLD_AXIS) -> torch.Tensor:
    """Logical OR of a bool tensor over the group: an ``all_reduce`` of
    it as int32, then ``> 0`` (JAX's ``_por_varying``), so every rank
    skips a step or takes it together."""
    group = axis_group(axis_name)
    return _all_reduce_(flag.to(torch.int32), group, "overflow",
                        axis_name) > 0


def pmean_tree(tree, axis_name=_WORLD_AXIS):
    """The tree with every float leaf replaced by its mean over the
    group: one flat ``all_reduce`` a dtype (XLA combines JAX's per-leaf
    ``pmean``s the same way), then the sum over the group's size.  Other
    leaves pass through."""
    group = axis_group(axis_name)
    n = dist.get_world_size(group)
    leaves, spec = pytree.tree_flatten(tree)
    by_dtype: dict = {}
    for i, x in enumerate(leaves):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            by_dtype.setdefault(x.dtype, []).append(i)
    out = list(leaves)
    for idx in by_dtype.values():
        flat = torch.cat([leaves[i].detach().reshape(-1) for i in idx])
        _all_reduce_(flat, group, "state", axis_name)
        if n != 1:
            flat = flat / n
        for i, piece in zip(idx, torch.split(
                flat, [leaves[i].numel() for i in idx])):
            out[i] = piece.view(leaves[i].shape)
    return pytree.tree_unflatten(out, spec)


def reduce_gradients(grads, axis_name=_WORLD_AXIS, *,
                     gradient_average: bool = True,
                     gradient_predivide_factor: float = 1.0,
                     allreduce_always_fp32: bool = False,
                     axis_index_groups: Optional[Sequence[Sequence[int]]]
                     = None,
                     world_size: Optional[int] = None,
                     bucket_store=None):
    """All-reduce a gradient tree over ``axis_name`` (JAX ``:197-354``).

    Per float leaf: optionally up to fp32, divided by
    ``gradient_predivide_factor``, summed over the group, then divided
    by ``world / predivide`` when averaging (or multiplied back by the
    predivide factor when not), and cast back; other leaves pass
    through.  ``world_size`` defaults to the group's size (a sub-group's
    under ``axis_index_groups``).  Returns a new tree.

    ``bucket_store`` (a :class:`~apex_tpu_torch.multi_tensor.BucketStore`
    of the gradient tree) is the flat-bucket path: the gradients are
    packed into per-dtype buffers and each bucket is one ``all_reduce``,
    issued in the store's ``reverse_topological_order()``; an already
    ``Packed`` tree stays packed."""
    from ..multi_tensor.buckets import Packed

    group = axis_group(axis_name, axis_index_groups)
    if world_size is None:
        world_size = dist.get_world_size(group)
    # one collective event for the call: its leaves or buckets summed
    coll = {"bytes": 0, "n": 0, "dtypes": set()}

    def one(g):
        if not (isinstance(g, torch.Tensor) and g.is_floating_point()):
            return g
        orig_dtype, x = g.dtype, g
        if allreduce_always_fp32:
            x = x.float()
        if gradient_predivide_factor != 1.0:
            x = x / gradient_predivide_factor
        coll["bytes"] += x.numel() * x.element_size()
        coll["n"] += 1
        coll["dtypes"].add(_dtype_name(x.dtype))
        x = _all_reduce_(_owned(x) if x is g else x.contiguous(), group,
                         "grads")
        if gradient_average:
            postdiv = world_size / gradient_predivide_factor
            if postdiv != 1.0:
                x = x / postdiv
        elif gradient_predivide_factor != 1.0:
            x = x * gradient_predivide_factor
        return x.to(orig_dtype)

    if bucket_store is not None or isinstance(grads, Packed):
        packed = (grads if isinstance(grads, Packed)
                  else bucket_store.pack(grads))
        order = (bucket_store.reverse_topological_order()
                 if bucket_store is not None
                 else tuple(range(len(packed.data))))
        data = list(packed.data)
        for bi in order:
            data[bi] = one(data[bi])
        out = Packed(data=tuple(data), rest=packed.rest)
        _note_collective("psum", axis_name, group, coll["bytes"],
                         coll["n"], coll["dtypes"])
        return out if isinstance(grads, Packed) else bucket_store.unpack(out)
    out = pytree.tree_map(one, grads)
    _note_collective("psum", axis_name, group, coll["bytes"], coll["n"],
                     coll["dtypes"])
    return out


def broadcast_params(params, axis_name=_WORLD_AXIS, root: int = 0,
                     axis_index_groups=None):
    """Every rank's ``params`` replaced by rank ``root``'s (``root`` an
    index in the group), bit for bit: one ``broadcast`` a float leaf.
    Returns a new tree; other leaves pass through."""
    group = axis_group(axis_name, axis_index_groups)
    src = dist.get_global_rank(group, root)
    coll = {"bytes": 0, "n": 0, "dtypes": set()}

    def one(p):
        if not (isinstance(p, torch.Tensor) and p.is_floating_point()):
            return p
        out = _owned(p)
        dist.broadcast(out, src=src, group=group)
        COLLECTIVES["broadcast"].launches += 1
        coll["bytes"] += out.numel() * out.element_size()
        coll["n"] += 1
        coll["dtypes"].add(_dtype_name(out.dtype))
        return out

    out = pytree.tree_map(one, params)
    _note_collective("broadcast", axis_name, group, coll["bytes"],
                     coll["n"], coll["dtypes"])
    return out


class DistributedDataParallel(nn.Module):
    """The reference wrapper's options over :func:`reduce_gradients`.

    ``forward`` is the wrapped module's.  ``message_size``,
    ``num_allreduce_streams``, ``allreduce_communicators``,
    ``retain_allreduce_buffers`` and ``prof`` are taken for the
    reference's signature and change nothing (NCCL schedules the
    collectives; there are no hooks to delay, so ``delay_allreduce``
    changes nothing either).  ``shared_param`` is refused, as the
    reference deprecated it."""

    def __init__(self, module: Optional[nn.Module] = None,
                 axis_name=_WORLD_AXIS, message_size: int = 10000000,
                 delay_allreduce: bool = False, shared_param=None,
                 allreduce_trigger_params=None,
                 retain_allreduce_buffers: bool = False,
                 allreduce_always_fp32: bool = False,
                 num_allreduce_streams: int = 1,
                 allreduce_communicators=None,
                 gradient_average: bool = True,
                 gradient_predivide_factor: float = 1.0,
                 axis_index_groups=None, prof: bool = False,
                 bucket_store=None):
        super().__init__()
        if shared_param is not None:
            raise ValueError("shared_param is deprecated (reference "
                             "distributed.py:149-151); use delay_allreduce.")
        self.module = module
        self.axis_name = axis_name
        self.delay_allreduce = delay_allreduce
        self.allreduce_always_fp32 = allreduce_always_fp32
        self.gradient_average = gradient_average
        self.gradient_predivide_factor = gradient_predivide_factor
        self.axis_index_groups = axis_index_groups
        self.retain_allreduce_buffers = retain_allreduce_buffers
        self.prof = prof
        self.bucket_store = bucket_store
        self._disable_allreduce = False

    def forward(self, *args, **kwargs):
        if self.module is None:
            raise ValueError("DistributedDataParallel wraps no module")
        return self.module(*args, **kwargs)

    def sync_params(self, params=None, root: int = 0):
        """``params`` (a tree) broadcast from ``root``; with none, the
        wrapped module's parameters and buffers, in place."""
        if params is not None:
            return broadcast_params(params, self.axis_name, root,
                                    self.axis_index_groups)
        tensors = [*self.module.parameters(), *self.module.buffers()]
        synced = broadcast_params([t.detach() for t in tensors],
                                  self.axis_name, root,
                                  self.axis_index_groups)
        with torch.no_grad():
            for t, s in zip(tensors, synced):
                t.copy_(s)
        return None

    def reduce_gradients(self, grads=None):
        """``grads`` (a tree) reduced; with none, every ``.grad`` of the
        wrapped module, in place.  Inside :meth:`no_sync` nothing is
        reduced."""
        if self._disable_allreduce:
            return grads
        kw = dict(gradient_average=self.gradient_average,
                  gradient_predivide_factor=self.gradient_predivide_factor,
                  allreduce_always_fp32=self.allreduce_always_fp32,
                  axis_index_groups=self.axis_index_groups)
        if grads is not None:
            return reduce_gradients(grads, self.axis_name,
                                    bucket_store=self.bucket_store, **kw)
        params = [p for p in self.module.parameters() if p.grad is not None]
        reduced = reduce_gradients([p.grad for p in params], self.axis_name,
                                   **kw)
        for p, g in zip(params, reduced):
            p.grad.copy_(g)
        return None

    @contextlib.contextmanager
    def no_sync(self):
        """No gradient reduction inside the context (the reference's
        ``disable_allreduce``): the accumulation idiom."""
        saved = self._disable_allreduce
        self._disable_allreduce = True
        try:
            yield
        finally:
            self._disable_allreduce = saved

    def wrap_grad_fn(self, grad_fn: Callable) -> Callable:
        """``grad_fn`` whose gradients come out reduced (a ``(value,
        grads)`` pair keeps its value)."""
        def wrapped(*args, **kwargs):
            out = grad_fn(*args, **kwargs)
            if isinstance(out, tuple) and len(out) == 2:
                value, grads = out
                return value, self.reduce_gradients(grads)
            return self.reduce_gradients(out)
        return wrapped


class Reducer:
    """A manually triggered all-reduce (reference ``Reducer``): of the
    tree given to :meth:`reduce`, or of the target given at construction
    (an ``nn.Module``: its ``.grad``s in place)."""

    def __init__(self, module_or_grads_list=None, axis_name=_WORLD_AXIS,
                 axis_index_groups=None):
        self.axis_name = axis_name
        self.axis_index_groups = axis_index_groups
        self.target = module_or_grads_list

    def reduce(self, tree=None, average: bool = True):
        tree = tree if tree is not None else self.target
        kw = dict(gradient_average=average,
                  axis_index_groups=self.axis_index_groups)
        if isinstance(tree, nn.Module):
            params = [p for p in tree.parameters() if p.grad is not None]
            for p, g in zip(params, reduce_gradients(
                    [p.grad for p in params], self.axis_name, **kw)):
                p.grad.copy_(g)
            return None
        return reduce_gradients(tree, self.axis_name, **kw)
