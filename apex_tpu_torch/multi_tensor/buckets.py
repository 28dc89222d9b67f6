"""Flat-bucket parameter engine: whole-model sweeps over a few large
buffers — counterpart of ``apex_tpu/multi_tensor/buckets.py``.

:class:`BucketStore` packs the float leaves of a tree into one 1-D
buffer per ``(dtype, weight-decay flag)`` key (split further by
``max_bucket_elems``), from an index map built once from the tree's
shapes and dtypes.  An optimizer can then keep its moments as
:class:`Packed` buckets across steps, so an update is a few
``torch._foreach_*`` launches over a few large buffers whatever the
number of leaves, and an overflow check is one ``isfinite`` reduction a
bucket.

Design points, as in the JAX store:

* **Exact dtypes.**  Buckets are keyed by dtype, so a ``pack``/``unpack``
  round trip is the identity, bit for bit.
* **Non-float passthrough.**  Integer and bool leaves travel in
  ``Packed.rest`` untouched.
* **Leaf order.**  Leaves are ordered as JAX flattens the flax tree of
  the same parameters: the keys of every mapping sorted, a ``.`` in a
  ``state_dict`` name read as a level of the flax tree
  (``block_10.ln1.scale`` after ``block_1.mlp_up.kernel``), sequences in
  their order.  So the port's store and the JAX store of a converted tree
  lay out the same buckets, and a ``Packed`` buffer crosses
  :mod:`apex_tpu_torch.convert` unchanged.  A leaf index (``view``,
  ``leaf_order``, ``_Bucket.leaf_ids``) counts in that order; ``unpack``
  gives the tree back in the template's own container order.
* **Per-leaf reductions without segment ids.**  The per-leaf sums and
  maxima reduce over per-leaf views of a bucket with one
  ``torch._foreach_norm`` (a few launches), where JAX builds a
  per-element segment map; :meth:`segment_ids` stays as an API.  The
  sums therefore add in another order than JAX's ``segment_sum``.

``Packed`` is a ``NamedTuple``, so torch's pytree, the capture of
:mod:`apex_tpu_torch.cache` and the step pipeline's state copies see
through it.  ``pack_jit`` and ``unpack_jit`` are plain aliases of
``pack`` and ``unpack``: torch has nothing to compile (a captured step
is the port's one program).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree

__all__ = ["BucketStore", "Packed", "cached_store", "padded_shard_len"]


def padded_shard_len(size: int, num_shards: int) -> int:
    """Length of a flat bucket padded to divide evenly over
    ``num_shards`` (the JAX package's one padding rule for sharded
    optimizer state and its checkpoints)."""
    return -(-int(size) // int(num_shards)) * int(num_shards)


def _signature(template) -> tuple:
    leaves, spec = pytree.tree_flatten(template)
    return (repr(spec), tuple(
        (tuple(x.shape), x.dtype) if isinstance(x, torch.Tensor)
        else type(x).__name__ for x in leaves))


def cached_store(cell: dict, template, **kwargs) -> "BucketStore":
    """One :class:`BucketStore` per (tree structure, shapes, dtypes)
    signature of ``template``, kept in the caller's ``cell`` dict, so a
    reused lazy-store optimizer never packs against a stale index map.
    ``kwargs`` (``decay_mask``, ``max_bucket_elems``) shape the store but
    not the key: pass a fresh ``cell`` per configuration."""
    key = _signature(template)
    store = cell.get(key)
    if store is None:
        store = cell[key] = BucketStore(template, **kwargs)
    return store


class Packed(NamedTuple):
    """A tree packed by a :class:`BucketStore`: ``data`` one 1-D tensor a
    bucket (the store's bucket order), ``rest`` the non-float leaves in
    the store's leaf order."""
    data: Tuple[Any, ...]
    rest: Tuple[Any, ...]


class _Bucket(NamedTuple):
    """Static index map of one bucket."""
    dtype: torch.dtype
    decay: bool                      # weight-decay flag of this bucket
    leaf_ids: Tuple[int, ...]        # leaf indices (the store's order)
    offsets: Tuple[int, ...]         # element offset of each segment
    sizes: Tuple[int, ...]           # element count of each segment
    shapes: Tuple[Tuple[int, ...], ...]
    size: int                        # elements in the bucket


def _sort_key(path) -> tuple:
    """The place of a leaf in JAX's flattening of the flax tree: mapping
    keys sorted level by level (a dotted ``state_dict`` name is one level
    per part), sequence and namedtuple fields in order."""
    key = []
    for entry in path:
        if isinstance(entry, pytree.MappingKey):
            key += [(0, part) for part in str(entry.key).split(".")]
        elif isinstance(entry, pytree.SequenceKey):
            key.append((1, entry.idx))
        else:                                   # namedtuple field
            key.append((1, str(entry)))
    return tuple(key)


def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


class BucketStore:
    """Static index map packing a tree's float leaves into 1-D buckets,
    one per ``(dtype, decay)`` key in order of first appearance.

    ``decay_mask`` (optional): a tree of Python bools shaped like
    ``template``; leaves marked ``False`` go to separate no-decay
    buckets, so a bucketed optimizer applies weight decay per bucket.
    ``max_bucket_elems`` (optional) caps a bucket's elements, starting a
    new bucket of the same key in leaf order (a larger leaf gets a bucket
    of its own; leaves are never split).  Only shapes, dtypes and the
    device of the template's leaves are read."""

    def __init__(self, template, *, decay_mask=None,
                 max_bucket_elems: Optional[int] = None):
        paths, self.treedef = pytree.tree_flatten_with_path(template)
        self.n_leaves = len(paths)
        #: the store's leaf order as indices into the template's own
        #: flattening (JAX's order of the converted tree)
        self._order = sorted(range(self.n_leaves),
                             key=lambda i: _sort_key(paths[i][0]))
        leaves = [paths[i][1] for i in self._order]
        self.device = next((x.device for x in leaves
                            if isinstance(x, torch.Tensor)),
                           torch.device("cpu"))
        if decay_mask is None:
            mask = [True] * self.n_leaves
        else:
            flat = pytree.tree_leaves(decay_mask)
            if len(flat) != self.n_leaves:
                raise ValueError(f"decay_mask has {len(flat)} leaves, "
                                 f"template has {self.n_leaves}")
            mask = [bool(flat[i]) for i in self._order]
        if max_bucket_elems is not None and max_bucket_elems < 1:
            raise ValueError(
                f"max_bucket_elems must be >= 1, got {max_bucket_elems}")
        self.max_bucket_elems = max_bucket_elems

        self._slots: list = [None] * self.n_leaves
        self._rest_ids: list = []
        order: dict = {}
        chunk_of: dict = {}
        for i, leaf in enumerate(leaves):
            if not _is_float(leaf):
                self._slots[i] = ("rest", len(self._rest_ids))
                self._rest_ids.append(i)
                continue
            shape = tuple(int(s) for s in leaf.shape)
            size = leaf.numel()
            group = (leaf.dtype, mask[i])
            key = (group, chunk_of.setdefault(group, 0))
            b = order.get(key)
            if (b is not None and max_bucket_elems is not None
                    and b["total"] and b["total"] + size > max_bucket_elems):
                chunk_of[group] += 1
                key = (group, chunk_of[group])
                b = None
            if b is None:
                b = order.setdefault(key, dict(leaf_ids=[], offsets=[],
                                               sizes=[], shapes=[],
                                               total=0))
            b["leaf_ids"].append(i)
            b["offsets"].append(b["total"])
            b["sizes"].append(size)
            b["shapes"].append(shape)
            b["total"] += size
        self.buckets: Tuple[_Bucket, ...] = tuple(
            _Bucket(dtype=key[0][0], decay=key[0][1],
                    leaf_ids=tuple(b["leaf_ids"]),
                    offsets=tuple(b["offsets"]), sizes=tuple(b["sizes"]),
                    shapes=tuple(b["shapes"]), size=b["total"])
            for key, b in order.items())
        for bi, b in enumerate(self.buckets):
            for seg, leaf_id in enumerate(b.leaf_ids):
                self._slots[leaf_id] = ("bucket", bi, seg)

    # -- introspection ---------------------------------------------------------
    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    @property
    def decay_flags(self) -> Tuple[bool, ...]:
        return tuple(b.decay for b in self.buckets)

    @property
    def dtypes(self) -> Tuple[torch.dtype, ...]:
        return tuple(b.dtype for b in self.buckets)

    @property
    def sizes(self) -> Tuple[int, ...]:
        return tuple(b.size for b in self.buckets)

    def __repr__(self):
        segs = ", ".join(
            f"{str(b.dtype).replace('torch.', '')}"
            f"{'[wd]' if b.decay else '[nowd]'}x{len(b.leaf_ids)}={b.size}"
            for b in self.buckets)
        return (f"BucketStore({self.n_leaves} leaves -> {self.n_buckets} "
                f"bucket(s): {segs})")

    # -- pack / unpack / view ----------------------------------------------------
    def _leaves(self, tree) -> list:
        """``tree``'s leaves in the store's order (structure checked)."""
        leaves, spec = pytree.tree_flatten(tree)
        if spec != self.treedef:
            raise ValueError(
                f"tree structure does not match this BucketStore's "
                f"template:\n  got      {spec}\n  expected {self.treedef}")
        return [leaves[i] for i in self._order]

    def pack(self, tree, *, dtype=None, cast: bool = False) -> Packed:
        """Pack ``tree`` (the template's structure) into bucket buffers.

        ``dtype`` casts every bucket to it (model-dtype gradients into
        fp32 buckets); ``cast=True`` casts each segment to its bucket's
        dtype.  With neither, a leaf's dtype must be its bucket's: no
        silent upcast."""
        leaves = self._leaves(tree)
        data = []
        for b in self.buckets:
            out_dt = dtype if dtype is not None else b.dtype
            segs = []
            for seg, leaf_id in enumerate(b.leaf_ids):
                leaf = leaves[leaf_id]
                if dtype is None and not cast and leaf.dtype != b.dtype:
                    raise ValueError(
                        f"leaf {leaf_id} has dtype {leaf.dtype}, bucket "
                        f"expects {b.dtype}; pass dtype=... or cast=True "
                        f"to cast explicitly")
                if tuple(leaf.shape) != b.shapes[seg]:
                    raise ValueError(
                        f"leaf {leaf_id} has shape {tuple(leaf.shape)}, "
                        f"bucket segment expects {b.shapes[seg]}: build "
                        f"the BucketStore from a same-shaped template")
                segs.append(leaf.reshape(-1).to(out_dt))
            data.append(torch.cat(segs))
        return Packed(data=tuple(data),
                      rest=tuple(leaves[i] for i in self._rest_ids))

    def unpack(self, packed: Packed, *, cast: bool = False):
        """The template-structured tree of ``packed``: each leaf a view
        of its bucket (``cast=True`` first casts each bucket to the
        store's dtype, the bucket-level master-to-model copy)."""
        if len(packed.data) != self.n_buckets:
            raise ValueError(f"Packed has {len(packed.data)} buckets, "
                             f"store has {self.n_buckets}")
        if len(packed.rest) != len(self._rest_ids):
            raise ValueError(f"Packed has {len(packed.rest)} passthrough "
                             f"leaves, store has {len(self._rest_ids)}")
        ordered: list = [None] * self.n_leaves
        for b, buf in zip(self.buckets, packed.data):
            if cast:
                buf = buf.to(b.dtype)
            for seg, shape, leaf_id in zip(torch.split(buf, b.sizes),
                                           b.shapes, b.leaf_ids):
                ordered[leaf_id] = seg.view(shape)
        for pos, leaf_id in enumerate(self._rest_ids):
            ordered[leaf_id] = packed.rest[pos]
        leaves: list = [None] * self.n_leaves
        for pos, i in enumerate(self._order):
            leaves[i] = ordered[pos]
        return pytree.tree_unflatten(leaves, self.treedef)

    #: torch compiles nothing: the JAX package's jitted conveniences are
    #: the plain calls here
    pack_jit = pack
    unpack_jit = unpack

    def view(self, packed: Packed, leaf_index: int):
        """One leaf of ``packed`` (a leaf index in the store's order),
        reshaped: a view of its bucket."""
        slot = self._slots[leaf_index]
        if slot[0] == "rest":
            return packed.rest[slot[1]]
        _, bi, seg = slot
        b = self.buckets[bi]
        return packed.data[bi].narrow(0, b.offsets[seg],
                                      b.sizes[seg]).view(b.shapes[seg])

    def zeros(self, dtype=torch.float32, device=None) -> Packed:
        """Zero buckets with this store's segmentation (an optimizer's
        moments), on ``device`` (default: the template's); ``rest`` is
        empty."""
        device = self.device if device is None else device
        return Packed(data=tuple(torch.zeros((b.size,), dtype=dtype,
                                             device=device)
                                 for b in self.buckets), rest=())

    # -- per-leaf reductions ---------------------------------------------------------
    def _segment_views(self, bucket_index: int, buf) -> list:
        return list(torch.split(buf.float(),
                                self.buckets[bucket_index].sizes))

    def segment_ids(self, bucket_index: int) -> torch.Tensor:
        """int32 ``[size]``: each bucket element's segment (its leaf's
        position in the bucket), on the template's device.  A per-element
        map as large as the bucket: the store's own reductions and the
        optimizers do not use it."""
        b = self.buckets[bucket_index]
        return torch.repeat_interleave(
            torch.arange(len(b.leaf_ids), dtype=torch.int32,
                         device=self.device),
            torch.tensor(b.sizes, device=self.device), output_size=b.size)

    def per_leaf_sq_sums(self, data: Sequence[Any]) -> Tuple[Any, ...]:
        """Per-leaf sums of squares in fp32, one ``[n_leaves_in_bucket]``
        tensor a bucket (LAMB's trust ratios, NovoGrad's norms): one
        ``_foreach_norm`` over the bucket's per-leaf views, squared."""
        return tuple(
            torch.stack(torch._foreach_norm(
                self._segment_views(bi, buf))).square()
            for bi, buf in enumerate(data))

    def per_leaf_max_abs(self, data: Sequence[Any]) -> Tuple[Any, ...]:
        """Per-leaf max ``|x|`` in fp32 a bucket (NovoGrad's inf norm)."""
        return tuple(
            torch.stack(torch._foreach_norm(
                self._segment_views(bi, buf), ord=float("inf")))
            for bi, buf in enumerate(data))

    def spread(self, bucket_index: int, per_leaf_vals):
        """A ``[n_leaves_in_bucket]`` vector repeated over each leaf's
        elements: per-tensor scalars as an elementwise multiplier (one
        copy of broadcast views; no per-element index is built)."""
        b = self.buckets[bucket_index]
        return torch.cat([v.expand(n) for v, n in
                          zip(per_leaf_vals.unbind(), b.sizes)])

    def reverse_topological_order(self) -> Tuple[int, ...]:
        """Bucket indices by descending smallest leaf index: the order
        their gradients become final in the backward, when the leaf
        order tracks the forward's use."""
        return tuple(sorted(range(len(self.buckets)),
                            key=lambda bi: -min(self.buckets[bi].leaf_ids)))

    def shard_layout(self, num_shards: int) -> dict:
        """The checkpoint descriptor of this store's buckets for state
        sharded ``num_shards`` ways: each bucket's true element count and
        the shard count (:func:`padded_shard_len`)."""
        return {"sizes": [int(s) for s in self.sizes],
                "num_shards": int(num_shards)}

    def leaf_order(self) -> Tuple[int, ...]:
        """The float leaves' indices in the store's order."""
        return tuple(i for i, s in enumerate(self._slots)
                     if s[0] == "bucket")

    def tree_order(self) -> Tuple[int, ...]:
        """The float leaves' indices (store's order) in the order the
        template's own flattening gives them: per-leaf results of a
        bucketed sweep, reassembled in that order, line up with the
        leafwise path's."""
        return tuple(i for i in sorted(range(self.n_leaves),
                                       key=self._order.__getitem__)
                     if self._slots[i][0] == "bucket")
