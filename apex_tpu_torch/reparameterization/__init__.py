"""Weight reparameterizations over trees of tensors — counterpart of
``apex_tpu/reparameterization`` (reference ``apex/reparameterization``).

A reparameterization is a pair of pure functions, as in JAX:

* ``apply_*(params, ...)`` replaces each matching weight ``w`` with a
  subtree of auxiliary tensors (weight norm: ``g`` and ``v``) and a
  marker (``__reparam__``, a :class:`_Kind` that records the
  reparameterization's name and its ``dim``);
* :func:`reconstruct` rebuilds the plain weights from the subtrees.  It
  composes with ``torch.func.functional_call(model, reconstruct(p),
  args)``: the weight is recomputed inside the forward, and autograd
  reaches ``g`` and ``v``;
* ``remove_*`` folds a reparameterization back into plain weights.

``params`` is a nested dict of tensors (JAX's tree) or a flat
``state_dict``-style mapping; a key's dots count as path separators, so
a path is matched JAX's way (``layer0/ih/weight``): by default every
``kernel`` or ``weight`` leaf of two or more dimensions, else every path
that contains ``name``.  The norm is taken in fp32.
"""

from __future__ import annotations

import re
from typing import Mapping, Optional

import torch

__all__ = ["Reparameterization", "WeightNorm", "apply_weight_norm",
           "remove_weight_norm", "apply_reparameterization",
           "remove_reparameterization", "reconstruct"]

_MARKER = "__reparam__"


def _norm_except_dim(v: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
    """The fp32 norm over every dimension but ``dim`` (kept, size 1 on
    the others); ``dim=None``: the whole tensor's, a scalar."""
    v32 = v.float()
    if dim is None:
        return torch.sqrt(torch.sum(v32 * v32))
    axes = tuple(i for i in range(v.dim()) if i != dim)
    return torch.sqrt(torch.sum(v32 * v32, dim=axes, keepdim=True))


class Reparameterization:
    """Base: a subclass defines ``reparameterize(w) -> aux`` and
    ``compute_weight(aux) -> w``."""

    name = "reparam"

    def __init__(self, dim: Optional[int] = 0):
        self.dim = dim

    def reparameterize(self, weight):
        raise NotImplementedError

    def compute_weight(self, aux):
        raise NotImplementedError


class WeightNorm(Reparameterization):
    """``w = g * v / ||v||``, the norm over every dimension but ``dim``;
    ``g`` fp32, ``w`` in ``v``'s dtype."""

    name = "weight_norm"

    def reparameterize(self, weight):
        return {"g": _norm_except_dim(weight, self.dim).float(),
                "v": weight}

    def compute_weight(self, aux):
        v, g = aux["v"], aux["g"]
        w = g * v.float() / (_norm_except_dim(v, self.dim) + 1e-12)
        return w.to(v.dtype)


class _Kind:
    """The marker a reparameterized subtree carries: the
    reparameterization's name and ``dim``, so :func:`reconstruct` needs
    no other argument."""

    def __init__(self, name: str, dim=0):
        self.name = name
        self.dim = dim

    def __eq__(self, other):
        return (isinstance(other, _Kind) and other.name == self.name
                and other.dim == self.dim)

    def __hash__(self):
        return hash(("_Kind", self.name, self.dim))

    def __repr__(self):
        return f"_Kind({self.name!r}, dim={self.dim})"


_REGISTRY = {WeightNorm.name: WeightNorm}


def _path(prefix: str, key) -> str:
    part = str(key).replace(".", "/")
    return f"{prefix}/{part}" if prefix else part


def _match(path_str: str, name: str) -> bool:
    if not name:
        # every kernel/weight leaf (the reference's name='')
        return bool(re.search(r"(kernel|weight)$", path_str))
    return name in path_str


def apply_reparameterization(params, reparameterization: Reparameterization,
                             name: str = "", dim: int = 0):
    """A new tree: each matching floating weight of two or more
    dimensions replaced by ``{"__reparam__": _Kind, **aux}``."""
    rep = reparameterization

    def transform(tree, prefix=""):
        new = {}
        for k, v in tree.items():
            path = _path(prefix, k)
            if isinstance(v, Mapping):
                new[k] = transform(v, path)
            elif (isinstance(v, torch.Tensor) and v.is_floating_point()
                  and v.dim() >= 2 and _match(path, name)):
                aux = rep.reparameterize(v)
                aux[_MARKER] = _Kind(rep.name, rep.dim)
                new[k] = aux
            else:
                new[k] = v
        return new

    return transform(params)


def reconstruct(params, name: str = ""):
    """A new tree with the plain weights rebuilt from every
    reparameterized subtree (kind and ``dim`` from its marker); ``name``
    limits the fold to paths that contain it."""
    def walk(tree, prefix=""):
        if isinstance(tree, Mapping):
            if _MARKER in tree:
                if name and name not in prefix:
                    return tree
                kind = tree[_MARKER]
                rep = _REGISTRY[kind.name](dim=kind.dim)
                return rep.compute_weight(
                    {k: v for k, v in tree.items() if k != _MARKER})
            return {k: walk(v, _path(prefix, k)) for k, v in tree.items()}
        return tree
    return walk(params)


def remove_reparameterization(params, name: str = ""):
    """Fold the auxiliary tensors back into plain weights; ``name``
    limits it to matching paths."""
    return reconstruct(params, name=name)


def apply_weight_norm(params, name: str = "", dim: int = 0):
    """Weight-normalize the matching weights (reference
    ``apply_weight_norm``)."""
    return apply_reparameterization(params, WeightNorm(dim=dim), name=name,
                                    dim=dim)


def remove_weight_norm(params, name: str = "", dim: int = 0):
    del dim  # recorded in each marker at apply time
    return remove_reparameterization(params, name=name)
