"""The tunable-kernel contract: one :class:`KernelSpec` a family.

Counterpart of ``apex_tpu/tune/registry.py``.  A spec is what the
measurement harness needs to search a family's tiles on the card:

* ``candidates(shape, bound)`` — the tiles the kernels have for this
  shape; the rule's tile (``defaults``) is always measured first, so the
  winner is a minimum over a set holding the rule's: the tuned config is
  never slower than the rule, by construction;
* ``constraint(shape, config)`` — the card's legality check
  (:mod:`apex_tpu_torch.tune.space`: shared memory per block, Triton's
  block limits, the instantiations that exist), applied before any
  launch;
* ``build(shape, interpret)`` — a :class:`TuneCase`: seeded inputs and a
  ``run(config)`` that launches the family forward and backward (where
  it has a backward) through its public function with the tile named;
  with ``interpret`` (off the card) the inputs are on the CPU and the
  plain versions run;
* ``exact`` — what the card's oracle shows, not what JAX's spec says: an
  exact family's candidates must equal the rule's outputs bit for bit,
  another's within its case's stated tolerance;
* ``regions`` — roofline-ledger region fragments attributable to the
  family (:func:`apex_tpu_torch.tune.measure.bound_from_ledger`);
* ``version`` — the kernel module's ``TUNE_VERSION``.

Kernels without a knob: the flash backward's ``[B, T, S]`` bias-gradient
kernel (``db2``, row 13 of the port's kernel table), the flash dQ and
dK/dV kernels and the fp32 and wide-head SIMT forward, and conv wgrad's
reduce pass keep their rule's tile; no spec names them.

The six builtin specs register from :mod:`apex_tpu_torch.tune.kernels`,
imported by :func:`load_builtin` on first use, so the kernel modules
(which import ``tune.space`` and ``tune.dispatch``) see no import cycle.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Tuple

__all__ = ["KernelSpec", "TuneCase", "register", "get_spec", "all_specs",
           "load_builtin", "registered_versions"]


@dataclass
class TuneCase:
    """One tuning problem: ``run(config)`` runs the family on fixed
    inputs and returns its outputs (a tuple of tensors); the harness
    times it and holds each candidate's outputs against the rule's.
    ``tol``: the oracle's ``(rtol, atol)`` for a family that is not
    exact, one pair for every output or a sequence of pairs, one an
    output."""
    run: Callable[[Dict[str, int]], object]
    tol: object = (2e-2, 2e-3)


@dataclass
class KernelSpec:
    name: str
    version: int
    #: config keys the kernels understand (the dispatch consult's filter)
    params: Tuple[str, ...]
    #: which side of the roofline the family's example stresses (the
    #: candidate order when no ledger verdict is given)
    kind: str                                    # "compute" | "memory"
    #: True: candidates must equal the rule's outputs bit for bit
    exact: bool
    defaults: Callable[[Mapping], Dict[str, int]]
    candidates: Callable[[Mapping, Optional[str]], List[Dict[str, int]]]
    constraint: Callable[[Mapping, Dict[str, int]], bool]
    build: Callable[[Mapping, bool], TuneCase]
    bucket: Callable[[Mapping], str]
    #: ``(shape, config, bound) -> float``: the harness visits candidates
    #: in ascending order of it (stable over a seeded shuffle)
    priority: Optional[Callable[[Mapping, Dict[str, int], Optional[str]],
                                float]] = None
    #: ``(shape, config) -> hashable``: the launch a config really makes
    #: after the kernels' clamps; two configs of one launch are timed once
    effective: Optional[Callable[[Mapping, Dict[str, int]],
                                 object]] = None
    #: the family's main-path shape on the card (the CLI's default)
    example_shape: Dict[str, object] = field(default_factory=dict)
    #: a small shape: CPU probes and the card tests
    small_shape: Dict[str, object] = field(default_factory=dict)
    #: roofline-ledger region fragments attributable to the family
    regions: Tuple[str, ...] = ()


_REGISTRY: Dict[str, KernelSpec] = {}
_BUILTIN_LOADED = False


def register(spec: KernelSpec) -> KernelSpec:
    """Add (or replace, by name) one spec; returns it."""
    if spec.kind not in ("compute", "memory"):
        raise ValueError(f"spec.kind must be 'compute' or 'memory', "
                         f"got {spec.kind!r}")
    _REGISTRY[spec.name] = spec
    return spec


def get_spec(name: str) -> KernelSpec:
    """The registered spec, loading the builtins on a first miss."""
    if name not in _REGISTRY:
        load_builtin()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"no tunable kernel {name!r} registered; known: "
            f"{sorted(_REGISTRY)}") from None


def all_specs() -> List[KernelSpec]:
    """The builtin specs (and any registered since), sorted by name."""
    load_builtin()
    return [_REGISTRY[k] for k in sorted(_REGISTRY)]


def registered_versions() -> Dict[str, int]:
    """``{kernel: version}`` of every spec: :func:`prune_stale`'s input."""
    load_builtin()
    return {s.name: s.version for s in _REGISTRY.values()}


def load_builtin() -> None:
    """Import the six builtin registrations; idempotent."""
    global _BUILTIN_LOADED
    if _BUILTIN_LOADED:
        return
    from . import kernels as _kernels        # noqa: F401  (registers)
    _BUILTIN_LOADED = True
