"""The measurement harness: candidate tiles timed on the card.

Counterpart of ``apex_tpu/tune/measure.py``, with its contract:

* **build and first launch excluded** — each candidate runs once (the
  kernels build and Triton compiles then) and its outputs are checked
  before any clock starts;
* **the minimum of ``reps``** passes of ``iters`` calls each: the calls
  captured in one CUDA graph, each pass a replay timed by CUDA events
  (the end event's wait is the fence; a host clock over eager calls
  would measure the launches, not the kernels);
* **rejected before a launch** — a candidate the spec's constraint
  refuses (shared memory, Triton's limits, a tile the kernels lack)
  never launches; a candidate whose outputs fail the oracle against the
  rule's (bit for bit for an exact family, else its stated tolerance) is
  launched, then discarded, so a fast wrong tile never wins; a
  candidate the constraint passed but whose launch raised is counted
  apart (``rejected_kernel``): the constraint and the kernel disagree,
  which on the card is a fault to look at, not a tile to skip;
* **ledger-driven priority** — :func:`bound_from_ledger` reads a roofline
  ledger's compute-or-memory verdicts for the family's regions, and the
  spec orders its candidates by it; with ``max_candidates`` the order
  decides what is measured at all.

Tuning runs only on the card, unless the caller passes ``interpret=True``
(JAX's name, so the CLI's flag reads the same): then the cases run their
plain versions on the CPU and the result is stored with
``source="interpret"`` (the determinism tests).  Dispatch never tunes.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import torch

from . import store
from .registry import KernelSpec, all_specs, get_spec

__all__ = ["TuneResult", "time_case", "tune_kernel", "bound_from_ledger",
           "tune_from_ledger"]


@dataclass
class TuneResult:
    kernel: str
    version: int
    bucket: str
    device_kind: str
    bound: str
    config: Dict[str, int]                 # the winner (may be the rule's)
    default_config: Dict[str, int]
    best_ms: Optional[float]
    default_ms: Optional[float]
    candidates: int                        # measured (oracle-passing)
    rejected_constraint: int
    rejected_oracle: int
    truncated: int = 0                     # dropped by max_candidates
    rejected_kernel: int = 0               # passed the constraint, raised
    order: List[Dict[str, int]] = field(default_factory=list)
    stored: bool = False
    source: str = "device"                 # "device" | "interpret"

    @property
    def tuned_over_default(self) -> Optional[float]:
        if not self.best_ms or not self.default_ms:
            return None
        return round(self.best_ms / self.default_ms, 4)


def _leaves(out) -> List[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _leaves(o)]
    if isinstance(out, dict):
        return [t for k in sorted(out) for t in _leaves(out[k])]
    return []


def time_case(run: Callable[[], Any], *, iters: int = 5,
              reps: int = 3) -> float:
    """Seconds per call, the minimum over ``reps`` passes of ``iters``
    calls; ``run`` must already be warm.  On the card the ``iters`` calls
    are captured in one CUDA graph (after a warm call on the capture's
    side stream) and each pass is a replay between two CUDA events: the
    device's time, without the host's launch gaps, which at a few
    microseconds a kernel would otherwise be what is measured.  Off the
    card the host clock times the calls (the interpret probes)."""
    best = float("inf")
    iters, reps = max(1, iters), max(1, reps)
    if torch.cuda.is_available():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                run()
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3 / iters)
        del graph
        return best
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def _tree_equal_bitwise(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(la, lb))


def _tree_close(a, b, tol) -> bool:
    la, lb = _leaves(a), _leaves(b)
    if len(la) != len(lb):
        return False
    tols = tol if isinstance(tol, (list, tuple)) and tol and isinstance(
        tol[0], (list, tuple)) else [tol] * len(la)
    for (rtol, atol), x, y in zip(tols, la, lb):
        if x.shape != y.shape or not torch.allclose(
                x.float(), y.float(), rtol=rtol, atol=atol):
            return False
    return True


def _oracle_ok(spec: KernelSpec, case, ref, out) -> bool:
    if spec.exact:
        return _tree_equal_bitwise(ref, out)
    return _tree_close(ref, out, case.tol)


def _config_key(spec: KernelSpec, shape: Mapping,
                cfg: Dict[str, int]) -> object:
    """Dedupe key: the effective launch when the spec can name it (two
    configs of one launch are timed once), else the raw config."""
    if spec.effective is not None:
        try:
            return ("eff", repr(spec.effective(shape, cfg)))
        except Exception:
            pass
    return tuple(sorted(cfg.items()))


def _dedupe(spec: KernelSpec, shape: Mapping,
            configs: Sequence[Dict[str, int]]) -> List[Dict[str, int]]:
    seen, out = set(), []
    for c in configs:
        key = _config_key(spec, shape, c)
        if key not in seen:
            seen.add(key)
            out.append(dict(c))
    return out


def _sync(cuda: bool) -> None:
    if cuda:
        torch.cuda.synchronize()


def tune_kernel(spec_or_name, shape: Optional[Mapping] = None, *,
                bound: Optional[str] = None,
                seed: int = 0,
                iters: int = 5, reps: int = 3,
                max_candidates: Optional[int] = None,
                interpret: bool = False,
                measure: Optional[Callable[[Dict[str, int],
                                            Callable[[], Any]],
                                           float]] = None,
                store_result: bool = True,
                path: Optional[str] = None) -> TuneResult:
    """Search one family's tiles on this card and (by default) store
    the winner in the config cache.

    ``shape`` defaults to the spec's ``example_shape`` (its
    ``small_shape`` under ``interpret`` off the card).  ``bound``
    overrides the candidate order's verdict (normally
    :func:`bound_from_ledger`'s).  ``seed`` fixes the visit order: the
    rule's tile first, the rest shuffled by ``seed``, then stably sorted
    by the spec's priority, so two runs with one seed measure the same
    list in the same order.  ``measure`` injects a timer ``(config,
    run) -> seconds`` (the tests' deterministic model; by default
    :func:`time_case`).  Off the card it refuses unless ``interpret``
    (the plain versions on the CPU, stored as ``source="interpret"``).
    """
    spec = spec_or_name if isinstance(spec_or_name, KernelSpec) \
        else get_spec(spec_or_name)
    on_card = torch.cuda.is_available()
    if not on_card and not interpret:
        raise RuntimeError(
            f"tune_kernel({spec.name!r}) measures on the card and none is "
            f"available — tuning only runs on the card (pass "
            f"interpret=True for an explicit probe of the plain "
            f"versions on the CPU)")
    cpu = interpret and not on_card
    if shape is None:
        shape = (spec.small_shape or spec.example_shape) if cpu \
            else spec.example_shape
    shape = dict(shape)
    bound = bound or spec.kind
    bucket = spec.bucket(shape)
    default = spec.defaults(shape)

    cands = _dedupe(spec, shape,
                    [default] + list(spec.candidates(shape, bound)))
    rng = random.Random(seed)
    tail = cands[1:]
    rng.shuffle(tail)
    if spec.priority is not None:
        tail.sort(key=lambda c: spec.priority(shape, c, bound))
    cands = [cands[0]] + tail
    kept, rejected_constraint = [], 0
    for c in cands:
        if c == default or spec.constraint(shape, c):
            kept.append(c)
        else:
            rejected_constraint += 1
    # the measurement budget has its own counter: a truncated candidate
    # passed the constraint
    truncated = 0
    if max_candidates is not None:
        truncated = max(0, len(kept) - max(1, int(max_candidates)))
        kept = kept[:max(1, int(max_candidates))]

    case = spec.build(shape, cpu)
    timer = measure or (lambda cfg, run: time_case(run, iters=iters,
                                                   reps=reps))
    cuda = on_card and not cpu

    # the rule's tile first: its outputs are the oracle's reference and
    # its time the bound a candidate must beat
    ref = case.run(default)
    _sync(cuda)
    default_ms = 1e3 * float(timer(default, lambda: case.run(default)))

    best_cfg, best_ms = dict(default), default_ms
    rejected_oracle = rejected_kernel = 0
    measured = 1
    for cfg in kept:
        if cfg == default:
            continue
        try:
            out = case.run(cfg)
            _sync(cuda)
        except (RuntimeError, ValueError):
            rejected_kernel += 1             # the kernels refused it
            continue
        if not _oracle_ok(spec, case, ref, out):
            rejected_oracle += 1
            continue
        ms = 1e3 * float(timer(cfg, lambda: case.run(cfg)))
        measured += 1
        if ms < best_ms:
            best_cfg, best_ms = dict(cfg), ms

    res = TuneResult(
        kernel=spec.name, version=spec.version, bucket=bucket,
        device_kind=store.device_kind(), bound=bound, config=best_cfg,
        default_config=dict(default),
        best_ms=round(best_ms, 6), default_ms=round(default_ms, 6),
        candidates=measured, rejected_constraint=rejected_constraint,
        rejected_oracle=rejected_oracle, truncated=truncated,
        rejected_kernel=rejected_kernel, order=kept,
        source="interpret" if cpu else "device")
    if store_result:
        store.put(spec.name, spec.version, bucket, best_cfg,
                  meta={"best_ms": res.best_ms,
                        "default_ms": res.default_ms,
                        "default_config": res.default_config,
                        "bound": bound, "seed": seed,
                        "source": res.source},
                  path=path)
        res.stored = True
    try:
        from ..telemetry import get_recorder
        rec = get_recorder()
        if rec is not None:
            rec.event("tune", phase="result", kernel=spec.name,
                      bucket=bucket, bound=bound, config=res.config,
                      default_ms=res.default_ms, best_ms=res.best_ms,
                      candidates=res.candidates,
                      rejected_constraint=res.rejected_constraint,
                      rejected_oracle=res.rejected_oracle,
                      rejected_kernel=res.rejected_kernel,
                      truncated=res.truncated,
                      stored=res.stored, source=res.source)
    except Exception:
        pass
    return res


# -- roofline-ledger priority ---------------------------------------------------

def bound_from_ledger(ledger: Mapping, spec: KernelSpec) -> Optional[str]:
    """The family's verdict read off an
    :func:`apex_tpu_torch.prof.roofline.mfu_ledger` result: the
    ``regions`` rows whose ``region`` contains one of the spec's
    fragments vote with their ``modeled_ms`` (else ``flops_g``, else 1)
    for their ``bound``.  ``"compute"`` or ``"memory"``; None when no
    region matches (the spec's own ``kind`` decides then)."""
    votes = {"compute": 0.0, "memory": 0.0}
    matched = False
    for row in (ledger.get("regions") or []):
        name = str(row.get("region", "")).lower()
        if not any(frag in name for frag in spec.regions):
            continue
        matched = True
        weight = float(row.get("modeled_ms") or row.get("flops_g") or 1.0)
        side = row.get("bound")
        if side in votes:
            votes[side] += weight
    if not matched:
        return None
    return "memory" if votes["memory"] >= votes["compute"] else "compute"


def tune_from_ledger(ledger: Mapping, *,
                     specs: Optional[Sequence[KernelSpec]] = None,
                     **kwargs) -> List[TuneResult]:
    """Tune every family (or ``specs``), each in the order its ledger
    verdict gives; kwargs go to :func:`tune_kernel`."""
    return [tune_kernel(spec, bound=bound_from_ledger(ledger, spec),
                        **kwargs)
            for spec in (specs if specs is not None else all_specs())]
