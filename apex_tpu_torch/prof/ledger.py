"""Bytes ledger — measured kernel time and traffic against the model's
intrinsic traffic; counterpart of ``apex_tpu/prof/ledger.py``.

* **intrinsic** (:func:`intrinsic_ledger`) — the traffic a perfectly
  fused program would move, from the analytic walk
  (:func:`apex_tpu_torch.prof.analysis.profile_function`): every product
  (the aten products and the product kernels, :data:`COMPUTE_OPS`) reads
  its operands and writes its outputs once, plus the optimizer's traffic
  per parameter (JAX's 22 bytes for SGD with momentum and a bf16 cast,
  30 for Adam); grouped by scope path into a per-layer table.
* **measured** (:func:`measured_ledger`) — per-kind time (and the bytes
  and FLOPs a trace carries; the CUDA profiler reports none, so they are
  0 for a ``torch.profiler`` trace) of a parsed trace
  (:func:`apex_tpu_torch.prof.parse.parse_trace`), and the top kernels.
* **join** (:func:`bytes_ledger`) — measured over intrinsic per category
  of interest, and per spatial stage through shape signatures
  (:func:`_spatial_sig` reads the shapes the trace recorded for each
  kernel's launching op).
* :func:`loader_ledger` — the input engine's counters in ledger form.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Optional

from .analysis import PRODUCT_OPS, _Walk, _run, profile_function

__all__ = ["COMPUTE_OPS", "intrinsic_ledger", "measured_ledger",
           "measured_by_shape", "intrinsic_by_shape", "bytes_ledger",
           "loader_ledger"]

#: the tensor-core ops: FLOPs charged to these are "matmul FLOPs"
#: everywhere downstream (this ledger's compute rows and the roofline's
#: MFU numerator): the aten products, and the hand-written kernels that
#: are products (flash, conv, qmm)
COMPUTE_OPS = PRODUCT_OPS + (
    "flash_attention_fwd", "flash_attention_bwd_dq",
    "flash_attention_bwd_dkv", "flash_attention_bwd_db2",
    "conv_fwd", "conv_dgrad", "conv_wgrad", "qmm")
_COMPUTE_OPS = COMPUTE_OPS

# Optimizer-side bytes per parameter element, beyond the products'
# operands (JAX's model): SGD grad read (4) + master read and write (8)
# + momentum read and write (8) + bf16 cast write (2); Adam grad read
# (4) + master (8) + m (8) + v (8) + cast write (2)
_OPT_BYTES_PER_PARAM_SGD = 22
_OPT_BYTES_PER_PARAM_ADAM = 30


def _layer_of(scope: str) -> str:
    """The last two scope components of an op's path (``block_3/attn``),
    ``<top>`` outside any scope; backward ops carry their forward's
    path, so forward and backward traffic land in one row."""
    parts = [p for p in scope.split("/") if p]
    if not parts:
        return "<top>"
    return "/".join(parts[-2:])


def intrinsic_ledger(fn, *args, n_params: Optional[int] = None,
                     optimizer: str = "sgd", prof=None) -> Dict[str, Any]:
    """Model-intrinsic traffic of one call of ``fn(*args)``:
    ``{"total_gb", "compute_gb", "optimizer_gb", "optimizer_model",
    "by_layer": [{layer, gb, gflops, ops}]}``; ``prof`` reuses a
    :func:`profile_function` result."""
    if prof is None:
        prof = profile_function(fn, *args, xla_cost=False)
    by_layer: Dict[str, Dict[str, float]] = {}
    compute_bytes = 0.0
    for r in prof.records:
        if r.op not in _COMPUTE_OPS:
            continue
        row = by_layer.setdefault(_layer_of(r.name),
                                  {"bytes": 0.0, "flops": 0.0, "ops": 0})
        row["bytes"] += r.bytes * r.count
        row["flops"] += r.flops * r.count
        row["ops"] += r.count
        compute_bytes += r.bytes * r.count
    per_param = (_OPT_BYTES_PER_PARAM_ADAM if optimizer == "adam"
                 else _OPT_BYTES_PER_PARAM_SGD)
    opt_bytes = float(n_params or 0) * per_param
    layers = [
        {"layer": k, "gb": round(v["bytes"] / 1e9, 4),
         "gflops": round(v["flops"] / 1e9, 1), "ops": v["ops"]}
        for k, v in sorted(by_layer.items(), key=lambda kv: -kv[1]["bytes"])]
    return {
        "total_gb": round((compute_bytes + opt_bytes) / 1e9, 3),
        "compute_gb": round(compute_bytes / 1e9, 3),
        "optimizer_gb": round(opt_bytes / 1e9, 3),
        "optimizer_model": f"{per_param} B/param ({optimizer})",
        "by_layer": layers,
    }


class _Uses(_Walk):
    """The walk, keeping each op's input and output storages (held, so
    no storage's key is reused within the walk)."""

    def __init__(self):
        super().__init__()
        self.uses: List[tuple] = []
        self.held: List[Any] = []

    def _storages(self, ts):
        out = []
        for t in ts:
            key, s = self._key(t)
            if key is not None:
                self.held.append(s)
                out.append((key, tuple(t.shape), s.nbytes()))
        return out

    def _record(self, op, flops, nbytes, ins, outs):
        super()._record(op, flops, nbytes, ins, outs)
        self.uses.append((op, self._storages(ins), self._storages(outs)))


def _bridge_bytes(fn, *args, gap: int = 100) -> Dict[str, Any]:
    """Unavoidable forward-to-backward spill traffic: a value produced
    more than ``gap`` ops before a consumer cannot stay in on-chip memory
    across the work between, so it is written once and read again by
    each distant consumer — the saved activations.  Values that are
    product operands are left out (:func:`intrinsic_ledger` charges
    those reads).  Returns totals and a per-spatial-stage breakdown
    (the keys of :func:`intrinsic_by_shape`)."""
    walk = _run(fn, args, {}, _Uses())
    produced: Dict[int, int] = {}
    sizes: Dict[int, tuple] = {}
    operands = set()
    bridges: Dict[int, int] = {}
    for idx, (op, ins, outs) in enumerate(walk.uses):
        for key, shape, nbytes in ins:
            if op in _COMPUTE_OPS:
                operands.add(key)
            p = produced.get(key)
            if p is not None and idx - p > gap:
                bridges[key] = bridges.get(key, 0) + 1
        for key, shape, nbytes in outs:
            if key not in produced:
                produced[key] = idx
                sizes[key] = (shape, nbytes)
    total = 0.0
    by_stage: Dict[str, float] = {}
    for key, reads in bridges.items():
        if key in operands:
            continue
        shape, nbytes = sizes[key]
        t = nbytes * (1 + reads)                 # one write + distant reads
        total += t
        sig = f"hw{shape[1]}" if len(shape) == 4 else "other"
        by_stage[sig] = by_stage.get(sig, 0.0) + t
    return {"gb": round(total / 1e9, 3), "gap_eqns": gap,
            "by_stage": {k: round(v / 1e9, 4) for k, v in by_stage.items()}}


def measured_ledger(tp, steps: int = 1) -> Dict[str, Any]:
    """A parsed trace's per-kind rows (time, the trace's bytes and their
    rate, per step over ``steps``) and its top kernels by bytes (by time
    where the trace carries no bytes)."""
    cats = {}
    for name, agg in sorted(tp.by_category().items(),
                            key=lambda kv: -kv[1]["total_us"]):
        cats[name] = {
            "us": round(agg["total_us"] / steps, 1),
            "gb": round(agg["bytes"] / steps / 1e9, 3),
            "gb_per_s": round(
                agg["bytes"] / (agg["total_us"] * 1e-6) / 1e9, 1)
            if agg["total_us"] else 0.0,
        }
    per_op: Dict[str, Dict[str, Any]] = {}
    for r in tp.records:
        agg = per_op.setdefault(r.name, {"us": 0.0, "bytes": 0.0,
                                         "count": 0,
                                         "category": r.category})
        agg["us"] += r.duration_us
        agg["bytes"] += r.bytes_accessed
        agg["count"] += 1
    top = [
        {"op": name, "category": a["category"],
         "us": round(a["us"] / steps, 1),
         "gb": round(a["bytes"] / steps / 1e9, 4),
         "gb_per_s": round(a["bytes"] / (a["us"] * 1e-6) / 1e9, 1)
         if a["us"] else 0.0}
        for name, a in sorted(per_op.items(),
                              key=lambda kv: (-kv[1]["bytes"],
                                              -kv[1]["us"]))[:10]]
    total_gb = sum(c["gb"] for c in cats.values())
    return {"total_gb": round(total_gb, 3), "by_category": cats,
            "top_fusions_by_bytes": top}


_SHAPE_RE = re.compile(r"(?:bf16|f32|f16|s32|u32|s8|u8)\[([\d,]+)\]")


def _spatial_sig(shapes) -> str:
    """Shape-signature key of one kernel: ``hw<H>`` of the largest 4-D
    NHWC shape among ``shapes`` (the launching op's recorded input
    shapes; or, as in the JAX package, the shapes written in an HLO
    instruction's text), else ``other``.  Every residual block shares
    the same source lines, so shapes are the join key at the granularity
    of a resolution stage."""
    if isinstance(shapes, str):
        shapes = [[int(x) for x in dims.split(",") if x]
                  for dims in _SHAPE_RE.findall(shapes)]
    best_elems, best_h = 0, None
    for parts in shapes:
        if len(parts) != 4:
            continue
        elems = math.prod(parts)
        if elems > best_elems:
            best_elems, best_h = elems, parts[1]
    return f"hw{best_h}" if best_h else "other"


#: the port's conv kinds (``parse.RESNET_KINDS``): the conv kernels, and
#: cuDNN's under ``--no-pallas-conv``
CONV_CATEGORIES = ("conv_fwd_kernel", "conv_dgrad_kernel",
                   "conv_wgrad_kernel", "conv")


def measured_by_shape(tp, steps: int = 1, categories=CONV_CATEGORIES
                      ) -> Dict[str, Dict[str, float]]:
    """Per-spatial-stage measured time and bytes of the given kinds."""
    rows: Dict[str, Dict[str, float]] = {}
    for r in tp.records:
        if categories and r.category not in categories:
            continue
        sig = _spatial_sig(r.input_shapes)
        agg = rows.setdefault(sig, {"us": 0.0, "bytes": 0.0, "count": 0})
        agg["us"] += r.duration_us
        agg["bytes"] += r.bytes_accessed
        agg["count"] += 1
    return {k: {"us": round(v["us"] / steps, 1),
                "gb": round(v["bytes"] / steps / 1e9, 4),
                "count": v["count"] // max(steps, 1)}
            for k, v in rows.items()}


def intrinsic_by_shape(fn, *args, prof=None) -> Dict[str, Dict[str, float]]:
    """Per-spatial-stage intrinsic product traffic, grouped as
    :func:`measured_by_shape` groups (the largest 4-D operand or
    output's H)."""
    if prof is None:
        prof = profile_function(fn, *args, xla_cost=False)
    rows: Dict[str, Dict[str, float]] = {}
    for r in prof.records:
        if r.op not in _COMPUTE_OPS:
            continue
        sig = _spatial_sig(list(r.in_shapes) + list(r.out_shapes))
        agg = rows.setdefault(sig, {"bytes": 0.0, "count": 0})
        agg["bytes"] += r.bytes * r.count
        agg["count"] += r.count
    return {k: {"gb": round(v["bytes"] / 1e9, 4), "count": v["count"]}
            for k, v in rows.items()}


def bytes_ledger(fn, args, tp, steps: int = 1,
                 n_params: Optional[int] = None,
                 optimizer: str = "sgd",
                 conv_categories=CONV_CATEGORIES) -> Dict[str, Any]:
    """The joined ledger: measured over intrinsic, in total, for the
    conv kinds, and per resolution stage.  ``fn(*args)`` must be the
    step the trace ``tp`` measured."""
    prof = profile_function(fn, *args, xla_cost=False)
    intr = intrinsic_ledger(fn, *args, n_params=n_params,
                            optimizer=optimizer, prof=prof)
    meas = measured_ledger(tp, steps=steps)
    bridge = _bridge_bytes(fn, *args)
    conv_meas = sum(meas["by_category"].get(c, {}).get("gb", 0.0)
                    for c in conv_categories)
    intr_v2 = round(intr["total_gb"] + bridge["gb"], 3)
    out = {
        "intrinsic": intr,
        "bridge_saved_tensors": bridge,
        "intrinsic_v2_total_gb": intr_v2,
        "measured": meas,
        "ratio_total": (round(meas["total_gb"] / intr["total_gb"], 2)
                        if intr["total_gb"] else None),
        "ratio_total_vs_v2": (round(meas["total_gb"] / intr_v2, 2)
                              if intr_v2 else None),
        "ratio_conv_vs_intrinsic_compute": (
            round(conv_meas / intr["compute_gb"], 2)
            if intr["compute_gb"] else None),
    }
    meas_shapes = measured_by_shape(
        tp, steps=steps, categories=tuple(conv_categories) + (
            "bn_epilogue", "other", "reduce"))
    intr_shapes = intrinsic_by_shape(fn, *args, prof=prof)
    joined = []
    for sig, m in sorted(meas_shapes.items(),
                         key=lambda kv: (-kv[1]["gb"], -kv[1]["us"])):
        row = {"stage": sig, "measured_gb": m["gb"], "us": m["us"],
               "fusions": m["count"]}
        il = intr_shapes.get(sig, {}).get("gb", 0.0)
        ib = bridge["by_stage"].get(sig, 0.0)
        if il or ib:
            row["intrinsic_gb"] = round(il + ib, 4)
            row["ratio"] = (round(m["gb"] / (il + ib), 2)
                            if (il + ib) else None)
        joined.append(row)
    out["by_stage_joined"] = joined
    return out


def loader_ledger(stats: Dict[str, Any],
                  bytes_per_batch: Optional[float] = None) -> Dict[str, Any]:
    """Input-engine counters in ledger form: a
    :meth:`apex_tpu_torch.data.LoaderStats.snapshot` joined with
    ``producer_stall_pct`` and ``stage_pct`` (of the wall) and, with
    ``bytes_per_batch``, the staging bandwidth ``stage_bw_gb_s`` over
    every staged batch."""
    out = dict(stats)
    elapsed = float(stats.get("elapsed_s") or 0.0)
    if elapsed > 0:
        out["producer_stall_pct"] = round(
            100.0 * float(stats.get("producer_stall_s", 0.0)) / elapsed, 2)
        out["stage_pct"] = round(
            100.0 * float(stats.get("stage_s", 0.0)) / elapsed, 2)
    if bytes_per_batch and stats.get("stage_s"):
        staged = stats.get("staged", stats.get("batches", 0))
        out["stage_bw_gb_s"] = round(
            staged * bytes_per_batch
            / float(stats["stage_s"]) / 1e9, 2)
    return out

