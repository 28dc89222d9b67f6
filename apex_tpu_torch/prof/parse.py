"""Measured-trace parsing — counterpart of ``apex_tpu/prof/parse.py``
(the ``pyprof.parse`` stage).

:func:`apex_tpu_torch.prof.capture.trace` writes ``torch.profiler``'s
Chrome trace under ``<logdir>/plugins/profile/<timestamp>/``.  This
module reads the newest one into :class:`KernelRecord` rows, one per
device kernel event (kernels, memcpys and memsets; the profiler's
projections of user ranges onto the device are not kernels):

* ``hlo_module`` — the ``/``-joined user ranges
  (:func:`~apex_tpu_torch.prof.capture.scope`, ``record_function``)
  around the launch, outermost first.  The launch is found through the
  kernel's ``correlation`` id to its runtime call, then through time to
  the CPU ops and ranges enclosing that call on its thread.  A backward
  kernel is launched from the autograd engine, outside the forward's
  ranges: it takes the ranges of its forward op, joined through the
  autograd ``Sequence number`` its ``evaluate_function`` range and the
  forward op both carry (pyprof's ``findFpropKernel``).
* ``run_id`` — the step range around the launch: ``ProfilerStep#N``, the
  serving engine's ``prefill[b]``/``decode[b]``, or a trainer's window.
* ``category`` — the kernel's kind, from the tables below
  (:data:`TRAINING_KINDS` by default), which ``chip_smoke.py`` shares.
* ``base_op`` — the hand-written kernel's counted name (its wrapper's,
  the name its launch counter and its analytic record carry), else the
  launching aten op (``mm``), else the kernel's short name.
* ``long_name`` — the kernel's full name; ``input_shapes`` the
  launching op's recorded input shapes.

**Captured graphs.**  A kernel replayed from a CUDA graph correlates to
``cudaGraphLaunch``, not to the op that recorded it at capture: it is
attributed to the ranges around the replay.  Per-region attribution is
for eager steps; a captured step is read whole and by kind.

CLI::

    python -m apex_tpu_torch.prof.parse <logdir> [--json]
"""

from __future__ import annotations

import bisect
import glob
import gzip
import json
import os
import re
from typing import Dict, List, NamedTuple, Optional, Tuple

__all__ = ["KernelRecord", "TraceProfile", "parse_trace", "attach_measured",
           "LOOP_FUSION_CATEGORY", "SERVING_KINDS", "TRAINING_KINDS",
           "RESNET_KINDS", "COUNTED_KERNELS", "kernel_kind", "counted_name",
           "range_host_time", "main"]

#: the kind of the elementwise kernels no other kind names (JAX's
#: ``loop fusion``)
LOOP_FUSION_CATEGORY = "other"

#: kernel kinds by substrings of the (lower-cased) kernel name, first
#: match wins, ``other`` for none: serving steps
SERVING_KINDS = (("qmm", ("qmm_kernel", "qmm_wgmma")),
                 ("flash", ("flash_fwd_",)), ("layer_norm", ("ln_fwd",)),
                 ("gemm", ("gemm", "nvjet", "xmma", "cutlass")),
                 ("index", ("index", "gather", "scatter")))
#: the LM and BERT training steps
TRAINING_KINDS = (("qmm", ("qmm_kernel", "qmm_wgmma")),
                  ("flash_fwd", ("flash_fwd_",)),
                  ("flash_bwd", ("flash_bwd_",)),
                  ("layer_norm", ("ln_fwd", "ln_bwd")),
                  ("loss", ("xent_",)),
                  ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "cublas")),
                  ("optimizer", ("foreach", "multi_tensor")))
#: the ResNet training step: the conv kernels split by pass
RESNET_KINDS = (("conv_fwd_kernel", ("conv_gemm_kernel<0", "kernelili0e",
                                     "conv_fwd_wgmma")),
                ("conv_dgrad_kernel", ("conv_gemm_kernel<1", "kernelili1e",
                                       "conv_gemm_kernel<3",
                                       "kernelili3e", "conv_dgrad_wgmma")),
                ("conv_wgrad_kernel", ("conv_gemm_kernel<2", "kernelili2e",
                                       "wgrad_reduce", "conv_wgrad_wgmma")),
                ("bn_epilogue", ("bn_fwd", "bn_bwd")),
                ("loss", ("xent_",)),
                ("conv", ("conv", "cudnn", "fprop", "dgrad", "wgrad",
                          "implicit", "xmma")),
                ("gemm", ("gemm", "nvjet", "cutlass", "cublas")),
                ("optimizer", ("foreach", "multi_tensor")),
                ("reduce", ("reduce",)))

#: each hand-written kernel's counted name (its wrapper's launch
#: counter) by the names of the device kernels it launches once a call;
#: the second kernels of a call (split-KV's combine, wgrad's reduce) are
#: not launches of their own
COUNTED_KERNELS = (
    ("flash_attention_fwd", ("flash_fwd_wgmma", "flash_fwd_mma",
                             "flash_fwd_simt", "flash_fwd_split")),
    ("flash_attention_bwd_dq", ("flash_bwd_dq",)),
    ("flash_attention_bwd_dkv", ("flash_bwd_dkv",)),
    ("flash_attention_bwd_db2", ("flash_bwd_db2",)),
    ("layer_norm_fwd", ("ln_fwd",)),
    ("layer_norm_bwd", ("ln_bwd",)),
    ("bn_act_fwd", ("bn_fwd",)),
    ("bn_act_bwd", ("bn_bwd",)),
    ("xentropy_fwd", ("xent_fwd",)),
    ("xentropy_bwd", ("xent_bwd",)),
    ("conv_fwd", ("conv_gemm_kernel<0", "kernelili0e", "conv_fwd_wgmma")),
    ("conv_dgrad", ("conv_gemm_kernel<1", "kernelili1e",
                    "conv_gemm_kernel<3", "kernelili3e", "conv_dgrad_wgmma")),
    ("conv_wgrad", ("conv_gemm_kernel<2", "kernelili2e", "conv_wgrad_wgmma")),
    ("qmm", ("qmm_kernel", "qmm_wgmma")))

#: device events that are work (the rest are projections of user ranges)
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: ranges that name a step rather than a region
_RUN_RE = re.compile(r"^(ProfilerStep#\d+|prefill\[\d+\]|decode\[\d+\]"
                     r"|window\b.*)$")


def kernel_kind(name: str, kinds=TRAINING_KINDS) -> str:
    """The first kind of ``kinds`` one of whose substrings the
    lower-cased kernel name holds; ``other`` for none."""
    low = name.lower()
    for kind, keys in kinds:
        if any(k in low for k in keys):
            return kind
    return "other"


def counted_name(name: str) -> Optional[str]:
    """The counted kernel (:data:`COUNTED_KERNELS`) a device kernel's
    launch counts for, or None."""
    low = name.lower()
    for counted, keys in COUNTED_KERNELS:
        if any(k in low for k in keys):
            return counted
    return None


class KernelRecord(NamedTuple):
    """One measured device kernel (the reference's per-kernel dict;
    JAX's fields, and the launching op's recorded input shapes)."""
    name: str              # the kernel's name
    base_op: str           # counted kernel, launching aten op, or short name
    hlo_module: str        # the user ranges around the launch
    duration_us: float
    start_us: float
    run_id: str            # the step range around the launch
    device: str
    category: str = ""     # the kernel's kind
    model_flops: float = 0.0
    bytes_accessed: float = 0.0
    long_name: str = ""
    input_shapes: tuple = ()


def _newest_run_dir(logdir: str) -> str:
    runs = sorted(glob.glob(os.path.join(logdir, "plugins", "profile", "*")))
    if not runs:
        raise FileNotFoundError(
            f"no profile runs under {logdir!r} (expected "
            f"plugins/profile/<timestamp>/) — did capture.trace run?")
    return runs[-1]


class TraceProfile:
    """Parsed measured trace: records, aggregates, step segmentation."""

    def __init__(self, records: List[KernelRecord]):
        self.records = records

    def by_op(self) -> Dict[str, dict]:
        """Measured time per ``base_op``."""
        out: Dict[str, dict] = {}
        for r in self.records:
            agg = out.setdefault(r.base_op,
                                 {"count": 0, "total_us": 0.0, "max_us": 0.0})
            agg["count"] += 1
            agg["total_us"] += r.duration_us
            agg["max_us"] = max(agg["max_us"], r.duration_us)
        for agg in out.values():
            agg["mean_us"] = agg["total_us"] / agg["count"]
        return out

    def by_category(self) -> Dict[str, dict]:
        """Measured time (and the trace's FLOPs and bytes, which a CUDA
        trace does not carry: 0) per kind."""
        out: Dict[str, dict] = {}
        for r in self.records:
            if not r.category:
                continue
            agg = out.setdefault(r.category, {
                "count": 0, "total_us": 0.0, "flops": 0.0, "bytes": 0.0})
            agg["count"] += 1
            agg["total_us"] += r.duration_us
            agg["flops"] += r.model_flops
            agg["bytes"] += r.bytes_accessed
        for agg in out.values():
            agg["tflops_per_sec"] = (agg["flops"] / agg["total_us"] / 1e6
                                     if agg["total_us"] else 0.0)
        return out

    def by_region(self, depth: int = 1) -> Dict[str, float]:
        """Measured microseconds per
        :func:`~apex_tpu_torch.prof.capture.region_path` region of
        ``hlo_module`` (``<unattributed>`` for none)."""
        from .capture import region_path
        out: Dict[str, float] = {}
        for r in self.records:
            key = region_path(r.hlo_module, depth)
            out[key] = out.get(key, 0.0) + r.duration_us
        return out

    def launches(self) -> Dict[str, int]:
        """Launches per counted kernel (:data:`COUNTED_KERNELS`)."""
        out: Dict[str, int] = {}
        for r in self.records:
            name = counted_name(r.long_name or r.name)
            if name is not None:
                out[name] = out.get(name, 0) + 1
        return out

    def steps(self) -> Dict[str, float]:
        """Device microseconds per ``run_id``."""
        out: Dict[str, float] = {}
        for r in self.records:
            out[r.run_id] = out.get(r.run_id, 0.0) + r.duration_us
        return out

    @property
    def total_us(self) -> float:
        return sum(r.duration_us for r in self.records)

    def summary(self, top: int = 20) -> str:
        rows = sorted(self.by_op().items(), key=lambda kv: -kv[1]["total_us"])
        lines = ["{:<28} {:>7} {:>12} {:>12}".format(
            "op", "count", "total_us", "mean_us")]
        for name, agg in rows[:top]:
            lines.append("{:<28} {:>7} {:>12.1f} {:>12.2f}".format(
                name[:28], agg["count"], agg["total_us"], agg["mean_us"]))
        cats = self.by_category()
        if cats:
            lines.append("")
            lines.append("{:<28} {:>7} {:>12}".format(
                "kind", "count", "total_us"))
            for name, agg in sorted(cats.items(),
                                    key=lambda kv: -kv[1]["total_us"])[:top]:
                lines.append("{:<28} {:>7} {:>12.1f}".format(
                    name, agg["count"], agg["total_us"]))
        lines.append(f"TOTAL measured: {self.total_us:.1f} us over "
                     f"{len(self.steps())} step(s)")
        return "\n".join(lines)


# -- the trace's CPU side: ranges and ops nested per thread -------------------

class _Thread:
    """One thread's CPU events, nested: for a time, the chain of events
    that enclose it, innermost first."""

    def __init__(self, events):
        events.sort(key=lambda e: (e["ts"], -e["dur"]))
        self.events = events
        self.starts = [e["ts"] for e in events]
        self.parent = [-1] * len(events)
        stack: List[int] = []
        for i, e in enumerate(events):
            while stack and (events[stack[-1]]["ts"] + events[stack[-1]]["dur"]
                             < e["ts"] + e["dur"]):
                stack.pop()
            self.parent[i] = stack[-1] if stack else -1
            stack.append(i)

    def chain(self, ts: float) -> list:
        i = bisect.bisect_right(self.starts, ts) - 1
        while i >= 0:
            e = self.events[i]
            if e["ts"] + e["dur"] >= ts:
                break
            i = self.parent[i]
        out = []
        while i >= 0:
            out.append(self.events[i])
            i = self.parent[i]
        return out


def _load_events(run_dir: str) -> list:
    paths = (glob.glob(os.path.join(run_dir, "*.trace.json.gz"))
             + glob.glob(os.path.join(run_dir, "*.trace.json")))
    if not paths:
        raise FileNotFoundError(f"no *.trace.json[.gz] in {run_dir!r}")
    events = []
    for path in paths:
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:
            events.extend(json.load(f).get("traceEvents", []))
    return events


def _short(name: str) -> str:
    name = re.sub(r"^void\s+", "", name)
    return re.split(r"[<(]", name, 1)[0].strip() or name


def _ranges(chain) -> Tuple[str, str]:
    """(user ranges outermost first, the run range) of a chain."""
    users, run = [], ""
    for e in reversed(chain):
        if e.get("cat") != "user_annotation":
            continue
        if _RUN_RE.match(e["name"]):
            run = e["name"]
        else:
            users.append(e["name"])
    return "/".join(users), run


def parse_trace(logdir: str, module_filter: Optional[str] = None,
                kinds=TRAINING_KINDS) -> TraceProfile:
    """Parse the newest profile run under ``logdir`` (the module
    docstring); ``module_filter`` keeps the kernels whose ``hlo_module``
    holds the substring; ``kinds`` is the kind table for ``category``."""
    events = _load_events(_newest_run_dir(logdir))
    threads: Dict[tuple, list] = {}
    runtime: Dict[int, dict] = {}
    kernels = []
    fwd_by_seq: Dict[int, tuple] = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        args = e.get("args") or {}
        e.setdefault("dur", 0.0)
        if cat in _DEVICE_CATS:
            kernels.append(e)
        elif cat in ("cuda_runtime", "cuda_driver"):
            if "correlation" in args:
                runtime[args["correlation"]] = e
        elif cat in ("cpu_op", "user_annotation"):
            threads.setdefault((e.get("pid"), e.get("tid")), []).append(e)
            seq = args.get("Sequence number")
            if (cat == "cpu_op" and seq is not None
                    and not e["name"].startswith("autograd::")):
                key = (e.get("pid"), e.get("tid"))
                if seq not in fwd_by_seq or e["ts"] < fwd_by_seq[seq][1]:
                    fwd_by_seq[seq] = (key, e["ts"])
    index = {k: _Thread(v) for k, v in threads.items()}
    # the step ranges of every thread: a backward thread's kernels fall
    # in the forward thread's step by time
    runs = sorted((e["ts"], e["ts"] + e["dur"], e["name"])
                  for v in threads.values() for e in v
                  if e.get("cat") == "user_annotation"
                  and _RUN_RE.match(e["name"]))

    def run_at(ts):
        name = ""
        for lo, hi, n in runs:
            if lo > ts:
                break
            if hi >= ts:
                name = n
        return name

    records: List[KernelRecord] = []
    for k in kernels:
        args = k.get("args") or {}
        launch = runtime.get(args.get("correlation"))
        module, run, base, shapes = "", "", None, ()
        if launch is not None:
            key = (launch.get("pid"), launch.get("tid"))
            chain = index[key].chain(launch["ts"]) if key in index else []
            module, run = _ranges(chain)
            graph = launch["name"].startswith("cudaGraphLaunch")
            ops = [e for e in chain if e.get("cat") == "cpu_op"]
            if ops and not graph:
                op = ops[0]
                shapes = tuple(tuple(d) for d in
                               (op.get("args") or {}).get("Input Dims", [])
                               if isinstance(d, list))
                if op["name"].startswith("aten::"):
                    base = op["name"][len("aten::"):]
            backward = next((e for e in ops if e["name"].startswith(
                "autograd::engine::evaluate_function")), None)
            if backward is not None and not graph:
                seq = (backward.get("args") or {}).get("Sequence number")
                fwd = fwd_by_seq.get(seq)
                if fwd is not None and fwd[0] in index:
                    module, _ = _ranges(index[fwd[0]].chain(fwd[1]))
            if not run:
                run = run_at(launch["ts"])
        if module_filter and module_filter not in module:
            continue
        name = k.get("name", "")
        base = counted_name(name) or base or _short(name)
        records.append(KernelRecord(
            name=name, base_op=base, hlo_module=module,
            duration_us=float(k["dur"]), start_us=float(k.get("ts", 0.0)),
            run_id=run, device=str(args.get("device", k.get("pid", ""))),
            category=kernel_kind(name, kinds), long_name=name,
            input_shapes=shapes))
    records.sort(key=lambda r: r.start_us)
    return TraceProfile(records)


def range_host_time(logdir: str, prefix: str = "decode[") -> Dict[str, dict]:
    """Where the host time of each named step range goes: for the ranges
    whose name starts with ``prefix`` (the serving engine's
    ``decode[b]``), per range name the count and, per range, its host
    microseconds, the share covered by the CPU events directly inside it
    (ops, runtime calls, nested ranges) and the gaps between them, and
    the covered time by event name, largest first."""
    events = _load_events(_newest_run_dir(logdir))
    threads: Dict[tuple, list] = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in (
                "cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"):
            e.setdefault("dur", 0.0)
            threads.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    out: Dict[str, dict] = {}
    for evs in threads.values():
        th = _Thread(evs)
        children: Dict[int, List[int]] = {}
        for j, parent in enumerate(th.parent):
            children.setdefault(parent, []).append(j)
        for i, e in enumerate(th.events):
            if not e["name"].startswith(prefix):
                continue
            row = out.setdefault(e["name"], {"count": 0, "host_us": 0.0,
                                             "covered_us": 0.0,
                                             "by_name": {}})
            row["count"] += 1
            row["host_us"] += e["dur"]
            for j in children.get(i, ()):
                child = th.events[j]
                row["covered_us"] += child["dur"]
                row["by_name"][child["name"]] = (
                    row["by_name"].get(child["name"], 0.0) + child["dur"])
    for row in out.values():
        n = row["count"]
        row["host_us"] /= n
        row["covered_us"] /= n
        row["gaps_us"] = row["host_us"] - row["covered_us"]
        row["by_name"] = dict(sorted(
            ((k, v / n) for k, v in row["by_name"].items()),
            key=lambda kv: -kv[1]))
    return out


# -- join with the static analysis (the reference ``prof`` stage input) -------

_STATIC_ALIASES = {
    # measured base op -> static op names it may cover
    "cudnn_convolution": ("convolution",),
    "convolution_backward": ("convolution_backward",),
    "linear": ("addmm", "mm"),
    "matmul": ("mm", "bmm"),
}


def attach_measured(profile, trace: TraceProfile, top: int = 20) -> str:
    """The static analysis with measured time joined per op name:
    analytic FLOPs and bytes next to measured microseconds (a measured
    op covering several static ones has its time apportioned by their
    FLOPs, so per-op times still sum to the trace's)."""
    measured = trace.by_op()

    static_by_op: Dict[str, dict] = {}
    for r in profile.records:
        agg = static_by_op.setdefault(r.op, {"flops": 0.0, "bytes": 0.0})
        agg["flops"] += r.flops * r.count
        agg["bytes"] += r.bytes * r.count

    joined: Dict[str, dict] = dict(measured)
    for meas_name, prims in _STATIC_ALIASES.items():
        if meas_name not in measured:
            continue
        present = [p for p in prims
                   if p in static_by_op and p not in joined]
        if not present:
            continue
        total_flops = sum(static_by_op[p]["flops"] for p in present)
        for p in present:
            share = (static_by_op[p]["flops"] / total_flops
                     if total_flops else 1.0 / len(present))
            m = dict(measured[meas_name])
            m["total_us"] = m.get("total_us", 0.0) * share
            joined[p] = m

    lines = ["{:<24} {:>13} {:>13} {:>11} {:>11}".format(
        "op", "flops", "bytes", "meas_us", "GFLOP/s")]
    order = sorted(static_by_op.items(),
                   key=lambda kv: -joined.get(kv[0], {}).get("total_us", 0.0))
    for op, agg in order[:top]:
        m = joined.get(op)
        if m:
            us = m["total_us"]
            rate = agg["flops"] / us / 1e3 if us else 0.0
            lines.append("{:<24} {:>13.3g} {:>13.3g} {:>11.1f} {:>11.1f}"
                         .format(op[:24], agg["flops"], agg["bytes"], us,
                                 rate))
        else:
            lines.append("{:<24} {:>13.3g} {:>13.3g} {:>11} {:>11}"
                         .format(op[:24], agg["flops"], agg["bytes"], "-",
                                 "-"))
    unmatched = sorted(set(measured) - set(static_by_op)
                       - set(_STATIC_ALIASES))
    if unmatched:
        lines.append("measured-only ops: " + ", ".join(unmatched[:10]))
    return "\n".join(lines)


# -- CLI ----------------------------------------------------------------------

def main(argv: Optional[List[str]] = None) -> int:
    """``python -m apex_tpu_torch.prof.parse <logdir>``: parse a trace
    directory and print the measured per-op report (``--json``: one
    record a kernel)."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.prof.parse",
        description="Parse a torch.profiler trace directory into a "
                    "measured per-op report.")
    ap.add_argument("logdir", help="trace logdir (from prof.capture.trace)")
    ap.add_argument("--module-filter", default=None,
                    help="keep only kernels whose ranges contain this "
                         "substring")
    ap.add_argument("--top", type=int, default=20,
                    help="rows per table (default 20)")
    ap.add_argument("--json", action="store_true",
                    help="emit one JSON record per measured kernel")
    args = ap.parse_args(argv)

    trace = parse_trace(args.logdir, module_filter=args.module_filter)
    if args.json:
        for r in trace.records:
            print(json.dumps(r._asdict()))
    else:
        print(trace.summary(top=args.top))
    return 0


if __name__ == "__main__":  # pragma: no cover - exercised via subprocess
    raise SystemExit(main())
