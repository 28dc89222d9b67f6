"""Per-op FLOPs and bytes of one call — counterpart of
``apex_tpu/prof/analysis.py`` (the ``pyprof.prof`` stage).

JAX walks the jaxpr of the call.  The port runs the call once under a
``FakeTensorMode`` (shapes, dtypes and devices, no data: nothing runs on
a device, no state moves, no graph is captured) and records one
:class:`OpRecord` per aten op a ``TorchDispatchMode`` sees, by JAX's
rules: ``mm``/``bmm``/``addmm``/``baddbmm``/``convolution`` and the
convolution's backward count the product's FLOPs, elementwise ops their
output elements, reductions their input elements, data movement none;
bytes are the inputs' plus the outputs'.

The hand-written kernels are launches no dispatch mode sees.  Each
kernel's entry point asks :func:`apex_tpu_torch.prof.costs.counting`
for the walk on its thread's dispatch-mode stack and, given a fake
operand under this walk, reports one record with its analytic cost
(:mod:`.costs`, the formulas ``chip_smoke.py``'s bounds use) and runs
its plain version with the aten ops hidden, so a kernel counts once, the
same on the CPU and on the card.

Regions: a forward op takes the ``/``-joined names of the open
:func:`~apex_tpu_torch.prof.capture.scope` ranges.  The backward runs
from the autograd engine, outside them; so the walk stamps each autograd
node with the region of the op whose output it is (``node.metadata``; a
custom Function's node takes its forward's last op's), and an op that
runs inside a node's backward takes the node's region, with the scopes
the backward opens inside it, as JAX's ``transpose(jvp(scope))`` peels
back to ``scope``.

With ``xla_cost=True`` the same call is counted again by
``torch.utils.flop_counter.FlopCounterMode``, the library's own count
(the counterpart of JAX's cross-check against XLA's
``cost_analysis``): it sees the kernels' plain versions, not their
formulas, and counts products only.
"""

from __future__ import annotations

import math
import weakref
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

from . import capture

__all__ = ["OpRecord", "Profile", "profile_function", "main"]


@dataclass
class OpRecord:
    """One op's analytic cost (reference ``pyprof/prof/data.py`` Data)."""
    index: int
    op: str                     # aten op, or the hand-written kernel
    name: str                   # the scope path it ran under
    in_shapes: list
    in_dtypes: list
    out_shapes: list
    out_dtypes: list
    flops: float                # analytic floating (or int8) operations
    bytes: float                # analytic memory traffic (read + write)
    count: int = 1              # multiplicity

    @property
    def intensity(self) -> float:
        """Arithmetic intensity flop/byte: the roofline coordinate."""
        return self.flops / self.bytes if self.bytes else 0.0


#: the products: FLOPs charged to these are "matmul FLOPs" downstream
PRODUCT_OPS = ("mm", "bmm", "addmm", "baddbmm", "addbmm", "convolution",
               "convolution_backward")

_ELEMENTWISE = frozenset((
    "add", "sub", "rsub", "mul", "div", "neg", "exp", "exp2", "log", "log2",
    "log1p", "expm1", "tanh", "sigmoid", "rsqrt", "sqrt", "pow", "abs",
    "sign", "floor", "ceil", "round", "trunc", "erf", "erfinv", "where",
    "clamp", "clamp_min", "clamp_max", "maximum", "minimum", "eq", "ne",
    "ge", "gt", "le", "lt", "logical_and", "logical_or", "logical_not",
    "logical_xor", "bitwise_and", "bitwise_or", "bitwise_not",
    "bitwise_xor", "reciprocal", "relu", "gelu", "silu", "leaky_relu",
    "elu", "hardtanh", "softplus", "threshold", "threshold_backward",
    "gelu_backward", "sigmoid_backward", "tanh_backward", "silu_backward",
    "leaky_relu_backward", "elu_backward", "hardtanh_backward", "cos",
    "sin", "tan", "atan2", "lerp", "addcmul", "addcdiv", "square",
    "masked_fill", "fmod", "remainder", "isinf", "isnan", "isfinite",
    "nan_to_num", "xlogy", "hypot", "copysign", "fma"))

_REDUCTIONS = frozenset((
    "sum", "mean", "amax", "amin", "max", "min", "prod", "argmax", "argmin",
    "cumsum", "cumprod", "var", "std", "var_mean", "std_mean", "logsumexp",
    "_log_softmax", "_softmax", "_log_softmax_backward_data",
    "_softmax_backward_data", "native_layer_norm",
    "native_layer_norm_backward", "native_batch_norm",
    "native_batch_norm_backward", "_native_batch_norm_legit",
    "_native_batch_norm_legit_functional",
    "_native_batch_norm_legit_no_training", "norm", "linalg_vector_norm",
    "nll_loss_forward", "nll_loss_backward", "nll_loss2d_forward",
    "nll_loss2d_backward", "all", "any", "count_nonzero", "topk", "sort",
    "max_pool2d_with_indices", "max_pool2d_with_indices_backward",
    "avg_pool2d", "avg_pool2d_backward", "_adaptive_avg_pool2d",
    "_adaptive_avg_pool2d_backward", "embedding_dense_backward",
    "mse_loss", "mse_loss_backward"))


# the profiler's own ranges: no work
_NOT_OPS = frozenset(("_record_function_enter", "_record_function_enter_new",
                      "_record_function_exit"))


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _base_name(func) -> str:
    name = func.overloadpacket.__name__
    if name.endswith("_") and not name.startswith("_") \
            and not name.endswith("__"):
        name = name[:-1]                   # in place: add_ is add
    if name.startswith("_foreach_"):
        name = name[len("_foreach_"):]
        if name.endswith("_"):
            name = name[:-1]
    return name


def _conv_flops(x_shape, w_shape, out_shape, transposed) -> float:
    """2 x multiply-adds of the product: each output element of a conv
    takes ``C/groups x kh x kw`` of them (a transposed conv: each input
    element ``O/groups x kh x kw``)."""
    per = math.prod(w_shape[1:])
    if transposed:
        return 2.0 * math.prod(x_shape) * per
    return 2.0 * math.prod(out_shape) * per


def _product_flops(name, args, outs) -> float:
    if name in ("mm", "addmm", "bmm", "baddbmm", "addbmm"):
        a, b = (args[0], args[1]) if name in ("mm", "bmm") \
            else (args[1], args[2])
        batch = a.shape[0] if a.dim() == 3 else 1
        return 2.0 * batch * a.shape[-2] * a.shape[-1] * b.shape[-1]
    if name == "convolution":
        return _conv_flops(args[0].shape, args[1].shape, outs[0].shape,
                           bool(args[6]))
    # convolution_backward(grad_out, input, weight, ..., transposed=7,
    # ..., output_mask=10): the forward product per gradient asked for
    grad_out, x, w = args[0], args[1], args[2]
    mask = args[10]
    fwd = _conv_flops(x.shape, w.shape, grad_out.shape, bool(args[7]))
    return fwd * (int(bool(mask[0])) + int(bool(mask[1])))


def _flops(name, args, outs) -> float:
    if name in PRODUCT_OPS:
        return _product_flops(name, args, outs)
    if name in _REDUCTIONS:
        return float(sum(t.numel() for t in _tensors(args)))
    if name in _ELEMENTWISE:
        return float(sum(t.numel() for t in outs))
    return 0.0


def _stamp_nodes(tensors, region: str) -> None:
    """Stamp the autograd nodes of ``tensors``, and every unstamped node
    behind them, with ``region``."""
    todo = [getattr(t, "grad_fn", None) for t in tensors]
    while todo:
        node = todo.pop()
        if node is None or "prof_region" in node.metadata:
            continue
        node.metadata["prof_region"] = region
        todo.extend(n for n, _ in node.next_functions)


class _Stamp(TorchFunctionMode):
    """Stamps each new autograd node with its region: the outputs'
    nodes with the op's region; nodes the mode did not see made (a
    custom Function's, which ``apply`` makes below it) with the region
    of the last forward op, its forward's last."""

    def __init__(self, walk):
        super().__init__()
        self.walk = walk

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        _stamp_nodes(_tensors((args, kwargs)), self.walk.last_region)
        out = func(*args, **kwargs)
        _stamp_nodes(_tensors(out), self.walk.region())
        return out


class _Walk(TorchDispatchMode):
    """The dispatch mode that records the call's ops (and, with
    ``memory``, tracks each storage from the op that makes it until its
    last reference dies).  The kernels' entry points find it on the
    dispatch-mode stack by ``counts_kernels``."""

    counts_kernels = True

    def __init__(self, memory: bool = False):
        super().__init__()
        self.records: List[OpRecord] = []
        self.hidden = 0
        self.memory = memory
        # storage key -> (bytes, region, shape, dtype); running total
        self.live: Dict[int, tuple] = {}
        self.arguments: Dict[int, tuple] = {}
        self.total = 0
        self.peak = 0
        self.snap: Dict[int, tuple] = {}
        # the region of the last forward op recorded
        self.last_region = ""

    # -- regions --------------------------------------------------------------

    def region(self) -> str:
        node = torch._C._current_autograd_node()
        if node is None:
            return capture.current_scope()
        inner = capture.current_scope(node)
        base = node.metadata.get("prof_region", "")
        return "/".join(p for p in (base, inner) if p)

    # -- the kernel hook (apex_tpu_torch.prof.costs.counting) ----------------

    def kernel(self, cost, plain: Callable, *args, **kwargs):
        """Record ``cost`` (a :class:`~.costs.KernelCost`, or a list of
        them for one plain version computing several kernels' outputs) and
        return ``plain(*args, **kwargs)``, its aten ops hidden.  The
        memory walk keeps the kernel's outputs only: the plain version's
        temporaries (the softmax of the logits, the attention
        probabilities) are not the kernel's."""
        ins = _tensors((args, kwargs))
        if self.memory:
            self._arguments(ins)
        self.hidden += 1
        try:
            out = plain(*args, **kwargs)
        finally:
            self.hidden -= 1
        outs = _tensors(out)
        for c in (cost if isinstance(cost, list) else [cost]):
            self._record(c.name, c.flops, c.bytes, ins, outs)
        if self.memory:
            self._born(outs)
        return out

    # -- the walk -------------------------------------------------------------

    def _record(self, op, flops, nbytes, ins, outs):
        region = self.region()
        if torch._C._current_autograd_node() is None:
            self.last_region = region
        self.records.append(OpRecord(
            index=len(self.records), op=op, name=region,
            in_shapes=[tuple(t.shape) for t in ins],
            in_dtypes=[str(t.dtype) for t in ins],
            out_shapes=[tuple(t.shape) for t in outs],
            out_dtypes=[str(t.dtype) for t in outs],
            flops=float(flops), bytes=float(nbytes)))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.hidden:
            return func(*args, **kwargs)
        if self.memory:
            self._arguments(_tensors((args, kwargs)))
        out = func(*args, **kwargs)
        name = _base_name(func)
        if func.namespace == "prim" or name in _NOT_OPS:
            return out
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        self._record(name, _flops(name, args, outs),
                     sum(_nbytes(t) for t in ins)
                     + sum(_nbytes(t) for t in outs), ins, outs)
        if self.memory:
            self._born(outs)
        return out

    # -- the memory walk ------------------------------------------------------

    @staticmethod
    def _key(t):
        try:
            s = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return None, None
        return s._cdata, s

    def _arguments(self, ins):
        for t in ins:
            key, s = self._key(t)
            if key is None or key in self.live or key in self.arguments:
                continue
            entry = (s.nbytes(), "<arguments>", tuple(t.shape),
                     str(t.dtype))
            self.arguments[key] = entry
            self.live[key] = entry
            self.total += entry[0]
        self._check_peak()

    def _born(self, outs):
        region = None
        for t in outs:
            key, s = self._key(t)
            if key is None or key in self.live:
                continue
            if region is None:
                region = self.region()
            entry = (s.nbytes(), region, tuple(t.shape), str(t.dtype))
            self.live[key] = entry
            self.total += entry[0]
            weakref.finalize(s, self._free, key)
        self._check_peak()

    def _free(self, key):
        entry = self.live.pop(key, None)
        if entry is not None and key not in self.arguments:
            self.total -= entry[0]

    def _check_peak(self):
        if self.total > self.peak:
            self.peak = self.total
            self.snap = dict(self.live)


class _GlobalOnly:
    """A module tracker that attributes every op to ``Global``."""
    parents = frozenset(("Global",))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


def _run(fn, args, kwargs, walk: Optional[_Walk], library: bool = False):
    """Run ``fn(*args, **kwargs)`` once under a fake-tensor mode with
    ``walk`` (or, with ``library``, FlopCounterMode) counting; returns
    the walk, or the FlopCounterMode total."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = FakeTensorMode(allow_non_fake_inputs=True)

    def fake(x):
        return mode.from_tensor(x) if isinstance(x, torch.Tensor) else x
    fargs, fkwargs = tree_map(fake, (tuple(args), dict(kwargs)))
    if library:
        from torch.utils.flop_counter import FlopCounterMode
        counter = FlopCounterMode(display=False)
        # count globally: the library's module tracker hooks each
        # module's inputs, which autograd.grad over leaves refuses
        counter.mod_tracker = _GlobalOnly()
        # a walk above it, so the kernels' entry points run their plain
        # versions, whose ops the counter sees
        with mode, counter, _Walk():
            fn(*fargs, **fkwargs)
        return float(counter.get_total_flops())
    if walk.memory:
        walk._arguments(_tensors((fargs, fkwargs)))
    with mode, _Stamp(walk), walk:
        out = fn(*fargs, **fkwargs)
    if walk.memory:
        walk.outputs = _tensors(out)
    return walk


class Profile:
    """Result of :func:`profile_function`: records, totals and summary;
    ``xla_cost`` holds FlopCounterMode's count of the same call
    (``{"flops": ..., "source": "flop_counter"}``) when asked for."""

    def __init__(self, records: List[OpRecord],
                 xla_cost: Optional[dict] = None):
        self.records = records
        self.xla_cost = xla_cost or {}

    @property
    def total_flops(self) -> float:
        return sum(r.flops * r.count for r in self.records)

    @property
    def total_bytes(self) -> float:
        return sum(r.bytes * r.count for r in self.records)

    def by_op(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for r in self.records:
            out[r.op] = out.get(r.op, 0.0) + r.flops * r.count
        return out

    def summary(self, top: int = 20) -> str:
        """Tabular report: op, flops, bytes, intensity, tensor-core
        eligibility (the products and the product kernels), shapes."""
        from .ledger import COMPUTE_OPS
        rows = sorted(self.records, key=lambda r: -(r.flops * r.count))[:top]
        lines = ["{:<5} {:<24} {:>14} {:>14} {:>9} {:>4}  {}".format(
            "idx", "op", "flops", "bytes", "intens", "TC", "shapes")]
        for r in rows:
            tc = "yes" if r.op in COMPUTE_OPS else ""
            lines.append("{:<5} {:<24} {:>14.3g} {:>14.3g} {:>9.2f} {:>4}  {}"
                         .format(r.index, r.op[:24], r.flops * r.count,
                                 r.bytes * r.count, r.intensity, tc,
                                 "{}->{}".format(r.in_shapes, r.out_shapes)))
        lines.append("TOTAL flops={:.4g} bytes={:.4g}  (flop_counter: "
                     "flops={})".format(self.total_flops, self.total_bytes,
                                        self.xla_cost.get("flops", "n/a")))
        return "\n".join(lines)


def profile_function(fn: Callable, *args, xla_cost: bool = True,
                     **kwargs) -> Profile:
    """Count ``fn(*args, **kwargs)`` (one call, on fake tensors of the
    arguments' shapes, dtypes and devices) into a :class:`Profile`; with
    ``xla_cost`` also FlopCounterMode's count of the same call."""
    walk = _run(fn, args, kwargs, _Walk())
    cost = None
    if xla_cost:
        cost = {"flops": _run(fn, args, kwargs, None, library=True),
                "source": "flop_counter"}
    return Profile(walk.records, cost)


# -- CLI ----------------------------------------------------------------------

def _load_target(spec: str):
    """Resolve ``module:attr`` to a Python object."""
    import importlib

    mod_name, _, attr = spec.partition(":")
    if not attr:
        raise SystemExit(f"--fn needs module:callable, got {spec!r}")
    obj = importlib.import_module(mod_name)
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


def _markers_table(path: str, top: int) -> str:
    """Render a dumped-markers file (:func:`.capture.dump_markers`) as
    the captured-op table (op name and argument shapes/dtypes)."""
    import json

    lines = ["{:<28} {}".format("marker op", "args")]
    with open(path) as f:
        for i, line in enumerate(f):
            if i >= top:
                lines.append("...")
                break
            m = json.loads(line)

            def fmt(d):
                if "shape" in d:
                    return f"{tuple(d['shape'])}:{d.get('dtype', '?')}"
                if "value" in d:
                    return repr(d["value"])
                return d.get("type", "?")
            args = [fmt(a) for a in m.get("args", [])]
            args += [f"{k}={fmt(v)}" for k, v in m.get("kwargs", {}).items()]
            lines.append("{:<28} {}".format(m.get("op", "?"), ", ".join(args)))
    return "\n".join(lines)


#: the target the CLIs profile without ``--fn``: LeNet's training step
DEFAULT_FN = "apex_tpu_torch.examples.prof.lenet:entry"


def main(argv: Optional[Sequence[str]] = None) -> int:
    """``python -m apex_tpu_torch.prof.analysis``: the per-op FLOPs and
    bytes report of a target, optionally joined with a measured trace
    directory and a dumped-markers file.

    ``--fn module:callable``: a zero-argument callable returning ``(fn,
    example_args)`` (the default, :data:`DEFAULT_FN`), or with
    ``--shape``/``--dtype`` per positional argument a function profiled
    on zero tensors of those shapes."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.prof.analysis",
        description="Analytic per-op FLOPs/bytes report (+ optional "
                    "measured-trace join).")
    ap.add_argument("--fn", default=DEFAULT_FN,
                    help="module:callable — returns (fn, args) when called "
                         "with no arguments, or is profiled directly with "
                         "--shape/--dtype example inputs")
    ap.add_argument("--shape", action="append", default=[],
                    help="example-arg shape as comma-separated ints (repeat "
                         "per positional argument); e.g. --shape 8,128")
    ap.add_argument("--dtype", action="append", default=[],
                    help="dtype per --shape (default float32)")
    ap.add_argument("--trace", default=None,
                    help="trace logdir to join measured kernel times "
                         "(capture.trace's output)")
    ap.add_argument("--markers", default=None,
                    help="dumped markers file (capture.dump_markers)")
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--no-xla-cost", action="store_true",
                    help="skip the FlopCounterMode cross-check")
    args = ap.parse_args(argv)

    target = _load_target(args.fn)
    if args.shape:
        dtypes = list(args.dtype) + ["float32"] * (len(args.shape)
                                                   - len(args.dtype))
        ex = tuple(torch.zeros(tuple(int(s) for s in sh.split(",") if s),
                               dtype=getattr(torch, dt))
                   for sh, dt in zip(args.shape, dtypes))
        fn = target
    else:
        fn, ex = target()

    prof = profile_function(fn, *ex, xla_cost=not args.no_xla_cost)
    print(prof.summary(top=args.top))
    if args.trace:
        from .parse import attach_measured, parse_trace
        print()
        print(attach_measured(prof, parse_trace(args.trace), top=args.top))
    if args.markers:
        print()
        print(_markers_table(args.markers, args.top))
    return 0


if __name__ == "__main__":  # pragma: no cover - exercised via subprocess
    raise SystemExit(main())
