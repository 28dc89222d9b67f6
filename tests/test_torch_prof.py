"""The port's profiling stages (``apex_tpu_torch.prof``: capture, parse,
analysis, trace_count and the kernels' cost hook) against the JAX
package's ``apex_tpu.prof`` on the same numpy inputs.

Counterparts of JAX's ``tests/test_prof.py``: the analytic walk's
FLOPs and bytes equal JAX's jaxpr walk's exactly where both count the
same op (a matmul, a conv, elementwise ops, reductions; the JAX
``scan`` multiplicity against a Python loop), the markers are JAX's
dicts, ``parse_trace`` reads a hand-written Chrome trace (kernel,
runtime and CPU-op events joined by correlation ids, a graph replay, a
backward op joined to its forward by its sequence number) and a real CPU
``torch.profiler`` trace, and ``assert_trace_count`` pins one capture
and no recapture on a CPU ``StepPipeline`` and ``ServingEngine`` (on
the CPU a capture is a program's first run).  Each hand-written
kernel's entry point counts once, by its formula in ``prof.costs``,
with its plain version's ops hidden.
"""

import gzip
import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from apex_tpu import prof as jprof
from apex_tpu import telemetry as jtelemetry
from apex_tpu_torch import prof, runtime, telemetry, training
from apex_tpu_torch.prof import capture, costs, parse
from apex_tpu_torch.prof.analysis import profile_function


@pytest.fixture(autouse=True)
def _markers_off():
    yield
    prof.init(enable_markers=False)
    jprof.init(enable_markers=False)
    prof.MARKERS.clear()
    jprof.MARKERS.clear()
    telemetry.set_recorder(None)
    jtelemetry.set_recorder(None)


def _np(*shapes, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# -- the analytic walk --------------------------------------------------------

def test_matmul_flops_exact():
    a, b = _np((64, 32), (32, 128))
    want = [r for r in jprof.profile_function(
        lambda x, y: x @ y, jnp.asarray(a), jnp.asarray(b),
        xla_cost=False).records if r.op == "dot_general"][0]
    p = profile_function(lambda x, y: x @ y, *_t(a, b), xla_cost=False)
    mms = [r for r in p.records if r.op == "mm"]
    assert len(mms) == 1
    assert mms[0].flops == want.flops == 2 * 64 * 32 * 128
    assert mms[0].bytes == want.bytes == 4 * (64 * 32 + 32 * 128 + 64 * 128)
    assert mms[0].intensity == pytest.approx(want.intensity)


def test_conv_flops():
    x, k = _np((2, 8, 8, 3), (3, 3, 3, 16))
    want = [r for r in jprof.profile_function(
        lambda a, b: jax.lax.conv_general_dilated(
            a, b, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO",
                                                     "NHWC")),
        jnp.asarray(x), jnp.asarray(k), xla_cost=False).records
        if r.op == "conv_general_dilated"][0]
    xt, kt = _t(x.transpose(0, 3, 1, 2).copy(), k.transpose(3, 2, 0, 1).copy())
    p = profile_function(lambda a, b: F.conv2d(a, b, padding="same"), xt, kt,
                         xla_cost=False)
    convs = [r for r in p.records if r.op == "convolution"]
    assert len(convs) == 1
    assert convs[0].flops == want.flops == 2 * (2 * 8 * 8 * 16) * 3 * 3 * 3


def test_elementwise_and_reduction():
    (x,) = _np((100,))
    jops = {r.op: r for r in jprof.profile_function(
        lambda a: jnp.sum(jnp.exp(a) + a), jnp.asarray(x),
        xla_cost=False).records}
    ops = {r.op: r for r in profile_function(
        lambda a: torch.sum(torch.exp(a) + a), *_t(x),
        xla_cost=False).records}
    assert ops["exp"].flops == jops["exp"].flops == 100
    assert ops["add"].flops == jops["add"].flops == 100
    assert ops["sum"].flops == jops["reduce_sum"].flops == 100


def test_scan_multiplicity():
    """JAX's scan of 10 matmuls counts one record ten times; the port
    has no scan: a loop of 10 counts ten records, the same total."""
    (x,) = _np((4, 8))

    def jf(a):
        def body(c, _):
            return c @ jnp.ones((8, 8)), None
        out, _ = jax.lax.scan(body, a, None, length=10)
        return out

    def tf(a):
        w = torch.ones((8, 8))
        for _ in range(10):
            a = a @ w
        return a

    jp = jprof.profile_function(jf, jnp.asarray(x), xla_cost=False)
    p = profile_function(tf, *_t(x), xla_cost=False)
    assert [r for r in jp.records if r.op == "dot_general"][0].count == 10
    assert len([r for r in p.records if r.op == "mm"]) == 10
    assert p.by_op()["mm"] == jp.by_op()["dot_general"] == 10 * 2 * 4 * 8 * 8


def test_profile_through_jit_and_grad():
    w, x = _np((16, 4), (8, 16))

    def jloss(w, x):
        return jnp.sum(jnp.tanh(x @ w) ** 2)

    def grad(w, x):
        w = w.detach().requires_grad_(True)
        return torch.autograd.grad((torch.tanh(x @ w) ** 2).sum(), w)

    jp = jprof.profile_function(jax.grad(jloss), jnp.asarray(w),
                                jnp.asarray(x), xla_cost=False)
    p = profile_function(grad, *_t(w, x), xla_cost=False)
    assert sum(1 for r in p.records if r.op == "mm") >= 2
    assert p.by_op()["mm"] == jp.by_op()["dot_general"]
    assert p.total_flops > 0


def test_summary_and_by_op():
    (a,) = _np((32, 32))
    p = profile_function(lambda x: torch.sum(x @ x), *_t(a), xla_cost=False)
    s = p.summary()
    assert "mm" in s and "TOTAL" in s and "TC" in s
    jp = jprof.profile_function(lambda x: jnp.sum(x @ x), jnp.asarray(a),
                                xla_cost=False)
    assert p.by_op()["mm"] == jp.by_op()["dot_general"] == 2 * 32 ** 3


def test_flop_counter_cross_check_attached():
    """The counterpart of JAX's XLA ``cost_analysis`` cross-check:
    FlopCounterMode's count of the same call, equal on a plain matmul."""
    (a,) = _np((64, 64))
    p = profile_function(lambda x: x @ x, *_t(a), xla_cost=True)
    assert p.xla_cost["source"] == "flop_counter"
    assert p.xla_cost["flops"] == p.total_flops == 2 * 64 ** 3
    assert "flop_counter: flops=" in p.summary()


def test_walk_runs_nothing_and_moves_no_state():
    """The walk runs on fake tensors: an in-place update of a real
    tensor leaves it as it was, and the walk's outputs hold no data."""
    w = torch.ones(4)

    def step(x):
        w.add_(x)
        return w * 2

    profile_function(step, torch.ones(4))
    torch.testing.assert_close(w, torch.ones(4))


# -- capture: markers and scopes ----------------------------------------------

def _json(obj):
    return json.loads(json.dumps(obj))


def test_capture_markers_and_scope():
    for mod in (prof, jprof):
        mod.MARKERS.clear()
        mod.init()
    got = prof.annotate("my_matmul")(lambda a: a @ a)(torch.ones((8, 8)))
    jprof.annotate("my_matmul")(lambda a: a @ a)(jnp.ones((8, 8)))
    assert got.shape == (8, 8)
    assert prof.MARKERS[0]["op"] == "my_matmul"
    assert prof.MARKERS[0]["args"][0]["shape"] == (8, 8)
    assert prof.MARKERS[0]["args"][0]["dtype"] == "torch.float32"
    assert _json(prof.MARKERS)[0]["args"][0]["shape"] \
        == _json(jprof.MARKERS)[0]["args"][0]["shape"]
    with prof.scope("outer"):
        assert capture.current_scope() == "outer"
        _ = torch.ones((2,)) + 1
    assert capture.current_scope() == ""


def test_dump_markers(tmp_path):
    prof.MARKERS.clear()
    prof.init()

    @prof.annotate()
    def g(a, flag=True):
        return a * 2

    g(torch.ones((3,)), flag=False)
    path = tmp_path / "markers.jsonl"
    prof.dump_markers(str(path))
    lines = [json.loads(l) for l in path.read_text().splitlines()]
    assert lines[0]["op"] == "g"
    assert lines[0]["kwargs"]["flag"]["value"] is False


def test_capture_scope_annotate_nesting():
    """Nested annotate/scope/annotate nest into the walk's op paths (the
    counterpart of JAX's HLO metadata ``outer_op/mid/inner_op``) and
    record one marker per annotated call in call order."""
    prof.MARKERS.clear()
    prof.init()

    @prof.annotate("inner_op")
    def inner(a):
        return a * 2

    @prof.annotate("outer_op")
    def outer(a):
        with prof.scope("mid"):
            return inner(a) + 1

    p = profile_function(outer, torch.ones((4,)), xla_cost=False)
    names = {r.name for r in p.records}
    assert "outer_op/mid/inner_op" in names and "outer_op/mid" in names
    assert [m["op"] for m in prof.MARKERS] == ["outer_op", "inner_op"]
    assert prof.MARKERS[0]["args"][0]["shape"] == (4,)


def test_dump_markers_roundtrip(tmp_path):
    """The dumped JSONL parses back into exactly the markers (tuples as
    lists), as JAX's does for the same calls."""
    for mod, arr in ((prof, torch.ones((2, 3))), (jprof, jnp.ones((2, 3)))):
        mod.MARKERS.clear()
        mod.init()

        @mod.annotate("round")
        def f(a, mode="x"):
            return a

        f(arr, mode="y")
        f(7, mode=None)
        path = str(tmp_path / f"{mod.__name__}.jsonl")
        mod.dump_markers(path)
        with open(path) as fh:
            back = [json.loads(line) for line in fh]
        assert back == _json(mod.MARKERS)
    port, jx = ([json.loads(l) for l in open(tmp_path / f"{n}.jsonl")]
                for n in ("apex_tpu_torch.prof", "apex_tpu.prof"))
    for m in port + jx:
        m["args"][0].pop("dtype", None)
    assert port == jx


def test_annotate_emits_marker_into_telemetry_stream(tmp_path):
    prof.MARKERS.clear()
    prof.init()
    path = str(tmp_path / "run.jsonl")
    rec = telemetry.start(path)
    try:
        @prof.annotate("tele_op")
        def f(a):
            return a + 1

        f(torch.ones((2,)))
        with prof.scope("tele_scope"):
            pass
    finally:
        rec.close()
    with open(path) as fh:
        events = [json.loads(line) for line in fh]
    markers = [e for e in events if e["kind"] == "marker"]
    assert [m["op"] for m in markers] == ["tele_op", "tele_scope"]
    assert markers[0]["args"][0]["shape"] == [2]
    assert markers[0]["t"] >= 0
    assert prof.MARKERS[0]["op"] == "tele_op"


def test_trace_writes_the_layout_parse_reads(tmp_path):
    """``prof.trace`` writes ``plugins/profile/<timestamp>/*.trace.json.gz``
    (the layout JAX's ``_newest_run_dir`` expects); a real CPU
    ``torch.profiler`` trace parses (no device kernel on the CPU: no
    record), the scope's range is in it."""
    with prof.trace(str(tmp_path)) as tr:
        with prof.scope("region"):
            torch.ones((64, 64)) @ torch.ones((64, 64))
        tr.step()
    runs = os.listdir(tmp_path / "plugins" / "profile")
    assert len(runs) == 1
    files = os.listdir(tmp_path / "plugins" / "profile" / runs[0])
    assert len(files) == 1 and files[0].endswith(".trace.json.gz")
    with gzip.open(tmp_path / "plugins" / "profile" / runs[0] / files[0],
                   "rt") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "region" in names and "aten::mm" in names
    tp = prof.parse_trace(str(tmp_path))
    assert tp.records == [] and tp.total_us == 0.0
    assert "TOTAL measured" in tp.summary()


# -- parse --------------------------------------------------------------------

def _trace_dir(tmp_path, events):
    run = tmp_path / "plugins" / "profile" / "2026_01_01_00_00_00"
    run.mkdir(parents=True)
    with gzip.open(run / "host.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)
    return str(tmp_path)


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def _k(name, ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": name, "pid": 0, "tid": 7,
            "ts": ts, "dur": dur, "args": {"correlation": corr,
                                           "device": 0}}


def synthetic_events():
    """One eager step (a scoped forward mm with sequence number 5, a
    hand-written LN launch, the backward's mm on the autograd thread),
    then a graph replay inside a decode range."""
    return [
        _x("ProfilerStep#1", "user_annotation", 0, 1000),
        _x("block_0", "user_annotation", 10, 300),
        _x("attn", "user_annotation", 20, 100),
        _x("aten::mm", "cpu_op", 30, 50, **{"Sequence number": 5,
                                             "Input Dims": [[8, 16],
                                                            [16, 4]]}),
        _x("cudaLaunchKernel", "cuda_runtime", 40, 5, correlation=11),
        _x("cudaLaunchKernel", "cuda_runtime", 200, 5, correlation=12),
        _x("autograd::engine::evaluate_function: MmBackward0", "cpu_op",
           500, 100, tid=2, **{"Sequence number": 5}),
        _x("aten::mm", "cpu_op", 510, 50, tid=2,
           **{"Sequence number": 5}),
        _x("cudaLaunchKernel", "cuda_runtime", 520, 5, tid=2,
           correlation=13),
        _x("decode[1024]", "user_annotation", 2000, 500),
        _x("cudaGraphLaunch", "cuda_runtime", 2010, 20, correlation=14),
        _k("void gemm_kernel<float>(Params)", 50, 10.0, 11),
        _k("ln_fwd", 210, 4.0, 12),
        _k("sm90_xmma_gemm_bf16", 530, 20.0, 13),
        _k("flash_fwd_mma_kernel<64>", 2100, 30.0, 14),
        _k("flash_fwd_combine_kernel", 2140, 2.0, 14),
        {"ph": "X", "cat": "gpu_user_annotation", "name": "block_0",
         "pid": 0, "tid": 7, "ts": 45, "dur": 300, "args": {}},
        {"ph": "M", "name": "process_name"},
        {"ph": "X", "ts": 1.0, "dur": 1.0, "name": "no_args_event"},
    ]


def test_parse_trace_joins_launch_backward_and_graph(tmp_path):
    tp = prof.parse_trace(_trace_dir(tmp_path, synthetic_events()))
    assert len(tp.records) == 5          # kernels only: no annotation
    by = {r.name: r for r in tp.records}
    mm = by["void gemm_kernel<float>(Params)"]
    assert mm.hlo_module == "block_0/attn" and mm.base_op == "mm"
    assert mm.run_id == "ProfilerStep#1" and mm.category == "gemm"
    assert mm.input_shapes == ((8, 16), (16, 4))
    ln = by["ln_fwd"]
    assert ln.hlo_module == "block_0" and ln.base_op == "layer_norm_fwd"
    # the backward kernel: launched on the autograd thread, joined to its
    # forward op by sequence number 5, in the step by time
    bwd = by["sm90_xmma_gemm_bf16"]
    assert bwd.hlo_module == "block_0/attn" and bwd.run_id == "ProfilerStep#1"
    # the replayed graph's kernels: the range around the replay
    fl = by["flash_fwd_mma_kernel<64>"]
    assert fl.run_id == "decode[1024]" and fl.hlo_module == ""
    assert fl.category == "flash_fwd"
    assert parse.kernel_kind(fl.name, parse.SERVING_KINDS) == "flash"
    assert tp.launches() == {"layer_norm_fwd": 1, "flash_attention_fwd": 1}
    assert tp.by_region() == {"block_0": 34.0, "<unattributed>": 32.0}
    assert tp.steps() == {"ProfilerStep#1": 34.0, "decode[1024]": 32.0}
    assert tp.by_op()["mm"]["count"] == 2     # forward and backward
    assert tp.by_category()["gemm"]["total_us"] == 30.0
    assert "kind" in tp.summary()
    assert [r.name for r in prof.parse_trace(
        str(tmp_path), module_filter="attn").records] == [
        "void gemm_kernel<float>(Params)", "sm90_xmma_gemm_bf16"]


def test_range_host_time_splits_a_decode_step(tmp_path):
    """A ``decode[b]`` range's host time: the CPU events directly inside
    it (the graph launch) and the gaps between them."""
    split = parse.range_host_time(_trace_dir(tmp_path, synthetic_events()),
                                  "decode[")
    row = split["decode[1024]"]
    assert row["count"] == 1 and row["host_us"] == 500.0
    assert row["covered_us"] == 20.0 and row["gaps_us"] == 480.0
    assert row["by_name"] == {"cudaGraphLaunch": 20.0}
    steps = parse.range_host_time(str(tmp_path), "ProfilerStep")
    assert steps["ProfilerStep#1"]["by_name"] == {"block_0": 300.0}


def test_parse_trace_missing_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        prof.parse_trace(str(tmp_path / "nope"))
    with pytest.raises(FileNotFoundError):
        jprof.parse_trace(str(tmp_path / "nope"))


def test_parse_cli(tmp_path, capsys):
    d = _trace_dir(tmp_path, synthetic_events())
    assert parse.main([d]) == 0
    out = capsys.readouterr().out
    assert "mm" in out and "TOTAL measured" in out
    assert parse.main([d, "--json"]) == 0
    recs = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert recs[0]["base_op"] == "mm" and recs[0]["duration_us"] == 10.0
    assert set(recs[0]) == set(parse.KernelRecord._fields)


def test_analysis_cli(tmp_path, capsys):
    """``--fn torch:tanh --shape 8,128``: the static table, joined with a
    trace directory and a markers file (JAX's CLI test)."""
    from apex_tpu_torch.prof import analysis
    d = _trace_dir(tmp_path, synthetic_events())
    markers = tmp_path / "markers.jsonl"
    markers.write_text(json.dumps(
        {"op": "dense", "args": [{"shape": [8, 16], "dtype": "float32"}],
         "kwargs": {"causal": {"value": True}}}) + "\n")
    assert analysis.main(["--fn", "torch:tanh", "--shape", "8,128",
                          "--no-xla-cost", "--trace", d,
                          "--markers", str(markers)]) == 0
    out = capsys.readouterr().out
    assert "tanh" in out and "TOTAL" in out
    assert "marker op" in out and "dense" in out and "causal=True" in out
    assert "measured-only ops" in out


def test_analysis_cli_default_target_is_a_port_example(capsys):
    from apex_tpu_torch.prof import analysis
    assert analysis.DEFAULT_FN.startswith("apex_tpu_torch.")
    assert analysis.main(["--top", "5"]) == 0
    out = capsys.readouterr().out
    assert "convolution" in out and "flop_counter" in out


def test_attach_measured_joins_kernels_to_their_records(tmp_path):
    """A kernel's measured time lands on its analytic record (the
    layer_norm_fwd row), an aten op's on the op's."""
    from apex_tpu_torch.normalization import FusedLayerNorm
    ln = FusedLayerNorm(16, device="cpu")
    p = profile_function(lambda x, w: ln(x @ w), torch.ones(8, 16),
                         torch.ones(16, 16), xla_cost=False)
    tp = prof.parse_trace(_trace_dir(tmp_path, synthetic_events()))
    report = prof.attach_measured(p, tp)
    rows = {l.split()[0]: l.split() for l in report.splitlines()[1:]
            if not l.startswith("measured-only")}
    assert rows["layer_norm_fwd"][3] == "4.0"
    assert rows["mm"][3] == "30.0"


# -- the kernels' cost hook ---------------------------------------------------

def _kernel_records(fn, *args):
    p = profile_function(fn, *args, xla_cost=False)
    return p, [r for r in p.records if r.op in costs.__all__
               or r.op.startswith(("flash_", "layer_norm_", "bn_act_",
                                   "xentropy_", "conv_", "qmm"))]


def _grad_of(fn, *leaves):
    def run(*xs):
        xs = [x.detach().requires_grad_(True) for x in xs]
        out = fn(*xs)
        return torch.autograd.grad(out.float().sum(), xs)
    return run


def _case_flash():
    from apex_tpu_torch.ops import flash_attention
    q, k, v = _t(*_np((2, 24, 2, 16), (2, 24, 2, 16), (2, 24, 2, 16)))
    run = _grad_of(lambda q, k, v: flash_attention(q, k, v, causal=True),
                   q, k, v)
    kw = dict(causal=True, q_offset=0, window=None)
    return run, (q, k, v), [
        costs.flash_fwd(q, k, v, None, None, **kw),
        costs.flash_bwd_dq(q, k, v, None, None, **kw),
        costs.flash_bwd_dkv(q, k, v, None, None, **kw)]


def _case_layer_norm():
    from apex_tpu_torch.normalization import FusedLayerNorm
    ln = FusedLayerNorm(32, device="cpu")
    (x,) = _t(*_np((12, 32)))
    return _grad_of(ln, x), (x,), [
        costs.layer_norm_fwd(x, ln.scale, ln.bias),
        costs.layer_norm_bwd(x, x, ln.scale)]


def _case_xentropy():
    from apex_tpu_torch.contrib.xentropy import softmax_cross_entropy_loss
    (x,) = _t(*_np((6, 40)))
    labels = torch.arange(6)
    return _grad_of(lambda x: softmax_cross_entropy_loss(x, labels, 0.1),
                    x), (x,), [costs.xentropy_fwd(x), costs.xentropy_bwd(x)]


def _case_bn_act():
    from apex_tpu_torch.normalization.fused_bn_act import bn_relu_residual
    x, z = _t(*_np((4, 3, 3, 8), (4, 3, 3, 8)))
    mean, invstd = torch.zeros(8), torch.ones(8)
    run = _grad_of(lambda x, z: bn_relu_residual(x, mean, invstd, z=z), x, z)
    x2, z2 = x.reshape(-1, 8), z.reshape(-1, 8)
    return run, (x, z), [costs.bn_act_fwd(x2, z2),
                         costs.bn_act_bwd(x2, z2, True)]


def _case_conv():
    from apex_tpu_torch.ops import conv2d
    x, w = _t(*_np((2, 8, 8, 4), (3, 3, 4, 8)))
    run = _grad_of(lambda x, w: conv2d(x, w, padding="SAME"), x, w)
    dy = torch.empty((2, 8, 8, 8))
    return run, (x, w), [costs.conv_fwd(x, w, (8, 8)),
                         costs.conv_dgrad(dy, w, x.shape),
                         costs.conv_wgrad(x, dy, w.shape)]


def _case_qmm():
    from apex_tpu_torch.quant import kernels as qk
    x, w = _t(*_np((6, 40), (40, 24)))
    qw = qk.weight_layout(w, qk.channel_scale(w))
    return (lambda x: qk.quantized_matmul(x, w, x_scale=0.05)), (x,), [
        costs.qmm(x, qw)]


@pytest.mark.parametrize("case", ["flash", "layer_norm", "xentropy",
                                  "bn_act", "conv", "qmm"])
def test_kernel_entry_point_counts_once_by_its_formula(case):
    """Under the walk each kernel's entry point reports one record with
    its formula (the costs ``chip_smoke.py``'s bounds use) and its plain
    version's aten ops are hidden: no product is counted besides the
    kernels'.  Outside a count the hook is off."""
    run, args, want = globals()[f"_case_{case}"]()
    p, got = _kernel_records(run, *args)
    assert [(r.op, r.flops, r.bytes) for r in got] == [
        (c.name, c.flops, c.bytes) for c in want]
    assert not [r for r in p.records if r.op in ("mm", "bmm", "convolution",
                                                 "_softmax", "_log_softmax")]
    assert costs.active_count() is None
    run(*args)                           # the plain versions really run


def test_a_real_tensor_under_a_walk_is_never_counted():
    """While a walk counts one thread's call, a real tensor reaching a
    kernel's entry point, on that thread or on another, takes the
    uncounted branch: it computes its real values, adds no record to the
    walk, and on the card would launch its kernel.  Only the fake
    operand of the walked call is counted."""
    import threading
    from apex_tpu_torch.contrib.xentropy import softmax_cross_entropy_loss
    (x,) = _t(*_np((6, 40)))
    labels = torch.arange(6)
    want = softmax_cross_entropy_loss(x, labels, 0.1)
    seen = {}

    def other():
        seen["active"] = costs.active_count()
        seen["loss"] = softmax_cross_entropy_loss(x, labels, 0.1)

    def fn(xf):
        assert costs.counting(xf) is costs.active_count() is not None
        assert costs.counting(x) is None        # real, on this thread
        th = threading.Thread(target=other)
        th.start()
        th.join()
        return softmax_cross_entropy_loss(xf, labels, 0.1)

    p = profile_function(fn, x, xla_cost=False)
    assert [r.op for r in p.records if r.op.startswith("xentropy")] \
        == ["xentropy_fwd"]
    assert seen["active"] is None
    torch.testing.assert_close(seen["loss"], want, rtol=0, atol=0)
    assert costs.active_count() is None


def test_kernel_costs_are_chip_smokes_formulas():
    """The formulas at a main-path shape equal the numbers the kernel
    table's bounds were computed with (the LM's LN [8184, 768] bf16,
    its causal flash call at B 8, T 1023)."""
    x = torch.empty((8184, 768), dtype=torch.bfloat16, device="meta")
    w = torch.empty((768,), device="meta")
    c = costs.layer_norm_fwd(x, w, w)
    assert (c.flops, c.bytes) == (8 * 8184 * 768,
                                  2 * 8184 * 768 * 2 + 2 * 768 * 4
                                  + 2 * 8184 * 4)
    assert costs.bound(c)[1] == "bytes"
    assert costs.bound(c)[0] == pytest.approx(c.bytes / 3.35e12 * 1e3)
    q = torch.empty((8, 1023, 12, 64), dtype=torch.bfloat16, device="meta")
    f = costs.flash_fwd(q, q, q, None, None, causal=True, q_offset=0,
                        window=None)
    assert f.flops == 4.0 * 12 * 64 * 8 * (1023 * 1024 // 2)
    assert costs.visible_pairs(1, 4, 4, True, 0, 2, None) == 1 + 2 + 2 + 2
    # the ring's signed offsets: a shard ahead hides rows, one behind
    # shows every key
    assert costs.visible_pairs(1, 4, 4, True, -2, None, None) == 1 + 2
    assert costs.visible_pairs(1, 4, 4, True, -4, None, None) == 0
    assert costs.visible_pairs(1, 4, 4, True, 4, None, None) == 16
    # what a ring step must read: the rows that see a key and the keys a
    # row sees; a shard wholly ahead reads nothing and writes its zeros
    assert costs.seen_rows_keys(4, 4, True, -2, None, None) == (2, 2)
    assert costs.seen_rows_keys(4, 4, True, -4, None, None) == (0, 0)
    assert costs.seen_rows_keys(4, 4, True, 4, None, None) == (4, 4)
    assert costs.seen_rows_keys(4, 8, True, 0, None, None) == (4, 4)
    assert costs.seen_rows_keys(4, 8, True, 4, 2, None) == (4, 5)
    assert costs.seen_rows_keys(4, 4, False, -4, None, None) == (4, 4)
    r = torch.empty((8, 512, 12, 64), dtype=torch.bfloat16, device="meta")
    kw = dict(causal=True, window=None)
    out_b, lse_b = r.numel() * 2, 8 * 12 * 512 * 4
    hidden = [f(r, r, r, None, None, q_offset=-512, **kw)
              for f in (costs.flash_fwd, costs.flash_bwd_dq,
                        costs.flash_bwd_dkv)]
    assert [(c.flops, c.bytes) for c in hidden] == [
        (0.0, out_b + lse_b), (0.0, out_b), (0.0, 2 * out_b)]
    behind = [f(r, r, r, None, None, q_offset=512, **kw)
              for f in (costs.flash_fwd, costs.flash_bwd_dq,
                        costs.flash_bwd_dkv)]
    assert [c.bytes for c in behind] == [
        4 * out_b + lse_b, 5 * out_b + 2 * lse_b, 6 * out_b + 2 * lse_b]
    kb = torch.tensor([[0.0, 0.0, -1e9]])
    assert costs.visible_pairs(1, 1, 3, True, 2, None, kb) == 2


def test_backward_ops_land_in_their_forward_region():
    """The region of an op inside a node's backward is the scope that
    made the node (stamped on ``grad_fn``), with the scopes the backward
    opens itself inside it."""
    from apex_tpu_torch.examples.prof.custom_func_module import Swishish

    def f(x, w):
        with prof.scope("blockA"):
            h = torch.tanh(x @ w)
        with prof.scope("act"):
            y = Swishish.apply(h, torch.tensor(1.5))
        return torch.autograd.grad(y.sum(), (x, w))

    x, w = _t(*_np((4, 8), (8, 8)))
    p = profile_function(f, x.requires_grad_(True), w.requires_grad_(True),
                         xla_cost=False)
    mms = [r.name for r in p.records if r.op == "mm"]
    assert mms == ["blockA"] * 3
    bwd = {r.name for r in p.records if "swishish_bwd" in r.name}
    assert bwd == {"act/swishish_fwd/swishish_bwd"}
    assert capture.region_path(bwd.pop()) == "act"
    assert "act/swishish_fwd" in {r.name for r in p.records}


# -- trace_count: one capture, no recapture -----------------------------------

def _pipeline(k=2):
    rs = np.random.RandomState(0)

    def loss_fn(p, batch):
        x, y = batch
        return ((x @ p["w"] - y) ** 2).mean()

    init_fn, step_fn = training.make_train_step(loss_fn, training.sgd(0.01),
                                                opt_level="O0")
    state = init_fn({"w": torch.from_numpy(rs.randn(8, 8)
                                           .astype(np.float32))})
    window = tuple(torch.from_numpy(rs.randn(k, 4, 8).astype(np.float32))
                   for _ in range(2))
    return runtime.StepPipeline(step_fn, k), state, window


def test_assert_trace_count_basic():
    pipe, state, window = _pipeline()
    with prof.assert_trace_count(pipe, 1):       # the first run captures
        for _ in range(3):
            state, _ = pipe.step_window(state, window)
    with prof.assert_trace_count(pipe, 0):       # steady state
        pipe.step_window(state, window)
    assert prof.trace_count(pipe) == 1


def test_assert_trace_count_catches_retrace():
    pipe, state, window = _pipeline()
    pipe.step_window(state, window)
    with pytest.raises(AssertionError, match="J004"):
        with prof.assert_trace_count(pipe, 0):
            pipe.step_window(state, tuple(w[:, :2] for w in window))
    with pytest.raises(AssertionError, match="J004"):
        with prof.assert_trace_count(pipe, 0):
            pipe.step_window(state, window, n_valid=1)   # the tail loop


def test_assert_trace_count_exact_catches_missing_compile():
    pipe, _, _ = _pipeline()
    with pytest.raises(AssertionError, match="not invoked"):
        with prof.assert_trace_count(pipe, 1):
            pass
    with prof.assert_trace_count(pipe, 1, exact=False):
        pass


def test_trace_count_rejects_plain_function():
    with pytest.raises(TypeError, match="tracing cache"):
        prof.trace_count(lambda x: x)
    with pytest.raises(TypeError, match="tracing cache"):
        jprof.trace_count(lambda x: x)


def test_amp_o2_step_compiles_once_never_retraces():
    """JAX's headline contract on the port: an amp O2 step through the
    pipeline traces once (its first window; a capture on CUDA), then
    every same-shaped window reuses it; its loss equals JAX's O2 step's
    on the same numpy weights and batch."""
    from apex_tpu import training as jtraining
    rng = np.random.RandomState(0)
    w = (rng.randn(6, 4) * 0.3).astype(np.float32)
    x = rng.randn(16, 6).astype(np.float32)
    y = (rng.randn(16, 4) * 0.1).astype(np.float32)

    def loss_fn(p, batch):
        xb, yb = batch
        out = xb.to(p["w"].dtype) @ p["w"] + p["b"]
        return ((out.float() - yb) ** 2).mean()

    init_fn, step_fn = training.make_train_step(
        loss_fn, training.adam(1e-2), opt_level="O2", loss_scale="dynamic")
    state = init_fn({"w": torch.from_numpy(w), "b": torch.zeros(4)})
    pipe = runtime.StepPipeline(step_fn, 1)
    window = (torch.from_numpy(x)[None], torch.from_numpy(y)[None])
    with prof.assert_trace_count(pipe, 1):
        for _ in range(5):
            state, metrics = pipe.step_window(state, window)
    with prof.assert_trace_count(pipe, 0):
        state, metrics = pipe.step_window(state, window)
    assert np.isfinite(float(metrics["loss"][0]))

    def jloss(p, batch):
        xb, yb = batch
        out = xb @ p["w"].astype(xb.dtype) + p["b"].astype(xb.dtype)
        return jnp.mean((out.astype(jnp.float32) - yb) ** 2)

    jinit, jstep = jtraining.make_train_step(
        jloss, jtraining.adam(1e-2), opt_level="O2", loss_scale="dynamic")
    jstate = jinit({"w": jnp.asarray(w), "b": jnp.zeros((4,), jnp.float32)})
    step = jax.jit(jstep)
    with jprof.assert_trace_count(step, 1):
        for _ in range(6):
            jstate, jm = step(jstate, (jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(float(metrics["loss"][0]), float(jm["loss"]),
                               rtol=2e-2)


def test_assert_trace_count_on_a_serving_engine():
    """The engine's AOT table: one program a (kind, bucket) at warmup (on
    the CPU the plain bodies), none while serving; ``trace_count`` reads
    the counter a capture on CUDA adds to."""
    from apex_tpu_torch.models import gpt_tiny
    from apex_tpu_torch.serving import ServingEngine
    model = gpt_tiny(vocab_size=64, hidden_size=32, num_layers=1,
                     num_heads=2, mlp_dim=64, max_len=64, device="cpu")
    eng = ServingEngine(model, buckets=(32, 64), page_size=16, max_seqs=2,
                        device="cpu")
    with prof.assert_trace_count(eng, 4):
        eng.warmup()
    prompts = [np.arange(1, 6), np.arange(3, 20)]
    with prof.assert_trace_count(eng, 0):
        eng.generate(prompts, max_new_tokens=4)
    assert prof.trace_count(eng) == 4
    assert eng.stats["captures"] == 0          # the CPU captures nothing
    eng.close()


def test_prof_package_names_mirror_jax():
    """``apex_tpu_torch.prof`` imports JAX's list (analysis, capture,
    ledger.loader_ledger, parse, trace_count) and each module has a
    counterpart of every public name of JAX's."""
    import importlib
    jax_names = {n for n in dir(jprof) if not n.startswith("_")
                 and not isinstance(getattr(jprof, n), type(os))}
    assert jax_names <= set(dir(prof))
    for mod in ("capture", "parse", "analysis", "roofline", "ledger",
                "trace_count", "memory"):
        j = importlib.import_module(f"apex_tpu.prof.{mod}")
        t = importlib.import_module(f"apex_tpu_torch.prof.{mod}")
        missing = {n for n in j.__all__ if not hasattr(t, n)} \
            if hasattr(j, "__all__") else set()
        public = {n for n, v in vars(j).items() if not n.startswith("_")
                  and getattr(v, "__module__", None) == j.__name__}
        missing |= {n for n in public if not hasattr(t, n)}
        # the XLA memory analysis's reader is the allocator snapshot's
        missing -= {"stats_from_analysis"}
        assert not missing, (mod, missing)
    from apex_tpu_torch.prof import memory
    assert callable(memory.stats_from_snapshot)


EXAMPLES = {
    "lenet": [], "user_annotation": [], "custom_func_module": [],
    "end_to_end": [], "jit_function": [], "apex_ops": [], "operators": [],
    "imagenet": ["-m", "resnet18", "-b", "2", "--image-size", "32"],
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_prof_example_runs_on_the_cpu(name, capsys, tmp_path):
    """Each of the eight ``examples/prof`` scripts runs on the CPU with
    ``--device cpu`` and prints its report."""
    import importlib
    mod = importlib.import_module(f"apex_tpu_torch.examples.prof.{name}")
    argv = EXAMPLES[name] + ["--device", "cpu"]
    if name in ("end_to_end", "operators"):
        argv = [str(tmp_path)] + argv
    assert mod.main(argv) == 0
    out = capsys.readouterr().out
    assert "TOTAL" in out or "flops" in out
    assert costs.active_count() is None


@pytest.mark.parametrize("name,kind,counted", [
    ("void (anonymous namespace)::qmm_wgmma_kernel<__nv_bfloat16, 2, 2, 1>"
     "(Maps, Args)", "qmm", "qmm"),
    ("void (anonymous namespace)::qmm_kernel<__nv_bfloat16, 16, 32, 1, 4>"
     "(Args)", "qmm", "qmm"),
    ("void (anonymous namespace)::conv_fwd_wgmma_kernel<__nv_bfloat16, 128>"
     "(CUtensorMap_st, ConvParams)", "conv_fwd_kernel", "conv_fwd"),
    ("void (anonymous namespace)::conv_gemm_kernel<0, __nv_bfloat16, 64>"
     "(ConvParams)", "conv_fwd_kernel", "conv_fwd"),
    ("void (anonymous namespace)::conv_dgrad_wgmma_kernel<__half, 128>"
     "(CUtensorMap_st, ConvParams)", "conv_dgrad_kernel", "conv_dgrad"),
    ("void (anonymous namespace)::conv_gemm_kernel<3, __nv_bfloat16, 64>"
     "(ConvParams)", "conv_dgrad_kernel", "conv_dgrad"),
    ("void (anonymous namespace)::conv_wgrad_wgmma_kernel<__nv_bfloat16, "
     "64>(CUtensorMap_st, ConvParams)", "conv_wgrad_kernel", "conv_wgrad"),
    ("void (anonymous namespace)::wgrad_reduce_kernel<__nv_bfloat16>("
     "float const*, __nv_bfloat16*, int, long)", "conv_wgrad_kernel",
     None),
    ("void (anonymous namespace)::flash_bwd_dq_wgmma_kernel<__nv_bfloat16, "
     "64, 1, 64, 3>(BwdMaps, BwdParams)", "flash_bwd",
     "flash_attention_bwd_dq"),
    ("void (anonymous namespace)::flash_bwd_dq_mma_kernel<__nv_bfloat16, "
     "64>(BwdParams, int, int)", "flash_bwd", "flash_attention_bwd_dq"),
    ("void (anonymous namespace)::flash_bwd_dkv_wgmma_kernel<__half, 128, "
     "2, 32, 1>(BwdMaps, BwdParams)", "flash_bwd",
     "flash_attention_bwd_dkv"),
    ("void (anonymous namespace)::flash_bwd_dkv_mma_kernel<__half, 128>("
     "BwdParams, int, int)", "flash_bwd", "flash_attention_bwd_dkv"),
    ("void (anonymous namespace)::flash_decode_kernel<__nv_bfloat16, 64>("
     "Maps, Params)", "flash", "flash_attention_fwd"),
    ("void (anonymous namespace)::flash_fwd_split_kernel<__nv_bfloat16, "
     "64>(Params)", "flash", "flash_attention_fwd"),
    ("void (anonymous namespace)::flash_fwd_combine_kernel<__nv_bfloat16, "
     "64>(Params)", "flash", None)])
def test_kernel_names_of_both_routes_count_alike(name, kind, counted):
    """A trace's kernel of either route of qmm, of the conv passes and of
    flash's dQ and dK/dV (the wgmma kernels and the mma.sync ones) and of
    the flash forward's decode routes (the decode kernel, split-KV) takes
    its kernel's kind and counts as that kernel's launch; wgrad's reduce
    and split-KV's combine take their kernel's kind and count as no launch
    of their own (each runs within its kernel's call)."""
    kinds = parse.RESNET_KINDS if kind.startswith("conv") \
        else parse.TRAINING_KINDS if kind == "flash_bwd" \
        else parse.SERVING_KINDS
    assert parse.kernel_kind(name, kinds) == kind
    assert parse.counted_name(name) == counted
