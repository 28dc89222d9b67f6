"""apex_tpu_torch.tune — the registry, harness, cache and dispatch on the
CPU, and their agreement with the JAX package's ``apex_tpu.tune``.

The semantics of each of ``tests/test_tune.py``'s tests, on the port:
the cache's lifecycle (a restart, a version bump, corrupt, partial and
future-schema files), the harness's contract (seeded order with an
injected timer, never slower than the rule, oracle and constraint
rejections, the effective dedupe, ``max_candidates`` as ``truncated``),
dispatch (the consult on the kernel path only, bool and partial entries,
an explicit tile bypassing the cache, hostile values rounded legal), the
telemetry and the CLI.  Off the card the harness runs with
``interpret=True``: the cases run the plain versions.  Then the JAX
comparisons: every module's ``tune_bucket`` and the bucket helpers give
JAX's strings, ``bound_from_ledger`` JAX's verdicts, a ``tune_configs
.json`` written by JAX's store reads back entry for entry (and a TPU's
entries never match here), and gpt_tiny's ledger regions select the
families JAX's select.
"""

import importlib
import json

import numpy as np
import pytest
import torch

import apex_tpu_torch.telemetry as telemetry
from apex_tpu_torch.tune import dispatch, measure, registry, space, store
from apex_tpu_torch.tune.__main__ import main as tune_main
from apex_tpu_torch.tune.registry import KernelSpec, TuneCase

fln = importlib.import_module("apex_tpu_torch.normalization.fused_layer_norm")
fba = importlib.import_module("apex_tpu_torch.normalization.fused_bn_act")
fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
cv = importlib.import_module("apex_tpu_torch.ops.conv")
qk = importlib.import_module("apex_tpu_torch.quant.kernels")
xe = importlib.import_module("apex_tpu_torch.contrib.xentropy")

registry.load_builtin()


@pytest.fixture
def tune_cache(tmp_path, monkeypatch):
    """An isolated config cache: a fresh file, the memo and the stats
    cleared, the environment pointing dispatch at it."""
    path = str(tmp_path / "tune_configs.json")
    monkeypatch.setenv("APEX_TPU_TUNE_CACHE", path)
    store._STATE["memo_path"] = None
    store._STATE["memo"] = None
    store._STATE["warned"] = set()
    dispatch.reset_stats()
    yield path
    store._STATE["memo_path"] = None
    store._STATE["memo"] = None
    dispatch.reset_stats()


def _fresh_reload(path):
    """A process restart: every in-memory trace dropped, the file read
    back."""
    store._STATE["memo_path"] = None
    store._STATE["memo"] = None
    dispatch.reset_stats()
    return store.load(path, reload=True)


def _fake_timer(model):
    """A deterministic injected timer: seconds from the config alone."""
    def timer(cfg, run):
        run()
        return model(cfg)
    return timer


def _stats(kernel):
    return dispatch.dispatch_stats()["by_kernel"].get(kernel)


# -- space: the card's row rules ----------------------------------------------

def test_space_is_the_one_home_for_the_row_rules():
    # the LayerNorm's rows a program and the BN epilogue's row block are
    # both space.pick_rows; the buckets are space.pow2_bucket
    for n1, blk in ((8184, 16), (4, 64), (1000, 100), (3, 3)):
        assert fln.rows_per_program(n1, blk) == space.pick_rows(
            n1, 1, 1, row_block=min(blk, fln._MAX_ROWS))
    for rows, c, blk in ((401408, 256, 128), (640, 64, 256), (10, 128, 64)):
        block_c = min(128, 1 << max(0, c - 1).bit_length())
        assert fba._grid(rows, c, blk)[1] == space.pick_rows(
            rows, block_c, fba._TILE_BYTES_PER_ELEM, row_block=blk)
    # the rule's BN tile is legal in the budget
    assert space.tile_fits(64, 128, fba._TILE_BYTES_PER_ELEM)
    assert space.smem_per_block(torch.device("cpu")) \
        == space.SMEM_OPTIN_H100 == 232448


def test_space_row_block_candidates_dedupe_clamped_blocks():
    # at 128 columns of 12 bytes the budget admits 128 rows: 256 and 512
    # clamp onto 128 and are dropped
    cands = space.row_block_candidates(401408, 128, 12)
    assert sorted(set(cands)) == sorted(cands)
    effs = {space.pick_rows(401408, 128, 12, row_block=b) for b in cands}
    assert len(effs) == len(cands)
    assert 256 not in cands and 128 in cands


def test_pow2_bucket():
    assert [space.pow2_bucket(n) for n in (1, 2, 3, 64, 65, 1024)] \
        == [1, 2, 4, 64, 128, 1024]


# -- the cache's lifecycle -------------------------------------------------------

def test_config_roundtrip_survives_restart(tune_cache):
    key = store.put("fused_layer_norm", 1, "r64_w128_i4",
                    {"row_block": 32}, meta={"best_ms": 0.5},
                    path=tune_cache)
    assert key == "cpu|fused_layer_norm|v1|r64_w128_i4"
    assert store.lookup("fused_layer_norm", 1, "r64_w128_i4",
                        path=tune_cache) == {"row_block": 32}
    _fresh_reload(tune_cache)
    assert store.lookup("fused_layer_norm", 1, "r64_w128_i4",
                        path=tune_cache) == {"row_block": 32}
    ents = store.entries(tune_cache)
    assert len(ents) == 1 and ents[0]["meta"]["best_ms"] == 0.5


def test_version_bump_invalidates_stale_entries(tune_cache):
    store.put("fused_layer_norm", 1, "r64_w128_i4", {"row_block": 32},
              path=tune_cache)
    assert store.lookup("fused_layer_norm", 2, "r64_w128_i4",
                        path=tune_cache) is None
    assert store.prune_stale({"fused_layer_norm": 2},
                             path=tune_cache) == 1
    _fresh_reload(tune_cache)
    assert store.lookup("fused_layer_norm", 1, "r64_w128_i4",
                        path=tune_cache) is None
    assert store.entries(tune_cache) == []


def test_corrupt_cache_falls_back_loudly_once(tune_cache, capsys):
    with open(tune_cache, "w") as f:
        f.write('{"schema": 1, "entries": {TRUNCATED')
    assert store.lookup("fused_layer_norm", 1, "b", path=tune_cache) is None
    assert store.lookup("bn_relu_residual", 1, "b", path=tune_cache) is None
    _fresh_reload(tune_cache)
    assert store.lookup("xentropy", 1, "b", path=tune_cache) is None
    err = capsys.readouterr().err
    assert err.count("falling back to built-in default configs") == 1
    assert "corrupt" in err
    store.put("xentropy", 1, "r32_h128", {"col_block": 1024,
                                          "num_warps": 4}, path=tune_cache)
    _fresh_reload(tune_cache)
    assert store.lookup("xentropy", 1, "r32_h128", path=tune_cache) \
        == {"col_block": 1024, "num_warps": 4}


def test_partial_entries_are_skipped_not_fatal(tune_cache, capsys):
    with open(tune_cache, "w") as f:
        json.dump({"schema": 1, "entries": {
            "cpu|xentropy|v1|r32_h128": {"kernel": "xentropy"},
            "cpu|fused_layer_norm|v1|b": {
                "kernel": "fused_layer_norm", "version": 1, "bucket": "b",
                "device_kind": "cpu", "config": {"row_block": 16}},
        }}, f)
    assert store.lookup("xentropy", 1, "r32_h128", path=tune_cache) is None
    assert store.lookup("fused_layer_norm", 1, "b",
                        path=tune_cache) == {"row_block": 16}
    assert "partial" in capsys.readouterr().err


def test_future_schema_is_not_misread(tune_cache, capsys):
    with open(tune_cache, "w") as f:
        json.dump({"schema": 99, "entries": {
            "cpu|xentropy|v1|b": {"config": {"row_block": 8}}}}, f)
    assert store.lookup("xentropy", 1, "b", path=tune_cache) is None
    assert "newer" in capsys.readouterr().err


def test_device_kind_and_cache_enable_point_the_store(tmp_path,
                                                      monkeypatch):
    from apex_tpu_torch import cache
    assert store.device_kind() == "cpu"           # no card here
    monkeypatch.delenv("APEX_TPU_TUNE_CACHE", raising=False)
    old = store._STATE["dir"]
    try:
        cache.enable(str(tmp_path / "cc"))
        assert store.cache_path() == str(tmp_path / "cc" /
                                         "tune_configs.json")
        monkeypatch.setenv("APEX_TPU_TUNE_CACHE", str(tmp_path / "e.json"))
        assert store.cache_path() == str(tmp_path / "e.json")
    finally:
        store.set_default_dir(old)
        cache._STATE["dir"] = None
        from apex_tpu_torch import _build
        _build.set_build_dir(_build._CSRC + "/build")


# -- the harness ----------------------------------------------------------------

def test_tuner_is_deterministic_on_cpu(tune_cache):
    # n1 = 1024 keeps every row block a distinct program (at a tiny n1
    # the effective dedupe folds the big ones: tested below)
    shape = {"n1": 1024, "n2": 128, "dtype": "float32"}
    model = lambda cfg: 1e-3 * (1 + abs(cfg["row_block"] - 8))    # noqa
    runs = []
    for _ in range(2):
        _fresh_reload(tune_cache)
        runs.append(measure.tune_kernel(
            "fused_layer_norm", shape, seed=7, interpret=True,
            measure=_fake_timer(model), path=tune_cache))
    a, b = runs
    assert a.config == b.config == {"row_block": 8}
    assert a.order == b.order and a.best_ms == b.best_ms
    assert a.source == "interpret" and a.candidates == 7
    c = measure.tune_kernel("fused_layer_norm", shape, seed=8,
                            interpret=True, measure=_fake_timer(model),
                            path=tune_cache)
    assert c.config == {"row_block": 8}


def test_tuner_refuses_to_measure_off_the_card_without_interpret():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is the CPU contract")
    with pytest.raises(RuntimeError, match="only runs on the card"):
        measure.tune_kernel("fused_layer_norm", {"n1": 8, "n2": 128},
                            store_result=False)


def test_tuned_never_slower_than_default_by_construction(tune_cache):
    model = lambda cfg: 1e-3 * (100.0 if cfg["row_block"] != 1      # noqa
                                else 1.0)
    res = measure.tune_kernel("fused_layer_norm",
                              {"n1": 64, "n2": 128, "dtype": "float32"},
                              interpret=True, measure=_fake_timer(model),
                              path=tune_cache)
    assert res.config == res.default_config == {"row_block": 1}
    assert res.tuned_over_default == 1.0


def test_oracle_rejects_wrong_outputs(tune_cache):
    def build(shape, interpret):
        def run(cfg):
            base = torch.arange(8, dtype=torch.float32)
            return base * (1.0 if cfg["blk"] == 1 else 1.5)
        return TuneCase(run=run)

    spec = KernelSpec(
        name="_test_wrong", version=1, params=("blk",), kind="memory",
        exact=True, defaults=lambda s: {"blk": 1},
        candidates=lambda s, b: [{"blk": 2}, {"blk": 3}],
        constraint=lambda s, c: True, build=build,
        bucket=lambda s: "b", small_shape={}, example_shape={})
    model = lambda cfg: 1e-6 * cfg["blk"]                           # noqa
    res = measure.tune_kernel(spec, {}, interpret=True,
                              measure=_fake_timer(model), path=tune_cache)
    assert res.rejected_oracle == 2
    assert res.config == {"blk": 1}


def test_oracle_tolerance_per_output(tune_cache):
    """A family that is not exact passes within its case's tolerance,
    one pair an output (xentropy's shape)."""
    def build(shape, interpret):
        def run(cfg):
            d = 1e-6 * cfg["blk"]
            return (torch.zeros(4) + d, torch.zeros(4) + 10 * d)
        return TuneCase(run=run, tol=[(0.0, 1e-4), (0.0, 1e-5)])

    spec = KernelSpec(
        name="_test_tol", version=1, params=("blk",), kind="memory",
        exact=False, defaults=lambda s: {"blk": 0},
        candidates=lambda s, b: [{"blk": 1}, {"blk": 5}],
        constraint=lambda s, c: True, build=build,
        bucket=lambda s: "b", small_shape={}, example_shape={})
    res = measure.tune_kernel(spec, {}, interpret=True,
                              measure=_fake_timer(lambda c: 1e-3),
                              path=tune_cache)
    assert res.rejected_oracle == 1 and res.candidates == 2


def test_constraint_rejects_before_timing(tune_cache):
    timed = []

    def build(shape, interpret):
        return TuneCase(run=lambda cfg: torch.zeros(4))

    spec = KernelSpec(
        name="_test_constraint", version=1, params=("blk",),
        kind="memory", exact=True, defaults=lambda s: {"blk": 8},
        candidates=lambda s, b: [{"blk": 16}, {"blk": 4096}],
        constraint=lambda s, c: c["blk"] <= 64, build=build,
        bucket=lambda s: "b", small_shape={}, example_shape={})

    def timer(cfg, run):
        timed.append(dict(cfg))
        return 1e-3
    res = measure.tune_kernel(spec, {}, interpret=True, measure=timer,
                              path=tune_cache)
    assert res.rejected_constraint == 1
    assert {"blk": 4096} not in timed


def test_bound_from_ledger_reorders_candidates():
    spec = registry.get_spec("flash_attention")
    ledger_mem = {"regions": [
        {"region": "encoder/attention", "bound": "memory",
         "modeled_ms": 10.0},
        {"region": "mlp", "bound": "compute", "modeled_ms": 50.0}]}
    ledger_cmp = {"regions": [
        {"region": "encoder/attention", "bound": "compute",
         "modeled_ms": 10.0}]}
    assert measure.bound_from_ledger(ledger_mem, spec) == "memory"
    assert measure.bound_from_ledger(ledger_cmp, spec) == "compute"
    assert measure.bound_from_ledger({"regions": [
        {"region": "optimizer", "bound": "memory"}]}, spec) is None

    shape = dict(spec.small_shape)
    mem = spec.candidates(shape, "memory")
    mem.sort(key=lambda c: spec.priority(shape, c, "memory"))
    cmp_ = spec.candidates(shape, "compute")
    cmp_.sort(key=lambda c: spec.priority(shape, c, "compute"))
    area = lambda c: c["block_q"] * c["block_k"]                    # noqa
    # the wgmma kernel's 4 tiles and the mma.sync kernel's 5
    assert len(mem) == len(fa.tiles(64, torch.bfloat16)) == 9
    assert area(mem[0]) == min(area(c) for c in mem)
    assert area(cmp_[0]) == max(area(c) for c in cmp_)


def test_effective_dedupe_never_times_the_default_twice(tune_cache):
    """At n1 = 4 every row block from 4 up runs one program of 4 rows:
    only one of them is measured."""
    spec = registry.get_spec("fused_layer_norm")
    shape = {"n1": 4, "n2": 128, "dtype": "float32"}
    res = measure.tune_kernel(spec, shape, interpret=True,
                              measure=_fake_timer(lambda c: 1e-3),
                              path=tune_cache)
    keys = [repr(spec.effective(shape, c)) for c in res.order]
    assert len(keys) == len(set(keys)) == 3
    assert keys.count(repr(spec.effective(shape,
                                          res.default_config))) == 1


def test_max_candidates_counts_as_truncated_not_constraint(tune_cache):
    res = measure.tune_kernel("fused_layer_norm",
                              {"n1": 64, "n2": 128, "dtype": "float32"},
                              interpret=True, max_candidates=2,
                              measure=_fake_timer(
                                  lambda cfg: 1e-3 * cfg["row_block"]),
                              path=tune_cache)
    assert res.truncated == 5
    assert res.rejected_constraint == 0


@pytest.mark.parametrize("name", ["flash_attention", "conv2d",
                                  "fused_layer_norm", "bn_relu_residual",
                                  "xentropy", "quantized_matmul"])
def test_every_family_tunes_its_small_shape_on_cpu(tune_cache, name):
    """Each family's interpret run: the plain version ignores the tile,
    so every candidate passes the oracle; the rule is a candidate and
    the winner is stored."""
    spec = registry.get_spec(name)
    assert spec.defaults(spec.example_shape) in spec.candidates(
        spec.example_shape, None)
    res = measure.tune_kernel(name, interpret=True, iters=1, reps=1,
                              measure=_fake_timer(lambda c: 1e-3),
                              path=tune_cache)
    assert res.rejected_oracle == 0 and res.candidates >= 2
    assert res.best_ms <= res.default_ms and res.stored
    assert store.lookup(name, spec.version, res.bucket,
                        path=tune_cache) == res.config


# -- dispatch: the consult on the kernel path -----------------------------------

def test_layer_norm_consults_on_the_kernel_path_only(tune_cache):
    x = torch.linspace(-2, 2, 64 * 128).reshape(64, 128)
    w = torch.linspace(0.5, 1.5, 128)
    base = fln.fused_layer_norm(x, (128,), w)
    store.put("fused_layer_norm", fln.TUNE_VERSION,
              fln.tune_bucket(64, 128, 4), {"row_block": 16},
              path=tune_cache)
    # the plain version neither consults nor changes
    assert torch.equal(fln.fused_layer_norm(x, (128,), w), base)
    assert _stats("fused_layer_norm") is None
    # the kernel path's consult picks the cached rows
    assert fln._row_block(x, None) == 16
    st = _stats("fused_layer_norm")
    assert st["hits"] == 1 and st["tuned"]
    assert fln.rows_per_program(64, 16) == 16


def test_bn_relu_consults_on_the_kernel_path_only(tune_cache):
    x = torch.linspace(-3, 3, 64 * 128).reshape(64, 128)
    z = torch.flip(x, dims=(0,))
    mean, invstd = torch.linspace(-0.2, 0.2, 128), torch.linspace(0.8, 1.2,
                                                                  128)
    base = fba.bn_relu_residual(x, mean, invstd, z=z)
    store.put("bn_relu_residual", fba.TUNE_VERSION,
              fba.tune_bucket(64, 128, 4, True), {"row_block": 8},
              path=tune_cache)
    assert torch.equal(fba.bn_relu_residual(x, mean, invstd, z=z), base)
    assert torch.equal(fba.bn_relu_residual(x, mean, invstd, z=z,
                                            row_block=32), base)
    assert _stats("bn_relu_residual") is None
    assert fba._tuned_rows(x, z) == 8 and _stats("bn_relu_residual")["tuned"]
    assert fba._tuned_rows(x, None) is None          # another bucket


def test_quantized_matmul_consults_on_the_kernel_path_only(tune_cache):
    x = torch.linspace(-1, 1, 64 * 128).reshape(64, 128)
    w = torch.linspace(-0.5, 0.5, 128 * 256).reshape(128, 256)
    base = qk.quantized_matmul(x, w, x_scale=0.01)
    store.put("quantized_matmul", qk.TUNE_VERSION,
              qk.tune_bucket(64, 128, 256, 4),
              {"block_m": 64, "block_n": 32}, path=tune_cache)
    assert torch.equal(qk.quantized_matmul(x, w, x_scale=0.01), base)
    assert _stats("quantized_matmul") is None
    assert qk._tuned_tile(x, 256) == (64, 32)
    assert _stats("quantized_matmul")["tuned"]
    # explicit wins without a consult; a missing half is -1, which the
    # kernel's plan() fills from its rule (the card tests check that and
    # the refusal of a tile the kernel lacks)
    dispatch.reset_stats()
    qw = torch.zeros((256, 128), dtype=torch.int8)
    assert qk._pick_tile(x, qw, 16, None) == (16, -1)
    assert qk._pick_tile(x, qw, None, 128) == (-1, 128)
    assert _stats("quantized_matmul") is None
    assert qk._tuned_tile(x, 512) is None                 # another bucket


def test_flash_consults_and_matches_default(tune_cache):
    rs = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rs.randn(1, 256, 2, 64).astype(
        np.float32)).to(torch.bfloat16) for _ in range(3))
    base = fa.flash_attention(q, k, v, causal=True)
    store.put("flash_attention", fa.TUNE_VERSION,
              fa.tune_bucket(256, 256, 64, True, False, False),
              {"block_q": 128, "block_k": 128}, path=tune_cache)
    tuned = fa.flash_attention(q, k, v, causal=True, block_q=128,
                               block_k=64)
    assert torch.equal(base, tuned)           # the plain version ignores
    assert _stats("flash_attention") is None
    assert fa._tuned_tile(q, k, True, False, None) == (128, 128)
    assert _stats("flash_attention")["hits"] == 1
    # fp32 runs the SIMT kernel, which has no tile: no consult
    dispatch.reset_stats()
    assert fa._pick_tile(q.float(), k.float(), None, True, False, None,
                         None, None) is None
    assert _stats("flash_attention") is None
    # explicit wins without a consult; a missing half is -1 (the
    # kernel's rule); on decode block_k is the split-KV chunk
    assert fa._pick_tile(q, k, None, True, False, None, 128, None) \
        == (128, -1)
    q1 = q[:, :1]
    assert fa._pick_tile(q1, k, None, True, False, None, None, 96) \
        == (-1, 96)
    assert _stats("flash_attention") is None


def test_conv_consults_on_the_kernel_path_only(tune_cache):
    x = torch.randn(2, 8, 8, 64, generator=torch.Generator().manual_seed(0))
    w = torch.randn(3, 3, 64, 128, generator=torch.Generator().manual_seed(1))
    base = cv.conv2d(x, w)
    bucket = cv.tune_bucket(2, 8, 8, 64, 128, 3, 3, 1, 1, 1, 1, 4, False,
                            False)
    store.put("conv2d", cv.TUNE_VERSION, bucket,
              {"block_m": 128, "block_n": 64}, path=tune_cache)
    assert torch.equal(cv.conv2d(x, w, block_m=128, block_n=128), base)
    assert _stats("conv2d") is None
    args = (2, 8, 8, 64, 128, 3, 3, (1, 1), (1, 1), 4, False, False)
    assert cv._pick_tile_n(*args, None, None) == 64
    assert _stats("conv2d")["tuned"]
    assert cv._pick_tile_n(*args, None, 128) == 128       # explicit wins
    with pytest.raises(ValueError, match="not a tile"):
        cv._pick_tile_n(*args, 64, 64)


def test_explicit_blocks_and_bad_entries_bypass_the_cache(tune_cache):
    x = torch.ones((64, 128))
    store.put("fused_layer_norm", fln.TUNE_VERSION,
              fln.tune_bucket(64, 128, 4),
              {"row_block": 16, "exotic_knob": 3}, path=tune_cache)
    assert fln._row_block(x, None) is None
    assert not _stats("fused_layer_norm")["tuned"]
    dispatch.reset_stats()
    assert fln._row_block(x, 32) == 32
    assert _stats("fused_layer_norm") is None
    with pytest.raises(ValueError, match="row_block"):
        fln.fused_layer_norm(x, (128,), row_block=0)


def test_partial_config_entry_is_a_miss_not_a_crash(tune_cache):
    store.put("flash_attention", fa.TUNE_VERSION,
              fa.tune_bucket(256, 256, 64, True, False, False),
              {"block_q": 128}, path=tune_cache)
    q = torch.zeros((1, 256, 2, 64), dtype=torch.bfloat16)
    assert fa._tuned_tile(q, q, True, False, None) is None
    assert not _stats("flash_attention")["tuned"]
    assert fa.flash_attention(q, q, q, causal=True).shape == (1, 256, 2, 64)


def test_hostile_row_block_is_rounded_legal(tune_cache):
    assert space.pick_rows(4096, 128, 12, row_block=100) == 64
    assert space.pick_rows(4096, 128, 12, row_block=3) == 2
    assert fln.rows_per_program(4096, 100) == 64
    assert fln.rows_per_program(4096, 10 ** 6) == 64
    assert fba._grid(4096, 256, 100000)[1] == 128      # the budget binds
    store.put("fused_layer_norm", fln.TUNE_VERSION,
              fln.tune_bucket(64, 128, 4), {"row_block": 100},
              path=tune_cache)
    x = torch.linspace(-2, 2, 64 * 128).reshape(64, 128)
    assert fln.rows_per_program(64, fln._row_block(x, None)) == 64
    assert _stats("fused_layer_norm")["tuned"]


def test_bool_config_values_are_rejected(tune_cache):
    bucket = qk.tune_bucket(64, 128, 128, 4)
    store.put("quantized_matmul", qk.TUNE_VERSION, bucket,
              {"block_m": True, "block_n": 256}, path=tune_cache)
    assert dispatch.kernel_config(
        "quantized_matmul", qk.TUNE_VERSION, bucket,
        params=("block_m", "block_n")) is None


def test_consult_is_memoized_until_the_store_moves(tune_cache, monkeypatch):
    """After its first, a consult does not read the store; a write drops
    the memo."""
    bucket = fln.tune_bucket(64, 128, 4)
    assert dispatch.kernel_config("fused_layer_norm", fln.TUNE_VERSION,
                                  bucket, params=("row_block",)) is None
    calls = []
    real = store.lookup
    monkeypatch.setattr(store, "lookup",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    for _ in range(3):
        dispatch.kernel_config("fused_layer_norm", fln.TUNE_VERSION,
                               bucket, params=("row_block",))
    assert calls == [] and _stats("fused_layer_norm")["misses"] == 4
    store.put("fused_layer_norm", fln.TUNE_VERSION, bucket,
              {"row_block": 4}, path=tune_cache)
    assert dispatch.kernel_config("fused_layer_norm", fln.TUNE_VERSION,
                                  bucket, params=("row_block",)) \
        == {"row_block": 4}
    assert len(calls) == 1


def test_xentropy_tuned_config_helper(tune_cache):
    logits = torch.zeros((32, 1000))
    assert xe._tuned(logits) is None
    store.put("xentropy", xe.TUNE_VERSION, xe.tune_bucket(32, 1000),
              {"col_block": 512, "num_warps": 4}, path=tune_cache)
    assert xe._tuned(logits) == (512, 4)
    # a config the kernels do not take (wider than the row's power of
    # two, or more warps than columns) runs the rule
    store.put("xentropy", xe.TUNE_VERSION, xe.tune_bucket(32, 1000),
              {"col_block": 4096, "num_warps": 4}, path=tune_cache)
    assert xe._tuned(logits) is None
    assert not xe.config_legal(1000, 128, 8)
    assert xe.rule_config(50257) == (4096, 8)


# -- telemetry ------------------------------------------------------------------

def test_tune_events_and_tuned_kernel_pct_gauge(tune_cache, tmp_path):
    stream = tmp_path / "tune_stream.jsonl"
    rec = telemetry.start(str(stream))
    try:
        measure.tune_kernel("fused_layer_norm",
                            {"n1": 64, "n2": 128, "dtype": "float32"},
                            interpret=True,
                            measure=_fake_timer(
                                lambda cfg: 1e-3 / cfg["row_block"]),
                            path=tune_cache)
        assert fln._row_block(torch.ones((64, 128)), None) == 64
        assert rec.metrics.gauge("tuned_kernel_pct").value == 100.0
    finally:
        rec.close()
    with open(stream) as f:
        events = [json.loads(line) for line in f]
    tune_events = [e for e in events if e["kind"] == "tune"]
    assert {"result", "dispatch"} <= {e["phase"] for e in tune_events}
    result = next(e for e in tune_events if e["phase"] == "result")
    assert result["kernel"] == "fused_layer_norm"
    assert result["best_ms"] <= result["default_ms"]
    assert result["stored"] is True
    hit = next(e for e in tune_events if e["phase"] == "dispatch")
    assert hit["hit"] is True and hit["config"] == {"row_block": 64}
    assert dispatch.coverage_line().startswith(
        "tune: 100% of consulted kernels tuned (fused_layer_norm")


# -- the CLI --------------------------------------------------------------------

def test_cli_tune_show_and_offline_refusal(tune_cache, capsys):
    rc = tune_main(["kernel", "fused_layer_norm", "--interpret",
                    "--cache", tune_cache, "--iters", "1", "--reps", "1",
                    "--shape", "n1=64,n2=128,dtype=float32"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "persisted to" in out and "tuned" in out

    rc = tune_main(["show", "--cache", tune_cache])
    out = capsys.readouterr().out
    assert rc == 0 and "fused_layer_norm" in out and "r64_w128_i4" in out

    rc = tune_main(["show", "--cache", tune_cache, "--json"])
    rows = json.loads(capsys.readouterr().out)
    assert rows and rows[0]["kernel"] == "fused_layer_norm"

    if not torch.cuda.is_available():
        rc = tune_main(["kernel", "fused_layer_norm", "--cache",
                        tune_cache])
        assert rc == 2
        assert "only runs on the card" in capsys.readouterr().err


def test_cli_ledger_rejects_shape(tune_cache, tmp_path, capsys):
    ledger = tmp_path / "ledger.json"
    ledger.write_text(json.dumps({"regions": []}))
    rc = tune_main(["ledger", str(ledger), "--interpret",
                    "--cache", tune_cache, "--shape", "rows=64"])
    assert rc == 2
    assert "--shape applies to `kernel NAME`" in capsys.readouterr().err


def test_cli_prune_drops_stale_versions(tune_cache, capsys):
    store.put("fused_layer_norm", fln.TUNE_VERSION + 1, "b1",
              {"row_block": 16}, path=tune_cache)
    store.put("fused_layer_norm", fln.TUNE_VERSION, "b2",
              {"row_block": 16}, path=tune_cache)
    rc = tune_main(["prune", "--cache", tune_cache])
    assert rc == 0
    assert "pruned 1" in capsys.readouterr().out
    _fresh_reload(tune_cache)
    assert [e["bucket"] for e in store.entries(tune_cache)] == ["b2"]


def test_cli_ledger_driven(tune_cache, tmp_path, capsys):
    ledger = tmp_path / "ledger.json"
    ledger.write_text(json.dumps({"regions": [
        {"region": "block_0/attention", "bound": "compute",
         "modeled_ms": 5.0},
        {"region": "block_0/ln1", "bound": "memory", "modeled_ms": 2.0}]}))
    rc = tune_main(["ledger", str(ledger), "--interpret", "--cache",
                    tune_cache, "--iters", "1", "--reps", "1", "--json"])
    assert rc == 0
    rows = json.loads(capsys.readouterr().out)
    by = {r["kernel"]: r for r in rows}
    assert set(by) == {s.name for s in registry.all_specs()}
    assert by["fused_layer_norm"]["bound"] == "memory"   # the ledger's
    assert by["flash_attention"]["bound"] == "compute"
    assert by["bn_relu_residual"]["bound"] == "memory"   # its own kind
    assert all(r["source"] == "interpret" and r["stored"] for r in rows)
    assert len(store.entries(tune_cache)) == 6


# -- against the JAX package -----------------------------------------------------

def test_tune_buckets_equal_jax():
    from apex_tpu.contrib import xentropy as jxe
    from apex_tpu.tune import space as jspace
    jfa = importlib.import_module("apex_tpu.ops.flash_attention")
    jcv = importlib.import_module("apex_tpu.ops.conv")
    jfln = importlib.import_module("apex_tpu.normalization.fused_layer_norm")
    jfba = importlib.import_module("apex_tpu.normalization.fused_bn_act")
    jqk = importlib.import_module("apex_tpu.quant.kernels")
    rs = np.random.RandomState(17)
    for _ in range(50):
        a, b, c, d = (int(v) for v in rs.randint(1, 5000, 4))
        f1, f2, f3 = (bool(v) for v in rs.randint(0, 2, 3))
        isz = int(rs.choice([2, 4]))
        assert space.pow2_bucket(a) == jspace.pow2_bucket(a)
        assert space.nhwc_bucket(a, b, c, d) == jspace.nhwc_bucket(a, b, c,
                                                                   d)
        assert fa.tune_bucket(a, b, c, f1, f2, f3) \
            == jfa.tune_bucket(a, b, c, f1, f2, f3)
        geo = (a % 64 + 1, b % 60 + 1, c % 60 + 1, d, a % 9 + 1, 3, 1, 2,
               1, 1, 1, isz, f1, f2)
        assert cv.tune_bucket(*geo) == jcv.tune_bucket(*geo)
        assert fln.tune_bucket(a, b, isz) == jfln.tune_bucket(a, b, isz)
        assert fba.tune_bucket(a, b, isz, f1) \
            == jfba.tune_bucket(a, b, isz, f1)
        assert xe.tune_bucket(a, b) == jxe.tune_bucket(a, b)
        assert qk.tune_bucket(a, b, c, isz) == jqk.tune_bucket(a, b, c, isz)
    for mod, jmod in ((fln, jfln), (fba, jfba), (xe, jxe)):
        assert mod.TUNE_VERSION == jmod.TUNE_VERSION == 1
    # the port's flash forward, conv forward and qmm moved their rules to
    # wgmma kernels: version 2, so an entry tuned against the mma.sync
    # kernels misses; conv's backward followed (version 3)
    for mod, jmod in ((fa, jfa), (qk, jqk)):
        assert mod.TUNE_VERSION == 2 and jmod.TUNE_VERSION == 1
    assert cv.TUNE_VERSION == 3 and jcv.TUNE_VERSION == 1


def test_bound_from_ledger_equals_jax():
    from apex_tpu.tune import measure as jmeasure
    from apex_tpu.tune import registry as jregistry
    jregistry.load_builtin()
    rs = np.random.RandomState(3)
    names = ["block_0/attention", "block_1/ln1", "GPT/ln_f", "loss",
             "stage1_block0", "downsample", "block_0/mlp_up", "head",
             "log_softmax", "conv1", "optimizer", "embed"]
    for trial in range(20):
        rows = [{"region": n, "bound": str(rs.choice(["compute",
                                                      "memory"])),
                 "modeled_ms": float(rs.rand() * 10)}
                for n in names if rs.rand() < 0.6]
        if trial % 4 == 0:
            for r in rows:
                r.pop("modeled_ms")
                r["flops_g"] = 2.0
        ledger = {"regions": rows}
        for spec in registry.all_specs():
            jspec = jregistry.get_spec(spec.name)
            assert spec.regions == jspec.regions
            assert measure.bound_from_ledger(ledger, spec) \
                == jmeasure.bound_from_ledger(ledger, jspec)


def test_jax_written_cache_reads_back_and_never_matches(tmp_path):
    from apex_tpu.tune import store as jstore
    path = str(tmp_path / "tune_configs.json")
    tpu = "TPU_v5_lite"          # what JAX's device_kind gives on a v5e
    jstore.put("flash_attention", 1, "q1024_k1024_d64_c1_b0_w0",
               {"block_q": 512, "block_k": 1024}, meta={"best_ms": 1.5},
               dev_kind=tpu, path=path)
    jstore.put("fused_layer_norm", 1, "r8192_w768_i2", {"row_block": 256},
               dev_kind=tpu, path=path)
    jstore.put("xentropy", 1, "r8192_h50257", {"row_block": 64},
               dev_kind=tpu, path=path)
    want = jstore.entries(path)
    store._STATE["memo_path"] = store._STATE["memo"] = None
    dispatch.reset_stats()
    got = store.entries(path)
    assert got == want and len(got) == 3
    kind = store.device_kind()
    assert all(e["device_kind"] != kind for e in got)
    for e in got:
        assert store.lookup(e["kernel"], e["version"], e["bucket"],
                            path=path) is None
        assert store.lookup(e["kernel"], e["version"], e["bucket"],
                            dev_kind=tpu, path=path) == e["config"]


def test_gpt_tiny_ledger_selects_jax_families():
    """The port's GPT opens JAX's submodule names (``attention``, ``ln1``,
    ``ln2``, ``mlp_up``, ``mlp_down``) inside each ``block_i``, so the
    families a ledger of its step selects are the ones JAX's ledger of
    the same step selects."""
    import jax
    import jax.numpy as jnp
    from apex_tpu.models import gpt_tiny as jgpt_tiny
    from apex_tpu.prof import roofline as jroofline
    from apex_tpu.tune import measure as jmeasure
    from apex_tpu.tune import registry as jregistry
    from apex_tpu_torch.convert import gpt_params_from_jax
    from apex_tpu_torch.examples.lm import main_amp
    from apex_tpu_torch.models import gpt_tiny
    from apex_tpu_torch.prof import roofline
    jregistry.load_builtin()
    cfg = dict(max_len=32, vocab_size=96, hidden_size=32, num_layers=2,
               num_heads=2, mlp_dim=64, attention_impl="full")
    ids = np.random.RandomState(1).randint(1, 96, (4, 17))
    x, y = ids[:, :-1], ids[:, 1:]
    jm = jgpt_tiny(**cfg)
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"]

    def jloss(p, x, y):
        logits = jm.apply({"params": p}, x)
        logp = jax.nn.log_softmax(logits.reshape(-1, 96).astype(
            jnp.float32))
        return -jnp.mean(jnp.take_along_axis(logp, y.reshape(-1)[:, None],
                                             -1))

    jh = jroofline.harvest_costs(jax.grad(jloss), params, jnp.asarray(x),
                                 jnp.asarray(y), xla=False, region_depth=3)
    tm = gpt_tiny(**cfg, device="cpu")
    tm.load_state_dict(gpt_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in tm.state_dict().items()}

    def tgrad(p, x, y):
        loss = main_amp.lm_loss(torch.func.functional_call(tm, p, (x,)), y)
        return torch.autograd.grad(loss, list(p.values()))

    h = roofline.harvest_costs(tgrad, leaves, torch.from_numpy(x),
                               torch.from_numpy(y), region_depth=3)
    assert {"block_0/attention", "block_0/ln1", "block_1/mlp_up",
            "head/ln_f"} <= set(h.by_region)
    peaks = {"name": "test", "flops": 1e12, "hbm_bw": 1e11}
    led = roofline.mfu_ledger(h, step_time_s=0.01, peaks=peaks)
    jled = jroofline.mfu_ledger(jh, step_time_s=0.01, peaks=peaks)

    def selected(ledger, specs, bound):
        return {s.name for s in specs if bound(ledger, s) is not None}

    got = selected(led, registry.all_specs(), measure.bound_from_ledger)
    want = selected(jled, jregistry.all_specs(), jmeasure.bound_from_ledger)
    assert got == want == {"flash_attention", "fused_layer_norm",
                           "quantized_matmul", "xentropy"}


def test_flash_rule_candidates_and_defaults_name_the_wgmma_kernel():
    """The flash family's rule is the wgmma kernel's tile (64 x 96 at
    width 64, 128 x 96 at 128); its candidates are every tile of both
    tensor-core kernels; fp32 has none; decode keeps the split-KV
    chunk."""
    spec = registry.get_spec("flash_attention")
    assert spec.version == fa.TUNE_VERSION == 2
    base = dict(spec.example_shape)
    assert spec.defaults(base) == {"block_q": 64, "block_k": 96}
    assert spec.defaults(dict(base, head_dim=128)) == {"block_q": 128,
                                                      "block_k": 96}
    assert spec.defaults(dict(base, dtype="float32")) == {"block_q": 64,
                                                         "block_k": 64}
    got = {(c["block_q"], c["block_k"]) for c in spec.candidates(base, None)}
    assert got == set(fa.tiles(64, torch.bfloat16))
    assert spec.candidates(dict(base, dtype="float32"), None) == []
    dec = dict(base, q_len=1)
    assert spec.defaults(dec)["block_k"] == fa._kv_split(8, 12, 1023, 132)[1]
    assert spec.effective(base, spec.defaults(base)) == (64, 96)


def test_flash_version_one_entry_misses(tune_cache):
    """An entry tuned against version 1 (the mma.sync rule) misses; the
    same bucket at version 2 hits."""
    bucket = fa.tune_bucket(256, 256, 64, True, False, False)
    store.put("flash_attention", 1, bucket, {"block_q": 128, "block_k": 128},
              path=tune_cache)
    q = torch.zeros((1, 256, 2, 64), dtype=torch.bfloat16)
    assert fa._tuned_tile(q, q, True, False, None) is None
    assert not _stats("flash_attention")["tuned"]
    store.put("flash_attention", 2, bucket, {"block_q": 128, "block_k": 96},
              path=tune_cache)
    assert fa._tuned_tile(q, q, True, False, None) == (128, 96)


def test_qmm_candidates_name_both_kernels_tiles_at_version_two():
    """qmm's candidates are every tile of its two kernels: quant.cu's
    decode tiles and the wgmma kernel's three (the wide one, 128 x 128,
    64 x 128); at M 8184 the wgmma tiles route to the wgmma kernel and
    the decode tiles to mma.sync; the cache keys carry version 2."""
    spec = registry.get_spec("quantized_matmul")
    assert spec.version == qk.TUNE_VERSION == 2
    shape = dict(spec.example_shape)
    got = {(c["block_m"], c["block_n"]) for c in spec.candidates(shape,
                                                                   None)}
    assert got == set(qk.tiles(2)) == {(16, 32), (64, 32), (128, 256),
                                       (64, 128), (128, 128)}
    assert set(qk.tiles(4)) == {(16, 32), (64, 32), (64, 256), (64, 128),
                                (128, 128)}
    routes = {t: qk._route(8184, 768, 3072, torch.bfloat16, t, True)
              for t in got}
    assert {t for t, r in routes.items() if r == "wgmma"} \
        == set(qk._wgmma_tiles(2))
    assert {t for t, r in routes.items() if r == "mma"} == {(16, 32),
                                                          (64, 32)}
    assert "|quantized_matmul|v2|" in store.key_for(
        "quantized_matmul", spec.version, spec.bucket(shape))


def test_conv_candidates_share_their_bucket_route_at_version_two():
    """conv's candidates are the two tile widths of the bucket's routes
    (every candidate of a bf16 bucket with C a multiple of 64 runs
    wgmma, of the stem's mma, of fp32 simt), and its cache keys carry
    version 3 (version 2 named the forward's routes alone)."""
    spec = registry.get_spec("conv2d")
    assert spec.version == cv.TUNE_VERSION == 3
    shape = dict(spec.example_shape)
    cands = spec.candidates(shape, None)
    assert {(c["block_m"], c["block_n"]) for c in cands} == {(128, 64),
                                                            (128, 128)}
    assert all(spec.constraint(shape, c) for c in cands)
    assert cv._fwd_route(torch.bfloat16, shape["cin"], True) == "wgmma"
    assert cv._dgrad_route(torch.bfloat16, shape["cout"], True) == "wgmma"
    assert cv._wgrad_route(torch.bfloat16, shape["cin"], True) == "wgmma"
    assert "|conv2d|v3|" in store.key_for("conv2d", spec.version,
                                          spec.bucket(shape))


@pytest.mark.parametrize("name,kmod", [("quantized_matmul", qk),
                                       ("conv2d", cv)])
def test_version_one_entries_of_qmm_and_conv_miss(tune_cache, name, kmod):
    """An entry tuned against version 1 (before the wgmma kernels) misses;
    the same bucket at version 2 hits."""
    spec = registry.get_spec(name)
    bucket = spec.bucket(dict(spec.example_shape))
    cfg = spec.defaults(dict(spec.example_shape))
    params = tuple(spec.params)
    store.put(name, 1, bucket, cfg, path=tune_cache)
    assert dispatch.kernel_config(name, kmod.TUNE_VERSION, bucket,
                                  params=params) is None
    store.put(name, kmod.TUNE_VERSION, bucket, cfg, path=tune_cache)
    assert dispatch.kernel_config(name, kmod.TUNE_VERSION, bucket,
                                  params=params) == cfg
