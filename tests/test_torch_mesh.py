"""The port's mesh front end (``apex_tpu_torch.parallel.mesh``:
``MeshPlan``, ``zero_sharded`` levels 1-3, ``make_mesh_train_step``,
``make_train_step(param_view=)``, ``StepPipeline(wrap=)``) over four gloo
ranks against JAX's ``apex_tpu.parallel.mesh`` over four CPU devices,
case by case as ``tests/test_mesh.py`` names them.

Four ranks are spawned once for the module (this file run as a script,
``multiproc.spawn`` with a file store under ``tmp_path``, one thread a
rank); each builds its plans over the world and saves what it got.  The
contracts:

* the port's mesh steps at zero 1, 2 and 3 (dp x fsdp 2 x 2 and 1 x 4)
  equal the port's ``zero1(bucketed=True)`` step BIT FOR BIT after 20
  steps (losses and parameters), as JAX's test asks of JAX's;
* they equal JAX's mesh steps within rtol 1e-5 (losses, parameters) on
  the same numpy inputs.  JAX's moments hold the mean gradient times a
  factor the test measures and asserts (the varying-axes autodiff sums
  the replicated parameters' gradient over the mesh before ZeRO sums it
  again: the data world at zero 1/2, dp at zero 3); the port's hold the
  mean gradient, so the test multiplies them by that factor;
* the refusals, the bucket layout, the reshard on restore and the
  collectives noted per axis, as JAX's tests name them.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

WORLD = 4
STEPS = 20
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = [(1, 2, 2), (2, 2, 2), (3, 2, 2), (3, 1, 4), (2, 1, 4)]
TOL = dict(rtol=1e-5, atol=1e-6)


def setup():
    rng = np.random.RandomState(0)
    params = {"w": (rng.randn(5, 7) * 0.3).astype(np.float32),
              "b": np.zeros((3,), np.float32)}     # 38 elements: pad to 40
    x = rng.randn(8 * WORLD, 5).astype(np.float32)
    y = (rng.randn(8 * WORLD, 7) * 0.1).astype(np.float32)
    return params, x, y


# -- the ranks' side ---------------------------------------------------------------

def _np(t):
    return t.detach().float().numpy().copy()


def _t(a):
    return torch.from_numpy(np.array(a))


def _loss_fn(p, batch):
    xb, yb = batch
    pred = xb @ p["w"].float() + torch.nn.functional.pad(p["b"].float(),
                                                         (0, 4))
    return ((pred - yb) ** 2).mean()


def _params():
    return {k: _t(v) for k, v in setup()[0].items()}


def _baseline(rank, steps=STEPS):
    from apex_tpu_torch import training
    from apex_tpu_torch.parallel.zero import zero1
    _, x, y = setup()
    tx = zero1(training.adam(1e-2), "data", num_shards=WORLD, bucketed=True)
    init_fn, step_fn = training.make_train_step(
        _loss_fn, tx, opt_level="O2", loss_scale="dynamic",
        axis_name="data", reduce_grads=False)
    state = init_fn(_params())
    rows = slice(8 * rank, 8 * rank + 8)
    losses = []
    for _ in range(steps):
        state, m = step_fn(state, (_t(x[rows]), _t(y[rows])))
        losses.append(float(m["loss"]))
    return np.array(losses), state


def _mesh_run(M, training, zero, dp, fsdp, steps=STEPS, x=None, **kw):
    params, x0, y = setup()
    x = x0 if x is None else x
    plan = M.MeshPlan(dp=dp, fsdp=fsdp)
    ms = M.make_mesh_train_step(
        _loss_fn, kw.pop("tx", None) or training.adam(1e-2), plan,
        zero=zero, opt_level=kw.pop("opt_level", "O2"),
        loss_scale=kw.pop("loss_scale", "dynamic"), **kw)
    state = ms.init(_params())
    step = ms.step_fn
    batch = plan.device_put_batch((_t(x), _t(y)))
    losses = []
    first = state
    for _ in range(steps):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return np.array(losses), state, ms, plan, first


def _rank_main(rank, out, tmp):
    import torch.distributed as dist

    from apex_tpu_torch import checkpoint as ckpt
    from apex_tpu_torch import runtime, telemetry, training
    from apex_tpu_torch.multi_tensor.buckets import Packed
    from apex_tpu_torch.parallel import mesh as M

    base_losses, base = _baseline(rank)
    out["base/losses"] = base_losses
    for k, v in base.params.items():
        out[f"base/{k}"] = _np(v)
    for zero, dp, fsdp in CONFIGS:
        key = f"z{zero}_{dp}x{fsdp}"
        losses, state, ms, plan, _ = _mesh_run(M, training, zero, dp, fsdp)
        out[f"{key}/losses"] = losses
        full = ms.gather_params(state)
        for k, v in full.items():
            out[f"{key}/{k}"] = _np(v)
        inner = state.opt_state.inner[0]
        out[f"{key}/exp_avg"] = _np(inner.exp_avg)
        out[f"{key}/exp_avg_sq"] = _np(inner.exp_avg_sq)
        spec = ms.state_spec(state)
        out[f"{key}/ratio"] = np.array(plan.state_bytes(
            (state.params, state.opt_state),
            (spec.params, spec.opt_state))["ratio"])
        out[f"{key}/opt_ratio"] = np.array(plan.state_bytes(
            state.opt_state, spec.opt_state)["ratio"])
        if zero == 3:
            assert isinstance(state.params, Packed)
            out[f"{key}/chunk"] = np.array(state.params.data[0].shape)
        else:
            out[f"{key}/params_whole"] = np.array(all(
                tuple(v.shape) == tuple(setup()[0][k].shape)
                for k, v in state.params.items()))
        out[f"{key}/coords"] = np.array(plan.coords)
        # O0 (fp32 end to end) for the comparison with JAX's
        losses, state, ms, _, _ = _mesh_run(M, training, zero, dp, fsdp,
                                            opt_level="O0")
        out[f"{key}/o0/losses"] = losses
        for k, v in ms.gather_params(state).items():
            out[f"{key}/o0/{k}"] = _np(v)
        out[f"{key}/o0/exp_avg"] = _np(state.opt_state.inner[0].exp_avg)
    # the plan's checks and placements
    plan = M.MeshPlan(dp=2, fsdp=2)
    out["plan/repr"] = np.array(repr(plan))
    out["plan/data_index"] = np.array(plan.data_index)
    xb = plan.device_put_batch(_t(np.arange(16.0).reshape(16, 1)))
    out["plan/rows"] = _np(xb)[:, 0]
    out["plan/specs"] = np.array(str((plan.batch_spec, plan.flat_spec)))
    auto = M.MeshPlan.auto()
    out["plan/auto"] = np.array((auto.dp, auto.fsdp, auto.tp))
    auto = M.MeshPlan.auto(fsdp=2)
    out["plan/auto2"] = np.array((auto.dp, auto.fsdp, auto.tp))
    errors = {}

    def refuse(name, fn):
        try:
            fn()
        except (ValueError, RuntimeError, TypeError) as e:
            errors[name] = f"{type(e).__name__}: {e}"
    refuse("sizes", lambda: M.MeshPlan(dp=3, fsdp=4))
    refuse("positive", lambda: M.MeshPlan(dp=0, fsdp=4))
    plan = M.MeshPlan(dp=1, fsdp=4)
    refuse("lamb", lambda: M.zero_sharded(training.lamb(1e-3), plan,
                                          level=2))
    refuse("novograd", lambda: M.zero_sharded(training.novograd(1e-3),
                                              plan, level=3))
    refuse("level4", lambda: M.zero_sharded(training.adam(1e-3), plan,
                                            level=4))
    refuse("zero5", lambda: M.make_mesh_train_step(
        _loss_fn, training.adam(1e-3), plan, zero=5))
    refuse("o3", lambda: M.make_mesh_train_step(
        _loss_fn, training.adam(1e-3), plan, zero=3, opt_level="O3"))
    refuse("gather_dtype", lambda: M.make_mesh_train_step(
        _loss_fn, training.adam(1e-3), plan, zero=2,
        gather_dtype=torch.bfloat16))
    ms = M.make_mesh_train_step(_loss_fn, training.adam(1e-3), plan, zero=3)
    refuse("step_before_init", lambda: ms.step_fn(None, None))
    refuse("store_before_init", lambda: ms.store())
    state = ms.init(_params())
    out["z3/layout"] = np.array(json.dumps(plan.bucket_layout(ms.store())))
    out["z3/padded"] = np.array(state.params.data[0].numel() * WORLD)
    out["errors"] = np.array(json.dumps(errors))
    # the pipeline: zero 3 over 2 x 2, K 4, three windows, wrap= cuts
    # this rank's rows of each global window
    params, x, y = setup()
    plan = M.MeshPlan(dp=2, fsdp=2)
    ms = M.make_mesh_train_step(_loss_fn, training.adam(1e-2), plan,
                                zero=3, opt_level="O2",
                                loss_scale="dynamic")
    state = ms.init(_params())
    pipe = runtime.StepPipeline(ms.step_fn, 4,
                                wrap=ms.pipeline_wrap(state))
    window = tuple(_t(a)[None].expand(4, *a.shape) for a in (x, y))
    pipe.warmup(state, window)
    losses = []
    for _ in range(3):
        state, metrics = pipe.step_window(state, window)
        losses += [float(v) for v in metrics["loss"]]
    out["pipe/losses"] = np.array(losses)
    # an inf on shard (dp 0, fsdp 0) skips the step on every rank
    xo = x.copy()
    xo[0, 0] = np.inf
    _, s1, ms, plan, s0 = _mesh_run(M, training, 3, 2, 2, steps=1, x=xo)
    p0, p1 = ms.gather_params(s0), ms.gather_params(s1)
    out["overflow/same"] = np.array(all(torch.equal(p0[k], p1[k])
                                        for k in p0))
    out["overflow/finite"] = np.array(all(
        bool(torch.isfinite(leaf.float()).all())
        for leaf in torch.utils._pytree.tree_leaves(s1.opt_state)))
    out["overflow/scale"] = _np(s1.scaler.loss_scale)
    # decay_mask and max_bucket_elems reach the store at zero 2 and 3
    for zero in (2, 3):
        def run(wd, mask):
            _, st, ms, _, _ = _mesh_run(
                M, training, zero, 2, 2, steps=3, opt_level="O0",
                loss_scale=None, tx=training.adam(1e-2, weight_decay=wd),
                decay_mask=mask, max_bucket_elems=16)
            return ms.gather_params(st), st
        all_off, _ = run(0.5, {"w": False, "b": False})
        no_wd, _ = run(0.0, None)
        decayed, dstate = run(0.5, None)
        out[f"decay{zero}/off_is_zero_wd"] = np.array(all(
            torch.equal(all_off[k], no_wd[k]) for k in all_off))
        out[f"decay{zero}/decay_moves"] = np.array(all(
            not torch.equal(all_off[k], decayed[k]) for k in all_off))
        out[f"decay{zero}/buckets"] = np.array(len(dstate.opt_state.inner))
    # zero 3 with accum_steps: the view's backward on the accumulated
    # gradients
    for accum in (1, 2):
        losses, st, ms, _, _ = _mesh_run(M, training, 3, 2, 2, steps=1,
                                         accum_steps=accum)
        out[f"accum{accum}/loss"] = losses
        for k, v in ms.gather_params(st).items():
            out[f"accum{accum}/{k}"] = _np(v)
    losses, _, _, _, _ = _mesh_run(M, training, 3, 2, 2, steps=5,
                                   accum_steps=2)
    out["accum2/losses5"] = losses
    # the bf16 gather: the trajectory, and the bytes noted per axis
    for name, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        path = os.path.join(tmp, f"{name}_rank{rank}.jsonl")
        rec = telemetry.start(path)
        try:
            losses, st, ms, _, _ = _mesh_run(M, training, 3, 2, 2,
                                             steps=1, gather_dtype=dtype)
        finally:
            rec.close()
        out[f"gather_{name}/path"] = np.array(path)
        losses, st, ms, _, _ = _mesh_run(M, training, 3, 2, 2,
                                         gather_dtype=dtype)
        out[f"gather_{name}/losses"] = losses
        for k, v in ms.gather_params(st).items():
            out[f"gather_{name}/{k}"] = _np(v)
    # the checkpoint: zero 3 over 1 x 4, its buckets gathered and saved
    # with the plan's layout, restored at 2 shards
    _, st, ms, plan, _ = _mesh_run(M, training, 3, 1, 4, steps=3)
    from apex_tpu_torch.parallel.zero import _all_gather
    from apex_tpu_torch.parallel.distributed import axis_group
    group = axis_group(plan.fsdp_axis)

    def gather(t):
        return _all_gather(t, group, 4, "fsdp") if t.dim() >= 1 else t
    full = st._replace(
        params=Packed(data=tuple(gather(b) for b in st.params.data),
                      rest=st.params.rest),
        opt_state=torch.utils._pytree.tree_map(gather, st.opt_state))
    with ckpt.CheckpointManager(os.path.join(tmp, "ck"), procs=(rank, WORLD),
                                async_write=False) as mgr:
        mgr.save(3, full, bucket_layout=plan.bucket_layout(ms.store()),
                 block=True)
    dist.barrier()
    out["ckpt/saved_exp_avg"] = _np(full.opt_state.inner[0].exp_avg)
    out["ckpt/saved_params"] = _np(full.params.data[0])
    if rank == 0:
        def at2(t):
            return (torch.zeros(38, dtype=t.dtype) if t.dim() >= 1 else t)
        like = full._replace(
            params=Packed(data=(at2(full.params.data[0]),),
                          rest=full.params.rest),
            opt_state=torch.utils._pytree.tree_map(at2, full.opt_state))
        got = ckpt.load_checkpoint_dir(os.path.join(tmp, "ck"), like).state
        out["ckpt/exp_avg2"] = _np(got.opt_state.inner[0].exp_avg)
        out["ckpt/params2"] = _np(got.params.data[0])


def _worker(out_dir):
    from apex_tpu_torch.examples.simple.mesh import fsdp_train
    from apex_tpu_torch.parallel import multiproc
    torch.set_num_threads(1)
    rank, world = multiproc.initialize(device="cpu")
    assert world == WORLD
    out = {}
    _rank_main(rank, out, out_dir)
    res = fsdp_train.run(["--device", "cpu", "--zero", "3", "--steps", "8"],
                         log=lambda *a: None)
    out["example/losses"] = np.array(res["losses"])
    out["example/ratio"] = np.array(res["ledger"]["ratio"])
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    multiproc.shutdown()


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    _worker(sys.argv[sys.argv.index("--out") + 1])
    sys.exit(0)

# -- the test process's side (JAX imports only here) -------------------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from apex_tpu import training as jtraining  # noqa: E402
from apex_tpu.parallel import mesh as JM  # noqa: E402
from apex_tpu_torch.parallel import multiproc  # noqa: E402


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's saved results (one spawn for the module)."""
    out = tmp_path_factory.mktemp("mesh")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    results = multiproc.spawn([os.path.abspath(__file__), "--out",
                               str(out)], WORLD, f"file://{out}/store",
                              timeout=300, capture=True, env=env)
    if any(r["returncode"] != 0 for r in results):
        pytest.fail("\n".join(
            f"rank {r['rank']} exited {r['returncode']}:\n{r['output']}"
            for r in results))
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]


def _jax_loss_fn(p, batch):
    xb, yb = batch
    pred = xb @ p["w"].astype(jnp.float32) + jnp.pad(
        p["b"].astype(jnp.float32), (0, 4))
    return jnp.mean((pred - yb) ** 2)


def _jax_mesh(zero, dp, fsdp, steps=STEPS, opt_level="O0"):
    params, x, y = setup()
    plan = JM.MeshPlan(dp=dp, fsdp=fsdp,
                       devices=jax.devices("cpu")[:dp * fsdp])
    ms = JM.make_mesh_train_step(_jax_loss_fn, jtraining.adam(1e-2), plan,
                                 zero=zero, opt_level=opt_level,
                                 loss_scale="dynamic")
    state = ms.init(jax.tree_util.tree_map(jnp.asarray, params))
    step = ms.jit_step(state, donate=False)
    batch = plan.device_put_batch((jnp.asarray(x), jnp.asarray(y)))
    losses = []
    for _ in range(steps):
        state, m = step(state, batch)
        losses.append(float(jnp.ravel(m["loss"])[0]))
    return np.array(losses), jax.device_get(ms.gather_params(state)), state


def test_plan_validates_sizes_and_derives_axes(ranks):
    r = ranks[0]
    err = json.loads(str(r["errors"]))
    assert "dp*fsdp*tp" in err["sizes"] and ">= 1" in err["positive"]
    assert "dp=2" in str(r["plan/repr"])
    assert str(r["plan/specs"]) == str(((("dp", "fsdp"),), ("fsdp",)))
    # rank r is (dp, fsdp) = divmod(r, 2): row-major over the world
    for i, rr in enumerate(ranks):
        assert tuple(rr["z2_2x2/coords"]) == (i // 2, i % 2, 0)


def test_plan_auto_fills_dp(ranks):
    assert tuple(ranks[0]["plan/auto"]) == (1, 4, 1)
    assert tuple(ranks[0]["plan/auto2"]) == (2, 2, 1)


def test_plan_places_this_ranks_rows(ranks):
    """``device_put_batch`` gives each rank its rows of the global batch,
    row-major over (dp, fsdp), as JAX's ``P(("dp", "fsdp"))``."""
    for i, r in enumerate(ranks):
        assert int(r["plan/data_index"]) == i
        np.testing.assert_array_equal(r["plan/rows"],
                                      np.arange(4 * i, 4 * i + 4))


@pytest.mark.parametrize("zero,dp,fsdp", CONFIGS)
def test_mesh_zero_matches_zero1_bitwise(ranks, zero, dp, fsdp):
    """20 O2 steps with a dynamic scale: losses and gathered parameters
    bit for bit the port's ``zero1(bucketed=True)`` step's, on every
    rank; the loss falls."""
    key = f"z{zero}_{dp}x{fsdp}"
    for r in ranks:
        np.testing.assert_array_equal(r[f"{key}/losses"], r["base/losses"])
        for k in ("w", "b"):
            np.testing.assert_array_equal(r[f"{key}/{k}"], r[f"base/{k}"])
    assert ranks[0][f"{key}/losses"][-1] < ranks[0][f"{key}/losses"][0]


@pytest.mark.parametrize("zero,dp,fsdp", CONFIGS)
def test_mesh_zero_matches_jax(ranks, zero, dp, fsdp):
    """The same 20 steps at O0 of JAX's mesh step over 4 CPU devices:
    losses and parameters within rtol 1e-5 (atol 1e-6); this rank's chunk
    of the moments equals JAX's chunk divided by the factor JAX's
    autodiff puts in (asserted: the data world at zero 1/2, dp at zero
    3).  At O2 the bf16 copy of a master one fp32 ulp from JAX's can
    round the other way, which moved three of 20 losses by up to 7e-4:
    O2 is held bit for bit to the port's zero1 above, as JAX's test holds
    JAX's."""
    key = f"z{zero}_{dp}x{fsdp}/o0"
    losses, params, state = _jax_mesh(zero, dp, fsdp)
    np.testing.assert_allclose(ranks[0][f"{key}/losses"], losses, **TOL)
    for k in ("w", "b"):
        np.testing.assert_allclose(ranks[0][f"{key}/{k}"], params[k],
                                   **TOL)
    inner = state.opt_state.inner[0]
    m = np.asarray(inner.exp_avg)
    factor = dp * fsdp if zero < 3 else dp
    chunk = m.size // fsdp
    for i, r in enumerate(ranks):
        f = i % fsdp                        # rank = dp_index * fsdp + f
        want = m[f * chunk:(f + 1) * chunk]
        got = r[f"{key}/exp_avg"]
        assert got.shape == want.shape
        # the factor is JAX's: its first moment over the port's
        big = np.abs(want) > 1e-4
        np.testing.assert_allclose(want[big] / got[big], factor, rtol=1e-3)
        np.testing.assert_allclose(got * factor, want, rtol=1e-4,
                                   atol=1e-7)


def test_zero3_state_is_actually_sharded(ranks):
    """At fsdp 4 a rank holds ~1/4 of the parameter and optimizer-state
    bytes (the step counts and the scaler stay whole), its parameter
    chunk 40 / 4 elements of the padded 38."""
    r = ranks[0]
    assert float(r["z3_1x4/ratio"]) <= 1.0 / 4 + 0.05
    assert tuple(r["z3_1x4/chunk"]) == (10,)


def test_zero2_params_stay_replicated_state_sharded(ranks):
    r = ranks[0]
    assert bool(r["z2_2x2/params_whole"])
    assert float(r["z2_2x2/opt_ratio"]) <= 1.0 / 2 + 0.1


def test_zero3_pipeline_wrap_matches_zero1(ranks):
    """``StepPipeline(ms.step_fn, 4, wrap=ms.pipeline_wrap(state))`` over
    the global window: three windows' losses bit for bit the first 12
    of the zero1 baseline."""
    for r in ranks:
        np.testing.assert_array_equal(r["pipe/losses"], r["base/losses"][:12])


def test_zero3_overflow_on_one_shard_skips_everywhere(ranks):
    for r in ranks:
        assert bool(r["overflow/same"]) and bool(r["overflow/finite"])
        assert float(r["overflow/scale"]) == 2.0 ** 15


@pytest.mark.parametrize("zero", [2, 3])
def test_decay_mask_and_buckets_forwarded(ranks, zero):
    r = ranks[0]
    assert bool(r[f"decay{zero}/off_is_zero_wd"])
    assert bool(r[f"decay{zero}/decay_moves"])
    assert int(r[f"decay{zero}/buckets"]) >= 2


def test_zero3_accum_steps_applies_view_transpose(ranks):
    """``accum_steps=2`` at zero 3: one step within rtol 1e-5 of the
    unaccumulated step (the view's backward runs once, on the
    accumulated gradients); five steps finite and falling."""
    r = ranks[0]
    np.testing.assert_allclose(r["accum2/loss"], r["accum1/loss"],
                               rtol=1e-5)
    for k in ("w", "b"):
        np.testing.assert_allclose(r[f"accum2/{k}"], r[f"accum1/{k}"],
                                   rtol=1e-5, atol=1e-6)
    assert np.all(np.isfinite(r["accum2/losses5"]))
    assert r["accum2/losses5"][-1] < r["accum2/losses5"][0]


def test_zero3_fp32_gather_path_stays_bitwise(ranks):
    for r in ranks:
        np.testing.assert_array_equal(r["gather_fp32/losses"],
                                      r["base/losses"])
        for k in ("w", "b"):
            np.testing.assert_array_equal(r[f"gather_fp32/{k}"],
                                          r[f"base/{k}"])


def test_zero3_bf16_gather_tracks_fp32(ranks):
    r = ranks[0]
    assert r["gather_bf16/losses"][-1] < r["gather_bf16/losses"][0]
    np.testing.assert_allclose(r["gather_bf16/losses"],
                               r["gather_fp32/losses"], rtol=0.05,
                               atol=5e-3)
    for k in ("w", "b"):
        np.testing.assert_allclose(r[f"gather_bf16/{k}"],
                                   r[f"gather_fp32/{k}"], rtol=0.05,
                                   atol=5e-3)


def _collectives(path):
    out, dtypes = {}, set()
    for line in open(path):
        e = json.loads(line)
        if e.get("kind") != "collective":
            continue
        axis = e["axis"] if isinstance(e["axis"], str) else tuple(e["axis"])
        if isinstance(axis, tuple) and len(axis) == 1:
            axis = axis[0]
        key = (e["op"], axis)
        out[key] = out.get(key, 0) + e["bytes"] * e["n"]
        if e["op"] in ("all_gather", "reduce_scatter"):
            dtypes.add(e.get("dtype"))
    return out, dtypes


def test_zero3_bf16_gather_halves_wire_bytes(ranks):
    """The fsdp all-gather and its backward's reduce-scatter are noted in
    bf16 at half the fp32 run's bytes; the dp sum is untouched."""
    fp32, dt32 = _collectives(str(ranks[0]["gather_fp32/path"]))
    bf16, dt16 = _collectives(str(ranks[0]["gather_bf16/path"]))
    assert bf16[("all_gather", "fsdp")] * 2 == fp32[("all_gather", "fsdp")]
    assert (bf16[("reduce_scatter", "fsdp")] * 2
            == fp32[("reduce_scatter", "fsdp")])
    assert bf16[("psum", "dp")] == fp32[("psum", "dp")]
    assert dt32 == {"float32"} and dt16 == {"bfloat16"}


def test_mesh_collectives_note_their_axis(ranks):
    got, _ = _collectives(str(ranks[0]["gather_fp32/path"]))
    axes = {}
    for op, axis in got:
        axes.setdefault(op, set()).add(axis)
    assert "fsdp" in axes["all_gather"] and "fsdp" in axes["reduce_scatter"]
    assert "dp" in axes["psum"]


def test_refusals_name_what_they_refuse(ranks):
    err = json.loads(str(ranks[0]["errors"]))
    assert "elementwise" in err["lamb"] and "elementwise" in err["novograd"]
    assert "level" in err["level4"] and "level" in err["zero5"]
    assert "fp32 flat buckets" in err["o3"]
    assert "gather_dtype" in err["gather_dtype"]
    assert err["step_before_init"].startswith("RuntimeError") \
        and "init" in err["step_before_init"]
    assert "init" in err["store_before_init"]


def test_zero3_store_and_bucket_layout_for_checkpoints(ranks):
    r = ranks[0]
    assert json.loads(str(r["z3/layout"])) == {"sizes": [38],
                                               "num_shards": 4}
    assert int(r["z3/padded"]) == 40       # padded_shard_len(38, 4)


def test_zero3_checkpoint_reshards_on_restore(ranks):
    """Zero 3's gathered buckets saved at 4 shards (padded to 40) with
    the plan's layout restore at 2 shards (38): the true elements equal,
    as JAX's ``_maybe_reshard_flat`` cuts them."""
    from apex_tpu.checkpoint import _maybe_reshard_flat
    r = ranks[0]
    layout = {"sizes": [38], "num_shards": 4}
    for saved, got, key in (
            ("ckpt/saved_exp_avg", "ckpt/exp_avg2",
             "opt_state/inner/0/exp_avg"),
            ("ckpt/saved_params", "ckpt/params2", "params/data/0")):
        assert r[saved].shape == (40,) and r[got].shape == (38,)
        want = _maybe_reshard_flat(r[saved], (38,), key, layout)
        np.testing.assert_array_equal(r[got], np.asarray(want))


def test_fsdp_train_example_runs_zero3(ranks):
    """``examples/simple/mesh/fsdp_train.py --zero 3`` over the four
    ranks (pure FSDP by default): 8 steps a window of 4, every loss
    finite and equal on every rank, a rank holding ~1/4 of the state."""
    losses = ranks[0]["example/losses"]
    assert losses.shape == (8,) and np.all(np.isfinite(losses))
    for r in ranks:
        np.testing.assert_array_equal(r["example/losses"], losses)
    assert float(ranks[0]["example/ratio"]) <= 1.0 / 4 + 0.05
