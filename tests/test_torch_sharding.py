"""The port's functional sharding primitives (``apex_tpu_torch.parallel``:
``zero``, ``tensor_parallel``, ``expert_parallel``, ``pipeline``) over
four gloo processes against JAX's ``shard_map`` over four CPU devices,
case by case as ``tests/test_{zero,tensor_parallel,expert_parallel,
pipeline}.py`` name them.

Four ranks are spawned once for the module (this file run as a script,
``multiproc.spawn`` with a file store under ``tmp_path``, a 120 s
timeout, one thread a rank); each runs every scenario on its shard of
the same numpy inputs and saves what it got.  The tests hold that
against the JAX functions on the same inputs: rtol 1e-6 (atol 1e-7 for
values near zero) where a sum runs over the ranks in another order (a
``psum``, a reduce-scatter, the gradient of a replicated input), and
bit for bit where JAX's test asks for equality (a skipped step, the
shard helpers).  The zero1 checkpoint is saved by the four ranks and
restored at 4, 2 and 1 shards, each restored leaf held against JAX's
``_maybe_reshard_flat`` on the saved arrays.
"""

import os
import sys

import numpy as np
import pytest
import torch

WORLD = 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-6, atol=1e-7)
# a pipeline's stages run torch's and XLA's own matrix products, whose
# sums run in another order: JAX's own pipeline tolerances (forward
# 1e-6 relative and absolute, gradients 1e-5)
PP_TOL = dict(rtol=1e-6, atol=1e-6)
PP_GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
D_TP, S_PP, M_PP, D_PP, V_PP = 64, 4, 4, 16, 2
E_MOE, D_MOE, T_MOE = 4, 8, 16


# -- inputs (numpy, shared by both sides) ----------------------------------------

def zero_setup():
    rng = np.random.RandomState(0)
    params = {"w": (rng.randn(5, 7) * 0.3).astype(np.float32),
              "b": np.zeros((3,), np.float32)}     # 38 elements: pad to 40
    x = rng.randn(8 * WORLD, 5).astype(np.float32)
    y = (rng.randn(8 * WORLD, 7) * 0.1).astype(np.float32)
    return params, x, y


def rand(shape, seed):
    return (np.random.RandomState(seed).randn(*shape) * 0.1).astype(
        np.float32)


def moe_params():
    rng = np.random.RandomState(0)
    router = (rng.randn(D_MOE, E_MOE) * 0.5).astype(np.float32)
    experts = [{"w": (rng.randn(D_MOE, 2 * D_MOE) * 0.3).astype(np.float32),
                "v": (rng.randn(2 * D_MOE, D_MOE) * 0.3).astype(np.float32)}
               for _ in range(E_MOE)]
    return router, experts


def pp_params(n, seed=0):
    rng = np.random.RandomState(seed)
    return [{"w": (rng.randn(D_PP, D_PP) * 0.3).astype(np.float32),
             "b": (rng.randn(D_PP) * 0.1).astype(np.float32)}
            for _ in range(n)]


# -- the ranks' side ---------------------------------------------------------------

def _np(t):
    return t.detach().float().numpy().copy()


def _t(a):
    return torch.from_numpy(np.array(a))


def _zero_loss(p, batch):
    xb, yb = batch    # O2 hands bf16 weights: JAX promotes to fp32
    pred = xb @ p["w"].float() + torch.nn.functional.pad(p["b"].float(),
                                                         (0, 4))
    return ((pred - yb) ** 2).mean()


def _zero_run(rank, tx, steps=5, loss_scale=None, x=None, y=None,
              reduce_grads=False, opt_level="O2"):
    from apex_tpu_torch import training
    params, x0, y0 = zero_setup()
    x = x0 if x is None else x
    y = y0 if y is None else y
    init_fn, step_fn = training.make_train_step(
        _zero_loss, tx, opt_level=opt_level, loss_scale=loss_scale,
        axis_name="data", reduce_grads=reduce_grads)
    state = init_fn({k: _t(v) for k, v in params.items()})
    rows = slice(rank * 8, rank * 8 + 8)
    batch = (_t(x[rows]), _t(y[rows]))
    losses = []
    for _ in range(steps):
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
    return np.array(losses), state


def _rank_zero(rank, out, tmp):
    import torch.distributed as dist

    from apex_tpu_torch import checkpoint as ckpt
    from apex_tpu_torch import training
    from apex_tpu_torch.multi_tensor.buckets import BucketStore
    from apex_tpu_torch.parallel.zero import (zero1, zero1_gather_state,
                                              zero1_init_full,
                                              zero1_partition_spec,
                                              zero1_shard_state)
    def z1(**kw):
        return zero1(training.adam(1e-2), "data", num_shards=WORLD, **kw)

    # O0: fp32 gradients, held against JAX's O0 zero1
    losses, st = _zero_run(rank, z1(), opt_level="O0")
    out["zero/losses"] = losses
    for k, v in st.params.items():
        out[f"zero/params/{k}"] = _np(v)
    out["zero/exp_avg"] = _np(st.opt_state.inner.exp_avg)
    spec = zero1_partition_spec(st.opt_state, "data")
    assert spec.inner.exp_avg == "data" and spec.inner.step is None
    # O2 (JAX's test's level): against the port's replicated DP step
    losses, st = _zero_run(rank, z1())
    _, plain = _zero_run(rank, training.adam(1e-2), reduce_grads=True)
    out["zero_o2/losses"] = losses
    for k in ("w", "b"):
        out[f"zero_o2/params/{k}"] = _np(st.params[k])
        out[f"zero_o2/plain/{k}"] = _np(plain.params[k])
    out["zero_dynamic/losses"] = _zero_run(
        rank, zero1(training.adam(1e-2), "data", num_shards=WORLD),
        loss_scale="dynamic")[0]
    params, x, y = zero_setup()
    x = x.copy()
    x[0, 0] = np.inf                       # rank 0's shard only
    _, st = _zero_run(rank, zero1(training.adam(1e-2), "data",
                                  num_shards=WORLD),
                      loss_scale="dynamic", steps=1, x=x)
    out["overflow/w"] = _np(st.params["w"])
    out["overflow/finite"] = np.array(all(
        bool(torch.isfinite(leaf.float()).all())
        for leaf in torch.utils._pytree.tree_leaves(st.opt_state)))
    out["overflow/scale"] = _np(st.scaler.loss_scale)
    out["sharded/len"] = np.array(st.opt_state.inner.exp_avg.numel())
    # bucketed: a mixed fp32/bf16 tree shards a bucket a dtype
    mixed = {"w": _t(params["w"]), "h": _t(rand((6,), 11)).bfloat16()}
    bz = zero1(training.adam(1e-2), "data", num_shards=WORLD,
               bucketed=True)
    bst = bz.init(mixed)
    out["bucketed/lens"] = np.array([s.exp_avg.numel() for s in bst.inner])
    g = {"w": _t(rand((5, 7), 20 + rank)), "h": _t(rand((6,), 30 + rank))
         .bfloat16()}
    new_p, _ = bz.update(g, bst, mixed)
    out["bucketed/w"], out["bucketed/h"] = _np(new_p["w"]), _np(new_p["h"])
    assert new_p["h"].dtype == torch.bfloat16

    _, x, y = zero_setup()
    # checkpoint: bucketed zero1 at 4 shards, 3 steps, gathered and saved
    # with its bucket layout; restored at 4, 2 and 1
    tx4 = zero1(training.adam(1e-2), "data", num_shards=WORLD,
                bucketed=True)
    _, st4 = _zero_run(rank, tx4, steps=3)
    full = st4._replace(opt_state=zero1_gather_state(st4.opt_state, "data"))
    tparams = {k: _t(v) for k, v in params.items()}
    store = BucketStore(tparams)
    with ckpt.CheckpointManager(tmp, procs=(rank, WORLD),
                                async_write=False) as mgr:
        mgr.save(3, full, bucket_layout=ckpt.bucket_layout(store, WORLD),
                 block=True)
    dist.barrier()
    groups = {2: dist.new_group([0, 1]), 1: dist.new_group([0])}
    for m_shards in (4, 2, 1):
        if rank >= m_shards:
            continue
        like = full._replace(opt_state=zero1_init_full(
            training.adam(1e-2), tparams, num_shards=m_shards,
            bucketed=True))
        got = ckpt.load_checkpoint_dir(tmp, like).state
        for i, s in enumerate(got.opt_state.inner):
            out[f"ckpt{m_shards}/exp_avg/{i}"] = _np(s.exp_avg)
            out[f"ckpt{m_shards}/exp_avg_sq/{i}"] = _np(s.exp_avg_sq)
        for k in params:
            assert torch.equal(got.params[k], full.params[k])
        if m_shards == WORLD:
            continue
        # training goes on at m_shards: this rank's chunk of the resharded
        # state, two steps over the sub-group on its rows
        group = groups[m_shards]
        txm = zero1(training.adam(1e-2), group, num_shards=m_shards,
                    bucketed=True)
        init_fn, step_fn = training.make_train_step(
            _zero_loss, txm, opt_level="O2", axis_name=group,
            reduce_grads=False)
        state = got._replace(opt_state=zero1_shard_state(got.opt_state,
                                                         group))
        assert state.opt_state.inner[0].exp_avg.numel() * m_shards == \
            got.opt_state.inner[0].exp_avg.numel()
        rows = slice(rank * 8, rank * 8 + 8)
        for _ in range(2):
            state, met = step_fn(state, (_t(x[rows]), _t(y[rows])))
        out[f"ckpt{m_shards}/resumed_w"] = _np(state.params["w"])
        out[f"ckpt{m_shards}/resumed_loss"] = np.array(float(met["loss"]))


def _rank_tp(rank, out):
    from apex_tpu_torch.parallel import (column_parallel_dense,
                                         row_parallel_dense, shard_column,
                                         shard_row, tp_mlp,
                                         tp_self_attention)
    import apex_tpu_torch.ops.flash_attention  # noqa: F401
    fa = sys.modules["apex_tpu_torch.ops.flash_attention"]
    x, w1, b1 = _t(rand((8, 64), 0)), _t(rand((64, 128), 1)), \
        _t(rand((128,), 2))
    w2, b2 = _t(rand((128, 64), 3)), _t(rand((64,), 4))
    h = column_parallel_dense(x, shard_column(w1, "data"),
                              shard_column(b1[None], "data")[0])
    out["tp/pair"] = _np(row_parallel_dense(h, shard_row(w2, "data"),
                                            "data", b=b2))
    x3 = _t(rand((4, 16, 64), 0))
    w1m, b1m = _t(rand((64, 256), 1)), _t(rand((256,), 2))
    w2m, b2m = _t(rand((256, 64), 3)), _t(rand((64,), 4))
    out["tp/mlp"] = _np(tp_mlp(x3, shard_column(w1m, "data"),
                               shard_column(b1m[None], "data")[0],
                               shard_row(w2m, "data"), b2m, "data"))
    # attention: 4 heads, one a rank; the default (flash) and blockwise
    xa, wqkv, wo = _t(rand((2, 16, 32), 0)), _t(rand((32, 3, 4, 8), 1)), \
        _t(rand((32, 32), 2))
    wqkv_l = wqkv[:, :, rank:rank + 1]
    wo_l = shard_row(wo, "data")
    calls = []
    orig = fa.flash_attention

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    fa.flash_attention = spy
    try:
        out["tp/attn_flash"] = _np(tp_self_attention(xa, wqkv_l, wo_l, 1,
                                                     "data", causal=True))
    finally:
        fa.flash_attention = orig
    out["tp/attn_flash_calls"] = np.array(len(calls))
    from apex_tpu_torch.ops.attention import blockwise_attention
    out["tp/attn_blockwise"] = _np(tp_self_attention(
        xa, wqkv_l, wo_l, 1, "data", causal=True,
        attention_fn=lambda q, k, v: blockwise_attention(q, k, v,
                                                         causal=True)))
    w = _t(rand((32, 64), 5))
    out["tp/col"] = _np(shard_column(w, "data"))
    out["tp/row"] = _np(shard_row(w, "data"))
    # gradients: local weight grads, the replicated input's summed
    w1l = shard_column(w1, "data").clone().requires_grad_(True)
    w2l = shard_row(w2, "data").clone().requires_grad_(True)
    xg = x.clone().requires_grad_(True)
    y = row_parallel_dense(column_parallel_dense(xg, w1l, axis_name="data"),
                           w2l, "data")
    (y ** 2).sum().div(y.numel()).backward()
    out["tp/g1"], out["tp/g2"], out["tp/gx"] = (_np(w1l.grad),
                                                _np(w2l.grad), _np(xg.grad))
    y = tp_mlp(x3, shard_column(w1m, "data"),
               shard_column(b1m[None], "data")[0],
               shard_row(w2m, "data").clone().requires_grad_(True), b2m,
               "data")
    assert y.requires_grad


def _expert_fn(p, h):
    return torch.tanh(h @ p["w"]) @ p["v"]


def _rank_moe(rank, out):
    from apex_tpu_torch.parallel import moe_layer
    router, experts = moe_params()
    mine = {k: _t(v) for k, v in experts[rank].items()}
    rows = slice(rank * T_MOE, (rank + 1) * T_MOE)
    x = np.random.RandomState(1).randn(E_MOE * T_MOE, D_MOE).astype(
        np.float32)
    y, aux = moe_layer(_t(x[rows]), _t(router), _expert_fn, mine,
                       axis_name="data", capacity_factor=E_MOE)
    out["moe/y"], out["moe/lb"] = _np(y), _np(aux.load_balance_loss)
    out["moe/dropped"] = _np(aux.dropped_fraction)
    ones = np.ones((E_MOE * T_MOE, D_MOE), np.float32)
    y, aux = moe_layer(_t(ones[rows]), _t(router), _expert_fn, mine,
                       axis_name="data", capacity_factor=1.0)
    out["moe_drop/y"], out["moe_drop/dropped"] = (_np(y),
                                                  _np(aux.dropped_fraction))
    x2 = np.random.RandomState(2).randn(E_MOE * T_MOE, D_MOE).astype(
        np.float32)
    r = _t(router).requires_grad_(True)
    ep = {k: v.clone().requires_grad_(True) for k, v in mine.items()}
    y, _ = moe_layer(_t(x2[rows]), r, _expert_fn, ep, axis_name="data",
                     capacity_factor=float(E_MOE))
    ((y ** 2).mean() / E_MOE).backward()
    out["moe_grad/router"] = _np(r.grad)
    for k, v in ep.items():
        out[f"moe_grad/{k}"] = _np(v.grad)
    x7 = (np.random.RandomState(7).randn(E_MOE * T_MOE, D_MOE) * 3).astype(
        np.float32)
    _, aux = moe_layer(_t(x7[rows]), _t(router), _expert_fn, mine,
                       axis_name="data", capacity_factor=E_MOE)
    out["moe_lb/lb"] = _np(aux.load_balance_loss)


def _stage_fn(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def _rank_pipeline(rank, out):
    from apex_tpu_torch.parallel import (spmd_pipeline,
                                         spmd_pipeline_interleaved,
                                         stack_interleaved_stage_params,
                                         stack_stage_params)
    from apex_tpu_torch.parallel.distributed import COLLECTIVES
    per = [{k: _t(v) for k, v in p.items()} for p in pp_params(S_PP)]
    stacked = stack_stage_params(per)
    mine = {k: v[rank:rank + 1] for k, v in stacked.items()}
    x = _t(np.random.RandomState(1).randn(8, D_PP).astype(np.float32))
    out["pp/fwd"] = _np(spmd_pipeline(_stage_fn, mine, x, axis_name="data",
                                      num_microbatches=M_PP))
    x2 = _t(np.random.RandomState(2).randn(8, D_PP).astype(np.float32))
    sp = {k: v.clone().requires_grad_(True) for k, v in mine.items()}
    xg = x2.clone().requires_grad_(True)
    y = spmd_pipeline(_stage_fn, sp, xg, axis_name="data",
                      num_microbatches=M_PP)
    (y ** 2).mean().backward()
    for k, v in sp.items():
        out[f"pp_grad/{k}"] = _np(v.grad)
    out["pp_grad/x"] = _np(xg.grad)
    x3 = _t(np.random.RandomState(3).randn(8, D_PP).astype(np.float32))
    for m in (2, 8):
        out[f"pp_m{m}"] = _np(spmd_pipeline(_stage_fn, mine, x3,
                                            axis_name="data",
                                            num_microbatches=m))
    try:
        spmd_pipeline(_stage_fn, mine, torch.ones(6, D_PP),
                      axis_name="data", num_microbatches=4)
    except ValueError as e:
        out["pp/indivisible"] = np.array(str(e))
    # interleaved
    per_i = [{k: _t(v) for k, v in p.items()} for p in pp_params(S_PP * V_PP)]
    st_i = stack_interleaved_stage_params(per_i, S_PP)
    mine_i = {k: v[:, rank:rank + 1] for k, v in st_i.items()}
    for m in (S_PP, 2 * S_PP):
        xi = _t(np.random.RandomState(1).randn(2 * m, D_PP).astype(
            np.float32))
        before = COLLECTIVES["permute"].launches
        out[f"ppi_fwd/{m}"] = _np(spmd_pipeline_interleaved(
            _stage_fn, mine_i, xi, axis_name="data", num_microbatches=m))
        out[f"ppi_ticks/{m}"] = np.array(COLLECTIVES["permute"].launches
                                         - before)
    before = COLLECTIVES["permute"].launches
    spmd_pipeline(_stage_fn, mine, torch.zeros(2 * 2 * S_PP, D_PP),
                  axis_name="data", num_microbatches=2 * S_PP)
    out["pp_ticks"] = np.array(COLLECTIVES["permute"].launches - before)
    per_g = [{k: _t(v) for k, v in p.items()}
             for p in pp_params(S_PP * V_PP, seed=3)]
    st_g = stack_interleaved_stage_params(per_g, S_PP)
    sp = {k: v[:, rank:rank + 1].clone().requires_grad_(True)
          for k, v in st_g.items()}
    tgt = _t(np.random.RandomState(4).randn(8, D_PP).astype(np.float32))
    y = spmd_pipeline_interleaved(_stage_fn, sp, x2, axis_name="data",
                                  num_microbatches=M_PP)
    ((y - tgt) ** 2).mean().backward()
    for k, v in sp.items():
        out[f"ppi_grad/{k}"] = _np(v.grad)
    try:
        spmd_pipeline_interleaved(_stage_fn, mine_i, torch.ones(6, D_PP),
                                  axis_name="data", num_microbatches=6)
    except ValueError as e:
        out["ppi/partial"] = np.array(str(e))


def _worker(out_dir):
    from apex_tpu_torch.parallel import multiproc
    torch.set_num_threads(1)
    rank, world = multiproc.initialize(device="cpu")
    assert world == WORLD
    out = {}
    _rank_zero(rank, out, os.path.join(out_dir, "ckpt"))
    _rank_tp(rank, out)
    _rank_moe(rank, out)
    _rank_pipeline(rank, out)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    multiproc.shutdown()


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    _worker(sys.argv[sys.argv.index("--out") + 1])
    sys.exit(0)

# -- the test process's side (JAX imports only here) -------------------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import shard_map  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

from apex_tpu import training as jtraining  # noqa: E402
from apex_tpu.parallel import expert_parallel as jep  # noqa: E402
from apex_tpu.parallel import pipeline as jpp  # noqa: E402
from apex_tpu.parallel import tensor_parallel as jtp  # noqa: E402
from apex_tpu.parallel.zero import (zero1 as jzero1,  # noqa: E402
                                    zero1_partition_spec as jspec)
from apex_tpu_torch import training  # noqa: E402
from apex_tpu_torch.parallel import multiproc  # noqa: E402
from apex_tpu_torch.parallel.zero import zero1  # noqa: E402


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's saved results (one spawn for the module)."""
    out = tmp_path_factory.mktemp("sharding")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    results = multiproc.spawn([os.path.abspath(__file__), "--out",
                               str(out)], WORLD, f"file://{out}/store",
                              timeout=120, capture=True, env=env)
    if any(r["returncode"] != 0 for r in results):
        pytest.fail("\n".join(
            f"rank {r['rank']} exited {r['returncode']}:\n{r['output']}"
            for r in results))
    got = [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]
    got[0]["_dir"] = str(out / "ckpt")
    return got


def _mesh(name="data"):
    return Mesh(np.array(jax.devices("cpu")[:WORLD]), (name,))


# -- ZeRO-1 --------------------------------------------------------------------------

def _jax_zero_loss(p, batch):
    xb, yb = batch
    pred = xb @ p["w"] + jnp.pad(p["b"], (0, 4))
    return jnp.mean((pred - yb) ** 2)


def _jax_zero_run(tx, opt_spec, steps=5, loss_scale=None, reduce_grads=True,
                  x=None, opt_level="O2"):
    params, x0, y = zero_setup()
    x = x0 if x is None else x
    init_fn, step_fn = jtraining.make_train_step(
        _jax_zero_loss, tx, opt_level=opt_level, loss_scale=loss_scale,
        axis_name=("data",), reduce_grads=reduce_grads)
    state = init_fn({k: jnp.asarray(v) for k, v in params.items()})
    spec = jtraining.TrainState(params=P(), opt_state=opt_spec, scaler=P(),
                                model_state=P())

    def wrapped(s, b):
        ns, m = step_fn(s, b)
        return ns, jax.tree_util.tree_map(
            lambda v: jtraining._pmean_varying(v, ("data",)), m)

    step = jax.jit(shard_map(wrapped, mesh=_mesh(),
                             in_specs=(spec, (P("data"), P("data"))),
                             out_specs=(spec, P())))
    losses = []
    for _ in range(steps):
        state, metrics = step(state, (jnp.asarray(x), jnp.asarray(y)))
        losses.append(float(jnp.ravel(metrics["loss"])[0]))
    return np.array(losses), state


def _jax_zero(**kw):
    tx = jzero1(jtraining.adam(1e-2), "data", num_shards=WORLD)
    spec = jspec(tx.init(zero_setup()[0]), "data")
    return _jax_zero_run(tx, spec, reduce_grads=False, **kw)


def test_zero1_matches_plain_dp(ranks):
    """At O0 the port's zero1 equals JAX's (losses, parameters, each
    rank's moment chunk) at rtol 1e-6.  At O2, JAX's test's level, it
    equals the port's replicated DP step at rtol 1e-6 and JAX's losses
    at JAX's own 1e-5: an O2 gradient is rounded to bf16 by the cast's
    transpose, so one ulp of fp32 difference before it (another
    product order) can move a gradient by a bf16 ulp."""
    losses, state = _jax_zero(opt_level="O0")
    full_m = np.asarray(state.opt_state.inner.exp_avg)
    o2_losses, _ = _jax_zero()
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["zero/losses"], losses, **TOL)
        for k in ("w", "b"):
            np.testing.assert_allclose(got[f"zero/params/{k}"],
                                       np.asarray(state.params[k]), **TOL)
            np.testing.assert_allclose(got[f"zero_o2/params/{k}"],
                                       got[f"zero_o2/plain/{k}"], **TOL)
        # JAX's moments hold four times the mean gradient: under
        # shard_map's varying-axes autodiff the gradient of the
        # replicated parameters is already summed over the axis before
        # zero1's reduce-scatter sums it again (Adam's update is the same
        # up to eps); the port's chunk holds the mean's moment
        np.testing.assert_allclose(got["zero/exp_avg"] * WORLD,
                                   full_m[r * 10:(r + 1) * 10], **TOL)
        np.testing.assert_allclose(got["zero_o2/losses"], o2_losses,
                                   rtol=1e-5, atol=1e-7)
    assert losses[-1] < losses[0]


def test_zero1_with_dynamic_scaling(ranks):
    losses, _ = _jax_zero(loss_scale="dynamic")
    got = ranks[0]["zero_dynamic/losses"]
    assert np.all(np.isfinite(got)) and got[-1] < got[0]
    np.testing.assert_allclose(got, losses, rtol=1e-5, atol=1e-7)


def test_zero1_overflow_on_one_rank_skips_everywhere(ranks):
    params, x, _ = zero_setup()
    x = x.copy()
    x[0, 0] = np.inf
    _, state = _jax_zero(loss_scale="dynamic", steps=1, x=x)
    for got in ranks:
        np.testing.assert_array_equal(got["overflow/w"], params["w"])
        np.testing.assert_array_equal(got["overflow/w"],
                                      np.asarray(state.params["w"]))
        assert bool(got["overflow/finite"])
        assert float(got["overflow/scale"]) == 2.**15 == float(
            state.scaler.loss_scale)


def test_zero1_state_is_actually_sharded(ranks):
    """Each rank holds 1/4 of the padded (38 -> 40) flat state, as JAX's
    shard_map hands each device; bucketed, a quarter of each dtype's
    padded bucket (the bf16 ``h``'s first in JAX's order: 6 -> 8, then
    35 -> 36)."""
    full = jzero1(jtraining.adam(1e-2), "data", num_shards=WORLD).init(
        {k: jnp.asarray(v) for k, v in zero_setup()[0].items()})
    assert full.inner.exp_avg.size == 40
    for got in ranks:
        assert int(got["sharded/len"]) == 40 // WORLD
        np.testing.assert_array_equal(got["bucketed/lens"], [2, 9])


def test_zero1_bucketed_mixed_dtypes_match_jax(ranks):
    params = {"w": jnp.asarray(zero_setup()[0]["w"]),
              "h": jnp.asarray(rand((6,), 11), jnp.bfloat16)}
    tx = jzero1(jtraining.adam(1e-2), "data", num_shards=WORLD,
                bucketed=True)
    st = tx.init(params)
    grads = {"w": np.stack([rand((5, 7), 20 + r) for r in range(WORLD)]),
             "h": np.stack([rand((6,), 30 + r) for r in range(WORLD)])
             .astype(jnp.bfloat16)}
    spec = jspec(st, "data")

    def body(g, s, p):
        g = jax.tree_util.tree_map(lambda a: a[0], g)
        return tx.update(g, s, p)[0]

    new_p = jax.jit(shard_map(body, mesh=_mesh(),
                              in_specs=(P("data"), spec, P()),
                              out_specs=P(), check_vma=False))(
        grads, st, params)
    for got in ranks:
        np.testing.assert_allclose(got["bucketed/w"],
                                   np.asarray(new_p["w"]), **TOL)
        np.testing.assert_allclose(got["bucketed/h"],
                                   np.asarray(new_p["h"], np.float32),
                                   rtol=1e-2)


def test_zero1_checkpoint_reshards_at_4_2_1(ranks):
    """The four ranks' bucketed zero1 checkpoint (saved at 4 shards)
    restores at 4, 2 and 1 shards: every flat leaf equals JAX's
    ``_maybe_reshard_flat`` of the saved array, and two more steps at 2
    and 1 shards train on."""
    from apex_tpu import checkpoint as jckpt
    from apex_tpu_torch.checkpoint import _validate_step_dir
    step_dir = os.path.join(ranks[0]["_dir"], "step_00000003")
    manifest = _validate_step_dir(step_dir)
    assert manifest is not None and len(manifest["parts"]) == WORLD
    saved = {}
    for part in manifest["parts"]:
        with np.load(os.path.join(step_dir, part["file"])) as data:
            saved.update({k: data[k] for k in data.files})
    buckets = manifest["parts"][0]["buckets"]
    assert buckets == {"sizes": [38], "num_shards": WORLD}
    for m in (4, 2, 1):
        want_len = -(-38 // m) * m
        for field in ("exp_avg", "exp_avg_sq"):
            key = f"opt_state/inner/0/{field}"
            got = ranks[0][f"ckpt{m}/{field}/0"]
            assert got.shape == (want_len,)
            want = (saved[key] if want_len == saved[key].size else
                    jckpt._maybe_reshard_flat(saved[key], (want_len,), key,
                                              buckets))
            np.testing.assert_array_equal(got, want)
    for m in (2, 1):
        assert np.isfinite(ranks[0][f"ckpt{m}/resumed_loss"])
        assert not np.array_equal(ranks[0][f"ckpt{m}/resumed_w"],
                                  zero_setup()[0]["w"])
    np.testing.assert_array_equal(ranks[0]["ckpt2/resumed_w"],
                                  ranks[1]["ckpt2/resumed_w"])


def test_zero1_rejects_per_tensor_norm_optimizers():
    for tx in (training.lamb(1e-3), training.novograd(1e-3)):
        with pytest.raises(ValueError, match="elementwise"):
            zero1(tx, "data", num_shards=4)


def test_zero1_rejects_unknown_optimizers_by_default():
    sneaky = training.FunctionalOptimizer(
        init=lambda p: None, update=lambda g, s, p, **kw: (p, s))
    with pytest.raises(ValueError, match="elementwise"):
        zero1(sneaky, "data", num_shards=4)
    zero1(sneaky._replace(elementwise=True), "data", num_shards=4)


def test_zero1_rejects_mixed_dtypes():
    tx = zero1(training.adam(1e-2), "data", num_shards=4)
    with pytest.raises(ValueError, match="uniform parameter dtype"):
        tx.init({"a": torch.zeros(3), "b": torch.zeros(3,
                                                       dtype=torch.bfloat16)})


# -- tensor parallel ---------------------------------------------------------------

def _jax_tp(fn, in_specs, *args):
    return np.asarray(jax.jit(shard_map(fn, mesh=_mesh("tp"),
                                        in_specs=in_specs,
                                        out_specs=P()))(*args))


def test_column_row_pair_matches_dense(ranks):
    args = [jnp.asarray(rand(s, i)) for i, s in enumerate(
        [(8, 64), (64, 128), (128,), (128, 64), (64,)])]
    want = _jax_tp(lambda x, w1, b1, w2, b2: jtp.row_parallel_dense(
        jtp.column_parallel_dense(x, w1, b1), w2, "tp", b=b2),
        (P(), P(None, "tp"), P("tp"), P("tp", None), P()), *args)
    for got in ranks:
        np.testing.assert_allclose(got["tp/pair"], want, **TOL)


def test_tp_mlp_matches_dense(ranks):
    args = [jnp.asarray(rand(s, i)) for i, s in enumerate(
        [(4, 16, 64), (64, 256), (256,), (256, 64), (64,)])]
    want = _jax_tp(lambda x, w1, b1, w2, b2: jtp.tp_mlp(x, w1, b1, w2, b2,
                                                        "tp"),
                   (P(), P(None, "tp"), P("tp"), P("tp", None), P()), *args)
    for got in ranks:
        np.testing.assert_allclose(got["tp/mlp"], want, **TOL)


def _jax_attention(attention_fn=None):
    args = [jnp.asarray(rand((2, 16, 32), 0)),
            jnp.asarray(rand((32, 3, 4, 8), 1)),
            jnp.asarray(rand((32, 32), 2))]
    return _jax_tp(lambda x, wqkv, wo: jtp.tp_self_attention(
        x, wqkv, wo, 1, "tp", causal=True, attention_fn=attention_fn),
        (P(), P(None, None, "tp"), P("tp", None)), *args)


def test_tp_self_attention_matches_dense(ranks):
    from apex_tpu.ops.attention import blockwise_attention
    want = _jax_attention(lambda q, k, v: blockwise_attention(
        q, k, v, causal=True))
    for got in ranks:
        np.testing.assert_allclose(got["tp/attn_blockwise"], want, **TOL)


def test_tp_self_attention_default_is_flash(ranks):
    want = _jax_attention()
    for got in ranks:
        assert int(got["tp/attn_flash_calls"]) == 1
        np.testing.assert_allclose(got["tp/attn_flash"], want,
                                   rtol=2e-6, atol=1e-7)


def test_shard_helpers_roundtrip(ranks):
    w = rand((32, 64), 5)
    np.testing.assert_array_equal(
        np.concatenate([g["tp/col"] for g in ranks], axis=1), w)
    np.testing.assert_array_equal(
        np.concatenate([g["tp/row"] for g in ranks], axis=0), w)
    cols = np.asarray(jax.jit(shard_map(
        lambda w: jtp.shard_column(w, "tp"), mesh=_mesh("tp"),
        in_specs=(P(),), out_specs=P("tp")))(jnp.asarray(w)))
    np.testing.assert_array_equal(cols.reshape(4, 32, 16)[2],
                                  ranks[2]["tp/col"])


def test_tp_gradients_stay_local_and_match(ranks):
    x, w1, w2 = (jnp.asarray(rand((8, 64), 0)), jnp.asarray(rand((64, 128), 1)),
                 jnp.asarray(rand((128, 64), 3)))

    def loss(x, w1, w2):
        y = jtp.row_parallel_dense(jtp.column_parallel_dense(x, w1), w2, "tp")
        return jnp.sum(y ** 2) / y.size

    g1, g2, gx = jax.jit(shard_map(
        lambda x, w1, w2: jax.grad(loss, argnums=(1, 2, 0))(x, w1, w2),
        mesh=_mesh("tp"), in_specs=(P(), P(None, "tp"), P("tp", None)),
        out_specs=(P(None, "tp"), P("tp", None), P())))(x, w1, w2)
    g1, g2 = np.asarray(g1), np.asarray(g2)
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["tp/g1"],
                                   g1[:, r * 32:(r + 1) * 32], **TOL)
        np.testing.assert_allclose(got["tp/g2"],
                                   g2[r * 32:(r + 1) * 32], **TOL)
        np.testing.assert_allclose(got["tp/gx"], np.asarray(gx), **TOL)


# -- expert parallel ----------------------------------------------------------------

def _jax_expert_fn(p, h):
    return jnp.tanh(h @ p["w"]) @ p["v"]


def _jax_moe(x, capacity_factor, seed_router=None):
    router, experts = moe_params()
    stacked = jpp.stack_stage_params([jax.tree_util.tree_map(
        jnp.asarray, e) for e in experts])

    def fn(router, ep, x):
        ep = jax.tree_util.tree_map(lambda p: jnp.squeeze(p, 0), ep)
        y, aux = jep.moe_layer(x, router, _jax_expert_fn, ep,
                               axis_name="ep",
                               capacity_factor=capacity_factor)
        return y, jax.tree_util.tree_map(lambda v: v[None], aux)

    y, aux = jax.jit(shard_map(fn, mesh=_mesh("ep"),
                               in_specs=(P(), P("ep"), P("ep")),
                               out_specs=(P("ep"), P("ep"))))(
        jnp.asarray(router), stacked, jnp.asarray(x))
    return np.asarray(y), jax.tree_util.tree_map(np.asarray, aux)


def test_moe_matches_dense_oracle_when_capacity_suffices(ranks):
    x = np.random.RandomState(1).randn(E_MOE * T_MOE, D_MOE).astype(
        np.float32)
    y, aux = _jax_moe(x, E_MOE)
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["moe/y"],
                                   y[r * T_MOE:(r + 1) * T_MOE], **TOL)
        assert float(got["moe/dropped"]) == 0.0
        np.testing.assert_allclose(got["moe/lb"],
                                   aux.load_balance_loss[r], **TOL)


def test_moe_drops_overflow_tokens(ranks):
    y, aux = _jax_moe(np.ones((E_MOE * T_MOE, D_MOE), np.float32), 1.0)
    for r, got in enumerate(ranks):
        assert float(got["moe_drop/dropped"]) > 0.5
        np.testing.assert_allclose(got["moe_drop/dropped"],
                                   aux.dropped_fraction[r], rtol=0)
        np.testing.assert_allclose(got["moe_drop/y"],
                                   y[r * T_MOE:(r + 1) * T_MOE], **TOL)
        kept = np.abs(got["moe_drop/y"]).sum(axis=1) > 0
        assert kept.sum() == round((1 - float(got["moe_drop/dropped"]))
                                   * T_MOE)


def test_moe_gradients_flow_to_experts_and_router(ranks):
    router, experts = moe_params()
    stacked = jpp.stack_stage_params([jax.tree_util.tree_map(
        jnp.asarray, e) for e in experts])
    x = np.random.RandomState(2).randn(E_MOE * T_MOE, D_MOE).astype(
        np.float32)

    def loss(router, ep, x):
        ep = jax.tree_util.tree_map(lambda p: jnp.squeeze(p, 0), ep)
        y, _ = jep.moe_layer(x, router, _jax_expert_fn, ep, axis_name="ep",
                             capacity_factor=float(E_MOE))
        return jnp.mean(y ** 2) / E_MOE

    g_router, g_experts = jax.jit(shard_map(
        lambda r, ep, x: jax.grad(loss, argnums=(0, 1))(r, ep, x),
        mesh=_mesh("ep"), in_specs=(P(), P("ep"), P("ep")),
        out_specs=(P(), P("ep"))))(jnp.asarray(router), stacked,
                                   jnp.asarray(x))
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["moe_grad/router"],
                                   np.asarray(g_router), **TOL)
        for k in ("w", "v"):
            np.testing.assert_allclose(got[f"moe_grad/{k}"],
                                       np.asarray(g_experts[k][r]), **TOL)
    assert np.linalg.norm(ranks[0]["moe_grad/router"]) > 0


def test_moe_load_balance_loss_uses_global_means(ranks):
    router, _ = moe_params()
    x = (np.random.RandomState(7).randn(E_MOE * T_MOE, D_MOE) * 3).astype(
        np.float32)
    probs = jax.nn.softmax(jnp.asarray(x) @ router, axis=-1)
    f_g = jnp.mean(jax.nn.one_hot(jnp.argmax(probs, -1), E_MOE), axis=0)
    want = float(E_MOE * jnp.sum(f_g * jnp.mean(probs, axis=0)))
    for got in ranks:
        assert abs(float(got["moe_lb/lb"]) - want) < 1e-5
    _, aux = _jax_moe(x, E_MOE)
    np.testing.assert_allclose(ranks[0]["moe_lb/lb"],
                               aux.load_balance_loss[0], **TOL)


# -- pipeline ------------------------------------------------------------------------

def _jax_stage_fn(p, h):
    return jnp.tanh(h @ p["w"] + p["b"])


def _jax_stacked(n, seed=0):
    return jpp.stack_stage_params([jax.tree_util.tree_map(
        jnp.asarray, p) for p in pp_params(n, seed)])


def _jax_pipe(x, m, stacked=None):
    stacked = _jax_stacked(S_PP) if stacked is None else stacked
    return np.asarray(jax.jit(shard_map(
        lambda sp, x: jpp.spmd_pipeline(_jax_stage_fn, sp, x,
                                        axis_name="pp", num_microbatches=m),
        mesh=_mesh("pp"), in_specs=(P("pp"), P()), out_specs=P()))(
        stacked, jnp.asarray(x)))


def test_pipeline_forward_matches_sequential(ranks):
    x = np.random.RandomState(1).randn(8, D_PP).astype(np.float32)
    want = _jax_pipe(x, M_PP)
    for got in ranks:
        np.testing.assert_allclose(got["pp/fwd"], want, **PP_TOL)


def test_pipeline_grads_match_sequential(ranks):
    stacked = _jax_stacked(S_PP)
    x = jnp.asarray(np.random.RandomState(2).randn(8, D_PP).astype(
        np.float32))

    def loss(sp, x):
        return jnp.mean(jpp.spmd_pipeline(_jax_stage_fn, sp, x,
                                          axis_name="pp",
                                          num_microbatches=M_PP) ** 2)

    gs, gx = jax.jit(shard_map(
        lambda sp, x: jax.grad(loss, argnums=(0, 1))(sp, x),
        mesh=_mesh("pp"), in_specs=(P("pp"), P()),
        out_specs=(P("pp"), P())))(stacked, x)
    for r, got in enumerate(ranks):
        for k in ("w", "b"):
            np.testing.assert_allclose(got[f"pp_grad/{k}"],
                                       np.asarray(gs[k][r:r + 1]),
                                       **PP_GRAD_TOL)
        np.testing.assert_allclose(got["pp_grad/x"], np.asarray(gx),
                                   **PP_GRAD_TOL)


def test_pipeline_rejects_indivisible_microbatches(ranks):
    assert "not divisible" in str(ranks[0]["pp/indivisible"])


def test_pipeline_microbatch_count_invariance(ranks):
    x = np.random.RandomState(3).randn(8, D_PP).astype(np.float32)
    for got in ranks:
        np.testing.assert_allclose(got["pp_m2"], got["pp_m8"], **PP_TOL)
        np.testing.assert_allclose(got["pp_m8"], _jax_pipe(x, 8), **PP_TOL)


@pytest.mark.parametrize("m", [S_PP, 2 * S_PP])
def test_interleaved_forward_matches_sequential(ranks, m):
    stacked = jpp.stack_interleaved_stage_params(
        [jax.tree_util.tree_map(jnp.asarray, p)
         for p in pp_params(S_PP * V_PP)], S_PP)
    x = np.random.RandomState(1).randn(2 * m, D_PP).astype(np.float32)
    want = np.asarray(jax.jit(shard_map(
        lambda sp, x: jpp.spmd_pipeline_interleaved(
            _jax_stage_fn, sp, x, axis_name="pp", num_microbatches=m),
        mesh=_mesh("pp"), in_specs=(P(None, "pp"), P()), out_specs=P()))(
        stacked, jnp.asarray(x)))
    for got in ranks:
        np.testing.assert_allclose(got[f"ppi_fwd/{m}"], want, **PP_TOL)


def test_interleaved_grads_match_sequential(ranks):
    stacked = jpp.stack_interleaved_stage_params(
        [jax.tree_util.tree_map(jnp.asarray, p)
         for p in pp_params(S_PP * V_PP, seed=3)], S_PP)
    x = jnp.asarray(np.random.RandomState(2).randn(8, D_PP).astype(
        np.float32))
    tgt = jnp.asarray(np.random.RandomState(4).randn(8, D_PP).astype(
        np.float32))

    def loss(sp, x):
        f = shard_map(lambda sp, x: jpp.spmd_pipeline_interleaved(
            _jax_stage_fn, sp, x, axis_name="pp", num_microbatches=M_PP),
            mesh=_mesh("pp"), in_specs=(P(None, "pp"), P()), out_specs=P())
        return jnp.mean((f(sp, x) - tgt) ** 2)

    g = jax.jit(jax.grad(loss))(stacked, x)
    for r, got in enumerate(ranks):
        for k in ("w", "b"):
            np.testing.assert_allclose(got[f"ppi_grad/{k}"],
                                       np.asarray(g[k][:, r:r + 1]),
                                       **PP_GRAD_TOL)


def test_interleaved_tick_economics(ranks):
    """``m*v + p - 1`` rotations of the interleaved schedule against
    GPipe's ``m + p - 1`` (JAX's scan lengths), counted here by the
    port's ``permute`` collective counter."""
    p, v, m = S_PP, V_PP, 2 * S_PP
    for got in ranks:
        assert int(got[f"ppi_ticks/{m}"]) == m * v + p - 1
        assert int(got["pp_ticks"]) == m + p - 1


def test_interleaved_rejects_partial_groups(ranks):
    assert "multiple of the" in str(ranks[0]["ppi/partial"])


def test_stack_interleaved_layout():
    from apex_tpu_torch.parallel import stack_interleaved_stage_params
    per = [{k: torch.from_numpy(v) for k, v in p.items()}
           for p in pp_params(S_PP * V_PP)]
    stacked = stack_interleaved_stage_params(per, S_PP)
    assert tuple(stacked["w"].shape[:2]) == (V_PP, S_PP)
    assert torch.equal(stacked["b"][1, 2], per[1 * S_PP + 2]["b"])
    jst = jpp.stack_interleaved_stage_params(
        [jax.tree_util.tree_map(jnp.asarray, p)
         for p in pp_params(S_PP * V_PP)], S_PP)
    np.testing.assert_array_equal(stacked["w"].numpy(), np.asarray(jst["w"]))


def test_zero1_group_of_one_equals_replicated(tmp_path):
    """zero1 Adam over a gloo group of one through
    ``make_train_step(reduce_grads=False)`` at O2 on gpt_tiny equals the
    replicated step bit for bit (parameters and both moments, three
    steps): the counterpart on the CPU of the card's NCCL check."""
    import torch.distributed as dist

    from apex_tpu_torch.examples.lm import main_amp
    from apex_tpu_torch.models import gpt_tiny
    from apex_tpu_torch.parallel import zero
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/s",
                            world_size=1, rank=0)
    try:
        model = gpt_tiny(dtype=torch.bfloat16, device="cpu", seed=0)
        params = {k: v.detach() for k, v in model.state_dict().items()}
        ids = torch.from_numpy(np.random.RandomState(6).randint(
            1, 1024, (2, 33)))
        batch = (ids[:, :-1], ids[:, 1:])

        def loss_fn(p, b):
            return main_amp.lm_loss(torch.func.functional_call(
                model, p, (b[0],)), b[1], fused=True)

        states = {}
        for name in ("replicated", "zero1"):
            adam = training.adam(3e-4, weight_decay=0.1)
            group = dist.group.WORLD
            tx = zero.zero1(adam, group, num_shards=1) if name == "zero1" \
                else adam
            init_fn, step_fn = training.make_train_step(
                loss_fn, tx, opt_level="O2",
                axis_name=group if name == "zero1" else None,
                reduce_grads=name != "zero1")
            st = init_fn({k: v.clone() for k, v in params.items()})
            for _ in range(3):
                st, _ = step_fn(st, batch)
            states[name] = st
        rs, zs = states["replicated"], states["zero1"]
        for k in params:
            assert torch.equal(rs.params[k], zs.params[k]), k
        n = sum(v.numel() for v in params.values())
        assert torch.equal(zero._flatten(rs.opt_state.exp_avg),
                           zs.opt_state.inner.exp_avg[:n])
        assert torch.equal(zero._flatten(rs.opt_state.exp_avg_sq),
                           zs.opt_state.inner.exp_avg_sq[:n])
    finally:
        dist.destroy_process_group()
