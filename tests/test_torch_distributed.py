"""The port's data parallelism over four gloo processes against JAX's
``shard_map`` over four CPU devices.

Four ranks are spawned once for the module (this file run as a script,
``multiproc.spawn`` with a file store under ``tmp_path``, a 120 s
timeout and one thread a rank); each runs every scenario below on its
rows of the same numpy inputs and saves what it got.  The tests hold
that against the JAX functions on the same rows:

* ``reduce_gradients``: mean, sum, predivide (averaged and summed),
  bf16 leaves with and without ``allreduce_always_fp32``, sub-groups
  ``[[0, 1], [2, 3]]``, ``bucket_store=`` — rtol 1e-6 (fp32 sums of four
  in another order), bf16 to one rounding;
* ``broadcast_params`` (bit for bit), ``no_sync``, ``Reducer``, the
  ``DistributedDataParallel`` module (``sync_params`` and the ``.grad``
  reduction in place);
* ``make_train_step(axis_name="data")`` on a small ResNet with GroupBN
  ``bn_group=2`` (sub-group statistics, then the state ``pmean``) and
  with SyncBatchNorm over the world (``sync_bn=True``) for three O0 steps and a fourth with an inf on rank 1 alone, against JAX's
  four-way step from the same converted weights: losses rtol 1e-4,
  parameters, statistics and momentum atol 1e-4 (fp32 summation order),
  the skipped step bit-identical on every rank, the scale halved; the
  evaluation logits equal across ranks;
* the four-rank O0 trajectory of a SyncBatchNorm ResNet against JAX's
  whole-batch single-process one at JAX's own O0 tolerance (rtol 2e-4,
  atol 1e-6, ``tests/test_l1_cross_product.py:241-246``).
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch

WORLD = 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESNET = dict(stage_sizes=[1, 1], num_filters=4, num_classes=10)
GROUPS = [[0, 1], [2, 3]]


def _per_rank(seed, shape, dtype=np.float32):
    """``[WORLD, *shape]`` inputs, rank r's at ``[r]``."""
    return np.random.RandomState(seed).randn(WORLD, *shape).astype(dtype)


def _images(seed, n):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 16, 16, 3).astype(np.float32),
            rng.randint(0, 10, n).astype(np.int64))


# -- the ranks' side ---------------------------------------------------------------

def _np(t):
    return t.detach().float().numpy().copy()


def _rank_collectives(rank):
    from apex_tpu_torch.multi_tensor.buckets import BucketStore
    from apex_tpu_torch.parallel import (DistributedDataParallel, Reducer,
                                         broadcast_params, reduce_gradients)
    out = {}
    tree = {"w": torch.from_numpy(_per_rank(1, (3, 5))[rank]),
            "b": torch.from_numpy(_per_rank(2, (7,))[rank])}
    cases = {"mean": {}, "sum": dict(gradient_average=False),
             "predivide": dict(gradient_predivide_factor=2.0),
             "predivide_sum": dict(gradient_predivide_factor=2.0,
                                   gradient_average=False),
             "groups": dict(axis_index_groups=GROUPS)}
    for name, kw in cases.items():
        for k, v in reduce_gradients(tree, "data", **kw).items():
            out[f"{name}/{k}"] = _np(v)
    bf = {k: v.to(torch.bfloat16) for k, v in tree.items()}
    for name, kw in (("bf16", {}),
                     ("bf16_fp32", dict(allreduce_always_fp32=True))):
        got = reduce_gradients(bf, "data", **kw)
        assert all(v.dtype == torch.bfloat16 for v in got.values())
        for k, v in got.items():
            out[f"{name}/{k}"] = _np(v)
    mixed = {"w": tree["w"], "h": bf["b"], "step": torch.tensor(rank)}
    got = reduce_gradients(mixed, "data", bucket_store=BucketStore(mixed))
    assert got["h"].dtype == torch.bfloat16 and int(got["step"]) == rank
    out["bucket/w"], out["bucket/h"] = _np(got["w"]), _np(got["h"])
    params = {"w": torch.from_numpy(_per_rank(3, (4, 4))[rank]),
              "h": torch.from_numpy(_per_rank(4, (6,))[rank]).to(
                  torch.bfloat16)}
    got = broadcast_params(params, "data")
    assert got["h"].dtype == torch.bfloat16
    out["broadcast/w"], out["broadcast/h"] = _np(got["w"]), _np(got["h"])
    out["broadcast_root2/w"] = _np(broadcast_params(params, "data",
                                                    root=2)["w"])
    ddp = DistributedDataParallel(axis_name="data")
    with ddp.no_sync():
        out["no_sync/w"] = _np(ddp.reduce_gradients(tree)["w"])
    out["ddp_tree/w"] = _np(ddp.reduce_gradients(tree)["w"])
    out["reducer/w"] = _np(Reducer(axis_name="data").reduce(tree)["w"])
    # the module form: parameters synced in place, .grad reduced in place
    torch.manual_seed(10 + rank)
    net = torch.nn.Linear(5, 3)
    ddp = DistributedDataParallel(net)
    ddp.sync_params()
    out["module_sync/weight"] = _np(net.weight)
    x = torch.from_numpy(_per_rank(5, (8, 5))[rank])
    ddp(x).square().sum().backward()
    out["module_local/weight"] = _np(net.weight.grad)
    ddp.reduce_gradients()
    out["module_reduced/weight"] = _np(net.weight.grad)
    Reducer(net).reduce()
    out["module_reducer/weight"] = _np(net.weight.grad)
    return out


def _port_model(norm, axis):
    """The port's small ResNet: ``norm`` "groupbn" for GroupBN
    ``bn_group=2`` over the world, "sync" for ``ResNet(sync_bn=True)``,
    statistics over ``axis`` (None: this process's)."""
    from apex_tpu_torch.contrib.groupbn import BatchNorm2d_NHWC
    from apex_tpu_torch.models import BasicBlock, ResNet
    kw = dict(sync_bn=True, axis_name=axis) if norm == "sync" else dict(
        norm_cls=functools.partial(BatchNorm2d_NHWC, bn_group=2,
                                   axis_name=axis, world_size=WORLD))
    return ResNet(block_cls=BasicBlock, device="cpu", seed=4, **RESNET,
                  **kw)


def _port_step(norm, loss_scale):
    """``(model, state, step)``: SGD on the log-softmax loss (times the
    batch's third tensor's maximum, when there is one), data parallel
    over "data"."""
    from apex_tpu_torch import training
    model = _port_model(norm, "data")

    def loss_fn(p, ms, batch):
        logits, new_ms = model.apply(p, ms, batch[0])
        logp = torch.log_softmax(logits.float(), -1)
        loss = -logp.gather(1, batch[1][:, None]).mean()
        if len(batch) > 2:
            loss = loss * batch[2].max()
        return loss, new_ms

    init, step = training.make_train_step(
        loss_fn, training.sgd(0.05, momentum=0.9, weight_decay=1e-4),
        opt_level="O0", loss_scale=loss_scale, axis_name="data",
        has_model_state=True)
    params, stats = model.variables()
    state = init({k: v.detach().clone() for k, v in params.items()},
                 {k: v.clone() for k, v in stats.items()})
    return model, state, step


def _rank_four_way(rank, norm):
    """Three steps, an inf on rank 1's rows, evaluation: what
    ``test_train_step_matches_jax_four_way[norm]`` holds."""
    out = {}
    rows = slice(rank * 2, rank * 2 + 2)
    model, state, step = _port_step(norm, "dynamic")
    x, y = _images(7, 2 * WORLD)
    ones = torch.ones(2 * WORLD)
    batch = (torch.from_numpy(x[rows]), torch.from_numpy(y[rows]),
             ones[rows])
    for i in range(3):
        state, m = step(state, batch)
        out[f"train/loss{i}"] = _np(m["loss"])
    for prefix, tree in (("params", state.params),
                         ("stats", state.model_state),
                         ("momentum", state.opt_state.momentum_buf)):
        for k, v in tree.items():
            out[f"train3/{prefix}/{k}"] = _np(v)
    bad = ones.clone()
    bad[2:4] = float("inf")                     # rank 1's rows
    before = {k: v.clone() for k, v in state.params.items()}
    state, m = step(state, (batch[0], batch[1], bad[rows]))
    out["skip/overflow"] = _np(m["overflow"])
    out["skip/scale"] = _np(m["loss_scale"])
    out["skip/same"] = np.array(all(torch.equal(before[k], v)
                                    for k, v in state.params.items()))
    for k, v in state.model_state.items():
        out[f"skip/stats/{k}"] = _np(v)
    with torch.no_grad():
        logits, _ = model.apply(state.params, state.model_state,
                                torch.from_numpy(_images(8, 4)[0]),
                                train=False)
    out["eval/logits"] = _np(logits)
    return {f"{norm}/{k}": v for k, v in out.items()}


def _rank_train(rank):
    out = {}
    for norm in ("groupbn", "sync"):
        out.update(_rank_four_way(rank, norm))
    _, state, step = _port_step("sync", 1.0)
    x, y = _images(9, 16)
    rows = slice(rank * 4, rank * 4 + 4)
    batch = (torch.from_numpy(x[rows]), torch.from_numpy(y[rows]))
    losses = []
    for _ in range(6):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    out["trajectory/losses"] = np.array(losses)
    return out


def _worker(out_dir):
    from apex_tpu_torch.parallel import multiproc
    torch.set_num_threads(1)
    rank, world = multiproc.initialize(device="cpu")
    assert world == WORLD
    out = _rank_collectives(rank)
    out.update(_rank_train(rank))
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
from apex_tpu.contrib.groupbn import \
    BatchNorm2d_NHWC as JBatchNorm2d_NHWC  # noqa: E402
from apex_tpu.models import resnet as jresnet  # noqa: E402
from apex_tpu.multi_tensor import BucketStore as JBucketStore  # noqa: E402
from apex_tpu.parallel import (DistributedDataParallel as JDDP,  # noqa: E402
                               Reducer as JReducer,
                               broadcast_params as jbroadcast,
                               reduce_gradients as jreduce)
from apex_tpu_torch.convert import resnet_variables_to_jax  # noqa: E402
from apex_tpu_torch.parallel import multiproc  # noqa: E402


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's saved results (one spawn for the module)."""
    out = tmp_path_factory.mktemp("ddp")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    results = multiproc.spawn([os.path.abspath(__file__), "--out",
                               str(out)], WORLD, f"file://{out}/store",
                              timeout=120, capture=True, env=env)
    if any(r["returncode"] != 0 for r in results):
        pytest.fail("\n".join(
            f"rank {r['rank']} exited {r['returncode']}:\n{r['output']}"
            for r in results))
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]


def _mesh():
    return Mesh(np.array(jax.devices("cpu")[:WORLD]), ("data",))


def _jax_per_rank(fn, tree):
    """``fn`` on each rank's slice of ``tree`` (leaves ``[WORLD, ...]``)
    inside ``shard_map`` over four devices; the per-rank outputs stacked
    on a leading axis."""
    def body(t):
        got = fn(jax.tree_util.tree_map(lambda x: x[0], t))
        return jax.tree_util.tree_map(lambda x: x[None], got)
    return jax.jit(shard_map(body, mesh=_mesh(), in_specs=(P("data"),),
                             out_specs=P("data")))(tree)


def _grad_tree():
    return {"w": _per_rank(1, (3, 5)), "b": _per_rank(2, (7,))}


@pytest.mark.parametrize("case,kw", [
    ("mean", {}), ("sum", dict(gradient_average=False)),
    ("predivide", dict(gradient_predivide_factor=2.0)),
    ("predivide_sum", dict(gradient_predivide_factor=2.0,
                           gradient_average=False)),
    ("groups", dict(axis_index_groups=GROUPS))])
def test_reduce_gradients_matches_jax(ranks, case, kw):
    want = _jax_per_rank(lambda t: jreduce(t, "data", **kw), _grad_tree())
    for r in range(WORLD):
        for k in ("w", "b"):
            np.testing.assert_allclose(ranks[r][f"{case}/{k}"],
                                       np.asarray(want[k][r]), rtol=1e-6,
                                       atol=1e-6, err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("case,fp32", [("bf16", False), ("bf16_fp32", True)])
def test_reduce_gradients_bf16_leaves_match_jax(ranks, case, fp32):
    """bf16 leaves stay bf16.  With ``allreduce_always_fp32`` the sum is
    taken in fp32 and rounded once: bit for bit JAX's.  Without it gloo
    adds in bf16, rounding each of three partial sums, where XLA rounds
    once: within three half-ulps of the partial sums' magnitude (at most
    the sum of the four magnitudes), over the world, plus the final
    rounding."""
    tree = {k: jnp.asarray(v, jnp.bfloat16) for k, v in _grad_tree().items()}
    want = _jax_per_rank(
        lambda t: jreduce(t, "data", allreduce_always_fp32=fp32), tree)
    for r in range(WORLD):
        for k in ("w", "b"):
            w = np.asarray(want[k][r].astype(jnp.float32))
            got = ranks[r][f"{case}/{k}"]
            if fp32:
                np.testing.assert_array_equal(got, w)
                continue
            mags = np.abs(np.asarray(tree[k].astype(jnp.float32))).sum(0)
            bound = 3 * 2.0 ** -9 * mags / WORLD + 2.0 ** -9 * np.abs(w)
            assert np.all(np.abs(got - w) <= bound), (k, r)


def test_reduce_gradients_bucket_store_matches_jax(ranks):
    tree = {"w": _grad_tree()["w"],
            "h": jnp.asarray(_grad_tree()["b"], jnp.bfloat16)}

    def fn(t):
        return jreduce(t, "data", bucket_store=JBucketStore(t))
    want = _jax_per_rank(fn, tree)
    for r in range(WORLD):
        np.testing.assert_allclose(ranks[r]["bucket/w"],
                                   np.asarray(want["w"][r]), rtol=1e-6,
                                   atol=1e-6)
        w = np.asarray(want["h"][r].astype(jnp.float32))
        mags = np.abs(np.asarray(tree["h"].astype(jnp.float32))).sum(0)
        assert np.all(np.abs(ranks[r]["bucket/h"] - w)
                      <= 3 * 2.0 ** -9 * mags / WORLD + 2.0 ** -9 * np.abs(w))


def test_broadcast_params_is_rank0_bit_for_bit(ranks):
    tree = {"w": _per_rank(3, (4, 4)),
            "h": jnp.asarray(_per_rank(4, (6,)), jnp.bfloat16)}
    want = _jax_per_rank(lambda t: jbroadcast(t, "data"), tree)
    root2 = _jax_per_rank(lambda t: jbroadcast(t, "data", root=2), tree)
    for r in range(WORLD):
        np.testing.assert_array_equal(ranks[r]["broadcast/w"],
                                      np.asarray(want["w"][r]))
        np.testing.assert_array_equal(
            ranks[r]["broadcast/h"],
            np.asarray(want["h"][r].astype(jnp.float32)))
        np.testing.assert_array_equal(ranks[r]["broadcast_root2/w"],
                                      np.asarray(root2["w"][r]))


def test_no_sync_ddp_and_reducer_match_jax(ranks):
    ddp = JDDP(axis_name="data")

    def fn(t):
        with ddp.no_sync():
            kept = ddp.reduce_gradients(t)
        return {"no_sync": kept["w"], "ddp": ddp.reduce_gradients(t)["w"],
                "reducer": JReducer(axis_name="data").reduce(t)["w"]}
    want = _jax_per_rank(fn, _grad_tree())
    for r in range(WORLD):
        np.testing.assert_array_equal(ranks[r]["no_sync/w"],
                                      _grad_tree()["w"][r])
        for name, key in (("ddp_tree/w", "ddp"), ("reducer/w", "reducer")):
            np.testing.assert_allclose(ranks[r][name],
                                       np.asarray(want[key][r]), rtol=1e-6,
                                       atol=1e-6)


def test_ddp_module_syncs_and_reduces_in_place(ranks):
    """``sync_params()`` makes every rank's weights rank 0's bit for bit;
    ``reduce_gradients()`` and ``Reducer(module).reduce()`` replace each
    ``.grad`` by the mean over the ranks (held against JAX's reduction
    of the ranks' local gradients)."""
    local = np.stack([ranks[r]["module_local/weight"] for r in range(WORLD)])
    want = _jax_per_rank(lambda t: jreduce(t, "data"), {"w": local})["w"]
    for r in range(WORLD):
        np.testing.assert_array_equal(ranks[r]["module_sync/weight"],
                                      ranks[0]["module_sync/weight"])
        np.testing.assert_allclose(ranks[r]["module_reduced/weight"],
                                   np.asarray(want[r]), rtol=1e-6, atol=1e-6)
        # reducing what is already the mean keeps it, to rounding
        np.testing.assert_allclose(ranks[r]["module_reducer/weight"],
                                   np.asarray(want[r]), rtol=1e-6, atol=1e-6)
    assert not np.allclose(local[0], local[1])


def _jax_resnet(norm, axis):
    if norm == "sync":
        jm = jresnet.ResNet(block_cls=jresnet.BasicBlock, sync_bn=True,
                            axis_name=axis, **RESNET)
    else:
        jm = jresnet.ResNet(block_cls=jresnet.BasicBlock,
                            norm_cls=functools.partial(
                                JBatchNorm2d_NHWC, bn_group=2,
                                axis_name=axis, world_size=WORLD),
                            **RESNET)

    def loss_fn(p, ms, batch):
        logits, upd = jm.apply({"params": p, "batch_stats": ms}, batch[0],
                               train=True, mutable=["batch_stats"])
        logp = jax.nn.log_softmax(logits.astype(jnp.float32))
        loss = -jnp.mean(jnp.take_along_axis(logp, batch[1][:, None],
                                             axis=1))
        if len(batch) > 2:
            loss = loss * jnp.max(batch[2])
        return loss, upd["batch_stats"]
    return jm, loss_fn


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _port_variables(norm):
    return resnet_variables_to_jax(*_port_model(norm, "data").variables())


def _jax_four_way(step):
    """JAX's step under ``shard_map`` over four devices.  The JAX
    BN-epilogue's custom VJP does not type-check under varying-axes
    tracking (its bias cotangent stays varying), so the map runs with
    ``check_vma=False``: the gradients and the overflow flag are then
    summed explicitly, as in the port, but nothing marks the loss and
    the statistics as varying, so JAX leaves them per device.  They come
    out per device here (``P("data")``), and the test takes their mean,
    which is what the ``pmean`` of a tracked run gives."""
    from apex_tpu.training import TrainState

    def body(state, batch):
        state = state._replace(model_state=jax.tree_util.tree_map(
            lambda x: x[0], state.model_state))
        new, m = step(state, batch)
        lead = functools.partial(jax.tree_util.tree_map, lambda x: x[None])
        return new._replace(model_state=lead(new.model_state)), lead(m)

    specs = TrainState(params=P(), opt_state=P(), scaler=P(),
                       model_state=P("data"))
    return jax.jit(shard_map(body, mesh=_mesh(),
                             in_specs=(specs, (P("data"),) * 3),
                             out_specs=(specs, P("data")), check_vma=False))


@pytest.mark.parametrize("norm", ["groupbn", "sync"])
def test_train_step_matches_jax_four_way(ranks, norm):
    """Three O0 steps of the small ResNet with GroupBN ``bn_group=2``
    (statistics over two ranks, then the state's pmean) or with
    ``sync_bn`` (SyncBatchNorm over all four), four ranks against JAX's
    four-way step: the loss and the statistics are the mean over the
    devices, the parameters and momentum JAX's; then an inf on rank 1's
    rows only: every rank skips (parameters bit-identical), the scale
    halves, the statistics still advance and stay replicated; evaluation
    logits equal across ranks and JAX's on the mean statistics."""
    ranks = [{k[len(norm) + 1:]: v for k, v in r.items()
              if k.startswith(norm + "/")} for r in ranks]
    jm, loss_fn = _jax_resnet(norm, "data")
    variables = _port_variables(norm)
    init, step = jtraining.make_train_step(
        loss_fn, jtraining.sgd(0.05, momentum=0.9, weight_decay=1e-4),
        opt_level="O0", loss_scale="dynamic", axis_name="data",
        has_model_state=True)
    step = _jax_four_way(step)
    state = init(variables["params"], jax.tree_util.tree_map(
        lambda x: np.stack([x] * WORLD), variables["batch_stats"]))
    x, y = _images(7, 2 * WORLD)
    ones = np.ones(2 * WORLD, np.float32)

    def mean_stats(st):
        return {k: v.mean(0) for k, v in _flat(st.model_state).items()}

    for i in range(3):
        state, m = step(state, (x, y.astype(np.int32), ones))
        for r in range(WORLD):
            np.testing.assert_allclose(ranks[r][f"train/loss{i}"],
                                       np.asarray(m["loss"]).mean(),
                                       rtol=1e-4, err_msg=f"step {i} {r}")
    for prefix, flat in (("params", _flat(state.params)),
                         ("stats", mean_stats(state)),
                         ("momentum", _flat(state.opt_state.momentum_buf))):
        for k, v in flat.items():
            for r in range(WORLD):
                np.testing.assert_allclose(
                    ranks[r][f"train3/{prefix}/{k}"], v, atol=1e-4,
                    rtol=1e-4, err_msg=f"{prefix}/{k} rank {r}")
    bad = ones.copy()
    bad[2:4] = np.inf
    state, m = step(state, (x, y.astype(np.int32), bad))
    assert np.asarray(m["overflow"]).all()
    assert float(state.scaler.loss_scale) == 2.0 ** 15
    stats = mean_stats(state)
    for r in range(WORLD):
        assert bool(ranks[r]["skip/overflow"])
        assert bool(ranks[r]["skip/same"])
        assert float(ranks[r]["skip/scale"]) == 2.0 ** 15
        for k, v in stats.items():
            np.testing.assert_array_equal(ranks[r][f"skip/stats/{k}"],
                                          ranks[0][f"skip/stats/{k}"])
            np.testing.assert_allclose(ranks[r][f"skip/stats/{k}"], v,
                                       atol=1e-4, rtol=1e-4)
        np.testing.assert_array_equal(ranks[r]["eval/logits"],
                                      ranks[0]["eval/logits"])
    if norm == "groupbn":
        # the two groups' statistics differ: the mean is not a no-op
        per_device = _flat(state.model_state)
        assert any(not np.allclose(v[0], v[2])
                   for v in per_device.values())
    nest = jax.tree_util.tree_map(lambda v: v.mean(0), state.model_state)
    want_logits = jm.apply({"params": state.params, "batch_stats": nest},
                           _images(8, 4)[0], train=False)
    np.testing.assert_allclose(ranks[0]["eval/logits"],
                               np.asarray(want_logits), atol=1e-4,
                               rtol=1e-4)


def test_four_rank_trajectory_matches_jax_whole_batch(ranks):
    """Six O0 steps of a SyncBatchNorm ResNet on four ranks of 4 images
    track JAX's one process on all 16 (``test_l1_cross_product``'s O0
    gate: rtol 2e-4, atol 1e-6)."""
    _, loss_fn = _jax_resnet("sync", None)
    variables = _port_variables("sync")
    init, step = jtraining.make_train_step(
        loss_fn, jtraining.sgd(0.05, momentum=0.9, weight_decay=1e-4),
        opt_level="O0", loss_scale=1.0, has_model_state=True)
    step = jax.jit(step)
    state = init(variables["params"], variables["batch_stats"])
    x, y = _images(9, 16)
    losses = []
    for _ in range(6):
        state, m = step(state, (x, y.astype(np.int32)))
        losses.append(float(m["loss"]))
    for r in range(WORLD):
        np.testing.assert_allclose(ranks[r]["trajectory/losses"], losses,
                                   rtol=2e-4, atol=1e-6)
    assert losses[-1] < losses[0]
