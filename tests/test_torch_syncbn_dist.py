"""SyncBatchNorm and GroupBN across four gloo processes against JAX.

Four ranks are spawned once for the module (this file run as a script,
a file store under ``tmp_path``, a 120 s timeout, one thread a rank);
each normalizes its rows of the same numpy inputs and saves the outputs
and gradients.  The forward, the running statistics and evaluation are
held against JAX's ``SyncBatchNorm`` / ``BatchNorm2d_NHWC`` under
``shard_map`` over four CPU devices; the backward against ``jax.grad``
of the whole batch (of each group, for sub-groups) in one JAX process,
which is what the synced statistics compute (JAX's own oracle,
``tests/test_parallel.py:284``).  Tolerance 1e-4 (fp32 sums over the
ranks in another order), as JAX's tests.  ``convert_syncbn_model`` of a
torch ``BatchNorm2d`` (NCHW) against JAX's ``channel_last=False``
module; ``create_syncbn_process_group`` against JAX's.
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch

WORLD = 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUPS = [[0, 1], [2, 3]]
C = 5


def _global(seed, shape, scale=3.0, shift=1.0):
    """A global batch ``[WORLD * n, ...]``; rank r takes rows ``[r n,
    (r + 1) n)``."""
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape) * scale + shift).astype(np.float32)


def _halves(seed, shape):
    """Two halves with different statistics (one a sub-group each)."""
    a = _global(seed, shape)
    half = shape[0] // 2
    a[half:] = a[half:] * 4 + 7
    return a


def _affine():
    rng = np.random.RandomState(11)
    return ((1 + 0.3 * rng.randn(C)).astype(np.float32),
            (0.2 * rng.randn(C)).astype(np.float32))


def _rows(a, rank):
    n = a.shape[0] // WORLD
    return torch.from_numpy(a[rank * n:(rank + 1) * n].copy())


# -- the ranks' side ---------------------------------------------------------------

def _np(t):
    return t.detach().float().numpy().copy()


def _worker_results(rank):
    from apex_tpu_torch.contrib.groupbn import BatchNorm2d_NHWC
    from apex_tpu_torch.parallel import SyncBatchNorm, convert_syncbn_model
    out = {}
    w, b = _affine()
    x = _rows(_global(1, (WORLD * 2, 6, 6, C)), rank)
    bn = SyncBatchNorm(C, axis_name="data", affine=False,
                       track_running_stats=False, device="cpu")
    out["fwd"] = _np(bn(x))
    # backward: rank r's loss is its rows' sum(sin(y) * g)
    x = _rows(_global(2, (WORLD * 3, 4, 4, C)), rank).requires_grad_(True)
    g = _rows(_global(3, (WORLD * 3, 4, 4, C), 1.0, 0.0), rank)
    bn = SyncBatchNorm(C, axis_name="data", device="cpu")
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(w))
        bn.bias.copy_(torch.from_numpy(b))
    (torch.sin(bn(x)) * g).sum().backward()
    out["bwd/x"] = _np(x.grad)
    out["bwd/scale"], out["bwd/bias"] = _np(bn.scale.grad), _np(bn.bias.grad)
    # running statistics (momentum 1: the batch's), then evaluation
    x = _rows(_global(4, (WORLD * 2, 4, 4, C), 2.0, 5.0), rank)
    bn = SyncBatchNorm(C, axis_name="data", momentum=1.0, device="cpu")
    bn(x)
    out["running/mean"], out["running/var"] = (_np(bn.running_mean),
                                               _np(bn.running_var))
    out["eval"] = _np(bn(x, use_running_average=True))
    # sub-groups
    x = _rows(_halves(5, (WORLD * 2, 3, 3, C)), rank)
    bn = SyncBatchNorm(C, axis_name="data", affine=False,
                       track_running_stats=False, process_group=GROUPS,
                       device="cpu")
    out["groups"] = _np(bn(x))
    # GroupBN bn_group=2 of 4, the fused relu and residual
    x = _rows(_halves(6, (WORLD * 2, 4, 4, C)), rank).requires_grad_(True)
    z = _rows(_global(7, (WORLD * 2, 4, 4, C)), rank).requires_grad_(True)
    g = _rows(_global(8, (WORLD * 2, 4, 4, C), 1.0, 0.0), rank)
    gbn = BatchNorm2d_NHWC(C, fuse_relu=True, bn_group=2, axis_name="data",
                           world_size=WORLD, device="cpu")
    y = gbn(x, z=z)
    out["groupbn/y"] = _np(y)
    (y * g).sum().backward()
    out["groupbn/dx"], out["groupbn/dz"] = _np(x.grad), _np(z.grad)
    out["groupbn/running_mean"] = _np(gbn.bn.running_mean)
    # convert_syncbn_model of torch's NCHW BatchNorm2d
    net = torch.nn.Sequential(torch.nn.BatchNorm2d(C))
    with torch.no_grad():
        net[0].weight.copy_(torch.from_numpy(w))
        net[0].bias.copy_(torch.from_numpy(b))
        net[0].running_mean.fill_(0.5)
        net[0].running_var.fill_(2.0)
    net = convert_syncbn_model(net, axis_name="data")
    assert isinstance(net[0], SyncBatchNorm) and not net[0].channel_last
    x = _rows(_global(9, (WORLD * 2, C, 3, 3)), rank)
    out["convert/y"] = _np(net(x))
    out["convert/running_var"] = _np(net[0].running_var)
    return out


def _worker(out_dir):
    from apex_tpu_torch.parallel import multiproc
    torch.set_num_threads(1)
    rank, world = multiproc.initialize(device="cpu")
    assert world == WORLD
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             **_worker_results(rank))
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

from apex_tpu.contrib.groupbn import \
    BatchNorm2d_NHWC as JBatchNorm2d_NHWC  # noqa: E402
from apex_tpu.parallel import (SyncBatchNorm as JSyncBatchNorm,  # noqa: E402
                               create_syncbn_process_group as jcreate)
from apex_tpu_torch.models import BasicBlock, ResNet  # noqa: E402
from apex_tpu_torch.parallel import (SyncBatchNorm,  # noqa: E402
                                     convert_syncbn_model,
                                     create_syncbn_process_group, multiproc)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("syncbn")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    results = multiproc.spawn([os.path.abspath(__file__), "--out",
                               str(out)], WORLD, f"file://{out}/store",
                              timeout=120, capture=True, env=env)
    if any(r["returncode"] != 0 for r in results):
        pytest.fail("\n".join(
            f"rank {r['rank']} exited {r['returncode']}:\n{r['output']}"
            for r in results))
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]


def _gathered(ranks, key):
    return np.concatenate([ranks[r][key] for r in range(WORLD)])


def _four_way(fn, *arrays):
    """``fn`` on each device's rows under ``shard_map`` (forward only);
    outputs concatenated back in rank order."""
    mesh = Mesh(np.array(jax.devices("cpu")[:WORLD]), ("data",))
    return jax.jit(shard_map(fn, mesh=mesh,
                             in_specs=(P("data"),) * len(arrays),
                             out_specs=P("data")))(*arrays)


def _params(bn, x, **extra):
    return bn.init(jax.random.PRNGKey(0), jnp.asarray(x[:2]), **extra)


def test_syncbn_forward_matches_jax(ranks):
    x = _global(1, (WORLD * 2, 6, 6, C))
    bn = JSyncBatchNorm(axis_name="data", affine=False,
                        track_running_stats=False)
    params = _params(bn, x)
    want = _four_way(lambda xs: bn.apply(params, xs), x)
    np.testing.assert_allclose(_gathered(ranks, "fwd"), np.asarray(want),
                               atol=1e-4, rtol=1e-4)


def test_syncbn_backward_matches_whole_batch(ranks):
    """Each rank's ``x.grad`` is its rows of the whole batch's gradient
    (the statistics' cotangent summed over the ranks); the affine
    parameters' gradients summed over the ranks are the whole batch's."""
    x = _global(2, (WORLD * 3, 4, 4, C))
    g = _global(3, (WORLD * 3, 4, 4, C), 1.0, 0.0)
    w, b = _affine()
    bn = JSyncBatchNorm(axis_name=None, track_running_stats=False)
    variables = _params(bn, x)
    params = dict(variables["params"], scale=jnp.asarray(w),
                  bias=jnp.asarray(b))

    def loss(p, xs):
        y = bn.apply({"params": p, "batch_stats": variables["batch_stats"]},
                     xs)
        return jnp.sum(jnp.sin(y) * g)
    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    np.testing.assert_allclose(_gathered(ranks, "bwd/x"), np.asarray(gx),
                               atol=1e-4, rtol=1e-4)
    for k in ("scale", "bias"):
        np.testing.assert_allclose(
            sum(ranks[r][f"bwd/{k}"] for r in range(WORLD)),
            np.asarray(gp[k]), atol=1e-4, rtol=1e-4)


def test_syncbn_running_stats_and_eval_match_jax(ranks):
    x = _global(4, (WORLD * 2, 4, 4, C), 2.0, 5.0)
    bn = JSyncBatchNorm(axis_name="data", momentum=1.0)
    params = _params(bn, x)
    mesh = Mesh(np.array(jax.devices("cpu")[:WORLD]), ("data",))
    _, upd = jax.jit(shard_map(
        lambda xs: bn.apply(params, xs, mutable=["batch_stats"]),
        mesh=mesh, in_specs=(P("data"),),
        out_specs=(P("data"), P())))(x)
    stats = upd["batch_stats"]
    for r in range(WORLD):
        np.testing.assert_allclose(ranks[r]["running/mean"],
                                   np.asarray(stats["running_mean"]),
                                   atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(ranks[r]["running/var"],
                                   np.asarray(stats["running_var"]),
                                   atol=1e-4, rtol=1e-4)
    want = bn.apply({"params": params["params"], "batch_stats": stats},
                    jnp.asarray(x), use_running_average=True)
    np.testing.assert_allclose(_gathered(ranks, "eval"), np.asarray(want),
                               atol=1e-4, rtol=1e-4)


def test_syncbn_groups_match_jax(ranks):
    x = _halves(5, (WORLD * 2, 3, 3, C))
    bn = JSyncBatchNorm(axis_name="data", affine=False,
                        track_running_stats=False, process_group=GROUPS)
    params = _params(bn, x)
    want = _four_way(lambda xs: bn.apply(params, xs), x)
    got = _gathered(ranks, "groups")
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=1e-4)
    # the halves normalize on their own statistics
    half = x.shape[0] // 2
    assert abs(got[:half].mean()) < 1e-5 and abs(got[half:].mean()) < 1e-5


def test_groupbn_two_of_four_matches_jax(ranks):
    """``BatchNorm2d_NHWC(bn_group=2)`` in a world of four: the forward
    (fused relu, residual ``z``) against JAX's under ``shard_map``; dx
    and dz against ``jax.grad`` of a one-group GroupBN on each group's
    rows; the running mean each group's."""
    x = _halves(6, (WORLD * 2, 4, 4, C))
    z = _global(7, (WORLD * 2, 4, 4, C))
    g = _global(8, (WORLD * 2, 4, 4, C), 1.0, 0.0)
    gbn = JBatchNorm2d_NHWC(fuse_relu=True, bn_group=2, axis_name="data",
                            world_size=WORLD)
    params = _params(gbn, x)
    want = _four_way(lambda xs, zs: gbn.apply(
        params, xs, z=zs, mutable=["batch_stats"])[0], x, z)
    np.testing.assert_allclose(_gathered(ranks, "groupbn/y"),
                               np.asarray(want), atol=1e-4, rtol=1e-4)
    one = JBatchNorm2d_NHWC(fuse_relu=True)
    half = x.shape[0] // 2
    for lo in (0, half):
        rows = slice(lo, lo + half)

        def loss(xs, zs):
            y, _ = one.apply(params, xs, z=zs, mutable=["batch_stats"])
            return jnp.sum(y * g[rows])
        dx, dz = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x[rows]),
                                                jnp.asarray(z[rows]))
        np.testing.assert_allclose(_gathered(ranks, "groupbn/dx")[rows],
                                   np.asarray(dx), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(_gathered(ranks, "groupbn/dz")[rows],
                                   np.asarray(dz), atol=1e-4, rtol=1e-4)
        for r in range(lo // 2, lo // 2 + 2):
            np.testing.assert_allclose(
                ranks[r]["groupbn/running_mean"],
                0.1 * x[rows].reshape(-1, C).mean(0), atol=1e-4, rtol=1e-4)


def test_convert_syncbn_model_nchw_matches_jax(ranks):
    """A torch ``BatchNorm2d`` converted keeps its affine parameters and
    running statistics and normalizes axis 1 across the ranks: JAX's
    ``SyncBatchNorm(channel_last=False)`` from the same values."""
    x = _global(9, (WORLD * 2, C, 3, 3))
    w, b = _affine()
    bn = JSyncBatchNorm(axis_name="data", channel_last=False, momentum=0.1)
    variables = {"params": {"scale": jnp.asarray(w), "bias": jnp.asarray(b)},
                 "batch_stats": {"running_mean": jnp.full((C,), 0.5),
                                 "running_var": jnp.full((C,), 2.0)}}
    mesh = Mesh(np.array(jax.devices("cpu")[:WORLD]), ("data",))
    y, upd = jax.jit(shard_map(
        lambda xs: bn.apply(variables, xs, mutable=["batch_stats"]),
        mesh=mesh, in_specs=(P("data"),),
        out_specs=(P("data"), P())))(x)
    np.testing.assert_allclose(_gathered(ranks, "convert/y"), np.asarray(y),
                               atol=1e-4, rtol=1e-4)
    for r in range(WORLD):
        np.testing.assert_allclose(
            ranks[r]["convert/running_var"],
            np.asarray(upd["batch_stats"]["running_var"]), atol=1e-4,
            rtol=1e-4)


def test_convert_syncbn_model_adopts_a_resnets_plain_norms():
    """The flax-style ``BatchNorm`` of a ResNet (``--no-fused-bn``)
    becomes ``SyncBatchNorm``: running ``mean``/``var`` renamed
    ``running_mean``/``running_var`` (JAX's ``adopt_batchnorm_stats``),
    values kept, and the model computes what ``ResNet(sync_bn=True)``
    computes on the same weights."""
    kw = dict(stage_sizes=[1, 1], block_cls=BasicBlock, num_filters=4,
              num_classes=10, device="cpu", seed=3)
    plain = ResNet(**kw)
    with torch.no_grad():
        plain.stage1_block1.bn1.mean.fill_(0.25)
    names = set(plain.state_dict())
    converted = convert_syncbn_model(plain, axis_name=None)
    assert isinstance(converted.stage1_block1.bn1, SyncBatchNorm)
    sync = ResNet(sync_bn=True, **kw)
    assert set(converted.state_dict()) == set(sync.state_dict())
    assert {n.replace(".mean", ".running_mean").replace(".var",
                                                        ".running_var")
            for n in names} == set(sync.state_dict())
    assert float(converted.stage1_block1.bn1.running_mean[0]) == 0.25
    sync.load_state_dict(converted.state_dict())
    x = torch.from_numpy(_global(10, (4, 16, 16, 3)))
    torch.testing.assert_close(converted(x), sync(x), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("size,world", [(0, 4), (1, 4), (2, 4), (4, 4),
                                        (3, 6), (2, 8)])
def test_create_syncbn_process_group_matches_jax(size, world):
    assert create_syncbn_process_group(size, world) == jcreate(size, world)
    for bad in ((8, 4), (3, 4)):
        with pytest.raises(ValueError):
            create_syncbn_process_group(*bad)
        with pytest.raises(ValueError):
            jcreate(*bad)
