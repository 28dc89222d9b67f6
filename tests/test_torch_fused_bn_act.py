"""The port's BN epilogue and SyncBatchNorm against the JAX package's.

Same numpy inputs through JAX ``bn_relu_residual(..., interpret=True)``
(the Pallas kernels in interpret mode, as ``tests/test_fused_bn_act.py``
runs them) and through the port, whose CPU path is the plain version of
its Triton kernels: every affine / residual / ReLU variant, the forward
(fp32 atol 1e-6; bf16 within one bf16 ulp of the output, 2**-7 relative)
and the six cotangents of ``jax.grad`` (fp32, atol 1e-5: the
per-channel sums add 50 products in another order).  Then the whole
BatchNorm through ``SyncBatchNorm`` and ``BatchNorm2d_NHWC``: output,
the gradients of x, scale, bias and z against ``jax.grad`` of the flax
module (atol 1e-5), and the running statistics (atol 1e-6).  The
kernels themselves run only on the card
(``tests/test_torch_kernels_cuda.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.contrib.groupbn import BatchNorm2d_NHWC as JBatchNorm2d_NHWC
from apex_tpu.normalization.fused_bn_act import \
    bn_relu_residual as jax_epilogue
from apex_tpu.parallel import SyncBatchNorm as JSyncBatchNorm
from apex_tpu.parallel import welford_parallel as jax_welford
from apex_tpu_torch.contrib.groupbn import BatchNorm2d_NHWC
from apex_tpu_torch.normalization import bn_act_epilogue_ref, bn_relu_residual
from apex_tpu_torch.parallel import (SyncBatchNorm, adopt_batchnorm_stats,
                                     welford_parallel)


def _operands(c=12, seed=0):
    rng = np.random.RandomState(seed)
    x, z = (rng.randn(2, 5, 5, c).astype(np.float32) for _ in range(2))
    mean = rng.randn(c).astype(np.float32)
    invstd = (np.abs(rng.randn(c)) + 0.3).astype(np.float32)
    w, b = (rng.randn(c).astype(np.float32) for _ in range(2))
    return x, z, mean, invstd, w, b


VARIANTS = [(affine, with_z, relu) for affine in (True, False)
            for with_z in (True, False) for relu in (True, False)]
IDS = [f"{'affine' if a else 'plain'}-{'z' if z else 'noz'}-"
       f"{'relu' if r else 'norelu'}" for a, z, r in VARIANTS]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("affine,with_z,relu", VARIANTS, ids=IDS)
def test_forward_matches_pallas_interpret(affine, with_z, relu, dtype):
    x, z, mean, invstd, w, b = _operands()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_epilogue(jnp.asarray(x).astype(jdt), mean, invstd,
                        w if affine else None, b if affine else None,
                        z=jnp.asarray(z).astype(jdt) if with_z else None,
                        relu=relu, interpret=True)
    t = torch.from_numpy
    got = bn_relu_residual(t(x).to(tdt), t(mean), t(invstd),
                           t(w) if affine else None, t(b) if affine else None,
                           z=t(z).to(tdt) if with_z else None, relu=relu)
    assert got.dtype == tdt and got.shape == x.shape
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                                   atol=1e-30)
    np.testing.assert_array_equal(
        got.float().numpy(),
        bn_act_epilogue_ref(t(x).to(tdt), t(mean), t(invstd),
                            t(w) if affine else None,
                            t(b) if affine else None,
                            t(z).to(tdt) if with_z else None,
                            relu).float().numpy())


@pytest.mark.parametrize("affine,with_z,relu", VARIANTS, ids=IDS)
def test_six_cotangents_match_jax_grad_of_pallas_interpret(affine, with_z,
                                                           relu):
    x, z, mean, invstd, w, b = _operands(seed=1)
    g = np.random.RandomState(2).randn(*x.shape).astype(np.float32)
    operands = [x, mean, invstd] + ([w, b] if affine else []) \
        + ([z] if with_z else [])

    def unpack(ops):
        ops = list(ops)
        xx, mm, ii = ops[:3]
        ww, bb = (ops[3], ops[4]) if affine else (None, None)
        zz = ops[-1] if with_z else None
        return xx, mm, ii, ww, bb, zz

    def jloss(*ops):
        xx, mm, ii, ww, bb, zz = unpack(ops)
        return jnp.sum(jax_epilogue(xx, mm, ii, ww, bb, z=zz, relu=relu,
                                    interpret=True) * g)

    want = jax.grad(jloss, argnums=tuple(range(len(operands))))(
        *[jnp.asarray(o) for o in operands])
    leaves = [torch.from_numpy(o).requires_grad_(True) for o in operands]
    xx, mm, ii, ww, bb, zz = unpack(leaves)
    out = bn_relu_residual(xx, mm, ii, ww, bb, z=zz, relu=relu)
    got = torch.autograd.grad((out * torch.from_numpy(g)).sum(), leaves)
    for gt, wt in zip(got, want):
        assert gt.shape == wt.shape
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt), atol=1e-5,
                                   rtol=1e-5)


def _flat(tree):
    return {"/".join(str(p.key) for p in path).replace("/", "."): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("wrapper", ["sync", "groupbn"])
@pytest.mark.parametrize("fuse_relu,with_z", [(True, True), (True, False),
                                              (False, False)],
                         ids=["relu-z", "relu", "plain"])
def test_whole_batchnorm_grads_and_running_stats_match_jax(fuse_relu, with_z,
                                                           wrapper):
    rng = np.random.RandomState(3)
    c = 6
    x = (rng.randn(4, 6, 6, c) * 1.5 + 0.3).astype(np.float32)
    z = rng.randn(4, 6, 6, c).astype(np.float32)
    g = rng.randn(4, 6, 6, c).astype(np.float32)
    scale = (1 + 0.2 * rng.randn(c)).astype(np.float32)
    bias = (0.2 * rng.randn(c)).astype(np.float32)
    jcls = JSyncBatchNorm if wrapper == "sync" else JBatchNorm2d_NHWC
    jm = jcls(num_features=c, fuse_relu=fuse_relu)
    zz = jnp.asarray(z) if with_z else None
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), zz)
    prefix = ("bn", ) if wrapper == "groupbn" else ()
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    for p in reversed(prefix):
        params = {p: params}

    def jloss(p, xx, zz_):
        y, upd = jm.apply({"params": p,
                           "batch_stats": variables["batch_stats"]},
                          xx, zz_, mutable=["batch_stats"])
        return jnp.sum(y * g), (y, upd["batch_stats"])

    (jgp, jgx, jgz), (jy, jstats) = jax.grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(params, jnp.asarray(x),
                                                 zz if with_z else
                                                 jnp.zeros_like(x))
    if wrapper == "sync":
        tm = SyncBatchNorm(c, fuse_relu=fuse_relu, device="cpu")
    else:
        tm = BatchNorm2d_NHWC(c, fuse_relu=fuse_relu, device="cpu")
    pre = "bn." if wrapper == "groupbn" else ""
    with torch.no_grad():
        tm.get_parameter(pre + "scale").copy_(torch.from_numpy(scale))
        tm.get_parameter(pre + "bias").copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).requires_grad_(True)
    zt = torch.from_numpy(z).requires_grad_(True) if with_z else None
    y = tm(xt, zt)
    leaves = [xt, tm.get_parameter(pre + "scale"),
              tm.get_parameter(pre + "bias")] + ([zt] if with_z else [])
    got = torch.autograd.grad((y * torch.from_numpy(g)).sum(), leaves)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               atol=1e-5)
    jflat = _flat(jgp)
    want = [jgx, jflat[pre + "scale"], jflat[pre + "bias"]] \
        + ([jgz] if with_z else [])
    for gt, wt in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt), atol=1e-5,
                                   rtol=1e-5)
    stats = {k: v.numpy() for k, v in tm.named_buffers()}
    for k, v in _flat(jstats).items():
        np.testing.assert_allclose(stats[k], np.asarray(v), atol=1e-6,
                                   err_msg=k)


def test_eval_uses_running_stats_and_nchw_tail():
    rng = np.random.RandomState(4)
    x = rng.randn(3, 5, 4, 4).astype(np.float32)       # NCHW
    jm = JSyncBatchNorm(num_features=5, channel_last=False, fuse_relu=True)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    jy, upd = jm.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    tm = SyncBatchNorm(5, channel_last=False, fuse_relu=True, device="cpu")
    with torch.no_grad():
        y = tm(torch.from_numpy(x))
        y2 = tm(torch.from_numpy(x), use_running_average=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)
    jy2 = jm.apply({**variables, "batch_stats": upd["batch_stats"]},
                   jnp.asarray(x), use_running_average=True)
    np.testing.assert_allclose(y2.numpy(), np.asarray(jy2), atol=1e-5)


def test_welford_adopt_and_refusals():
    rng = np.random.RandomState(5)
    mean, var = rng.randn(3, 4), np.abs(rng.randn(3, 4))
    count = np.array([[5.0], [7.0], [2.0]]) * np.ones((3, 4))
    want = jax_welford(jnp.asarray(mean, jnp.float32),
                       jnp.asarray(var, jnp.float32), count)
    got = welford_parallel(torch.tensor(mean, dtype=torch.float32),
                           torch.tensor(var, dtype=torch.float32), count)
    for gt, wt in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt), atol=1e-6)
    tree = {"bn1": {"mean": 1, "var": 2}, "head": {"kernel": 3}}
    assert adopt_batchnorm_stats(tree) == {
        "bn1": {"running_mean": 1, "running_var": 2}, "head": {"kernel": 3}}
    with pytest.raises(NotImplementedError, match="cross-process"):
        SyncBatchNorm(4, axis_name="data", device="cpu")
    with pytest.raises(NotImplementedError, match="bn_group"):
        BatchNorm2d_NHWC(4, bn_group=2, device="cpu")
