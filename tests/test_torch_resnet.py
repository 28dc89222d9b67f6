"""The port's ResNet against the JAX package's.

A small ``ResNet(stage_sizes=[1, 1, 1, 1], num_filters=8)`` of each
block class, with the same weights in both (made by the port, moved by
``resnet_variables_to_jax``), on the same eight numpy images of 32 x 32
(an even size, so the stride-2 3x3 convs pad flax's asymmetric
``'SAME'`` ``(0, 1)``; eight, so the last stage's BatchNorms, at 1 x 1,
average more than two values): training-mode logits (fp32, atol 1e-4) and the updated
``batch_stats`` (atol 1e-5) through both the fused-epilogue routing
(``BatchNorm2d_NHWC``) and the plain flax-style BatchNorm; eval-mode
logits; the variables' round trip; the O2 cast, which keeps the same
leaves fp32 in both packages; and ``remat`` (``"full"``, ``"conv_out"``):
the same loss, gradients and batch statistics as no remat, bit for bit
(the recompute runs the same operations on the same inputs), and
against JAX's remat within the forward test's tolerances.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.amp import policy as jpolicy
from apex_tpu.contrib.groupbn import BatchNorm2d_NHWC as JBatchNorm2d_NHWC
from apex_tpu.models import resnet as jresnet
from apex_tpu.ops import PallasConv as JPallasConv
from apex_tpu_torch.amp import convert_params
from apex_tpu_torch.contrib.groupbn import BatchNorm2d_NHWC
from apex_tpu_torch.convert import (resnet_variables_from_jax,
                                    resnet_variables_to_jax)
from apex_tpu_torch.models import resnet
from apex_tpu_torch.ops import PallasConv, conv as tconv

SMALL = dict(stage_sizes=[1, 1, 1, 1], num_filters=8, num_classes=10)
BLOCKS = {"basic": (jresnet.BasicBlock, resnet.BasicBlock),
          "bottleneck": (jresnet.BottleneckBlock, resnet.BottleneckBlock)}


def _images(n=8, size=32, seed=0):
    return np.random.RandomState(seed).randn(n, size, size, 3).astype(
        np.float32)


def _pair(block, fused, dtype=torch.float32, pallas_conv=False):
    """(flax model, the port model's variables in the flax layout, the
    port's model).  The weights are made by the port (flax's init is
    slow to compile on the CPU) and must fit the flax model's tree.
    ``pallas_conv`` builds both with their packages' ``PallasConv``."""
    jblock, tblock = BLOCKS[block]
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jm = jresnet.ResNet(block_cls=jblock, dtype=jdt,
                        norm_cls=JBatchNorm2d_NHWC if fused else None,
                        conv_cls=JPallasConv if pallas_conv else None,
                        **SMALL)
    tm = resnet.ResNet(block_cls=tblock, dtype=dtype,
                       norm_cls=BatchNorm2d_NHWC if fused else None,
                       conv_cls=PallasConv if pallas_conv else None,
                       device="cpu", seed=1, **SMALL)
    with torch.no_grad():      # statistics other than the init's
        for name, buf in tm.named_buffers():
            buf.add_(torch.rand(buf.shape, generator=torch.Generator()
                                .manual_seed(len(name))))
    return jm, resnet_variables_to_jax(*tm.variables()), tm


def _apply(jm, variables, x, train=True):
    kw = dict(mutable=["batch_stats"]) if train else {}
    return jax.jit(functools.partial(jm.apply, train=train, **kw))(
        variables, jnp.asarray(x))


def _flat(tree):
    return {"/".join(str(p.key) for p in path).replace("/", "."): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "plain_bn"])
@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_forward_logits_and_batch_stats_match_jax(block, fused):
    jm, variables, tm = _pair(block, fused)
    x = _images(seed=2)
    jlogits, upd = _apply(jm, variables, x)
    params, stats = tm.variables()
    with torch.no_grad():
        logits, new_stats = tm.apply(params, stats, torch.from_numpy(x))
    assert logits.dtype == torch.float32 and logits.shape == (8, 10)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=1e-4)
    want = _flat(upd["batch_stats"])
    assert sorted(new_stats) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(new_stats[k].numpy(), np.asarray(v),
                                   atol=1e-5, err_msg=k)
    # apply() leaves the module's own statistics as they were
    for k, v in _flat(variables["batch_stats"]).items():
        np.testing.assert_array_equal(stats[k].numpy(), v)
    jeval = _apply(jm, {**variables, "batch_stats": upd["batch_stats"]}, x,
                   train=False)
    with torch.no_grad():
        teval, _ = tm.apply(params, new_stats, torch.from_numpy(x),
                            train=False)
    np.testing.assert_allclose(teval.numpy(), np.asarray(jeval), atol=1e-4,
                               rtol=1e-4)


def test_fused_routing_counts_and_flax_names():
    """ResNet-50's 53 BN sites (1 + 16 x 3 + 4 downsample) under flax's
    names, at a small width."""
    tm = resnet.ResNet50(num_filters=4, num_classes=10,
                         norm_cls=BatchNorm2d_NHWC, device="cpu")
    params, stats = tm.variables()
    assert len([k for k in params if k.endswith(".bn.scale")]) == 53
    assert len(stats) == 2 * 53
    assert params["conv_init.kernel"].shape == (7, 7, 3, 4)
    assert params["stage1_block1.conv2.kernel"].shape == (3, 3, 4, 4)
    assert params["head.kernel"].shape == (128, 10)
    assert "stage2_block1.downsample_bn.bn.running_var" in stats
    assert not bool(params["stage4_block3.bn3.bn.scale"].any())   # zeros
    with pytest.raises(ValueError, match="fused_epilogue"):
        resnet.ResNet18(fused_epilogue=True, device="cpu")
    # sync_bn (ported): every site a SyncBatchNorm on the fused epilogue,
    # its statistics under SyncBatchNorm's names, as in the JAX model
    from apex_tpu_torch.parallel import SyncBatchNorm
    sm = resnet.ResNet18(num_filters=4, num_classes=10, device="cpu",
                         sync_bn=True, bn_momentum=0.2)
    norms = [m for m in sm.modules() if isinstance(m, SyncBatchNorm)]
    assert len(norms) == 1 + 8 * 2 + 3 and sm.fused
    assert {m.momentum for m in norms} == {0.2}
    assert "stage2_block1.downsample_bn.running_var" in sm.state_dict()
    assert not bool(sm.state_dict()["stage4_block2.bn2.scale"].any())
    # remat is ported: every block carries the policy
    rm = resnet.ResNet18(device="cpu", remat=True)
    assert {getattr(rm, n).remat for n in rm.block_names} == {"full"}


def test_variables_round_trip():
    """port -> flax tree -> port gives every tensor back, and the flax
    tree has the flax model's structure (its ``init`` gives the same
    names and shapes)."""
    jm, variables, tm = _pair("bottleneck", True)
    params, stats = resnet_variables_from_jax(variables)
    tm.load_state_dict({**params, **stats}, strict=True)
    for k, v in {**params, **stats}.items():
        np.testing.assert_array_equal(v.numpy(), tm.get_buffer(k).numpy()
                                      if k in stats else
                                      tm.get_parameter(k).detach().numpy())
    shapes = jax.eval_shape(functools.partial(jm.init, train=True),
                            jax.random.PRNGKey(0),
                            jnp.zeros((2, 32, 32, 3)))
    for coll in ("params", "batch_stats"):
        want = {k: tuple(v.shape) for k, v in _flat(shapes[coll]).items()}
        assert {k: v.shape for k, v in _flat(variables[coll]).items()} \
            == want


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "plain_bn"])
def test_o2_casts_the_same_leaves(fused):
    """Every BN leaf (``bn_init``, ``bn1``..``bn3``, ``downsample_bn``)
    stays fp32, the convs and the head go to bf16, in both packages."""
    _, variables, tm = _pair("bottleneck", fused)
    jcast = _flat(jpolicy.convert_params(variables["params"], jnp.bfloat16))
    want = {k: v.dtype == jnp.float32 for k, v in jcast.items()}
    params, _ = tm.variables()
    got = {k: v.dtype == torch.float32
           for k, v in convert_params(params, torch.bfloat16).items()}
    assert got == want
    kept = sorted(k for k, v in got.items() if v)
    assert all(".bn" in k or k.startswith("bn_init") or "_bn." in k
               for k in kept)
    assert not got["head.kernel"] and not got["conv_init.kernel"]
    assert not got["stage1_block1.downsample_conv.kernel"]


def test_bf16_forward_close_to_jax():
    """O2's compute dtype through the whole network (loose: bf16
    activations through every layer)."""
    jm, variables, tm = _pair("basic", True, dtype=torch.bfloat16)
    x = _images(seed=3)
    jcast = jpolicy.convert_params(variables["params"], jnp.bfloat16)
    jlogits, _ = _apply(jm, {"params": jcast,
                             "batch_stats": variables["batch_stats"]}, x)
    params, stats = tm.variables()
    with torch.no_grad():
        logits, _ = tm.apply(convert_params(params, torch.bfloat16), stats,
                             torch.from_numpy(x))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_pallas_conv_resnet_matches_jax(block):
    """``conv_cls=PallasConv`` in both packages, fused BN, 32 x 32:
    training-mode logits (atol 1e-4), updated batch statistics (1e-5) and
    the gradient of every parameter (``sum(sin(logits))``), each within
    1e-3 of its largest value: fp32 summation order through the backward
    of ten layers of batch statistics.  On the CPU every conv goes through
    ``conv2d``'s plain version and no kernel is launched."""
    jm, variables, tm = _pair(block, True, pallas_conv=True)
    x = _images(seed=4)

    def jloss(params):
        logits, upd = jm.apply({"params": params,
                                "batch_stats": variables["batch_stats"]},
                               jnp.asarray(x), train=True,
                               mutable=["batch_stats"])
        return jnp.sum(jnp.sin(logits)), (logits, upd)
    (_, (jlogits, upd)), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(variables["params"])
    params, stats = tm.variables()
    params = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    tconv.reset_conv_dispatch_stats()
    launches = tconv.conv_fwd_kernel.launches
    logits, new_stats = tm.apply(params, stats, torch.from_numpy(x))
    grads = dict(zip(params, torch.autograd.grad(torch.sin(logits).sum(),
                                                 list(params.values()))))
    n_convs = len([k for k in params if k.endswith("kernel")]) - 1  # head
    assert tconv.conv_dispatch_stats()["pallas_sites"] == n_convs
    assert tconv.conv_fwd_kernel.launches == launches
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=1e-4)
    for k, v in _flat(upd["batch_stats"]).items():
        np.testing.assert_allclose(new_stats[k].numpy(), np.asarray(v),
                                   atol=1e-5, err_msg=k)
    want = _flat(jgrads)
    assert sorted(grads) == sorted(want)
    for k, v in want.items():
        v = np.asarray(v)
        err = np.abs(grads[k].numpy() - v).max()
        assert err <= 1e-3 * max(np.abs(v).max(), 1e-6), (k, err)


def test_pallas_conv_keeps_names_and_round_trips():
    """The conv class changes no parameter: the same names, shapes and
    values as the ``Conv`` model from the same seed, and the variables
    round-trip through the flax layout unchanged."""
    _, variables, tm = _pair("bottleneck", True, pallas_conv=True)
    plain = resnet.ResNet(block_cls=resnet.BottleneckBlock,
                          norm_cls=BatchNorm2d_NHWC, device="cpu", seed=1,
                          **SMALL)
    for got, want in zip(tm.variables(), plain.variables()):
        assert sorted(got) == sorted(want)
    for k, v in plain.named_parameters():
        assert torch.equal(tm.get_parameter(k), v), k
    params, stats = resnet_variables_from_jax(variables)
    for k, v in {**params, **stats}.items():
        want = (tm.get_buffer(k) if k in stats else
                tm.get_parameter(k).detach())
        np.testing.assert_array_equal(v.numpy(), want.numpy())


def _loss_and_grads(tm, x):
    params, stats = tm.variables()
    params = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    stats = {k: v.clone() for k, v in stats.items()}
    logits, new_stats = tm.apply(params, stats, torch.from_numpy(x))
    loss = torch.sin(logits).sum()
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss, dict(zip(params, grads)), new_stats


@pytest.mark.parametrize("remat", ["full", "conv_out"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "plain_bn"])
@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_remat_matches_no_remat_and_jax(block, fused, remat):
    """The loss ``sum(sin(logits))``, every gradient and the updated
    batch statistics under ``remat`` equal those without it bit for bit
    (the running statistics advance once, not again in the recompute),
    and, with the fused BN, match JAX's ``remat`` model: the loss at 1e-4
    and each gradient within 1e-3 of its largest value, as the
    conv-kernel test above."""
    jm, variables, tm = _pair(block, fused)
    x = _images(seed=5)
    rm = resnet.ResNet(block_cls=BLOCKS[block][1],
                       norm_cls=BatchNorm2d_NHWC if fused else None,
                       remat=remat, device="cpu", seed=1, **SMALL)
    rm.load_state_dict(tm.state_dict())
    loss, grads, stats = _loss_and_grads(tm, x)
    rloss, rgrads, rstats = _loss_and_grads(rm, x)
    assert torch.equal(loss, rloss)
    for k in grads:
        assert torch.equal(grads[k], rgrads[k]), k
    for k in stats:
        assert torch.equal(stats[k], rstats[k]), k
    if not fused:
        return           # JAX's remat of the plain BatchNorm: one compile less
    jrm = jm.clone(remat=remat)

    def jloss(params):
        logits, _ = jrm.apply({"params": params,
                               "batch_stats": variables["batch_stats"]},
                              jnp.asarray(x), train=True,
                              mutable=["batch_stats"])
        return jnp.sum(jnp.sin(logits))
    jl, jgrads = jax.jit(jax.value_and_grad(jloss))(variables["params"])
    np.testing.assert_allclose(float(rloss.detach()), float(jl), rtol=1e-4)
    for k, v in _flat(jgrads).items():
        v = np.asarray(v)
        err = np.abs(rgrads[k].numpy() - v).max()
        assert err <= 1e-3 * max(np.abs(v).max(), 1e-6), (k, err)


def test_remat_refuses_unknown_policies():
    with pytest.raises(ValueError, match="remat must be"):
        resnet.ResNet(block_cls=resnet.BasicBlock, remat="dots",
                      device="cpu", **SMALL)
