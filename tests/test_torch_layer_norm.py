"""The port's LayerNorm forward against the JAX package's.

Same numpy inputs through JAX ``fused_layer_norm`` — its jnp reference
(``impl="jnp"``) and its Pallas kernel in interpret mode — and through
the port, whose CPU path is the plain version of its Triton kernel; and
the gradients (``dx`` from the backward kernel's plain version,
``dgamma``/``dbeta`` as column sums) against ``jax.grad`` of the Pallas
path in interpret mode.  fp32 at atol/rtol 1e-5, bf16 at 2e-2.  The kernel itself runs only on the card
(``tests/test_torch_kernels_cuda.py``).
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.normalization.fused_layer_norm import _pallas_fwd
from apex_tpu_torch.normalization import (FusedLayerNorm, fused_layer_norm,
                                          fused_layer_norm_affine)

# the packages re-export the functions under the modules' names
jfln = importlib.import_module("apex_tpu.normalization.fused_layer_norm")
fln_mod = importlib.import_module(
    "apex_tpu_torch.normalization.fused_layer_norm")

TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(shape, n2, seed=0, affine=True, has_bias=True):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    w = (1 + 0.1 * rng.randn(n2)).astype(np.float32) if affine else None
    b = (0.1 * rng.randn(n2)).astype(np.float32) if has_bias else None
    return x, w, b


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("affine,has_bias", [(True, True), (False, False),
                                             (True, False)],
                         ids=["affine", "no_affine", "no_bias"])
@pytest.mark.parametrize("impl", ["jnp", "interpret"])
def test_forward_matches_jax(affine, has_bias, impl):
    shape, n2 = (3, 5, 96), 96
    x, w, b = _inputs(shape, n2, affine=affine, has_bias=has_bias and affine)
    kw = {"interpret": True} if impl == "interpret" else {"impl": "jnp"}
    want = jfln.fused_layer_norm(_j(x), n2, _j(w), _j(b), **kw)
    got = fused_layer_norm(_t(x), n2, _t(w), _t(b))
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mean_invvar_match_pallas_interpret():
    """The three outputs of the TPU kernel (out, fp32 mean, fp32 invvar)
    against the port's plain version of the Hopper kernel."""
    x, w, b = _inputs((40, 200), 200, seed=1)
    want = _pallas_fwd(_j(x), _j(w), _j(b), 1e-5, interpret=True)
    got = fln_mod.layer_norm_fwd(_t(x), _t(w), _t(b), 1e-5)
    for g, wnt in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), **TOL)


def test_multi_dim_normalized_shape_and_affine_alias():
    x, w, b = _inputs((4, 6, 8), 48, seed=2)
    w2, b2 = w.reshape(6, 8), b.reshape(6, 8)
    want = jfln.fused_layer_norm_affine(_j(x), _j(w2), _j(b2), (6, 8),
                                        impl="jnp")
    got = fused_layer_norm_affine(_t(x), _t(w2), _t(b2), (6, 8))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="trailing dims"):
        fused_layer_norm(_t(x), (7,))


def test_bf16_input_keeps_dtype_with_fp32_stats():
    x, w, b = _inputs((16, 64), 64, seed=3)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    out, mean, invvar = fln_mod.layer_norm_fwd(xb, _t(w), _t(b), 1e-5)
    assert out.dtype == torch.bfloat16
    assert mean.dtype == invvar.dtype == torch.float32
    want = jfln.fused_layer_norm(jnp.asarray(x).astype(jnp.bfloat16), 64,
                                 _j(w), _j(b), impl="jnp")
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)


def test_module_params_and_grad_on_cpu():
    """flax's parameter names and init; the CPU path is differentiable
    through the autograd Function's plain backward."""
    ln = FusedLayerNorm(32, device="cpu")
    assert sorted(n for n, _ in ln.named_parameters()) == ["bias", "scale"]
    assert bool((ln.scale == 1).all()) and bool((ln.bias == 0).all())
    x = torch.randn(4, 32, requires_grad=True)
    ln(x).square().sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    assert FusedLayerNorm(32, elementwise_affine=False).scale is None


@pytest.mark.parametrize("affine,has_bias", [(True, True), (False, False),
                                             (True, False)],
                         ids=["affine", "no_affine", "no_bias"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
def test_grads_match_jax_grad_of_pallas_interpret(affine, has_bias, dtype,
                                                  tol):
    """dx, dw and db of the port against ``jax.grad`` of the Pallas
    path (``_pallas_bwd_input`` in interpret mode)."""
    shape, n2 = (3, 7, 96), 96
    x, w, b = _inputs(shape, n2, seed=4, affine=affine,
                      has_bias=has_bias and affine)
    g = np.random.RandomState(5).randn(*shape).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def jloss(x_, w_, b_):
        out = jfln.fused_layer_norm(x_, n2, w_, b_, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * g)

    argnums = tuple(i for i, a in enumerate((x, w, b)) if a is not None)
    want = jax.grad(jloss, argnums=argnums)(
        jnp.asarray(x).astype(jdt), _j(w), _j(b))
    leaves = [None if a is None else torch.from_numpy(a) for a in (x, w, b)]
    leaves[0] = leaves[0].to(tdt)
    for t in leaves:
        if t is not None:
            t.requires_grad_(True)
    out = fused_layer_norm(leaves[0], n2, leaves[1], leaves[2])
    got = torch.autograd.grad((out.float() * torch.from_numpy(g)).sum(),
                              [leaves[i] for i in argnums])
    assert got[0].dtype == tdt
    for gt, wt in zip(got, want):
        np.testing.assert_allclose(gt.float().numpy(),
                                   np.asarray(wt.astype(jnp.float32)),
                                   atol=tol, rtol=tol)


def test_bwd_input_ref_matches_pallas_kernel_interpret():
    """The backward kernel's plain version against the Pallas backward
    kernel itself (interpret mode), on the same saved statistics."""
    x, w, _ = _inputs((40, 200), 200, seed=6)
    g = np.random.RandomState(7).randn(40, 200).astype(np.float32)
    _, mean, invvar = jfln._fwd_ref(_j(x), _j(w), None, 1e-5)
    want = jfln._pallas_bwd_input(_j(g), _j(x), mean, invvar, _j(w),
                                  interpret=True)
    got = fln_mod._bwd_input_ref(_t(g), _t(x),
                                 torch.from_numpy(np.asarray(mean)),
                                 torch.from_numpy(np.asarray(invvar)), _t(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
