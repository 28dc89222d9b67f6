"""The port's fused softmax cross-entropy against the JAX package's.

Same numpy logits and labels through the JAX Pallas kernels in interpret
mode (``_fwd_pallas`` / ``_bwd_pallas``, as ``tests/test_contrib.py``
runs them) and the custom-VJP function, and through the port, whose CPU
path is the plain version of its Triton kernels.  fp32 losses, ``mlse``
and ``dx`` at atol 1e-5; smoothing 0 and 0.1; padding rows (loss and
gradient zero), including ``padding_idx=-1``.  The kernels themselves
run only on the card (``tests/test_torch_kernels_cuda.py``).
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.contrib.xentropy import _bwd_pallas, _fwd_pallas
from apex_tpu.contrib.xentropy import \
    softmax_cross_entropy_loss as jax_xentropy
from apex_tpu_torch.contrib.xentropy import (SoftmaxCrossEntropyLoss,
                                             softmax_cross_entropy_loss)

xent = importlib.import_module("apex_tpu_torch.contrib.xentropy")

TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(n, v, seed, padding_idx=0, pad_every=5):
    rng = np.random.RandomState(seed)
    x = (2 * rng.randn(n, v)).astype(np.float32)
    labels = rng.randint(1, v, n).astype(np.int32)
    labels[::pad_every] = padding_idx
    return x, labels


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_forward_losses_and_mlse_match_pallas_interpret(smoothing):
    x, labels = _inputs(48, 256, seed=0, pad_every=7)
    want_loss, want_mlse = _fwd_pallas(jnp.asarray(x), jnp.asarray(labels),
                                       smoothing, interpret=True)
    loss, mlse = xent._fwd_ref(torch.from_numpy(x),
                               torch.from_numpy(labels), smoothing)
    assert loss.dtype == mlse.dtype == torch.float32
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss), **TOL)
    np.testing.assert_allclose(mlse.numpy(), np.asarray(want_mlse), **TOL)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_backward_dx_matches_pallas_interpret(smoothing):
    x, labels = _inputs(40, 128, seed=1)
    _, mlse = xent._fwd_ref(torch.from_numpy(x), torch.from_numpy(labels),
                            smoothing)
    g = np.random.RandomState(2).rand(40).astype(np.float32)
    g[labels == 0] = 0.0                     # the vjp's padding mask
    want = _bwd_pallas(jnp.asarray(g), jnp.asarray(x),
                       jnp.asarray(mlse.numpy()), jnp.asarray(labels),
                       smoothing, interpret=True)
    got = xent._bwd_ref(torch.from_numpy(g), torch.from_numpy(x), mlse,
                        torch.from_numpy(labels), smoothing)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not got[::5].any()


@pytest.mark.parametrize("padding_idx", [0, -1])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_function_and_gradient_match_custom_vjp(smoothing, padding_idx):
    """Masked losses and ``dx`` of the mean loss through the port's
    autograd Function against ``jax.grad`` of the JAX custom VJP."""
    x, labels = _inputs(30, 100, seed=3, padding_idx=padding_idx)
    jl = jnp.asarray(labels)

    def jloss(xx):
        return jnp.mean(jax_xentropy(xx, jl, smoothing, padding_idx))
    want_losses = jax_xentropy(jnp.asarray(x), jl, smoothing, padding_idx)
    want_dx = jax.grad(jloss)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    losses = softmax_cross_entropy_loss(xt, torch.from_numpy(labels).long(),
                                        smoothing, padding_idx)
    losses.mean().backward()
    np.testing.assert_allclose(losses.detach().numpy(),
                               np.asarray(want_losses), **TOL)
    assert not losses.detach()[labels == padding_idx].any()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), **TOL)
    assert not xt.grad[labels == padding_idx].any()


def test_bf16_logits_give_fp32_losses_and_bf16_dx():
    x, labels = _inputs(16, 64, seed=4)
    xb = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    losses = SoftmaxCrossEntropyLoss.apply(xb, torch.from_numpy(labels),
                                           0.1, 0, True)
    assert losses.dtype == torch.float32
    losses.sum().backward()
    assert xb.grad.dtype == torch.bfloat16
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    want = jax_xentropy(jx, jnp.asarray(labels), 0.1, 0)
    np.testing.assert_allclose(losses.detach().numpy(), np.asarray(want),
                               **TOL)
    want_dx = jax.grad(lambda a: jnp.sum(jax_xentropy(
        a, jnp.asarray(labels), 0.1, 0)))(jx)
    np.testing.assert_allclose(xb.grad.float().numpy(),
                               np.asarray(want_dx.astype(jnp.float32)),
                               atol=2 ** -8, rtol=0)
