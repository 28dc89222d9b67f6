"""The port's leafwise LAMB and NovoGrad, LARC and the multi-tensor
extras against the JAX package's on the same numpy inputs.

LAMB and NovoGrad: 20 steps with periodic skips, in every mode the JAX
functions take (rtol 5e-5, atol 5e-6: per-tensor norms whose sums add in
another order, as JAX's own bucketed-vs-leafwise test allows);
``larc_gradients`` in clip and scale mode and ``larc_transform`` (rtol
1e-6: two norms and a handful of fp32 operations per element); the
multi-tensor max-norm, the two-stage LAMB, ``flatten``/``unflatten`` and
the applier (rtol 1e-6); and the optimizers' declared ``elementwise``
flags.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from apex_tpu import multi_tensor as jmta
from apex_tpu import training as jtraining
from apex_tpu.optimizers import functional as jF
from apex_tpu_torch import multi_tensor as mta
from apex_tpu_torch import training
from apex_tpu_torch.optimizers import functional as F
from apex_tpu_torch.parallel import larc_gradients, larc_transform

# the module (the package's ``LARC`` name is the wrapper class)
jlarc = importlib.import_module("apex_tpu.parallel.LARC")

TOL = dict(rtol=5e-5, atol=5e-6)


def _np_tree(seed, shapes=((7,), (3, 5), (64,), (1,), (2, 2, 3))):
    rng = np.random.RandomState(seed)
    return {f"p{i}": rng.randn(*s).astype(np.float32)
            for i, s in enumerate(shapes)}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _close(got, want, **tol):
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **(tol or TOL))


def _steps(init, update, jinit, jupdate, steps=20, skip=7, **kw):
    params = _np_tree(0)
    p, jp = _t(params), _j(params)
    st, jst = init(p), jinit(jp)
    rng = np.random.RandomState(1)
    for i in range(steps):
        g = _np_tree(100 + i)
        g = {k: (0.1 * rng.rand()) * v for k, v in g.items()}
        keep = i % skip != 0
        p, st = update(_t(g), st, p, apply_mask=torch.tensor(keep), **kw)
        jp, jst = jupdate(_j(g), jst, jp, apply_mask=jnp.asarray(keep),
                          **kw)
    return (p, st), (jp, jst)


@pytest.mark.parametrize("kw", [
    dict(lr=1e-2), dict(lr=1e-2, weight_decay=0.0),
    dict(lr=1e-2, use_nvlamb=True), dict(lr=1e-2, max_grad_norm=0.05),
    dict(lr=1e-2, max_grad_norm=None, grad_averaging=False),
    dict(lr=1e-2, bias_correction=False, grad_scale=2.0)],
    ids=["default", "no_decay", "nvlamb", "clipped", "no_clip_no_avg",
         "no_correction_scaled"])
def test_lamb_matches_jax(kw):
    (p, st), (jp, jst) = _steps(F.lamb_init, F.lamb_update, jF.lamb_init,
                                jF.lamb_update, **kw)
    _close(p, jp)
    _close(st.exp_avg, jst.exp_avg)
    _close(st.exp_avg_sq, jst.exp_avg_sq)
    assert int(st.step) == int(jst.step)


@pytest.mark.parametrize("kw", [
    dict(lr=1e-2), dict(lr=1e-2, weight_decay=0.01),
    dict(lr=1e-2, weight_decay=0.01, adam_w_mode=False),
    dict(lr=1e-2, norm_type=float("inf")), dict(lr=1e-2, init_zero=True),
    dict(lr=1e-2, bias_correction=True, grad_averaging=False)],
    ids=["default", "decoupled_decay", "l2_decay", "inf_norm", "init_zero",
         "corrected_no_avg"])
def test_novograd_matches_jax(kw):
    (p, st), (jp, jst) = _steps(F.novograd_init, F.novograd_update,
                                jF.novograd_init, jF.novograd_update, **kw)
    _close(p, jp)
    _close(st.exp_avg, jst.exp_avg)
    _close(st.exp_avg_sq, jst.exp_avg_sq)
    assert all(v.shape == () for v in st.exp_avg_sq.values())


def test_skipped_steps_leave_state_bit_identical():
    params = _t(_np_tree(2))
    g = _t(_np_tree(3))
    for init, update in ((F.lamb_init, F.lamb_update),
                         (F.novograd_init, F.novograd_update)):
        st = init(params)
        p, st2 = update(g, st, params, lr=0.1,
                        apply_mask=torch.tensor(False))
        for k in params:
            assert torch.equal(p[k], params[k])
        assert int(st2.step) == 0


@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("weight_decay", [0.0, 1e-3])
def test_larc_gradients_match_jax(clip, weight_decay):
    params, grads = _np_tree(4), _np_tree(5)
    params["p3"] = np.zeros_like(params["p3"])      # |p| = 0: rate 1
    kw = dict(lr=0.1, trust_coefficient=0.02, clip=clip,
              weight_decay=weight_decay)
    got = larc_gradients(_t(grads), _t(params), **kw)
    want = jlarc.larc_gradients(_j(grads), _j(params), **kw)
    _close(got, want, rtol=1e-6, atol=1e-7)
    bf = {k: v.bfloat16() for k, v in _t(grads).items()}
    assert all(v.dtype == torch.bfloat16
               for v in larc_gradients(bf, _t(params), **kw).values())


def test_larc_transform_matches_jax():
    params, grads = _np_tree(6), _np_tree(7)
    tx = larc_transform(lambda step: 0.5, weight_decay=1e-4)
    jtx = jlarc.larc_transform(lambda step: 0.5, weight_decay=1e-4)
    state = tx.init(_t(params))
    got, state2 = tx.update(_t(grads), state, _t(params))
    want, _ = jtx.update(_j(grads), jtx.init(_j(params)), _j(params))
    _close(got, want, rtol=1e-6, atol=1e-7)
    assert state2 == state == ()
    with pytest.raises(ValueError, match="requires params"):
        tx.update(_t(grads), state)


def test_maxnorm_and_two_stage_lamb_match_jax():
    p, g, m, v = (_np_tree(s) for s in (8, 9, 10, 11))
    v = {k: np.abs(x) for k, x in v.items()}
    total, per = mta.multi_tensor_maxnorm(_t(g), per_tensor=True)
    jtotal, jper = jmta.multi_tensor_maxnorm(_j(g), per_tensor=True)
    assert float(total) == float(jtotal)
    assert [float(x) for x in per] == [float(x) for x in jper]
    kw = dict(beta1=0.9, beta2=0.999, beta1_correction=0.1,
              beta2_correction=0.001, epsilon=1e-6,
              clipped_global_grad_norm=2.0)
    decay = [0.01, 0.0, 0.01, 0.0, 0.01]
    upd, nm, nv = mta.multi_tensor_lamb_stage1(_t(g), _t(p), _t(m), _t(v),
                                               decay, **kw)
    jupd, jnm, jnv = jmta.multi_tensor_lamb_stage1(_j(g), _j(p), _j(m),
                                                   _j(v), decay, **kw)
    for got, want in ((upd, jupd), (nm, jnm), (nv, jnv)):
        _close(got, want, rtol=1e-6, atol=1e-7)
    _, pn = mta.multi_tensor_l2norm(_t(p), per_tensor=True)
    _, un = mta.multi_tensor_l2norm(upd, per_tensor=True)
    pn[1] = torch.tensor(0.0)                        # a zero norm: plain lr
    new = mta.multi_tensor_lamb_stage2(_t(p), upd, pn, un, 0.01)
    jnew = jmta.multi_tensor_lamb_stage2(
        _j(p), {k: jnp.asarray(x.numpy()) for k, x in upd.items()},
        [jnp.asarray(x.numpy()) for x in pn],
        [jnp.asarray(x.numpy()) for x in un], 0.01)
    _close(new, jnew, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="one entry per leaf"):
        mta.multi_tensor_lamb_stage1(_t(g), _t(p), _t(m), _t(v), [0.0],
                                     **kw)


def test_flatten_unflatten_and_applier():
    tensors = [torch.arange(6.0).reshape(2, 3), torch.ones(4)]
    flat = mta.flatten(tensors)
    jflat = jmta.flatten([jnp.asarray(t.numpy()) for t in tensors])
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    back = mta.unflatten(flat, tensors)
    assert all(torch.equal(a, b) for a, b in zip(back, tensors))
    out, overflow = mta.multi_tensor_applier(
        mta.multi_tensor_scale, None, [tensors], 2.0)
    assert torch.equal(out[1], 2 * tensors[1]) and not bool(overflow)
    assert mta.MultiTensorApply.available


def test_elementwise_flags_match_jax():
    for name in ("adam", "sgd", "lamb", "novograd"):
        for bucketed in (False, True):
            got = getattr(training, name)(1e-3, bucketed=bucketed)
            want = getattr(jtraining, name)(1e-3, bucketed=bucketed)
            assert got.elementwise == want.elementwise, (name, bucketed)


@pytest.mark.parametrize("name", ["lamb", "novograd"])
def test_training_transforms_step_like_the_functions(name):
    """``training.lamb``/``novograd`` are the functional updates with
    their learning rate bound; the bucketed form keeps a Packed state."""
    params, grads = _t(_np_tree(12)), _t(_np_tree(13))
    fn = {"lamb": (F.lamb_init, F.lamb_update),
          "novograd": (F.novograd_init, F.novograd_update)}[name]
    tx = getattr(training, name)(0.05, weight_decay=0.01)
    p, _ = tx.update(grads, tx.init(params), params)
    want, _ = fn[1](grads, fn[0](params), params, lr=0.05,
                    weight_decay=0.01)
    for k in params:
        assert torch.equal(p[k], want[k])
    btx = getattr(training, name)(0.05, weight_decay=0.01, bucketed=True)
    st = btx.init(params)
    assert isinstance(st.exp_avg, mta.Packed)
    pb, _ = btx.update(grads, st, params)
    _close(pb, {k: v.numpy() for k, v in want.items()})
