"""The port's RNN stack and weight norm (``apex_tpu_torch.RNN``,
``apex_tpu_torch.reparameterization``) against the JAX package's: every
test of ``tests/test_rnn_reparam.py`` mirrored, the same numpy inputs
through both, the JAX weights carried over by
``convert.rnn_params_from_jax`` (flax kernels ``[in, out]`` -> the
``nn.Linear`` weights ``[out, in]``).  Forward outputs, final states,
``collect_hidden`` states and gradients are held at fp32 rtol 1e-5
(atol 1e-6 for values near zero)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import RNN as JRNN
from apex_tpu import reparameterization as jrep
from apex_tpu_torch import RNN, convert, reparameterization as rep

T, B, F, H = 5, 3, 4, 8
TOL = dict(rtol=1e-5, atol=1e-6)
NAMES = ["LSTM", "GRU", "ReLU", "Tanh", "mLSTM"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(name, x, *args, **kw):
    """(JAX module, its variables, the port's module with the same
    weights)."""
    jm = getattr(JRNN, name)(F, H, *args, **kw)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tm = getattr(RNN, name)(F, H, *args, device="cpu", **kw)
    tm.load_state_dict(convert.rnn_params_from_jax(
        _np(variables["params"])))
    return jm, variables, tm


def _close(got, want, **tol):
    leaves_g = torch.utils._pytree.tree_leaves(got)
    leaves_w = jax.tree_util.tree_leaves(want)
    assert len(leaves_g) == len(leaves_w)
    for g, w in zip(leaves_g, leaves_w):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   **(tol or TOL))


@pytest.mark.parametrize("name,n_states", [
    ("LSTM", 2), ("GRU", 1), ("ReLU", 1), ("Tanh", 1), ("mLSTM", 2)])
def test_rnn_shapes_and_states(name, n_states):
    x = np.random.RandomState(0).randn(T, B, F).astype(np.float32)
    jm, variables, tm = _pair(name, x, num_layers=2)
    want = jm.apply(variables, jnp.asarray(x))
    out, finals = tm(torch.from_numpy(x))
    assert out.shape == (T, B, H)
    assert len(finals) == 2 and len(finals[0]) == n_states
    assert finals[0][0].shape == (B, H)
    _close((out, finals), want)


def test_rnn_batch_first_and_proj():
    x = np.random.RandomState(1).randn(B, T, F).astype(np.float32)
    jm, variables, tm = _pair("LSTM", x, num_layers=1, batch_first=True,
                              output_size=6)
    out, finals = tm(torch.from_numpy(x))
    assert out.shape == (B, T, 6)
    assert "proj.weight" in tm.state_dict()
    _close((out, finals), jm.apply(variables, jnp.asarray(x)))


def test_bidirectional_concat():
    x = np.random.RandomState(2).randn(T, B, F).astype(np.float32)
    jm, variables, tm = _pair("GRU", x, num_layers=1, bidirectional=True)
    out, (fin_f, fin_r) = tm(torch.from_numpy(x))
    assert out.shape == (T, B, 2 * H)
    assert len(fin_f) == 1 and len(fin_r) == 1
    assert {k.split(".")[0] for k in tm.state_dict()} == {"fwd", "bwd"}
    _close((out, (fin_f, fin_r)), jm.apply(variables, jnp.asarray(x)))


def test_rnn_initial_state_threading():
    x = np.random.RandomState(1).randn(2 * T, B, F).astype(np.float32)
    jm, variables, tm = _pair("Tanh", x, num_layers=1)
    xt = torch.from_numpy(x)
    full, _ = tm(xt)
    out1, fin1 = tm(xt[:T])
    out2, _ = tm(xt[T:], initial_states=fin1)
    torch.testing.assert_close(full[T:], out2, rtol=1e-5, atol=1e-6)
    _, jfin1 = jm.apply(variables, jnp.asarray(x[:T]))
    jout2, _ = jm.apply(variables, jnp.asarray(x[T:]),
                        initial_states=jfin1)
    _close(out2, jout2)


def test_rnn_collect_hidden():
    x = np.random.RandomState(3).randn(T, B, F).astype(np.float32)
    jm, variables, tm = _pair("LSTM", x, num_layers=2)
    out, per_step = tm(torch.from_numpy(x), collect_hidden=True)
    assert len(per_step) == 2
    h_all, c_all = per_step[0]
    assert h_all.shape == (T, B, H) and c_all.shape == (T, B, H)
    _, finals = tm(torch.from_numpy(x))
    torch.testing.assert_close(h_all[-1], finals[0][0], rtol=0, atol=1e-6)
    _close((out, per_step), jm.apply(variables, jnp.asarray(x),
                                     collect_hidden=True))


def test_rnn_grads_flow():
    x = np.random.RandomState(4).randn(T, B, F).astype(np.float32)
    jm, variables, tm = _pair("LSTM", x, num_layers=1)

    def jloss(p):
        out, _ = jm.apply(p, jnp.asarray(x))
        return jnp.sum(out ** 2)

    want = convert.rnn_params_from_jax(_np(jax.grad(jloss)(variables)
                                           ["params"]))
    out, _ = tm(torch.from_numpy(x))
    (out ** 2).sum().backward()
    got = {k: p.grad for k, p in tm.named_parameters()}
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert sum(float(g.abs().sum()) for g in got.values()) > 0


def test_weight_norm_dim_recorded_in_marker():
    v = np.random.RandomState(0).randn(3, 5).astype(np.float32)
    wn = rep.apply_weight_norm({"l": {"kernel": torch.from_numpy(v)}},
                               dim=1)
    jwn = jrep.apply_weight_norm({"l": {"kernel": jnp.asarray(v)}}, dim=1)
    assert wn["l"]["kernel"]["g"].shape == (1, 5)
    assert wn["l"]["kernel"]["__reparam__"].dim == 1
    np.testing.assert_allclose(wn["l"]["kernel"]["g"].numpy(),
                               np.asarray(jwn["l"]["kernel"]["g"]), **TOL)
    rebuilt = rep.reconstruct(wn)
    np.testing.assert_allclose(rebuilt["l"]["kernel"].numpy(),
                               np.asarray(jrep.reconstruct(jwn)["l"]
                                          ["kernel"]), **TOL)
    np.testing.assert_allclose(rebuilt["l"]["kernel"].numpy(), v, atol=1e-5)


def test_remove_weight_norm_respects_name_filter():
    params = {"a": {"kernel": torch.ones((2, 3))},
              "b": {"kernel": torch.ones((2, 3))}}
    partial = rep.remove_weight_norm(rep.apply_weight_norm(params), name="a")
    assert isinstance(partial["a"]["kernel"], torch.Tensor)
    assert isinstance(partial["b"]["kernel"], dict)
    jp = jrep.remove_weight_norm(jrep.apply_weight_norm(
        {k: {"kernel": jnp.ones((2, 3))} for k in "ab"}), name="a")
    np.testing.assert_allclose(partial["a"]["kernel"].numpy(),
                               np.asarray(jp["a"]["kernel"]), **TOL)
    assert isinstance(jp["b"]["kernel"], dict)


def test_weight_norm_roundtrip():
    k = np.random.RandomState(0).randn(4, 6).astype(np.float32)
    params = {"dense": {"kernel": torch.from_numpy(k),
                        "bias": torch.zeros(6)}}
    wn = rep.apply_weight_norm(params)
    assert "g" in wn["dense"]["kernel"] and "v" in wn["dense"]["kernel"]
    assert wn["dense"]["kernel"]["g"].shape == (4, 1)
    jwn = jrep.apply_weight_norm({"dense": {"kernel": jnp.asarray(k),
                                            "bias": jnp.zeros(6)}})
    np.testing.assert_allclose(wn["dense"]["kernel"]["g"].numpy(),
                               np.asarray(jwn["dense"]["kernel"]["g"]),
                               **TOL)
    for fold in (rep.reconstruct, rep.remove_weight_norm):
        np.testing.assert_allclose(fold(wn)["dense"]["kernel"].numpy(), k,
                                   atol=1e-5)
    np.testing.assert_allclose(rep.reconstruct(wn)["dense"]["kernel"]
                               .numpy(), np.asarray(jrep.reconstruct(jwn)
                                                    ["dense"]["kernel"]),
                               **TOL)


def test_weight_norm_grad_decoupling():
    v = np.random.RandomState(0).randn(3, 5).astype(np.float32)
    wn = rep.apply_weight_norm({"layer": {"kernel": torch.from_numpy(v)}})
    wn2 = {"layer": {"kernel": dict(wn["layer"]["kernel"])}}
    wn2["layer"]["kernel"]["v"] = wn["layer"]["kernel"]["v"] * 7.0
    r1, r2 = rep.reconstruct(wn), rep.reconstruct(wn2)
    torch.testing.assert_close(r1["layer"]["kernel"], r2["layer"]["kernel"],
                               rtol=0, atol=1e-4)
    jwn = jrep.apply_weight_norm({"layer": {"kernel": jnp.asarray(v)}})
    np.testing.assert_allclose(r1["layer"]["kernel"].numpy(),
                               np.asarray(jrep.reconstruct(jwn)["layer"]
                                          ["kernel"]), **TOL)


def test_weight_norm_inside_jit_and_grad():
    """The port's counterpart of JAX's jit-and-grad case: autograd
    through ``reconstruct`` reaches ``g`` and ``v``, equal to
    ``jax.grad``'s."""
    rng = np.random.RandomState(6)
    k = rng.randn(4, 2).astype(np.float32)
    x = rng.randn(3, 4).astype(np.float32)
    wn = rep.apply_weight_norm({"dense": {"kernel": torch.from_numpy(k),
                                          "bias": torch.zeros(2)}})
    leaves = [wn["dense"]["kernel"]["g"], wn["dense"]["kernel"]["v"]]
    for t in leaves:
        t.requires_grad_(True)
    w = rep.reconstruct(wn)
    loss = ((torch.from_numpy(x) @ w["dense"]["kernel"]
             + w["dense"]["bias"]) ** 2).sum()
    g_g, g_v = torch.autograd.grad(loss, leaves)
    assert g_g.shape == (4, 1)

    jwn = jrep.apply_weight_norm({"dense": {"kernel": jnp.asarray(k),
                                            "bias": jnp.zeros((2,))}})

    @jax.jit
    def jloss(p):
        w = jrep.reconstruct(p)
        return jnp.sum((jnp.asarray(x) @ w["dense"]["kernel"]
                        + w["dense"]["bias"]) ** 2)

    jg = jax.grad(jloss)(jwn)["dense"]["kernel"]
    np.testing.assert_allclose(g_g.numpy(), np.asarray(jg["g"]), **TOL)
    np.testing.assert_allclose(g_v.numpy(), np.asarray(jg["v"]),
                               rtol=1e-5, atol=1e-5)


# -- beyond the JAX file's cases ------------------------------------------------

def test_mlstm_weight_norm_gradients_through_functional_call():
    """The mLSTM with weight norm on its ``ih``/``hh`` weights, run with
    ``functional_call(model, reconstruct(p), x)``: the loss and the
    ``g``/``v`` gradients equal JAX's ``apply(reconstruct(p))``."""
    x = np.random.RandomState(7).randn(T, B, F).astype(np.float32)
    jm, variables, tm = _pair("mLSTM", x, num_layers=1)
    jwn = jrep.apply_weight_norm(_np(variables["params"]), name="layer0/i")
    jwn = jrep.apply_weight_norm(jwn, name="layer0/hh")

    def jloss(p):
        out, _ = jm.apply({"params": jrep.reconstruct(p)}, jnp.asarray(x))
        return jnp.sum(out ** 2)

    jval, jgrad = jax.value_and_grad(jloss)(jwn)
    # JAX's dim 0 of a kernel [in, out] is dim 1 of the weight [out, in]
    p = rep.apply_weight_norm(dict(tm.state_dict()), name="layer0/i", dim=1)
    p = rep.apply_weight_norm(p, name="layer0/hh", dim=1)
    assert set(k for k, v in p.items() if isinstance(v, dict)) == {
        "layer0.ih.weight", "layer0.hh.weight"}
    # the converted JAX tree is the port's tree
    conv = convert.rnn_params_from_jax(_np(jwn))
    for k, v in p.items():
        if isinstance(v, dict):
            assert conv[k]["__reparam__"] == v["__reparam__"]
            for part in ("g", "v"):
                np.testing.assert_allclose(v[part].numpy(),
                                           conv[k][part].numpy(), **TOL)
    leaves = {k: v for k, v in p.items() if isinstance(v, dict)}
    for v in leaves.values():
        v["g"].requires_grad_(True)
        v["v"].requires_grad_(True)
    out, _ = torch.func.functional_call(tm, rep.reconstruct(p),
                                        (torch.from_numpy(x),))
    loss = (out ** 2).sum()
    np.testing.assert_allclose(loss.item(), float(jval), rtol=1e-5)
    want = convert.rnn_params_from_jax(_np(jgrad))
    for k, v in leaves.items():
        g_g, g_v = torch.autograd.grad(loss, [v["g"], v["v"]],
                                       retain_graph=True)
        np.testing.assert_allclose(g_g.numpy(), want[k]["g"].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(g_v.numpy(), want[k]["v"].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", NAMES)
def test_rnn_params_round_trip(name):
    """``rnn_params_to_jax`` inverts ``rnn_params_from_jax`` on a
    bidirectional stack with a projection, and a weight-normed tree's
    markers come back as the JAX package's ``_Kind``."""
    x = np.zeros((T, B, F), np.float32)
    jm, variables, tm = _pair(name, x, num_layers=2, bidirectional=True,
                              output_size=6)
    back = convert.rnn_params_to_jax(tm.state_dict())
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(_np(variables["params"]))):
        np.testing.assert_array_equal(a, b)
    wn = rep.apply_weight_norm(dict(tm.state_dict()), dim=1)
    jback = convert.rnn_params_to_jax(wn, marker=jrep._Kind)
    jwn = jrep.apply_weight_norm(_np(variables["params"]))
    assert (jax.tree_util.tree_structure(jback)
            == jax.tree_util.tree_structure(jwn))
    for a, b in zip(jax.tree_util.tree_leaves(jback),
                    jax.tree_util.tree_leaves(jwn)):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)


def test_reparam_tree_round_trip():
    k = np.random.RandomState(8).randn(4, 6).astype(np.float32)
    jwn = jrep.apply_weight_norm({"dense": {"kernel": jnp.asarray(k)}},
                                 dim=1)
    port = convert.reparam_tree_from_jax(_np(jwn))
    assert port["dense"]["kernel"]["__reparam__"] == rep._Kind(
        "weight_norm", 1)
    np.testing.assert_allclose(rep.reconstruct(port)["dense"]["kernel"]
                               .numpy(), k, atol=1e-5)
    back = convert.reparam_tree_to_jax(port, marker=jrep._Kind)
    np.testing.assert_array_equal(back["dense"]["kernel"]["v"], k)
    assert back["dense"]["kernel"]["__reparam__"] == jrep._Kind(
        "weight_norm", 1)


def test_dropout_comes_from_the_generator():
    """Inter-layer dropout draws from the generator it is given: the
    same seed gives the same output, another seed another, evaluation
    none; training without a generator is refused."""
    x = torch.from_numpy(np.random.RandomState(9).randn(T, B, F)
                         .astype(np.float32))
    m = RNN.LSTM(F, H, 3, dropout=0.5, device="cpu")
    a = m(x, train=True, generator=torch.Generator().manual_seed(1))[0]
    b = m(x, train=True, generator=torch.Generator().manual_seed(1))[0]
    c = m(x, train=True, generator=torch.Generator().manual_seed(2))[0]
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    assert not torch.equal(a, m(x)[0])
    with pytest.raises(ValueError, match="generator"):
        m(x, train=True)


@pytest.mark.parametrize("name", NAMES)
def test_bf16_cells_match_jax(name):
    """dtype=bf16: the gate products in bf16, the state in fp32, against
    JAX's bf16 module to bf16's rounding."""
    x = np.random.RandomState(10).randn(T, B, F).astype(np.float32)
    jm = getattr(JRNN, name)(F, H, 2, dtype=jnp.bfloat16)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tm = getattr(RNN, name)(F, H, 2, dtype=torch.bfloat16, device="cpu")
    tm.load_state_dict(convert.rnn_params_from_jax(
        _np(variables["params"])))
    out, finals = tm(torch.from_numpy(x))
    assert finals[0][0].dtype == torch.float32
    jout, _ = jm.apply(variables, jnp.asarray(x))
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(jout, np.float32), atol=3e-2)
