"""The port's flat-bucket engine (``apex_tpu_torch.multi_tensor.buckets``)
against the JAX package's, from ``tests/test_buckets.py``.

Round trips (bit for bit), buckets keyed by dtype and decay flag and cut
by ``max_bucket_elems``, per-leaf sums and maxima (rtol 1e-5, fp32
summation order), overflow flags through buckets, and the bucket layout
of a converted flax tree equal to the JAX store's, buffer for buffer.
The optimizers: the bucketed Adam and SGD equal the leafwise ones bit
for bit over 100 steps with skipped steps and a non-unit ``grad_scale``;
LAMB and NovoGrad within JAX's own tolerance for them (rtol 5e-5, atol
5e-6: the per-leaf sums add in another order); each against JAX's
bucketed update on the same numpy inputs (Adam and SGD rtol 1e-5 and
atol 1e-6, LAMB and NovoGrad the same as above).  Then ``unscale(
store=)``, and ``make_train_step`` through ``StepPipeline`` (K 3 with a
ragged tail) with a ``Packed`` Adam state, against JAX's pipeline, a
JAX bucketed state continued in the port, ``accum_steps=2`` with a
skipped step and the ImageNet trainer's ``--bucketed``, each bit for
bit its leafwise form.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu import runtime as jruntime
from apex_tpu import training as jtraining
from apex_tpu.amp.loss_scaler import LossScaler as JLossScaler
from apex_tpu.models import gpt_tiny as jgpt_tiny
from apex_tpu.multi_tensor import BucketStore as JBucketStore
from apex_tpu.optimizers import functional as jF
from apex_tpu_torch import runtime, training
from apex_tpu_torch.amp import LossScaler, all_finite
from apex_tpu_torch.convert import gpt_params_from_jax, train_state_from_jax
from apex_tpu_torch.models import gpt_tiny
from apex_tpu_torch.multi_tensor import (BucketStore, Packed,
                                         multi_tensor_axpby,
                                         multi_tensor_l2norm,
                                         multi_tensor_scale, tree_finite)
from apex_tpu_torch.optimizers import functional as F

SHAPES = ((7,), (3, 5), (64,), (1,))


def _np_tree(seed, shapes=SHAPES):
    rng = np.random.RandomState(seed)
    return {f"p{i}": rng.randn(*s).astype(np.float32)
            for i, s in enumerate(shapes)}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _mixed():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "nest": {"bf": torch.arange(7, dtype=torch.float32).bfloat16(),
                     "scalar": torch.tensor(3.5),
                     "ints": torch.arange(5, dtype=torch.int32),
                     "flag": torch.tensor(True)},
            "list": [torch.ones(2, 2), torch.zeros(3, dtype=torch.bfloat16)]}


# -- pack / unpack -----------------------------------------------------------------

def test_roundtrip_preserves_dtypes_shapes_values_exactly():
    tree = _mixed()
    store = BucketStore(tree)
    back = store.unpack(store.pack(tree))
    leaves = torch.utils._pytree.tree_leaves(tree)
    got = torch.utils._pytree.tree_leaves(back)
    assert len(got) == len(leaves)
    for orig, new in zip(leaves, got):
        assert orig.shape == new.shape and orig.dtype == new.dtype
        assert torch.equal(orig, new)


def test_buckets_are_keyed_per_dtype_and_rest_passes_through():
    store = BucketStore(_mixed())
    assert store.n_buckets == 2
    assert set(store.dtypes) == {torch.float32, torch.bfloat16}
    assert len(store.pack(_mixed()).rest) == 2


def test_scalar_and_empty_trees():
    s = BucketStore({"x": torch.tensor(2.0)})
    p = s.pack({"x": torch.tensor(2.0)})
    assert p.data[0].shape == (1,)
    assert float(s.unpack(p)["x"]) == 2.0
    empty = BucketStore({})
    assert empty.n_buckets == 0 and bool(tree_finite({}, store=empty))
    nofloat = BucketStore({"i": torch.arange(3)})
    packed = nofloat.pack({"i": torch.arange(3)})
    assert packed.data == () and len(packed.rest) == 1
    assert torch.equal(nofloat.unpack(packed)["i"], torch.arange(3))


def test_pack_rejects_structure_and_dtype_mismatch():
    store = BucketStore({"a": torch.ones(3)})
    with pytest.raises(ValueError, match="structure"):
        store.pack({"b": torch.ones(3)})
    with pytest.raises(ValueError, match="dtype"):
        store.pack({"a": torch.ones(3, dtype=torch.bfloat16)})
    out = store.pack({"a": torch.ones(3, dtype=torch.bfloat16)}, cast=True)
    assert out.data[0].dtype == torch.float32
    out = store.pack({"a": torch.ones(3)}, dtype=torch.bfloat16)
    assert out.data[0].dtype == torch.bfloat16


def test_view_returns_each_leaf_in_the_stores_order():
    tree = _t(_np_tree(0, SHAPES * 3))      # p10, p11 sort before p2
    store = BucketStore(tree)
    packed = store.pack(tree)
    names = sorted(tree)
    for i in store.leaf_order():
        assert torch.equal(store.view(packed, i), tree[names[i]])
    assert [names[i] for i in store.tree_order()] == list(tree)


@pytest.mark.parametrize("kw", [
    dict(decay_mask={"w": True, "b": False, "c": True}),
    dict(max_bucket_elems=5), dict(max_bucket_elems=1)],
    ids=["decay_mask", "max5", "max1"])
def test_bucket_layout_equals_jax(kw):
    """``decay_mask`` splits the no-decay leaves out; ``max_bucket_elems``
    cuts a key's bucket in leaf order, a larger leaf alone: the same
    buckets, flags and sizes as JAX's store, and the same buffers."""
    tree = {"w": np.ones((4,), np.float32), "b": np.arange(2, dtype=
                                                            np.float32),
            "c": np.full((3, 2), 2.0, np.float32)}
    ts, js = BucketStore(_t(tree), **kw), JBucketStore(_j(tree), **kw)
    assert ts.decay_flags == js.decay_flags and ts.sizes == js.sizes
    for a, b in zip(ts.pack(_t(tree)).data, js.pack(_j(tree)).data):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert ts.reverse_topological_order() == js.reverse_topological_order()
    assert ts.shard_layout(3) == js.shard_layout(3)


def test_converted_flax_tree_packs_as_jax_packs_it():
    """gpt_tiny's flax parameters and the port's ``state_dict`` of them
    (module order, dotted names, ``block_10`` after ``block_1``): the
    two stores lay out the same buckets and pack the same bytes, so a
    ``Packed`` buffer crosses ``convert`` unchanged."""
    jm = jgpt_tiny(vocab_size=64, hidden_size=16, num_layers=11,
                   num_heads=2, mlp_dim=32, max_len=16)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 4), jnp.int32))["params"]
    rng = np.random.RandomState(1)
    jparams = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.randn(*x.shape).astype(np.float32)),
        shapes)
    sd = gpt_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    mask = {k: not k.endswith("bias") for k in sd}
    jmask = jax.tree_util.tree_map_with_path(
        lambda p, _: p[-1].key != "bias", jparams)
    for kw, jkw in ((dict(), dict()),
                    (dict(decay_mask=mask), dict(decay_mask=jmask)),
                    (dict(max_bucket_elems=600),
                     dict(max_bucket_elems=600))):
        ts, js = BucketStore(sd, **kw), JBucketStore(jparams, **jkw)
        assert ts.sizes == js.sizes and ts.decay_flags == js.decay_flags
        for a, b in zip(ts.pack(sd).data, js.pack(jparams).data):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# -- per-leaf reductions and overflow flags ---------------------------------------

def test_per_leaf_sums_and_max_abs_match_leafwise():
    tree = _t(_np_tree(2))
    store = BucketStore(tree)
    packed = store.pack(tree)
    names = sorted(tree)
    (sums,), (maxes,) = (store.per_leaf_sq_sums(packed.data),
                         store.per_leaf_max_abs(packed.data))
    for pos, i in enumerate(store.buckets[0].leaf_ids):
        x = tree[names[i]]
        np.testing.assert_allclose(float(sums[pos]), float(x.square().sum()),
                                   rtol=1e-5)
        assert float(maxes[pos]) == float(x.abs().max())
    seg = store.segment_ids(0)
    assert seg.dtype == torch.int32 and seg.shape == (store.sizes[0],)
    spread = store.spread(0, torch.arange(4, dtype=torch.float32))
    assert torch.equal(spread, seg.float())


@pytest.mark.parametrize("bad", [np.inf, -np.inf, np.nan])
@pytest.mark.parametrize("where", ["first", "last"])
def test_nan_inf_propagate_through_bucketed_flags(bad, where):
    x = np.ones((37,), np.float32)
    x[0 if where == "first" else -1] = bad
    tree = {"ok": torch.ones(5), "bad": torch.from_numpy(x),
            "bf": torch.ones(3, dtype=torch.bfloat16)}
    store = BucketStore(tree)
    assert not bool(tree_finite(tree, store=store))
    assert not bool(all_finite(store.pack(tree)))
    assert bool(multi_tensor_scale(tree, 1.0, store=store)[1])
    zeros = {k: torch.zeros_like(v) for k, v in tree.items()}
    assert bool(multi_tensor_axpby(tree, zeros, 1.0, 1.0, store=store)[1])


def test_bucketed_sweeps_match_leafwise_and_packed_stays_packed():
    tree = _t(_np_tree(3))
    store = BucketStore(tree)
    out_l, ov_l = multi_tensor_scale(tree, 0.25)
    out_b, ov_b = multi_tensor_scale(tree, 0.25, store=store)
    for k in tree:
        assert torch.equal(out_l[k], out_b[k])
    assert bool(ov_l) == bool(ov_b) is False
    gl, pl = multi_tensor_l2norm(tree, per_tensor=True)
    gb, pb = multi_tensor_l2norm(tree, per_tensor=True, store=store)
    np.testing.assert_allclose(float(gl), float(gb), rtol=1e-6)
    np.testing.assert_allclose(torch.stack(pl).numpy(),
                               torch.stack(pb).numpy(), rtol=1e-5)
    packed = store.pack(tree)
    out, overflow = multi_tensor_scale(packed, 2.0)
    assert isinstance(out, Packed) and not bool(overflow)
    assert torch.equal(out.data[0], 2 * packed.data[0])


def test_unscale_with_store_matches_leafwise_and_jax():
    """``unscale(store=)`` on a dynamic scaler: the same fp32 gradients
    as the leafwise sweep and as JAX's, the overflow flag raised by an
    inf in either form, and a ``Packed`` input kept packed."""
    grads = _np_tree(4)
    scaler, jscaler = LossScaler("dynamic"), JLossScaler("dynamic")
    state = scaler.init()
    store = BucketStore(_t(grads))
    leaf, s1 = scaler.unscale(_t(grads), state)
    buck, s2 = scaler.unscale(_t(grads), state, store=store)
    jout, _ = jscaler.unscale(_j(grads), jscaler.init())
    for k in grads:
        assert torch.equal(leaf[k], buck[k])
        np.testing.assert_allclose(buck[k].numpy(), np.asarray(jout[k]),
                                   rtol=1e-7)
    assert not bool(s1.overflow) and not bool(s2.overflow)
    packed, s3 = scaler.unscale(store.pack(_t(grads)), state)
    assert isinstance(packed, Packed) and not bool(s3.overflow)
    bad = dict(grads, p1=np.full((3, 5), np.inf, np.float32))
    assert bool(scaler.unscale(_t(bad), state, store=store)[1].overflow)


# -- the optimizers: bucketed against leafwise, and against JAX --------------------

def _grads(rng, params):
    return {k: rng.randn(*v.shape).astype(np.float32)
            for k, v in params.items()}


def _run(update, init, params, steps, seed, skip_every, store=None,
         to=_t, **kw):
    """``steps`` updates from ``init(params)`` on seeded gradients, every
    ``skip_every``-th step masked out; ``to`` makes tensors (torch or
    JAX)."""
    rng = np.random.RandomState(seed)
    p = to(params)
    st = init(p) if store is None else init(p, store=store)
    for i in range(steps):
        mask = (None if skip_every is None
                else (torch.tensor(i % skip_every != 0) if to is _t
                      else jnp.asarray(i % skip_every != 0)))
        extra = {} if store is None else dict(store=store)
        p, st = update(to(_grads(rng, params)), st, p, apply_mask=mask,
                       **extra, **kw)
    return p, st


OPTIMIZERS = {
    "adam": (F.adam_init, F.adam_update, jF.adam_init, jF.adam_update,
             dict(lr=1e-2, weight_decay=0.01), 9, True),
    "adam_l2": (F.adam_init, F.adam_update, jF.adam_init, jF.adam_update,
                dict(lr=1e-2, weight_decay=0.01, adam_w_mode=False), 9,
                True),
    "sgd": (functools.partial(F.sgd_init, momentum=0.9), F.sgd_update,
            functools.partial(jF.sgd_init, momentum=0.9), jF.sgd_update,
            dict(lr=0.1, momentum=0.9, nesterov=True, weight_decay=1e-2),
            7, True),
    "lamb": (F.lamb_init, F.lamb_update, jF.lamb_init, jF.lamb_update,
             dict(lr=1e-2, weight_decay=0.01), 11, False),
    "novograd": (F.novograd_init, F.novograd_update, jF.novograd_init,
                 jF.novograd_update, dict(lr=1e-2, weight_decay=0.01), 11,
                 False),
    "novograd_inf": (F.novograd_init, F.novograd_update, jF.novograd_init,
                     jF.novograd_update,
                     dict(lr=1e-2, norm_type=float("inf"),
                          bias_correction=True), None, False),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_bucketed_update_against_leafwise_and_jax(name):
    """100 steps (with periodic skips where the case has them; Adam with
    ``grad_scale`` 4.0): bucketed = leafwise bit for bit for the
    elementwise optimizers, within rtol 5e-5 / atol 5e-6 for LAMB and
    NovoGrad; and the bucketed update against JAX's bucketed update."""
    init, update, jinit, jupdate, kw, skip, exact = OPTIMIZERS[name]
    if name == "adam":
        kw = dict(kw, grad_scale=torch.tensor(4.0))
    params = _np_tree(5)
    store = BucketStore(_t(params))
    p_l, st_l = _run(update, init, params, 100, 6, skip, **kw)
    p_b, st_b = _run(update, init, params, 100, 6, skip, store=store, **kw)
    for k in params:
        if exact:
            assert torch.equal(p_l[k], p_b[k]), k
        else:
            np.testing.assert_allclose(p_b[k].numpy(), p_l[k].numpy(),
                                       rtol=5e-5, atol=5e-6, err_msg=k)
    if hasattr(st_b, "exp_avg"):
        assert isinstance(st_b.exp_avg, Packed)
        m_b = store.unpack(st_b.exp_avg._replace(rest=()))
        for k in params:
            assert (torch.equal(st_l.exp_avg[k], m_b[k]) if exact else
                    np.allclose(st_l.exp_avg[k], m_b[k], 5e-5, 5e-6)), k
    jkw = {k: (jnp.float32(4.0) if k == "grad_scale" else v)
           for k, v in kw.items()}
    jstore = JBucketStore(_j(params))
    jp, _ = _run(jupdate, jinit, params, 100, 6, skip, store=jstore, to=_j,
                 **jkw)
    tol = dict(rtol=1e-5, atol=1e-6) if exact else dict(rtol=5e-5,
                                                        atol=5e-6)
    for k in params:
        np.testing.assert_allclose(p_b[k].numpy(), np.asarray(jp[k]),
                                   err_msg=k, **tol)


def test_bucketed_adam_bf16_params_close_to_leafwise():
    params = {k: torch.from_numpy(v).bfloat16()
              for k, v in _np_tree(11).items()}
    store = BucketStore(params)
    st_l, st_b = F.adam_init(params), F.adam_init(params, store=store)
    p_l = p_b = params
    rng = np.random.RandomState(12)
    for _ in range(10):
        g = {k: torch.from_numpy(rng.randn(*v.shape).astype(
            np.float32)).bfloat16() for k, v in params.items()}
        p_l, st_l = F.adam_update(g, st_l, p_l, lr=1e-2)
        p_b, st_b = F.adam_update(g, st_b, p_b, lr=1e-2, store=store)
    for k in params:
        assert p_b[k].dtype == torch.bfloat16
        assert torch.equal(p_l[k], p_b[k]), k


def test_packed_params_stay_packed():
    params = _t(_np_tree(13))
    store = BucketStore(params)
    packed = store.pack(params)
    st = F.sgd_init(params, 0.9, store=store)
    g = _t(_grads(np.random.RandomState(14), _np_tree(13)))
    out, st = F.sgd_update(g, st, packed, lr=0.1, momentum=0.9, store=store)
    want, _ = F.sgd_update(g, F.sgd_init(params, 0.9), params, lr=0.1,
                           momentum=0.9)
    assert isinstance(out, Packed) and isinstance(st.momentum_buf, Packed)
    for k, v in store.unpack(out).items():
        assert torch.equal(v, want[k])


# -- the training step and the pipeline with a Packed state -----------------------

CFG = dict(vocab_size=96, hidden_size=32, num_layers=1, num_heads=2,
           mlp_dim=64, max_len=32)


def _models():
    """gpt_tiny in both packages on the same random weights (flax's own
    init is slow on the CPU; only its tree's shapes are taken)."""
    jm = jgpt_tiny(**CFG)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 4), jnp.int32))["params"]
    rng = np.random.RandomState(3)
    jparams = jax.tree_util.tree_map(
        lambda x: jnp.asarray(0.1 * rng.randn(*x.shape).astype(np.float32)),
        shapes)
    tm = gpt_tiny(**CFG, device="cpu")
    tm.load_state_dict(gpt_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams)))
    return jm, jparams, tm


def _gpt_pipeline_pair():
    """gpt_tiny at O0 with a bucketed Adam in both packages, the loss
    multiplied by the batch's third leaf (inf makes a step overflow)."""
    jm, jparams, tm = _models()

    def jloss(p, batch):
        x, y, mult = batch
        logp = jax.nn.log_softmax(jm.apply({"params": p}, x), axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, y[..., None],
                                             axis=-1)) * mult

    def tloss(p, batch):
        x, y, mult = batch
        logp = torch.log_softmax(
            torch.func.functional_call(tm, p, (x,)), dim=-1)
        return -logp.gather(-1, y[..., None]).mean() * mult

    kw = dict(opt_level="O0", loss_scale="dynamic")
    jinit, jstep = jtraining.make_train_step(
        jloss, jtraining.adam(1e-3, weight_decay=0.1, bucketed=True), **kw)
    init, step = training.make_train_step(
        tloss, training.adam(1e-3, weight_decay=0.1, bucketed=True), **kw)
    rng = np.random.RandomState(7)
    batches = []
    for i in range(8):
        b = rng.randint(1, 96, (4, 13))
        batches.append((b[:, :-1], b[:, 1:],
                        np.float32(np.inf if i == 1 else 1.0)))
    return ((jinit(jparams), jstep), (lambda: init(tm.state_dict()), step),
            batches)


def _pipeline(rt, step, state, batches, k, to):
    seen = []
    state, _ = rt.StepPipeline(step, k=k).run(
        state, rt.window_batches(iter(batches), k, transform=to),
        on_metrics=lambda wm: seen.append((wm.n_valid, wm.fetch())))
    return state, np.concatenate([np.ravel(np.asarray(m["loss"]))[:n]
                                  for n, m in seen])


def test_pipeline_with_packed_state_matches_jax():
    """K 3 over 8 batches (two windows and a ragged tail of two), an inf
    at step 1 skipped: the same losses as JAX's pipeline (rtol 1e-5), the
    Packed moments bucket for bucket and the parameters within Adam's
    rounding (rtol 1e-5, atol 1e-4: a tenth of lr; the key projection's
    bias, whose gradient is zero in exact arithmetic, within the seven
    applied steps' bound 7 lr); the port's state equal bit for bit to
    eight single steps."""
    (jst, jstep), (init, step), batches = _gpt_pipeline_pair()
    jstate, jloss = _pipeline(
        jruntime, jstep, jst, batches, 3,
        lambda b: (jnp.asarray(b[0], jnp.int32), jnp.asarray(b[1], jnp.int32),
                   jnp.asarray(b[2])))
    to_t = (lambda b: (torch.from_numpy(b[0]), torch.from_numpy(b[1]),
                       torch.tensor(b[2])))
    state, loss = _pipeline(runtime, step, init(), batches, 3, to_t)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    assert isinstance(state.opt_state.exp_avg, Packed)
    assert int(state.opt_state.step) == 7
    want = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate))
    for name in ("exp_avg", "exp_avg_sq"):
        for a, b in zip(getattr(state.opt_state, name).data,
                        getattr(want.opt_state, name).data):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-6)
    start = init().params
    for k, v in state.params.items():
        if k.endswith("attention.key.bias"):
            assert float((v - start[k]).abs().max()) <= 7e-3 * 1.01, k
            continue
        np.testing.assert_allclose(v.numpy(), want.params[k].numpy(),
                                   rtol=1e-5, atol=1e-4, err_msg=k)
    ref = init()
    for b in batches:
        ref, _ = step(ref, to_t(b))
    for g, w in zip(torch.utils._pytree.tree_leaves(state),
                    torch.utils._pytree.tree_leaves(ref)):
        assert torch.equal(g, w) if isinstance(w, torch.Tensor) else g == w


@pytest.mark.parametrize("tx", ["adam", "novograd"])
def test_port_continues_a_jax_bucketed_train_state(tx):
    """A JAX state after two bucketed steps (Adam's Packed moments,
    NovoGrad's per-tensor vectors) carried into the port: one more step
    in each package gives the same loss and parameters."""
    jm, jparams, tm = _models()
    rng = np.random.RandomState(8)
    batches = [(b[:, :-1], b[:, 1:])
               for b in (rng.randint(1, 96, (4, 13)) for _ in range(3))]

    def jloss(p, batch):
        logp = jax.nn.log_softmax(jm.apply({"params": p}, batch[0]), -1)
        return -jnp.mean(jnp.take_along_axis(logp, batch[1][..., None], -1))

    def tloss(p, batch):
        logp = torch.log_softmax(
            torch.func.functional_call(tm, p, (batch[0],)), dim=-1)
        return -logp.gather(-1, batch[1][..., None]).mean()

    make = {"adam": (jtraining.adam, training.adam),
            "novograd": (jtraining.novograd, training.novograd)}[tx]
    jinit, jstep = jtraining.make_train_step(
        jloss, make[0](1e-3, bucketed=True), opt_level="O0")
    _, step = training.make_train_step(
        tloss, make[1](1e-3, bucketed=True), opt_level="O0")
    jstep = jax.jit(jstep)
    jst = jinit(jparams)
    for b in batches[:2]:
        jst, _ = jstep(jst, (jnp.asarray(b[0]), jnp.asarray(b[1])))
    st = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jst))
    assert isinstance(st.opt_state.exp_avg_sq, Packed)
    x, y = batches[2]
    jst, jm_ = jstep(jst, (jnp.asarray(x), jnp.asarray(y)))
    st, m = step(st, (torch.from_numpy(x), torch.from_numpy(y)))
    np.testing.assert_allclose(float(m["loss"]), float(jm_["loss"]),
                               rtol=1e-5)
    want = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jst))
    for k, v in st.params.items():
        np.testing.assert_allclose(v.numpy(), want.params[k].numpy(),
                                   rtol=1e-5, atol=1e-4, err_msg=k)


def test_accum_steps_with_packed_state_equals_leafwise():
    """``accum_steps=2`` under a dynamic scale, an inf injected at the
    second step (skipped): the bucketed Adam's parameters and moments
    equal the leafwise Adam's bit for bit."""
    tm = _models()[2]

    def tloss(p, batch):
        x, y, mult = batch
        logp = torch.log_softmax(
            torch.func.functional_call(tm, p, (x,)), dim=-1)
        return -logp.gather(-1, y[..., None]).mean() * mult[0]

    states = []
    for bucketed in (False, True):
        init, step = training.make_train_step(
            tloss, training.adam(1e-3, weight_decay=0.1, bucketed=bucketed),
            opt_level="O0", loss_scale="dynamic", accum_steps=2)
        st = init(tm.state_dict())
        for i in range(3):
            b = np.random.RandomState(20 + i).randint(1, 96, (4, 13))
            st, m = step(st, (torch.from_numpy(b[:, :-1]),
                              torch.from_numpy(b[:, 1:]),
                              torch.full((4,), np.inf if i == 1 else 1.0)))
            assert bool(m["overflow"]) == (i == 1)
        states.append(st)
    leaf, buck = states
    store = BucketStore(buck.params)
    for k, v in leaf.params.items():
        assert torch.equal(v, buck.params[k]), k
    for name in ("exp_avg", "exp_avg_sq"):
        unpacked = store.unpack(getattr(buck.opt_state, name))
        for k, v in getattr(leaf.opt_state, name).items():
            assert torch.equal(v, unpacked[k]), (name, k)
    assert int(buck.opt_state.step) == 2


def test_imagenet_trainer_bucketed_equals_leafwise():
    """The ImageNet trainer with ``--bucketed`` (the SGD momentum in flat
    buckets) at a tiny size, two windows of two steps: every state leaf
    equal to the leafwise run's bit for bit, the momentum ``Packed``."""
    from apex_tpu_torch.examples.imagenet import main_amp as imagenet_main
    argv = ["--synthetic", "--device", "cpu", "--arch", "resnet18", "-b",
            "4", "--image-size", "32", "--prof", "4", "--steps-per-call",
            "2", "--opt-level", "O2"]
    quiet = dict(log=lambda line: None)
    leaf = imagenet_main.train(imagenet_main.parse(argv), **quiet)["state"]
    buck = imagenet_main.train(imagenet_main.parse(argv + ["--bucketed"]),
                               **quiet)["state"]
    assert isinstance(buck.opt_state.momentum_buf, Packed)
    momentum = BucketStore(buck.params).unpack(buck.opt_state.momentum_buf)
    for k, v in leaf.opt_state.momentum_buf.items():
        assert torch.equal(v, momentum[k]), k
    for tree in ("params", "model_state"):
        for k, v in getattr(leaf, tree).items():
            assert torch.equal(v, getattr(buck, tree)[k]), k
