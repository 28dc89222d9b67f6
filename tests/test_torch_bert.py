"""The port's BERT against the JAX package's, on the same weights.

``bert_tiny`` weights (random numpy in the flax tree's shapes) carried
into the port through ``apex_tpu_torch.convert``: the encoder's logits
and fp32 features with the ``full``, ``blockwise`` and ``flash``
attention impls, with and without a padding mask, at fp32 (atol 1e-4:
summation order through two layers) and bf16 (atol 5e-2: bf16
activations, each package rounding its own matmuls); ``BertSelfAttention
(attention_impl="blockwise")`` with a mask and grouped KV heads (atol
1e-5); the JAX package's BERT step (``bench.py``: the tied fp32 head,
smoothing 0.1, ``padding_idx=-1``) at O2 for three steps with the
bucketed LAMB and the bucketed Adam (losses rtol 2e-2, parameters within
2e-2 and a tenth of the learning rate: bf16 activations, Adam's and
LAMB's per-element normalisation); the conversions; and the refusals of
``sp_axis`` and ``ring``.  The CPU runs the kernels' plain versions;
``chip_smoke.py`` runs BERT-base on the card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu import training as jtraining
from apex_tpu.contrib.xentropy import \
    softmax_cross_entropy_loss as jax_xentropy
from apex_tpu.models import bert as jbert
from apex_tpu_torch import training
from apex_tpu_torch.contrib.xentropy import softmax_cross_entropy_loss
from apex_tpu_torch.convert import (bert_params_from_jax, bert_params_to_jax,
                                    train_state_from_jax)
from apex_tpu_torch.models import BertSelfAttention, bert_tiny
from apex_tpu_torch.multi_tensor import Packed

CFG = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
           mlp_dim=64, max_len=16)


def _random_params(module, *args, seed=0, **kw):
    """A flax parameter tree in ``module``'s shapes, random numpy (flax's
    own init is slow on the CPU): LayerNorm scales near one."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args,
                            **kw)["params"]
    rng = np.random.RandomState(seed)

    def one(path, x):
        base = 1.0 if path[-1].key == "scale" else 0.0
        return jnp.asarray(base + 0.2 * rng.randn(*x.shape).astype(
            np.float32))
    return jax.tree_util.tree_map_with_path(one, shapes)


def _ids(seed, b=2, t=12):
    return np.random.RandomState(seed).randint(0, 128, (b, t))


def _mask(b=2, t=12):
    mask = np.ones((b, t), bool)
    mask[1, 7:] = False
    return mask


@pytest.fixture(scope="module")
def params():
    return _random_params(jbert.bert_tiny(**CFG), jnp.zeros((1, 4),
                                                            jnp.int32))


def _port(params, **kw):
    tm = bert_tiny(**CFG, device="cpu", **kw)
    tm.load_state_dict(bert_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return tm


def test_convert_round_trip_names_and_shapes(params):
    tm = _port(params)
    sd = tm.state_dict()
    assert len(jax.tree_util.tree_leaves(params)) == len(sd)
    back = bert_params_to_jax(sd)
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    assert tuple(sd["word_embeddings.embedding"].shape) == (128, 32)
    assert tuple(sd["layer_1.intermediate.kernel"].shape) == (32, 64)
    assert tuple(sd["layer_0.attention.out.kernel"].shape) == (2, 16, 32)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("impl", ["full", "blockwise", "flash"])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 5e-2)],
                         ids=["fp32", "bf16"])
def test_forward_matches_jax(params, impl, masked, dtype, atol):
    """Logits (the pooler and classifier) and fp32 features."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ids = _ids(1)
    mask = _mask() if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    for num_classes in (2, None):
        jm = jbert.bert_tiny(**CFG, dtype=jdt, attention_impl=impl,
                             num_classes=num_classes)
        p = params if num_classes else {k: v for k, v in params.items()
                                        if k not in ("pooler",
                                                     "classifier")}
        want = jm.apply({"params": p}, jnp.asarray(ids), jmask)
        tm = _port(p, dtype=dtype, attention_impl=impl,
                   num_classes=num_classes)
        with torch.no_grad():
            got = tm(torch.from_numpy(ids), tmask)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=atol, rtol=atol)


def test_blockwise_self_attention_matches_jax():
    """``attention_impl="blockwise"`` reaches the port's
    ``blockwise_attention`` with the padding bias, as in JAX; grouped KV
    heads repeated as in JAX."""
    jm = jbert.BertSelfAttention(num_heads=4, num_kv_heads=2,
                                 attention_impl="blockwise")
    x = np.random.RandomState(2).randn(2, 12, 32).astype(np.float32)
    p = _random_params(jm, jnp.asarray(x), seed=3)
    mask = _mask()
    want = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(mask))
    tm = BertSelfAttention(32, 4, num_kv_heads=2,
                           attention_impl="blockwise", device="cpu")
    tm.load_state_dict(bert_params_from_jax(
        jax.tree_util.tree_map(np.asarray, p)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def _jax_loss(jm):
    def loss_fn(p, batch):
        ids, labels = batch
        feats = jm.apply({"params": p}, ids)
        logits = feats @ p["word_embeddings"]["embedding"].T
        losses = jax_xentropy(logits.reshape(-1, logits.shape[-1]),
                              labels.reshape(-1), smoothing=0.1,
                              padding_idx=-1)
        return jnp.mean(losses)
    return loss_fn


def _port_loss(tm):
    def loss_fn(p, batch):
        ids, labels = batch
        feats = torch.func.functional_call(tm, p, (ids,))
        logits = feats @ p["word_embeddings.embedding"].float().T
        return softmax_cross_entropy_loss(
            logits.reshape(-1, logits.shape[-1]), labels.reshape(-1),
            smoothing=0.1, padding_idx=-1).mean()
    return loss_fn


@pytest.mark.parametrize("opt,lr", [("lamb", 1e-3), ("adam", 1e-4)])
def test_o2_bert_step_bucketed_matches_jax(params, opt, lr):
    """The JAX package's BERT step at O2 (bf16 compute, fp32 masters),
    three steps with the bucketed optimizer in both packages: the losses,
    the parameters and the Packed moments, bucket for bucket."""
    p = {k: v for k, v in params.items()
         if k not in ("pooler", "classifier")}
    jm = jbert.bert_tiny(**CFG, dtype=jnp.bfloat16, num_classes=None,
                         attention_impl="flash")
    tm = _port(p, dtype=torch.bfloat16, num_classes=None,
               attention_impl="flash")
    jinit, jstep = jtraining.make_train_step(
        _jax_loss(jm), getattr(jtraining, opt)(lr, bucketed=True),
        opt_level="O2")
    init, step = training.make_train_step(
        _port_loss(tm), getattr(training, opt)(lr, bucketed=True),
        opt_level="O2")
    jst, jstep = jinit(p), jax.jit(jstep)
    st = init(tm.state_dict())
    assert isinstance(st.opt_state.exp_avg, Packed)
    rng = np.random.RandomState(5)
    for i in range(3):
        ids, labels = rng.randint(0, 128, (2, 2, 12))
        jst, jmet = jstep(jst, (jnp.asarray(ids), jnp.asarray(labels)))
        st, met = step(st, (torch.from_numpy(ids), torch.from_numpy(labels)))
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=2e-2, err_msg=f"step {i}")
    want = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jst))
    assert all(v.dtype == torch.float32 for v in st.params.values())
    for k, v in st.params.items():
        np.testing.assert_allclose(v.numpy(), want.params[k].numpy(),
                                   rtol=2e-2, atol=max(2e-2, 0.1 * lr),
                                   err_msg=k)
    for a, b in zip(st.opt_state.exp_avg.data, want.opt_state.exp_avg.data):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-2)
    assert int(st.opt_state.step) == 3


def test_not_ported_paths_raise():
    with pytest.raises(NotImplementedError, match="sp_axis"):
        bert_tiny(sp_axis="sp", device="cpu")
    with pytest.raises(NotImplementedError, match="ring"):
        bert_tiny(attention_impl="ring", device="cpu")
    with pytest.raises(NotImplementedError, match="ulysses"):
        BertSelfAttention(32, 2, attention_impl="ulysses", device="cpu")
    with pytest.raises(ValueError, match="unknown attention_impl"):
        BertSelfAttention(32, 2, attention_impl="sparse", device="cpu")
