"""``generate`` and the ``decode=True`` cache path of the port's GPT and
BERT attention against the JAX package's, on the same weights (flax
``gpt_tiny`` weights carried over by ``apex_tpu_torch.convert``).

* greedy ``generate`` tokens equal JAX's ``generate`` exactly, in every
  case of ``tests/test_gpt.py``'s greedy test (MHA, GQA, a window of 12
  generating past it);
* decode-step logits equal JAX's ``decode=True`` apply from the same
  converted weights and cache at rtol 1e-5, atol 1e-5, step by step,
  past the cache's end too (both clamp the write), and the caches after
  the steps equal JAX's;
* BERT's self-attention in decode mode, sampling (deterministic for a
  generator, inside the vocabulary), truncation at ``max_len`` and the
  ``sp_axis`` refusal (JAX's).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.models import bert as jbert
from apex_tpu.models import gpt_tiny as jgpt_tiny
from apex_tpu.models.gpt import generate as jgenerate
from apex_tpu_torch import convert
from apex_tpu_torch.models import (BertSelfAttention, GPT, generate,
                                   gpt_tiny, init_decode_cache)

TOL = dict(rtol=1e-5, atol=1e-5)
CASES = [{}, {"num_kv_heads": 2}, {"window": 12}]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(max_len=64, seed=1, **kw):
    jm = jgpt_tiny(max_len=max_len, **kw)
    prompt = np.random.RandomState(0).randint(1, 1024, (2, 5))
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(prompt))["params"]
    tm = gpt_tiny(max_len=max_len, device="cpu", **kw)
    tm.load_state_dict(convert.gpt_params_from_jax(_np(params)))
    return jm, params, tm, prompt


def _jax_cache(dec, b):
    shapes = jax.eval_shape(dec.init, jax.random.PRNGKey(0),
                            jnp.zeros((b, 1), jnp.int32))["cache"]
    return jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                  shapes)


@pytest.mark.parametrize("kw", CASES, ids=["mha", "gqa", "window"])
def test_generate_matches_jax_greedy(kw):
    jm, params, tm, prompt = _pair(**kw)
    want = np.asarray(jgenerate(jm, params, jnp.asarray(prompt),
                                max_new_tokens=25))
    got = generate(tm, tm, prompt, 25)
    assert got.dtype == torch.long and got.shape == (2, 30)
    np.testing.assert_array_equal(got.numpy(), want)
    # the weights as a mapping, through functional_call: the same tokens
    by_params = generate(tm, dict(tm.state_dict()), torch.from_numpy(prompt),
                         25)
    np.testing.assert_array_equal(by_params.numpy(), want)
    assert not tm.decode        # generate's decode twin was temporary


@pytest.mark.parametrize("kw", CASES, ids=["mha", "gqa", "window"])
def test_decode_steps_match_jax_apply(kw):
    """Twenty decode steps of a ``max_len`` 16 model, each token's logits
    against JAX's ``decode=True`` apply: positions 16-19 are past the
    cache, where both packages clamp the write to the last row and the
    position embedding to the last one."""
    jm, params, _, _ = _pair(max_len=16, **kw)
    dec = jm.clone(decode=True)
    tm = gpt_tiny(max_len=16, decode=True, device="cpu", **kw)
    tm.load_state_dict(convert.gpt_params_from_jax(_np(params)))
    jcache = _jax_cache(dec, 2)
    cache = init_decode_cache(tm, 2)
    assert cache["block_0"]["attention"]["cached_key"].shape == (
        2, 16, kw.get("num_kv_heads", 4), 32)
    toks = np.random.RandomState(3).randint(0, 1024, (20, 2))
    for t in range(20):
        jl, upd = dec.apply({"params": params, "cache": jcache},
                            jnp.asarray(toks[t][:, None]), mutable=["cache"])
        jcache = upd["cache"]
        with torch.no_grad():
            logits, out = tm(torch.from_numpy(toks[t][:, None]),
                             cache=cache)
        assert out is cache
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"step {t}")
    back = convert.gpt_decode_cache_to_jax(cache)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(back),
                            jax.tree_util.tree_leaves(jcache)):
        np.testing.assert_allclose(a, np.asarray(b), **TOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_decode_cache_from_jax_continues_jax_run():
    """A JAX decode cache after five steps, converted, continues in the
    port: the next step's logits and the cache written are JAX's."""
    jm, params, _, _ = _pair(max_len=32)
    dec = jm.clone(decode=True)
    tm = gpt_tiny(max_len=32, decode=True, device="cpu")
    tm.load_state_dict(convert.gpt_params_from_jax(_np(params)))
    jcache = _jax_cache(dec, 2)
    toks = np.random.RandomState(4).randint(0, 1024, (6, 2))
    for t in range(5):
        _, upd = dec.apply({"params": params, "cache": jcache},
                           jnp.asarray(toks[t][:, None]), mutable=["cache"])
        jcache = upd["cache"]
    cache = convert.gpt_decode_cache_from_jax(_np(jcache))
    assert int(cache["pos_index"]) == 5
    assert cache["block_1"]["attention"]["cache_index"].dtype == torch.long
    jl, upd = dec.apply({"params": params, "cache": jcache},
                        jnp.asarray(toks[5][:, None]), mutable=["cache"])
    with torch.no_grad():
        logits, _ = tm(torch.from_numpy(toks[5][:, None]), cache=cache)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    back = convert.gpt_decode_cache_to_jax(cache)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(upd["cache"])):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)
    # and the round trip is exact
    again = convert.gpt_decode_cache_from_jax(back)
    for a, b in zip(torch.utils._pytree.tree_leaves(again),
                    torch.utils._pytree.tree_leaves(cache)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kw", [{}, {"num_kv_heads": 1}, {"window": 3}],
                         ids=["mha", "gqa", "window"])
def test_bert_self_attention_decode_matches_jax(kw):
    """BERT's self-attention with ``decode=True`` (``cache_len`` 8,
    eleven steps, the last three past the cache) against the flax
    module's apply with its ``"cache"`` collection."""
    d, heads, b = 32, 2, 3
    rng = np.random.RandomState(5)
    jattn = jbert.BertSelfAttention(heads, causal=True, decode=True,
                                    cache_len=8, **kw)
    x0 = jnp.asarray(rng.randn(b, 1, d), jnp.float32)
    variables = jattn.init(jax.random.PRNGKey(2), x0)
    jcache = jax.tree_util.tree_map(jnp.zeros_like, variables["cache"])
    attn = BertSelfAttention(d, heads, causal=True, decode=True,
                             cache_len=8, device="cpu", **kw)
    attn.load_state_dict(convert.bert_params_from_jax(
        _np(variables["params"])))
    cache = attn.init_cache(b)
    for t in range(11):
        x = rng.randn(b, 1, d).astype(np.float32)
        jy, upd = jattn.apply({"params": variables["params"],
                               "cache": jcache}, jnp.asarray(x),
                              mutable=["cache"])
        jcache = upd["cache"]
        with torch.no_grad():
            y = attn(torch.from_numpy(x), cache=cache)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL,
                                   err_msg=f"step {t}")
    assert int(cache["cache_index"]) == int(jcache["cache_index"]) == 11
    np.testing.assert_allclose(cache["cached_key"].numpy(),
                               np.asarray(jcache["cached_key"]), **TOL)


def test_decode_checks():
    """JAX's checks: one token a call, causal only, no padding mask, and
    the cache is the decode step's."""
    attn = BertSelfAttention(32, 2, causal=True, decode=True, cache_len=4,
                             device="cpu")
    cache = attn.init_cache(2)
    with pytest.raises(ValueError, match="ONE token"):
        attn(torch.zeros(2, 2, 32), cache=cache)
    with pytest.raises(ValueError, match="padding mask"):
        attn(torch.zeros(2, 1, 32), torch.ones(2, 4), cache=cache)
    with pytest.raises(ValueError, match="causal"):
        BertSelfAttention(32, 2, decode=True, cache_len=4,
                          device="cpu")(torch.zeros(2, 1, 32), cache=cache)
    with pytest.raises(ValueError, match="init_cache"):
        attn(torch.zeros(2, 1, 32))
    m = gpt_tiny(max_len=16, decode=True, device="cpu")
    with pytest.raises(ValueError, match="ONE token"):
        m(torch.zeros((2, 3), dtype=torch.long),
          cache=init_decode_cache(m, 2))
    with pytest.raises(ValueError, match="init_decode_cache"):
        m(torch.zeros((2, 1), dtype=torch.long))
    with pytest.raises(ValueError, match="decode=True"):
        gpt_tiny(max_len=16, device="cpu")(
            torch.zeros((2, 1), dtype=torch.long),
            cache=init_decode_cache(m, 2))


def test_generate_sampling_and_truncation():
    jm, params, tm, _ = _pair(max_len=16)
    prompt = np.random.RandomState(0).randint(1, 1024, (1, 4))
    out = generate(tm, tm, prompt, 100)
    assert out.shape == (1, 16)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jgenerate(
        jm, params, jnp.asarray(prompt), max_new_tokens=100)))
    a = generate(tm, tm, prompt, 8, temperature=1.0,
                 generator=torch.Generator().manual_seed(7))
    b = generate(tm, tm, prompt, 8, temperature=1.0,
                 generator=torch.Generator().manual_seed(7))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert a.shape == (1, 12)
    assert int(a.min()) >= 0 and int(a.max()) < 1024
    np.testing.assert_array_equal(a[:, :4].numpy(), prompt)
    seeds = {tuple(generate(tm, tm, prompt, 8, temperature=1.0,
                            generator=torch.Generator().manual_seed(s))
                   [0].tolist()) for s in range(4)}
    assert len(seeds) > 1          # the generator does choose the tokens
    # no generator: one seeded 0 on the model's device, deterministic
    torch.testing.assert_close(generate(tm, tm, prompt, 8, temperature=1.0),
                               generate(tm, tm, prompt, 8, temperature=1.0),
                               rtol=0, atol=0)


def test_generate_rejects_sp_models():
    """A model built for sequence parallelism (``sp_axis``, ported) is
    refused by ``generate``, as JAX's refuses it
    (``apex_tpu/models/gpt.py:220-222``)."""
    sp = GPT(vocab_size=64, hidden_size=32, num_layers=1, num_heads=2,
             mlp_dim=64, max_len=16, attention_impl="ring", sp_axis="sp",
             device="cpu")
    with pytest.raises(ValueError, match="without sp_axis"):
        generate(sp, sp, np.ones((1, 2), np.int64), 4)
    m = gpt_tiny(max_len=16, device="cpu")
    m.sp_axis = "sp"          # as a model built for sequence parallelism
    with pytest.raises(ValueError, match="without sp_axis"):
        generate(m, m, np.ones((1, 2), np.int64), 4)
