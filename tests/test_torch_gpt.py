"""The port's GPT against the JAX package's, on the same weights.

``gpt_tiny`` weights made by flax are carried into the port through
``apex_tpu_torch.convert``; full-forward logits and a prefill followed by
three decode steps through external ``kv_caches`` must agree at 1e-4
(fp32, CPU: the plain versions of the kernels).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.models import gpt_tiny as jgpt_tiny
from apex_tpu.models.gpt import init_cache as jinit_cache
from apex_tpu_torch.convert import gpt_params_from_jax, gpt_params_to_jax
from apex_tpu_torch.models import GPT, gpt_tiny, init_cache

TOL = dict(atol=1e-4, rtol=1e-4)
CFG = dict(vocab_size=96, hidden_size=64, num_layers=2, num_heads=4,
           mlp_dim=128, max_len=32)


@pytest.fixture(scope="module")
def pair():
    jm = jgpt_tiny(**CFG)
    ids = jnp.asarray(np.random.RandomState(0).randint(0, 96, (2, 12)))
    params = jm.init(jax.random.PRNGKey(3), ids)["params"]
    tm = gpt_tiny(**CFG, device="cpu")
    tm.load_state_dict(gpt_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, tm


def test_convert_roundtrip_names_and_shapes(pair):
    """Every flax leaf has a port parameter of the same name and shape,
    and the inverse gives back the flax tree."""
    _, params, tm = pair
    back = gpt_params_to_jax(tm.state_dict())
    flat_j = jax.tree_util.tree_leaves_with_path(params)
    assert len(flat_j) == len(tm.state_dict())
    for path, leaf in flat_j:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    assert tuple(tm.state_dict()["block_0.attention.query.kernel"].shape) \
        == (64, 4, 16)
    assert tuple(tm.state_dict()["block_1.attention.out.kernel"].shape) \
        == (4, 16, 64)


@pytest.mark.parametrize("impl", ["flash", "full"])
def test_full_forward_logits(pair, impl):
    jm, params, tm = pair
    ids = np.random.RandomState(1).randint(0, 96, (2, 12))
    want = jm.apply({"params": params}, jnp.asarray(ids))
    model = tm
    if impl != "flash":
        model = gpt_tiny(**CFG, attention_impl=impl, device="cpu")
        model.load_state_dict(tm.state_dict())
    with torch.no_grad():
        got = model(torch.from_numpy(ids))
    assert got.dtype == torch.float32 and got.shape == (2, 12, 96)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_then_three_decode_steps(pair):
    """The serving engine's incremental forward: a padded prefill at
    per-sequence positions, then single-token decodes whose cache writes
    land at each sequence's own position."""
    jm, params, tm = pair
    rng = np.random.RandomState(2)
    prompt = rng.randint(0, 96, (2, 8))
    jc = jinit_cache(jm, 2, cache_len=16)
    tc = init_cache(tm, 2, cache_len=16)
    jpos = jnp.asarray([0, 0], jnp.int32)
    tpos = torch.tensor([0, 0])
    with torch.no_grad():
        want, jc = jm.apply({"params": params}, jnp.asarray(prompt),
                            kv_caches=jc, positions=jpos)
        got, tc = tm(torch.from_numpy(prompt), kv_caches=tc, positions=tpos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        pos = np.array([5, 8])             # staggered, as in a batch
        for step in range(3):
            tok = rng.randint(0, 96, (2, 1))
            want, jc = jm.apply({"params": params}, jnp.asarray(tok),
                                kv_caches=jc,
                                positions=jnp.asarray(pos, jnp.int32))
            got, tc = tm(torch.from_numpy(tok), kv_caches=tc,
                         positions=torch.from_numpy(pos))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       **TOL)
            for (jk, jv), (tk, tv) in zip(jc, tc):
                np.testing.assert_allclose(tk.numpy(), np.asarray(jk),
                                           **TOL)
                np.testing.assert_allclose(tv.numpy(), np.asarray(jv),
                                           **TOL)
            pos = pos + 1


def test_init_mirrors_flax_initializers():
    """Seeded torch init with flax's initializer families and scales."""
    m = GPT(vocab_size=512, hidden_size=128, num_layers=1, num_heads=4,
            mlp_dim=256, max_len=64, device="cpu", seed=0)
    sd = m.state_dict()
    assert sd["wte"].std().item() == pytest.approx(0.02, rel=0.05)
    assert sd["wpe"].std().item() == pytest.approx(0.01, rel=0.1)
    up = sd["block_0.mlp_up.kernel"]
    assert up.std().item() == pytest.approx(128 ** -0.5, rel=0.05)
    bound = 2 * 128 ** -0.5 / 0.87962566103423978
    assert up.abs().max().item() <= bound + 1e-6
    assert not sd["block_0.attention.query.bias"].any()
    assert bool((sd["block_0.ln1.scale"] == 1).all())
    again = GPT(vocab_size=512, hidden_size=128, num_layers=1, num_heads=4,
                mlp_dim=256, max_len=64, device="cpu", seed=0)
    torch.testing.assert_close(again.state_dict()["block_0.mlp_down.kernel"],
                               sd["block_0.mlp_down.kernel"], rtol=0, atol=0)


def test_not_ported_paths_raise():
    # decode=True is ported: the one-token step over init_decode_cache
    # gives the full forward's logits for the first token
    from apex_tpu_torch.models import init_decode_cache
    dec = gpt_tiny(**CFG, decode=True, device="cpu")
    ids = torch.from_numpy(np.random.RandomState(2).randint(0, 96, (2, 3)))
    cache = init_decode_cache(dec, 2)
    with torch.no_grad():
        logits, _ = dec(ids[:, :1], cache=cache)
        full = gpt_tiny(**CFG, device="cpu")(ids[:, :1])
    torch.testing.assert_close(logits, full, rtol=1e-5, atol=1e-5)
    assert int(cache["pos_index"]) == 1
    # the ring impls are ported (test_torch_ring_attention.py): a ring
    # model builds, and its sp axis needs a process group to run
    ring = gpt_tiny(attention_impl="ring", sp_axis="sp", device="cpu")
    assert ring.sp_axis == "sp"
    with pytest.raises((RuntimeError, ValueError)):
        ring(ids)
    # quant= is ported: every projection is a QuantDenseGeneral named by
    # its flax path, and the LM head stays plain
    from apex_tpu_torch.quant import QuantConfig, QuantDenseGeneral
    qm = gpt_tiny(**CFG, quant=QuantConfig.observe(), device="cpu")
    sites = sorted(m.site for m in qm.modules()
                   if isinstance(m, QuantDenseGeneral))
    assert len(sites) == 12 and sites[0] == "block_0/attention/key"
    assert "block_1/mlp_down" in sites
    m = gpt_tiny(**CFG, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        m(torch.zeros((1, 33), dtype=torch.long))


def test_o2_cast_params_forward_matches_jax(pair):
    """Under O2 the step hands the model bf16 copies of every parameter
    but the norms': the LM head then multiplies fp32 activations by a
    bf16 ``wte``, which JAX promotes to fp32 and the port must too.
    bf16 activations through two blocks: 2e-2."""
    from apex_tpu.amp.policy import convert_params as jconvert
    from apex_tpu_torch.amp import convert_params

    _, params, tm = pair
    jm = jgpt_tiny(**CFG, dtype=jnp.bfloat16)
    tm16 = gpt_tiny(**CFG, dtype=torch.bfloat16, device="cpu")
    ids = np.random.RandomState(4).randint(0, 96, (2, 12))
    want = jm.apply({"params": jconvert(params, jnp.bfloat16)},
                    jnp.asarray(ids))
    cast = convert_params(tm.state_dict(), torch.bfloat16)
    assert cast["wte"].dtype == torch.bfloat16
    assert cast["ln_f.scale"].dtype == torch.float32
    with torch.no_grad():
        got = torch.func.functional_call(tm16, cast,
                                         (torch.from_numpy(ids),))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-2,
                               rtol=2e-2)
