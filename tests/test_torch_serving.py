"""The port's serving engine and paged KV cache against the JAX package's.

Same weights (carried through ``apex_tpu_torch.convert``), the same
prompts and the config of ``tests/test_serving.py``: the port's greedy
tokens must equal the JAX ``ServingEngine``'s bit for bit.  Everything
runs on the CPU (``device="cpu"``, the plain versions of the kernels).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu import serving as jserving
from apex_tpu import telemetry
from apex_tpu.models import gpt_tiny as jgpt_tiny
from apex_tpu_torch.convert import gpt_params_from_jax
from apex_tpu_torch.models import gpt_tiny
from apex_tpu_torch.serving import ServingEngine
from apex_tpu_torch.serving.kv_cache import (TRASH_PAGE, PageAllocator,
                                             gather_views, make_pool,
                                             scatter_prefill, scatter_token)

VOCAB = 256
CFG = dict(max_len=64, vocab_size=VOCAB, hidden_size=64, num_layers=2,
           num_heads=2, mlp_dim=128)


@pytest.fixture(autouse=True)
def _clean_recorder():
    telemetry.set_recorder(None)
    yield
    telemetry.set_recorder(None)


@pytest.fixture(scope="module")
def models():
    jm = jgpt_tiny(**CFG)
    probe = jnp.asarray(np.random.RandomState(0).randint(1, VOCAB, (1, 8)))
    params = jm.init(jax.random.PRNGKey(1), probe)["params"]
    tm = gpt_tiny(**CFG, device="cpu")
    tm.load_state_dict(gpt_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, tm


def _prompt(n, seed=0):
    return np.random.RandomState(seed).randint(1, VOCAB, (n,)).astype(
        np.int32)


def test_page_allocator_accounting():
    al = PageAllocator(9)                # 8 allocatable + trash page 0
    assert al.total_pages == 8 and al.free_pages == 8
    a = al.alloc(3)
    b = al.alloc(5)
    assert al.free_pages == 0 and al.alloc(1) is None   # all-or-nothing
    assert al.occupancy_pct == 100.0
    assert TRASH_PAGE not in a + b
    al.free(a)
    assert al.free_pages == 3 and al.occupancy_pct == pytest.approx(62.5)
    with pytest.raises(ValueError, match="double free"):
        al.free(b + b[:1])
    with pytest.raises(ValueError, match="trash"):
        al.free([TRASH_PAGE])
    row = al.padded_row([4, 6, 7], 2)    # truncated to a smaller view
    np.testing.assert_array_equal(row, [4, 6])
    np.testing.assert_array_equal(al.padded_row([4], 3), [4, 0, 0])


def test_pool_gather_scatter_roundtrip(models):
    """scatter_prefill -> gather_views reproduces the dense cache exactly
    through a permuted page list; scatter_token lands at (page, offset)."""
    _, _, tm = models
    page, bucket = 4, 16
    pool_k, pool_v = make_pool(tm, n_pages=9, page_size=page)
    hd = pool_k.shape[-1]
    dense = torch.from_numpy(
        np.random.RandomState(3).randn(tm.num_layers, bucket, 2, hd)
        .astype(np.float32))
    pages = torch.tensor([5, 2, 7, 1])
    scatter_prefill(pool_k, pages, dense)
    tables = torch.zeros((2, bucket // page), dtype=torch.long)
    tables[1] = pages
    views = gather_views(pool_k, pool_v, tables)
    for i in range(tm.num_layers):
        torch.testing.assert_close(views[i][0][1], dense[i], rtol=0, atol=0)
        assert not views[i][0][0].any()  # slot 0 reads the trash page
    tok = torch.ones((tm.num_layers, 2, 2, hd))
    scatter_token(pool_k, torch.tensor([5, 0]), torch.tensor([3, 0]), tok)
    assert bool((pool_k[:, 5, 3] == 1).all())


def test_engine_tokens_equal_jax_engine(models):
    """The config of tests/test_serving.py (buckets (16, 32), page 4,
    two slots, five prompts, 5 new tokens): more requests than slots,
    both buckets, long sequences decoding through the small bucket's
    table — the tokens equal the JAX engine's bit for bit."""
    jm, params, tm = models
    prompts = [_prompt(n, seed=n) for n in (3, 7, 12, 5, 9)]
    jeng = jserving.ServingEngine(jm, params, buckets=(16, 32), page_size=4,
                                  max_seqs=2)
    jeng.warmup()
    want = jeng.generate(prompts, max_new_tokens=5)
    jeng.close()
    eng = ServingEngine(tm, buckets=(16, 32), page_size=4, max_seqs=2,
                        device="cpu").warmup()
    got = eng.generate(prompts, max_new_tokens=5)
    for w, g in zip(want, got):
        assert g.ok and w.ok
        np.testing.assert_array_equal(g.tokens, w.tokens)
        assert g.bucket == w.bucket
        t = g.timings
        assert t["ttft_s"] > 0 and t["total_s"] >= t["ttft_s"]
        assert t["tpot_s"] > 0
    assert {r.bucket for r in got} == {16, 32}
    assert eng.stats["completed"] == 5 and eng.stats["tokens_out"] == 20
    assert eng.pages.occupancy_pct == 0.0
    eng.close()


def test_engine_rejects_and_threaded_serving(models):
    """A prompt that fits no bucket is rejected in its result; the serve
    thread answers submitted requests with the synchronous tokens."""
    _, _, tm = models
    eng = ServingEngine(tm, buckets=(16,), page_size=4, max_seqs=2,
                        device="cpu")
    sync = eng.generate([_prompt(6, 1)], max_new_tokens=3)[0]
    bad = eng.generate([_prompt(15, 2)], max_new_tokens=3)[0]
    assert not bad.ok and "fits no bucket" in bad.error
    eng.start()
    threaded = eng.submit(_prompt(6, 1), 3).result(timeout=60)
    np.testing.assert_array_equal(threaded.tokens, sync.tokens)
    eng.close()
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(_prompt(4), 2)


def test_engine_without_gpu_raises(models):
    """With no device given the engine runs on CUDA; on a host without a
    GPU it raises instead of falling back to the CPU."""
    _, _, tm = models
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(tm, buckets=(16,), page_size=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gpt_tiny(**CFG)


def _jax_tokens(jm, params, prompts, n, buckets=(16, 32)):
    """The JAX engine's greedy tokens (page 4, two slots)."""
    jeng = jserving.ServingEngine(jm, params, buckets=buckets, page_size=4,
                                  max_seqs=2)
    out = [r.tokens for r in jeng.generate(prompts, max_new_tokens=n)]
    jeng.close()
    return out


def test_engine_zero_misses_after_warmup(models):
    """After ``warmup`` the AOT table holds both step kinds of every
    bucket: serving misses nothing, with the JAX engine's tokens."""
    jm, params, tm = models
    eng = ServingEngine(tm, buckets=(16, 32), page_size=4, max_seqs=2,
                        device="cpu").warmup()
    assert len(eng._aot) == 4
    assert {(kind, b) for kind, b, _ in eng._aot.values()} == {
        (k, b) for k in ("prefill", "decode") for b in (16, 32)}
    prompts = [_prompt(n, seed=n) for n in (3, 7, 12, 5, 9)]
    results = eng.generate(prompts, max_new_tokens=5)
    for want, r in zip(_jax_tokens(jm, params, prompts, 5), results):
        assert r.ok
        np.testing.assert_array_equal(r.tokens, want)
    assert eng.stats["aot_misses"] == 0
    assert eng.stats["captures"] == eng.stats["replays"] == 0   # the CPU
    assert {r.bucket for r in results} == {16, 32}
    eng.close()
    assert not eng._aot


def test_unwarmed_bucket_is_one_counted_miss(models):
    """A bucket never warmed misses once for each step kind, as JAX's
    engine misses its AOT table there, and is in the table after: a
    second request at that bucket misses nothing.  The tokens equal the
    JAX engine's."""
    jm, params, tm = models
    eng = ServingEngine(tm, buckets=(16, 32), page_size=4, max_seqs=2,
                        device="cpu")
    eng.warmup(buckets=(16,))
    p_small, p_big = _prompt(4), _prompt(20, 1)
    r_small, r_big = eng.generate([p_small, p_big], max_new_tokens=4)
    assert r_small.bucket == 16 and r_big.bucket == 32
    assert eng.stats["aot_misses"] == 2        # prefill[32], decode[32]
    want_small, want_big = _jax_tokens(jm, params, [p_small, p_big], 4)
    np.testing.assert_array_equal(r_big.tokens, want_big)
    np.testing.assert_array_equal(r_small.tokens, want_small)
    eng.generate([_prompt(18, 2)], max_new_tokens=4)
    assert eng.stats["aot_misses"] == 2
    eng.close()


def test_engine_serves_new_weights_after_an_in_place_update(models):
    """The table is made for the weights' versions: after
    ``load_state_dict`` the engine notices (on the card it captures every
    graph again) and serves the new weights' tokens."""
    _, _, tm = models
    model = gpt_tiny(**CFG, device="cpu")
    model.load_state_dict(tm.state_dict())
    eng = ServingEngine(model, buckets=(16,), page_size=4, max_seqs=2,
                        device="cpu").warmup()
    before = eng.generate([_prompt(6, 3)], max_new_tokens=4)[0].tokens
    seen = eng._weights_seen
    other = gpt_tiny(**CFG, device="cpu", seed=9)
    model.load_state_dict(other.state_dict())
    fresh = ServingEngine(other, buckets=(16,), page_size=4, max_seqs=2,
                          device="cpu")
    want = fresh.generate([_prompt(6, 3)], max_new_tokens=4)[0].tokens
    got = eng.generate([_prompt(6, 3)], max_new_tokens=4)[0].tokens
    assert eng._weights_seen != seen
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, before)
    eng.close()
    fresh.close()


@pytest.mark.parametrize("how", ["assign", "new_parameter"])
def test_engine_notices_replaced_weights(models, how):
    """A weight replaced by another tensor, not updated in place
    (``load_state_dict(assign=True)``, a new ``nn.Parameter``), moves
    the table as an in-place update does (on the card every graph is
    captured again), and the engine serves the new weights' tokens."""
    _, _, tm = models
    model = gpt_tiny(**CFG, device="cpu")
    model.load_state_dict(tm.state_dict())
    eng = ServingEngine(model, buckets=(16,), page_size=4, max_seqs=2,
                        device="cpu").warmup()
    eng.generate([_prompt(6, 3)], max_new_tokens=4)
    seen = eng._weights_seen
    other = gpt_tiny(**CFG, device="cpu", seed=9)
    if how == "assign":
        model.load_state_dict(
            {k: v.clone() for k, v in other.state_dict().items()},
            assign=True)
    else:
        for name, p in other.named_parameters():
            owner, _, leaf = name.rpartition(".")
            setattr(model.get_submodule(owner), leaf,
                    torch.nn.Parameter(p.detach().clone()))
    got = eng.generate([_prompt(6, 3)], max_new_tokens=4)[0].tokens
    assert eng._weights_seen != seen
    # every key moved by identity: no version or address was touched
    assert all(a[0] != b[0] for a, b in zip(eng._weights_seen, seen))
    fresh = ServingEngine(other, buckets=(16,), page_size=4, max_seqs=2,
                          device="cpu")
    want = fresh.generate([_prompt(6, 3)], max_new_tokens=4)[0].tokens
    np.testing.assert_array_equal(got, want)
    eng.close()
    fresh.close()


def test_package_exports_page_allocator_and_make_pool_as_jax():
    """``serving.PageAllocator`` and ``serving.make_pool`` are exported
    by the package, in its names and ``__all__``, as JAX's are."""
    from apex_tpu_torch import serving
    assert serving.PageAllocator is PageAllocator
    assert serving.make_pool is make_pool
    assert set(jserving.__all__) <= set(serving.__all__)
    al, jal = serving.PageAllocator(5), jserving.PageAllocator(5)
    assert al.alloc(3) == jal.alloc(3)
    assert al.free_pages == jal.free_pages == 1
