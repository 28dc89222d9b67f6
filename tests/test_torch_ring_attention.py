"""The port's sequence parallelism (``apex_tpu_torch.parallel.
ring_attention``: ``ring_attention``, ``ring_flash_attention``,
``ulysses_attention``; BERT and GPT with ``sp_axis``; the LM trainer's
``--sp``) over gloo ranks against JAX's ``shard_map`` over CPU devices,
case by case as ``tests/test_ring_attention.py`` and
``tests/test_ring_flash.py`` name them.

Four ranks are spawned once for the module (this file run as a script,
``multiproc.spawn`` with a file store under ``tmp_path``, one thread a
rank), and two more run the LM trainer's ``--sp 2``; each rank runs
every scenario on its shard of the same numpy inputs and saves what it
got.  The tolerances are JAX's tests': 2e-5 on fp32 outputs, 5e-4 on
gradients, 3e-2 on bf16; the ring-flash side runs the JAX kernels in
interpret mode under ``check_vma=False``, as ``test_ring_flash.py``
does, and the port's CPU ranks the kernels' plain versions.
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch

WORLD = 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T, H, D = 2, 64, 8, 16              # tests/test_ring_attention.py
FB, FT, FH, FD = 1, 512, 2, 32         # tests/test_ring_flash.py
LM_ARGS = ["--synthetic", "--device", "cpu", "--vocab", "256", "--hidden",
           "64", "--layers", "2", "--heads", "4", "--seq-len", "33",
           "--steps", "3", "--attention", "ring_flash", "--opt-level", "O2"]


def qkv(seed, shape=(B, T, H, D), scale=0.5):
    rng = np.random.RandomState(seed)
    return tuple((rng.randn(*shape) * scale).astype(np.float32)
                 for _ in range(3))


def bert_ids():
    return np.random.RandomState(0).randint(0, 1024, (4, 16))


# -- the ranks' side ---------------------------------------------------------------

def _np(t):
    return t.detach().float().numpy().copy()


def _shard(a, rank, axis=1):
    n = a.shape[axis] // WORLD
    return torch.from_numpy(np.ascontiguousarray(
        np.take(a, range(rank * n, (rank + 1) * n), axis=axis)))


def _rank_attention(rank, out):
    import importlib
    # the package exports the function under the module's name
    ra = importlib.import_module("apex_tpu_torch.parallel.ring_attention")
    fns = {"ring": ra.ring_attention, "ring_flash": ra.ring_flash_attention,
           "ulysses": ra.ulysses_attention}
    for name, fn in fns.items():
        for causal in (False, True):
            q, k, v = (_shard(a, rank).requires_grad_(True)
                       for a in qkv(2))
            o = fn(q, k, v, "data", causal=causal)
            (o ** 2).sum().backward()
            key = f"{name}/{int(causal)}"
            out[f"{key}/out"] = _np(o)
            for n_, t in zip("qkv", (q, k, v)):
                out[f"{key}/d{n_}"] = _np(t.grad)
    # sub-blocking with a remainder block (t_local 16, block_size 6)
    q, k, v = (_shard(a, rank) for a in qkv(8))
    out["sub/out"] = _np(ra.ring_attention(q, k, v, "data", causal=True,
                                           block_size=6))
    # bf16
    q, k, v = (_shard(a, rank).bfloat16() for a in qkv(5))
    o = ra.ring_attention(q, k, v, "data", causal=True)
    assert o.dtype == torch.bfloat16
    out["bf16/out"] = _np(o)
    # ring-flash at tests/test_ring_flash.py's shape: 128 a rank
    for causal in (False, True):
        q, k, v = (_shard(a, rank).requires_grad_(True)
                   for a in qkv(1, (FB, FT, FH, FD), 1.0))
        o = ra.ring_flash_attention(q, k, v, "data", causal=causal)
        torch.sin(o.float()).sum().backward()
        out[f"flash/{int(causal)}/out"] = _np(o)
        for n_, t in zip("qkv", (q, k, v)):
            out[f"flash/{int(causal)}/d{n_}"] = _np(t.grad)
    # Ulysses refuses heads that do not divide the axis
    x = torch.ones(B, T // WORLD, 6, D)
    try:
        ra.ulysses_attention(x, x, x, "data")
    except ValueError as e:
        out["ulysses/refusal"] = np.array(str(e))


def _rank_models(rank, out):
    from apex_tpu_torch import training
    from apex_tpu_torch.models import bert_tiny, gpt_tiny
    from apex_tpu_torch.parallel import distributed
    # a 2 x 2 (data x sp) mesh, JAX's test's layout at four devices
    distributed.register_mesh(("data", "sp"), (2, 2))
    d_i, s_i = rank // 2, rank % 2
    ids = torch.from_numpy(bert_ids())
    mine = ids[2 * d_i:2 * d_i + 2, 8 * s_i:8 * s_i + 8]
    for impl in ("ring", "ring_flash", "ulysses"):
        model = bert_tiny(attention_impl=impl, sp_axis="sp", device="cpu")
        with torch.no_grad():
            out[f"bert/{impl}/logits"] = _np(model(mine))
    # an O2 step over both axes: finite, and every rank's parameters equal
    model = bert_tiny(attention_impl="ring", sp_axis="sp", device="cpu")
    labels = torch.arange(4)[2 * d_i:2 * d_i + 2] % 2

    def loss_fn(p, batch):
        lg = torch.func.functional_call(model, p, (batch[0],))
        logp = torch.log_softmax(lg.float(), -1)
        return -logp.gather(1, batch[1][:, None]).mean()
    init_fn, step_fn = training.make_train_step(
        loss_fn, training.adam(1e-3), opt_level="O2",
        axis_name=("data", "sp"))
    state = init_fn({k: v.detach() for k, v in model.state_dict().items()})
    state, m = step_fn(state, (mine, labels))
    out["bert/step/loss"] = _np(m["loss"])
    out["bert/step/finite"] = np.array(all(
        bool(torch.isfinite(v).all()) for v in state.params.values()))
    out["bert/step/pooler"] = _np(state.params["pooler.kernel"])
    out["bert/step/word"] = _np(state.params["word_embeddings.embedding"])
    # GPT on the sp axis of the same mesh
    gids = torch.from_numpy(np.random.RandomState(3).randint(
        0, 1024, (4, 32)))[2 * d_i:2 * d_i + 2, 16 * s_i:16 * s_i + 16]
    for impl in ("ring", "ring_flash", "ulysses"):
        g = gpt_tiny(attention_impl=impl, sp_axis="sp", device="cpu")
        with torch.no_grad():
            out[f"gpt/{impl}/logits"] = _np(g(gids))
    g = gpt_tiny(attention_impl="ring", sp_axis="sp", max_len=16,
                 device="cpu")
    try:
        g(gids)
    except ValueError as e:
        out["gpt/too_long"] = np.array(str(e))


def _worker(out_dir):
    from apex_tpu_torch.parallel import multiproc
    torch.set_num_threads(1)
    rank, world = multiproc.initialize(device="cpu")
    assert world == WORLD
    out = {}
    _rank_attention(rank, out)
    _rank_models(rank, out)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    multiproc.shutdown()


def _lm_worker(out_dir):
    from apex_tpu_torch.examples.lm import main_amp
    from apex_tpu_torch.parallel import multiproc
    torch.set_num_threads(1)
    res = main_amp.run(LM_ARGS + ["--sp", "2"], log=lambda *a: None)
    rank = multiproc.process_identity()[0]
    np.savez(os.path.join(out_dir, f"lm{rank}.npz"),
             losses=np.array(res["losses"]),
             wte=_np(res["state"].params["wte"]))
    multiproc.shutdown()


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    if "--lm" in sys.argv:
        _lm_worker(sys.argv[sys.argv.index("--lm") + 1])
    else:
        _worker(sys.argv[sys.argv.index("--out") + 1])
    sys.exit(0)

# -- the test process's side (JAX imports only here) -------------------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import shard_map  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

from apex_tpu.ops.attention import dot_product_attention  # noqa: E402
from apex_tpu.parallel.ring_attention import (  # noqa: E402
    _ring_flash, ring_attention as jring, ulysses_attention as julysses)
from apex_tpu_torch.parallel import multiproc  # noqa: E402


def _spawn(out, argv, n):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    results = multiproc.spawn([os.path.abspath(__file__), *argv], n,
                              f"file://{out}/store_{argv[0][2:]}",
                              timeout=300, capture=True, env=env)
    if any(r["returncode"] != 0 for r in results):
        pytest.fail("\n".join(
            f"rank {r['rank']} exited {r['returncode']}:\n{r['output']}"
            for r in results))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's saved results (one spawn of four for the module)."""
    out = tmp_path_factory.mktemp("ring")
    _spawn(out, ["--out", str(out)], WORLD)
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]


def _gathered(ranks, key, axis=1):
    return np.concatenate([r[key] for r in ranks], axis=axis)


def _mesh(n=WORLD, name="sp"):
    return Mesh(np.array(jax.devices("cpu")[:n]), (name,))


def _jax_sharded(fn, *args, n_out=1, check_vma=True):
    specs = (P(None, "sp"),) * len(args)
    out_specs = P(None, "sp") if n_out == 1 else (P(None, "sp"),) * n_out
    return jax.jit(shard_map(fn, mesh=_mesh(), in_specs=specs,
                             out_specs=out_specs, check_vma=check_vma))(
        *args)


def _jax_attention_and_grads(fn, causal, arrays):
    f = functools.partial(fn, axis_name="sp", causal=causal)
    q, k, v = (jnp.asarray(a) for a in arrays)
    out = _jax_sharded(f, q, k, v)

    def loss(a, b, c):
        mapped = shard_map(f, mesh=_mesh(), in_specs=(P(None, "sp"),) * 3,
                           out_specs=P(None, "sp"))
        return jnp.sum(mapped(a, b, c) ** 2)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name", ["ring", "ulysses"])
def test_ring_and_ulysses_match_jax_and_single_device(ranks, name, causal):
    """Forward (2e-5) and the gradients of ``sum(out ** 2)`` (5e-4) of the
    port's ring and Ulysses attention over four ranks against JAX's over
    four devices and the single-device oracle (JAX's test's B 2, T 64,
    H 8, D 16)."""
    fn = {"ring": jring, "ulysses": julysses}[name]
    arrays = qkv(2)
    jout, jgrads = _jax_attention_and_grads(fn, causal, arrays)
    ref = np.asarray(dot_product_attention(
        *(jnp.asarray(a) for a in arrays), causal=causal))
    got = _gathered(ranks, f"{name}/{int(causal)}/out")
    np.testing.assert_allclose(got, jout, atol=2e-5)
    np.testing.assert_allclose(got, ref, atol=2e-5)
    for n_, jg in zip("qkv", jgrads):
        np.testing.assert_allclose(
            _gathered(ranks, f"{name}/{int(causal)}/d{n_}"), jg, atol=5e-4,
            err_msg=f"d{n_}")


@pytest.mark.parametrize("causal", [False, True])
def test_ring_flash_plain_route_matches_ring(ranks, causal):
    """``ring_flash_attention`` at the ring tests' shape: forward and
    gradients equal the plain ring's within 2e-5 / 5e-4."""
    for part in ("out", "dq", "dk", "dv"):
        np.testing.assert_allclose(
            _gathered(ranks, f"ring_flash/{int(causal)}/{part}"),
            _gathered(ranks, f"ring/{int(causal)}/{part}"),
            atol=2e-5 if part == "out" else 5e-4, err_msg=part)


def test_ring_attention_sub_blocking(ranks):
    """``block_size`` sub-blocks each shard, a remainder block included
    (t_local 16, blocks of 6): JAX's ring at the same block size and the
    oracle, 2e-5."""
    arrays = qkv(8)
    f = functools.partial(jring, axis_name="sp", causal=True, block_size=6)
    jout = _jax_sharded(f, *(jnp.asarray(a) for a in arrays))
    got = _gathered(ranks, "sub/out")
    np.testing.assert_allclose(got, np.asarray(jout), atol=2e-5)
    ref = dot_product_attention(*(jnp.asarray(a) for a in arrays),
                                causal=True)
    np.testing.assert_allclose(got, np.asarray(ref), atol=2e-5)


def test_ring_attention_bf16(ranks):
    arrays = qkv(5)
    ref = dot_product_attention(*(jnp.asarray(a, jnp.bfloat16)
                                  for a in arrays), causal=True)
    np.testing.assert_allclose(_gathered(ranks, "bf16/out"),
                               np.asarray(ref, np.float32), atol=3e-2)


def _jax_ring_flash(arrays, causal, grads):
    """JAX's ``_ring_flash`` core with the Pallas kernels in interpret
    mode (``check_vma=False``, as ``tests/test_ring_flash.py`` runs it)."""
    q, k, v = (jnp.asarray(a) for a in arrays)

    def fwd(q, k, v):
        qt, kt, vt = (x.transpose(0, 2, 1, 3) for x in (q, k, v))
        return _ring_flash(qt, kt, vt, "sp", causal, FD ** -0.5, 128, 128,
                           True).transpose(0, 2, 1, 3)
    if not grads:
        return np.asarray(_jax_sharded(fwd, q, k, v, check_vma=False))

    def run(q, k, v):
        return jax.grad(lambda *a: jnp.sum(jnp.sin(
            fwd(*a).astype(jnp.float32))), argnums=(0, 1, 2))(q, k, v)
    return [np.asarray(g) for g in _jax_sharded(run, q, k, v, n_out=3,
                                                  check_vma=False)]


@pytest.mark.parametrize("causal", [False, True])
def test_ring_flash_forward_matches_jax_and_oracle(ranks, causal):
    """Ring-flash forward at ``test_ring_flash.py``'s shape (B 1, T 512,
    H 2, D 32, 128 a rank) against JAX's interpret-mode kernels and the
    oracle: atol and rtol 2e-5."""
    arrays = qkv(1, (FB, FT, FH, FD), 1.0)
    got = _gathered(ranks, f"flash/{int(causal)}/out")
    np.testing.assert_allclose(got, _jax_ring_flash(arrays, causal, False),
                               atol=2e-5, rtol=2e-5)
    ref = dot_product_attention(*(jnp.asarray(a) for a in arrays),
                                causal=causal)
    np.testing.assert_allclose(got, np.asarray(ref), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_flash_grads_match_jax_and_oracle(ranks, causal):
    """The gradients of ``sum(sin(out))`` through the ring-flash backward
    (global lse, dK/dV rotated home) against JAX's and the dense
    oracle's: atol and rtol 5e-4."""
    arrays = qkv(1, (FB, FT, FH, FD), 1.0)
    jg = _jax_ring_flash(arrays, causal, True)
    r = jax.grad(lambda a, b, c: jnp.sum(jnp.sin(dot_product_attention(
        a, b, c, causal=causal).astype(jnp.float32))), argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in arrays))
    for n_, a, b in zip("qkv", jg, r):
        got = _gathered(ranks, f"flash/{int(causal)}/d{n_}")
        np.testing.assert_allclose(got, a, atol=5e-4, rtol=5e-4,
                                   err_msg=f"d{n_} vs JAX")
        np.testing.assert_allclose(got, np.asarray(b), atol=5e-4,
                                   rtol=5e-4, err_msg=f"d{n_} vs oracle")


def test_ulysses_rejects_indivisible_heads(ranks):
    assert "divisible" in str(ranks[0]["ulysses/refusal"])
    with pytest.raises(ValueError, match="divisible"):
        q = jnp.ones((B, T, 6, D))
        _jax_sharded(functools.partial(julysses, axis_name="sp"), q, q, q)


def _dp_sp_mesh():
    return Mesh(np.array(jax.devices("cpu")[:WORLD]).reshape(2, 2),
                ("data", "sp"))


@pytest.mark.parametrize("impl", ["ring", "ring_flash", "ulysses"])
def test_bert_sp_matches_jax_on_dp_sp_mesh(ranks, impl):
    """bert_tiny with ``sp_axis`` on a 2 x 2 (data x sp) mesh: the
    logits of every data shard equal JAX's model on JAX's mesh and the
    unsharded model's on the same weights (2e-4, JAX's test's)."""
    from apex_tpu.models import bert_tiny as jbert_tiny
    from apex_tpu_torch.convert import bert_params_to_jax
    from apex_tpu_torch.models import bert_tiny
    params = bert_params_to_jax(bert_tiny(device="cpu").state_dict())
    ids = jnp.asarray(bert_ids())
    jm = jbert_tiny(attention_impl=impl, sp_axis="sp")
    f = shard_map(lambda i: jm.apply({"params": params}, i),
                  mesh=_dp_sp_mesh(), in_specs=P("data", "sp"),
                  out_specs=P("data"))
    want = np.asarray(jax.jit(f)(ids))
    plain = np.asarray(jbert_tiny().apply({"params": params}, ids))
    got = np.concatenate([ranks[0][f"bert/{impl}/logits"],
                          ranks[2][f"bert/{impl}/logits"]])
    for r in (1, 3):        # both sp ranks of a data shard hold the logits
        np.testing.assert_array_equal(ranks[r][f"bert/{impl}/logits"],
                                      ranks[r - 1][f"bert/{impl}/logits"])
    np.testing.assert_allclose(got, want, atol=2e-4)
    np.testing.assert_allclose(got, plain, atol=2e-4)


def test_bert_ring_o2_step_on_dp_sp_mesh(ranks):
    """A full O2 step over both axes (``axis_name=("data", "sp")``):
    finite, the loss the same on every rank and the parameters
    replicated on all four ranks, as JAX's test asks."""
    for r in ranks:
        assert bool(r["bert/step/finite"])
        np.testing.assert_array_equal(r["bert/step/loss"],
                                      ranks[0]["bert/step/loss"])
        for key in ("bert/step/pooler", "bert/step/word"):
            np.testing.assert_array_equal(r[key], ranks[0][key])


@pytest.mark.parametrize("impl", ["ring", "ring_flash", "ulysses"])
def test_gpt_sp_matches_jax(ranks, impl):
    """gpt_tiny with ``sp_axis`` (positions offset by rank x shard): the
    logits of each shard equal JAX's model under ``shard_map`` on the
    same weights (2e-4); a global sequence past ``max_len`` raises."""
    from apex_tpu.models.gpt import gpt_tiny as jgpt_tiny
    from apex_tpu_torch.convert import gpt_params_to_jax
    from apex_tpu_torch.models import gpt_tiny
    params = jax.tree_util.tree_map(jnp.asarray, gpt_params_to_jax(
        gpt_tiny(device="cpu").state_dict()))
    ids = jnp.asarray(np.random.RandomState(3).randint(0, 1024, (4, 32)))
    jm = jgpt_tiny(attention_impl=impl, sp_axis="sp")
    f = shard_map(lambda i: jm.apply({"params": params}, i),
                  mesh=_dp_sp_mesh(), in_specs=P("data", "sp"),
                  out_specs=P("data", "sp"))
    want = np.asarray(jax.jit(f)(ids))
    got = np.concatenate([np.concatenate(
        [ranks[2 * d + s][f"gpt/{impl}/logits"] for s in range(2)], axis=1)
        for d in range(2)])
    np.testing.assert_allclose(got, want, atol=2e-4)
    assert "exceeds max_len" in str(ranks[0]["gpt/too_long"])


def test_lm_trainer_sp2_matches_jax(tmp_path):
    """The LM trainer's ``--sp 2 --attention ring_flash`` on two gloo
    ranks (O2, fused loss, 3 steps, gpt_tiny-like widths): every rank's
    losses equal, and equal to JAX's example's ``--sp 2`` step
    (``make_train_step(axis_name="sp")`` under ``shard_map`` with the
    sequence sharded, ``examples/lm/main_amp.py:180-262``) on the same
    weights and batch, rtol 1e-4 (bf16 models on both sides, their sums
    in other orders: the unsharded trainer's test's tolerance).  The JAX
    step runs with ``check_vma=False`` (its fused loss's VJP fails the
    varying-axes check), its loss averaged over sp explicitly."""
    from apex_tpu import training as jtraining
    from apex_tpu.contrib.xentropy import softmax_cross_entropy_loss
    from apex_tpu.models.gpt import GPT as JGPT
    from apex_tpu_torch.convert import gpt_params_to_jax
    from apex_tpu_torch.examples.lm import main_amp
    from apex_tpu_torch.models import GPT
    _spawn(tmp_path, ["--lm", str(tmp_path)], 2)
    got = [dict(np.load(tmp_path / f"lm{r}.npz")) for r in range(2)]
    np.testing.assert_array_equal(got[0]["losses"], got[1]["losses"])
    np.testing.assert_array_equal(got[0]["wte"], got[1]["wte"])
    args = main_amp.parse(LM_ARGS)
    model = GPT(vocab_size=args.vocab, hidden_size=args.hidden,
                num_layers=args.layers, num_heads=args.heads,
                mlp_dim=4 * args.hidden, max_len=args.seq_len,
                dtype=torch.bfloat16, device="cpu", seed=0)
    params = jax.tree_util.tree_map(jnp.asarray,
                                    gpt_params_to_jax(model.state_dict()))
    jm = JGPT(vocab_size=args.vocab, hidden_size=args.hidden,
              num_layers=args.layers, num_heads=args.heads,
              mlp_dim=4 * args.hidden, max_len=args.seq_len,
              dtype=jnp.bfloat16, attention_impl="ring_flash",
              sp_axis="sp")

    def loss_fn(p, batch):
        logits = jm.apply({"params": p}, batch[0])
        flat = logits.reshape(-1, logits.shape[-1])
        return jnp.mean(softmax_cross_entropy_loss(
            flat, batch[1].reshape(-1), smoothing=args.smoothing))
    init_fn, step_fn = jtraining.make_train_step(
        loss_fn, jtraining.adam(args.lr, weight_decay=args.weight_decay),
        opt_level="O2", axis_name="sp")
    def sharded_step(st, b):
        # check_vma=False: JAX's fused cross-entropy VJP fails the
        # varying-axes check under shard_map (as the BN epilogue's does,
        # tests/test_torch_distributed.py), so the gradients arrive per
        # device and reduce_gradients sums them over sp itself; the loss
        # is then per device, and its mean over sp is the metric
        ns, m = step_fn(st, b)
        return ns, {**m, "loss": jax.lax.pmean(m["loss"], "sp")}
    step = jax.jit(shard_map(
        sharded_step, mesh=_mesh(2),
        in_specs=(P(), (P(None, "sp"), P(None, "sp"))),
        out_specs=(P(), P()), check_vma=False))
    ids = np.random.RandomState(0).randint(1, args.vocab,
                                           (args.batch_size, args.seq_len))
    batch = (jnp.asarray(ids[:, :-1]), jnp.asarray(ids[:, 1:]))
    state = init_fn(params)
    losses = []
    for _ in range(args.steps):
        state, m = step(state, batch)
        losses.append(float(jnp.ravel(m["loss"])[0]))
    np.testing.assert_allclose(got[0]["losses"], losses, rtol=1e-4)
