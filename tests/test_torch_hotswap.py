"""Weight hot-swap in the port's engine against the JAX engine's (oracle
``tests/test_serving.py::test_hotswap_mid_load_no_failed_requests``).

Both engines serve gpt_tiny in fp32 from the same numpy weights; each
watches its own checkpoint directory, into which the same new weights
(``x 1.01``) are published mid-load by its own package's manager.  Each
adopts them between scheduler steps, fails no request, and the greedy
tokens after the swap equal JAX's.  The watcher skips a torn or
corrupted step (``last_error`` set, retried, serving goes on), stages a
step at most once, and an LM trainer's checkpoint serves through
``extract`` (``convert.gpt_params_from_train_state``) and the CLI.
"""

import glob
import io
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu import serving as jserving
from apex_tpu.checkpoint import CheckpointManager as JCheckpointManager
from apex_tpu.models import gpt_tiny as jgpt_tiny
from apex_tpu_torch import convert, telemetry
from apex_tpu_torch.checkpoint import CheckpointManager, latest_checkpoint
from apex_tpu_torch.convert import gpt_params_from_jax
from apex_tpu_torch.models import gpt_tiny
from apex_tpu_torch.serving import ServingEngine
from apex_tpu_torch.serving.hotswap import WeightWatcher

VOCAB = 256
CFG = dict(max_len=64, vocab_size=VOCAB, hidden_size=64, num_layers=2,
           num_heads=2, mlp_dim=128)


@pytest.fixture(scope="module")
def weights():
    jm = jgpt_tiny(**CFG)
    probe = jnp.asarray(np.random.RandomState(0).randint(1, VOCAB, (1, 8)))
    params = jm.init(jax.random.PRNGKey(1), probe)["params"]
    params2 = jax.tree_util.tree_map(lambda x: x * 1.01, params)
    return jm, params, params2


def _prompt(n, seed=0):
    return np.random.RandomState(seed).randint(1, VOCAB, (n,)).astype(
        np.int32)


def _port_model(params):
    tm = gpt_tiny(**CFG, device="cpu")
    tm.load_state_dict(gpt_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return tm


def _save(directory, tree, step):
    with CheckpointManager(directory, keep=3) as mgr:
        mgr.save(step, tree, block=True)


def test_hotswap_mid_load_equals_jax(weights, tmp_path):
    jm, params, params2 = weights
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jeng = jserving.ServingEngine(jm, params, buckets=(32,), page_size=4,
                                  max_seqs=2, watch_dir=jdir,
                                  poll_every_s=60)
    jeng.warmup()
    tm = _port_model(params)
    eng = ServingEngine(tm, buckets=(32,), page_size=4, max_seqs=2,
                        device="cpu", watch_dir=tdir,
                        poll_every_s=60).warmup()
    results = {}
    for name, e in (("jax", jeng), ("port", eng)):
        comp = e.submit(_prompt(5), 8)
        for _ in range(4):
            e.step()
        results[name] = comp
    jmgr = JCheckpointManager(jdir, keep=3, procs=(0, 1), async_write=False)
    jmgr.save(11, params2)
    jmgr.close()
    _save(tdir, gpt_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params2)), 11)
    assert jeng.watcher.poll_once() and eng.watcher.poll_once()
    jeng.run_until_idle()
    eng.run_until_idle()
    for name in ("jax", "port"):
        assert results[name].result(timeout=0).ok
    assert eng.stats["hotswaps"] == jeng.stats["hotswaps"] == 1
    np.testing.assert_array_equal(results["port"].result(timeout=0).tokens,
                                  results["jax"].result(timeout=0).tokens)
    prompts = [_prompt(6, 9), _prompt(11, 3), _prompt(3, 4)]
    want = jeng.generate(prompts, max_new_tokens=5)
    got = eng.generate(prompts, max_new_tokens=5)
    for g, w in zip(got, want):
        assert g.ok and w.ok
        np.testing.assert_array_equal(g.tokens, w.tokens)
    fresh = ServingEngine(_port_model(params2), buckets=(32,), page_size=4,
                          max_seqs=2, device="cpu").warmup()
    for g, f in zip(got, fresh.generate(prompts, max_new_tokens=5)):
        np.testing.assert_array_equal(g.tokens, f.tokens)
    assert eng.watcher.adopted_step == 11 and eng.stats["swap_s"] > 0
    for e in (jeng, eng, fresh):
        e.close()


def test_hotswap_under_threaded_load_fails_no_request(weights, tmp_path):
    """The serve thread runs; a checkpoint lands while requests queue
    and decode: every request is served, the swap is counted once."""
    _, params, params2 = weights
    d = str(tmp_path / "ck")
    eng = ServingEngine(_port_model(params), buckets=(32,), page_size=4,
                        max_seqs=2, device="cpu", watch_dir=d,
                        poll_every_s=0.01).warmup().start()
    comps = [eng.submit(_prompt(4 + i % 7, i), 8) for i in range(12)]
    _save(d, _port_model(params2).state_dict(), 3)
    more = [eng.submit(_prompt(5, 20 + i), 8) for i in range(6)]
    for c in comps + more:
        r = c.result(timeout=120)
        assert r.ok and len(r.tokens) == 8
    deadline = 200
    while eng.stats["hotswaps"] == 0 and deadline:
        eng.submit(_prompt(3, 99), 2).result(timeout=60)
        deadline -= 1
    assert eng.stats["hotswaps"] == 1 and eng.watcher.adopted_step == 3
    assert eng.stats["rejected"] == 0
    eng.close()


def _corrupt(step_dir, how):
    shard = glob.glob(os.path.join(step_dir, "shard_*.npz"))[0]
    if how == "truncated":
        with open(shard, "r+b") as f:
            f.truncate(16)
        with open(shard + ".tmp", "wb") as f:
            f.write(b"partial")
    elif how == "flipped":
        data = bytearray(open(shard, "rb").read())
        data[len(data) // 2] ^= 0xFF
        open(shard, "wb").write(bytes(data))
    else:
        for m in glob.glob(os.path.join(step_dir, "manifest_*.json")):
            os.remove(m)


@pytest.mark.parametrize("how", ["truncated", "flipped", "no_manifest"])
def test_torn_checkpoint_is_skipped_and_serving_goes_on(weights, tmp_path,
                                                        how):
    _, params, params2 = weights
    d = str(tmp_path / "ck")
    like = _port_model(params).state_dict()
    w = WeightWatcher(d, like=like, poll_every_s=60)
    assert not w.poll_once() and w.last_error is None
    _save(d, like, 5)
    assert w.poll_once() and w.adopted_step == 5
    assert w.take()[0] == 5 and w.take() is None
    new = _port_model(params2).state_dict()
    _save(d, new, 10)
    _corrupt(latest_checkpoint(d), how)
    assert not w.poll_once() and w.adopted_step == 5
    assert w.last_error is not None and "step 10" in w.last_error
    _save(d, new, 15)
    assert w.poll_once() and w.adopted_step == 15
    step, staged = w.take()
    assert step == 15 and torch.equal(staged["wte"], new["wte"])
    # an engine on a directory whose newest step is torn keeps serving
    eng = ServingEngine(_port_model(params), buckets=(32,), page_size=4,
                        max_seqs=2, device="cpu", watch_dir=d,
                        watch_from_step=15, poll_every_s=60).warmup()
    _save(d, new, 20)
    _corrupt(latest_checkpoint(d), how)
    assert not eng.watcher.poll_once()
    r = eng.generate([_prompt(5)], max_new_tokens=4)[0]
    assert r.ok and eng.stats["hotswaps"] == 0
    assert "step 20" in eng.watcher.last_error
    eng.close()


def test_poll_checksums_only_newer_steps_once(weights, tmp_path,
                                             monkeypatch):
    """With nothing newer than the adopted step a poll reads no shard;
    staging a newer step checks its shard's crc32 once, not again in the
    load."""
    import apex_tpu_torch.checkpoint as ckpt
    _, params, params2 = weights
    calls = []
    crc = ckpt._crc32_file
    monkeypatch.setattr(ckpt, "_crc32_file",
                        lambda path: calls.append(path) or crc(path))
    d = str(tmp_path / "ck")
    like = _port_model(params).state_dict()
    _save(d, like, 5)
    w = WeightWatcher(d, like=like, poll_every_s=60)
    calls.clear()
    assert w.poll_once() and len(calls) == 1
    calls.clear()
    assert not w.poll_once() and not w.poll_once() and calls == []
    new = _port_model(params2).state_dict()
    _save(d, new, 10)
    calls.clear()
    assert w.poll_once() and w.adopted_step == 10 and len(calls) == 1
    step, staged = w.take()
    assert step == 10 and torch.equal(staged["wte"], new["wte"])
    # a corrupted newer step is read once, and again only once it changes
    _save(d, new, 15)
    _corrupt(latest_checkpoint(d), "flipped")
    calls.clear()
    assert not w.poll_once() and len(calls) == 1
    assert not w.poll_once() and len(calls) == 1
    assert "step 15" in w.last_error
    _save(d, new, 15)
    calls.clear()
    assert w.poll_once() and w.adopted_step == 15 and len(calls) == 1


def test_watcher_extract_and_initial_step(weights, tmp_path):
    """A trainer's ``TrainState`` checkpoint through ``extract``; a
    watcher started from the step it serves stages nothing older."""
    _, params, params2 = weights
    model = _port_model(params)
    like = convert.lm_train_state_like(model)
    state = like._replace(params=_port_model(params2).state_dict())
    d = str(tmp_path / "ck")
    _save(d, state, 8)
    w = WeightWatcher(d, like=like,
                      extract=convert.gpt_params_from_train_state,
                      initial_step=8)
    assert not w.poll_once()
    w2 = WeightWatcher(d, like=like,
                       extract=convert.gpt_params_from_train_state)
    assert w2.poll_once() and w2.initial_step is None
    _, got = w2.take()
    assert sorted(got) == sorted(model.state_dict())
    assert all(torch.equal(got[k], state.params[k]) for k in got)
    assert w2.load_s > 0
    # telemetry= is ported: a staging is a serving "stage" event
    sink = io.StringIO()
    w3 = WeightWatcher(d, like=like, telemetry=telemetry.Recorder(sink),
                       extract=convert.gpt_params_from_train_state)
    assert w3.poll_once()
    assert '"kind": "serving", "phase": "stage"' in sink.getvalue()


def test_serving_cli_serves_and_watches_a_trainer_checkpoint(tmp_path,
                                                             capsys):
    """The LM trainer writes its checkpoint; ``python -m
    apex_tpu_torch.serving --checkpoint-dir ... --watch`` builds the
    model at the widths the newest step records and loads its
    masters."""
    from apex_tpu_torch.examples.lm import main_amp
    from apex_tpu_torch.serving import __main__ as cli
    ck = str(tmp_path / "ck")
    main_amp.main(["--synthetic", "--steps", "2", "--device", "cpu",
                   "--vocab", "128", "--hidden", "32", "--layers", "2",
                   "--heads", "2", "--seq-len", "65", "-b", "2",
                   "--checkpoint-dir", ck])
    cli.main(["--model", "gpt_tiny", "--dtype", "float32", "--buckets",
              "32,64", "--requests", "3", "--max-new", "4", "--device",
              "cpu", "--checkpoint-dir", ck, "--watch"])
    out = capsys.readouterr().out
    assert "loaded checkpoint step 2" in out
    assert "served 3/3 requests" in out and "hotswaps 0" in out
    assert cli._widths(ck) == dict(vocab_size=128, hidden_size=32,
                                   max_len=65, num_layers=2, num_heads=2,
                                   mlp_dim=128)
    with pytest.raises(SystemExit):
        cli.main(["--model", "gpt_tiny", "--device", "cpu", "--watch"])
