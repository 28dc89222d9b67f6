"""The port's checkpoint engine (``apex_tpu_torch.checkpoint``) against
the JAX package's (``apex_tpu.checkpoint``, oracle
``tests/test_checkpoint.py``).

v1 single files: a GPT ``TrainState`` (fp32 masters, O3 bf16 storage,
fp16 leaves) round-trips bit for bit, the scaler, amp state and extras
with it; a dtype mismatch and a missing leaf are rejected; each
package reads the other's file (bf16 as ``uint16`` bits under
``@dtype=bfloat16``).  v2 directories: the manager's async and sync
saves, cadence, retention and a writer error on the caller's thread;
the same step directories, file for file, as JAX's manager writes;
both corrupted by the same helpers (a flipped byte, a truncated shard,
a missing manifest, a missing shard, a leftover ``.tmp``) and read by
both packages' ``list_checkpoints`` / ``latest_checkpoint`` with equal
answers; each package restores the other's directory.
"""

import glob
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from apex_tpu import checkpoint as jckpt
from apex_tpu_torch import checkpoint as ckpt
from apex_tpu_torch import telemetry, training
from apex_tpu_torch.checkpoint import (CheckpointError, CheckpointManager,
                                       latest_checkpoint, list_checkpoints,
                                       load_checkpoint, load_checkpoint_dir,
                                       save_checkpoint)
from apex_tpu_torch.models import gpt_tiny

CFG = dict(vocab_size=96, hidden_size=32, num_layers=2, num_heads=4,
           mlp_dim=64, max_len=16)


def _lm(opt_level="O2", loss_scale=None):
    """gpt_tiny's ``(init_fn, step_fn, params)`` through
    ``make_train_step`` with Adam, the LM trainer's loss."""
    model = gpt_tiny(**CFG, device="cpu", seed=0)

    def loss_fn(p, batch):
        x, y = batch
        logits = torch.func.functional_call(model, p, (x,)).float()
        return torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), y.reshape(-1))
    init_fn, step_fn = training.make_train_step(
        loss_fn, training.adam(1e-2), opt_level=opt_level,
        loss_scale=loss_scale)
    return init_fn, step_fn, {k: v.detach().clone()
                              for k, v in model.state_dict().items()}


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = torch.from_numpy(rng.randint(1, CFG["vocab_size"], (2, 9)))
        out.append((ids[:, :-1], ids[:, 1:]))
    return out


def _leaves(tree):
    return [x for x in torch.utils._pytree.tree_leaves(tree)
            if isinstance(x, torch.Tensor)]


def _assert_same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.view(-1).view(torch.uint8) if x.dim() else x,
                           y.view(-1).view(torch.uint8) if y.dim() else y)


# -- v1 -------------------------------------------------------------------------

@pytest.mark.parametrize("opt_level", ["O2", "O3"])
def test_bitwise_resume(tmp_path, opt_level):
    """10 steps = 5 steps, a save, a load into a fresh template, 5 more:
    bit for bit (O2 fp32 masters, O3 bf16 storage)."""
    init_fn, step_fn, params = _lm(opt_level, "dynamic")
    batches = _batches(10)
    state = init_fn(params)
    for b in batches:
        state, _ = step_fn(state, b)
    part = init_fn(params)
    for b in batches[:5]:
        part, _ = step_fn(part, b)
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, part, step=5)
    restored, _, extra = load_checkpoint(path, init_fn(params))
    assert int(extra["step"]) == 5
    _assert_same(restored, part)
    for b in batches[5:]:
        restored, _ = step_fn(restored, b)
    _assert_same(restored, state)
    if opt_level == "O3":
        assert all(v.dtype == torch.bfloat16
                   for v in restored.params.values())


def test_bf16_and_fp16_leaves_bit_for_bit(tmp_path):
    """bf16 as its 16-bit payload (never through fp32: NaN payloads and
    subnormals survive), fp16 as itself, under JAX's key encoding."""
    bits = torch.from_numpy(np.array(
        [0x7FC1, 0x0001, 0x8000, 0x3F80, 0xFF80], np.uint16).view(np.int16))
    state = {"w": bits.view(torch.bfloat16).reshape(5, 1),
             "h": torch.tensor([1.5, -65504.0, 6e-8], dtype=torch.float16),
             "i": torch.tensor(7, dtype=torch.int32)}
    path = str(tmp_path / "x.npz")
    save_checkpoint(path, state)
    with np.load(path) as z:
        assert z["w@dtype=bfloat16"].dtype == np.uint16
        assert z["h"].dtype == np.float16
    restored, _, _ = load_checkpoint(path, state)
    _assert_same(restored, state)


def test_each_package_reads_the_others_file(tmp_path):
    """The same numpy values through JAX's ``save_checkpoint`` and the
    port's: the files hold the same keys and bytes, and each package
    loads the other's (bf16 included)."""
    rng = np.random.RandomState(3)
    w = rng.randn(4, 3).astype(np.float32)
    jstate = {"dense": {"kernel": jnp.asarray(w, jnp.bfloat16),
                        "bias": jnp.asarray(w[0])}}
    tstate = {"dense": {"kernel": torch.from_numpy(w).bfloat16(),
                        "bias": torch.from_numpy(w[0].copy())}}
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jckpt.save_checkpoint(jpath, jstate, step=3)
    save_checkpoint(tpath, tstate, step=3)
    with np.load(jpath) as a, np.load(tpath) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    got, _, extra = load_checkpoint(jpath, tstate)
    _assert_same(got, tstate)
    assert int(extra["step"]) == 3
    jgot, _, _ = jckpt.load_checkpoint(tpath, jstate)
    np.testing.assert_array_equal(
        np.asarray(jgot["dense"]["kernel"], np.float32),
        tstate["dense"]["kernel"].float().numpy())


def test_scaler_state_roundtrips(tmp_path):
    """A halved dynamic scale (an inf step) survives the checkpoint."""
    init_fn, step_fn, params = _lm("O2", "dynamic")
    state = init_fn(params)
    x, y = _batches(1)[0]
    bad_fn = training.make_train_step(
        lambda p, b: torch.tensor(float("inf")) * sum(
            v.float().sum() for v in p.values()),
        training.adam(1e-2), opt_level="O2", loss_scale="dynamic")[1]
    state, m = bad_fn(state, (x, y))
    assert float(m["loss_scale"]) == 2.0 ** 15
    path = str(tmp_path / "s.npz")
    save_checkpoint(path, state)
    restored, _, _ = load_checkpoint(path, init_fn(params))
    assert float(restored.scaler.loss_scale) == 2.0 ** 15
    assert int(restored.scaler.unskipped) == int(state.scaler.unskipped)
    assert bool(restored.scaler.overflow) == bool(state.scaler.overflow)


def test_dtype_mismatch_rejected(tmp_path):
    init2, _, params = _lm("O2")
    init3, _, _ = _lm("O3")
    path = str(tmp_path / "o2.npz")
    save_checkpoint(path, init2(params))
    with pytest.raises(ValueError, match="opt_level"):
        load_checkpoint(path, init3(params))


def test_missing_and_extra_leaves_rejected(tmp_path):
    init_fn, _, params = _lm("O0")
    path = str(tmp_path / "x.npz")
    save_checkpoint(path, {"only": torch.ones(2)})
    with pytest.raises(KeyError, match="missing leaf"):
        load_checkpoint(path, init_fn(params))
    save_checkpoint(path, {"a": torch.ones(2), "b": torch.ones(2)})
    with pytest.raises(KeyError, match="no matching template leaf"):
        load_checkpoint(path, {"a": torch.zeros(2)})
    with pytest.raises(ValueError, match="shape mismatch"):
        load_checkpoint(path, {"a": torch.zeros(3), "b": torch.zeros(2)})


def test_amp_state_and_extras_roundtrip(tmp_path):
    """``amp.state_dict()`` and extras of every kind, as JAX returns
    them."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.optimizers import FusedSGD
    model = torch.nn.Linear(3, 2)
    opt = FusedSGD(model.parameters(), lr=0.1)
    model, opt = amp.initialize(model, opt, opt_level="O2",
                                loss_scale="dynamic", verbosity=0)
    try:
        sd = amp.state_dict()
        path = str(tmp_path / "amp.npz")
        save_checkpoint(path, {"w": torch.zeros(())}, amp_state=sd,
                        step=7, lr=0.1, run_name="lm-a", resumed=True,
                        note=None, sched={"warmup": 5, "decay": "cosine"})
        _, amp_sd, extra = load_checkpoint(path, {"w": torch.zeros(())})
        jpath = str(tmp_path / "jamp.npz")
        jckpt.save_checkpoint(jpath, {"w": jnp.zeros(())}, amp_state=sd,
                              step=7, lr=0.1, run_name="lm-a",
                              resumed=True, note=None,
                              sched={"warmup": 5, "decay": "cosine"})
        _, jamp_sd, jextra = jckpt.load_checkpoint(jpath,
                                                   {"w": jnp.zeros(())})
    finally:
        amp.shutdown()
    assert sorted(amp_sd) == sorted(jamp_sd)
    assert any("loss_scale" in k for k in amp_sd)
    for k in amp_sd:
        assert float(amp_sd[k]) == float(jamp_sd[k])
    assert int(extra["step"]) == int(jextra["step"]) == 7
    assert float(extra["lr"]) == pytest.approx(0.1)
    assert extra["run_name"] == "lm-a" and extra["resumed"] is True
    assert extra["note"] is None
    assert extra["sched"] == jextra["sched"] == {"warmup": 5,
                                                 "decay": "cosine"}


def test_extras_reject_unserializable(tmp_path):
    with pytest.raises(TypeError, match="not serializable|object dtype"):
        save_checkpoint(str(tmp_path / "x.npz"), {"w": torch.zeros(())},
                        bad=object())


# -- v2: the manager ------------------------------------------------------------

def _state():
    return {"w": torch.arange(24.0), "b": torch.ones(3,
                                                     dtype=torch.bfloat16),
            "n": torch.tensor(5, dtype=torch.int32),
            "f": torch.tensor(True)}


def _jstate():
    return {"w": jnp.arange(24.0, dtype=jnp.float32),
            "b": jnp.ones((3,), jnp.bfloat16),
            "n": jnp.asarray(5, jnp.int32), "f": jnp.asarray(True)}


def test_manager_async_save_restore_roundtrip(tmp_path):
    state = _state()
    with CheckpointManager(str(tmp_path), every_steps=4) as mgr:
        assert not mgr.maybe_save(0, state)
        assert not mgr.maybe_save(2, state)
        assert mgr.maybe_save(4, state, loader_state={"cursor": 4},
                              note="mid")
        assert not mgr.maybe_save(6, state)
        mgr.wait()
        assert mgr.pending == 0 and mgr.latest_step() == 4
        assert mgr.stats["bytes"] > 0 and mgr.stats["d2h_s"] is None
        restored = mgr.restore(like=state)
    assert restored.step == 4 and restored.loader_state == {"cursor": 4}
    assert restored.extra["note"] == "mid" and restored.run_id
    _assert_same(restored.state, state)


def test_manager_snapshot_is_taken_at_save(tmp_path):
    """The async save copies the state when it is called: a later
    in-place update of the tensors does not reach the checkpoint."""
    state = _state()
    with CheckpointManager(str(tmp_path)) as mgr:
        mgr.save(1, state)
        state["w"].add_(1000.0)
        mgr.wait()
        restored = mgr.restore(like=state)
    torch.testing.assert_close(restored.state["w"], torch.arange(24.0),
                               rtol=0, atol=0)


def test_manager_sync_mode_and_retention(tmp_path):
    state = _state()
    with CheckpointManager(str(tmp_path), keep=2, async_write=False) as mgr:
        for step in (1, 2, 3, 4):
            mgr.save(step, state)
    names = sorted(os.path.basename(p) for p in
                   glob.glob(str(tmp_path / "step_*")))
    assert names == ["step_00000003", "step_00000004"]


def test_manager_block_save_orders_after_pending(tmp_path):
    state = _state()
    with CheckpointManager(str(tmp_path), keep=5) as mgr:
        mgr.save(1, state)
        mgr.save(2, state, block=True)
        assert [s for s, _ in list_checkpoints(str(tmp_path))] == [1, 2]


def test_writer_error_surfaces_on_caller(tmp_path):
    state = _state()
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, state)
    mgr.wait()
    shutil.rmtree(str(tmp_path / "ck"))
    open(str(tmp_path / "ck"), "w").close()     # a file where the dir was
    mgr.save(2, state)
    with pytest.raises(CheckpointError, match="writer failed"):
        mgr.wait()
    mgr.close()


def test_manager_refuses_what_is_not_ported(tmp_path):
    # per-process parts are ported (tests/test_torch_multiproc.py); a
    # process index outside the count is refused, as in JAX
    with pytest.raises(ValueError, match="not in"):
        CheckpointManager(str(tmp_path), procs=(2, 2))
    # telemetry= is ported: the pinned recorder gets the checkpoint events
    sink = io.StringIO()
    rec = telemetry.Recorder(sink)
    mgr = CheckpointManager(str(tmp_path), telemetry=rec)
    assert mgr.run_id != rec.run_id     # only the active recorder's id
    mgr.save(1, {"w": torch.ones(2)}, block=True)
    mgr.close()
    assert '"phase": "commit", "step": 1' in sink.getvalue()
    CheckpointManager(str(tmp_path), procs=(0, 1)).close()
    CheckpointManager(str(tmp_path), procs=(1, 2)).close()


def test_bucketed_state_restores_at_the_same_count(tmp_path):
    """A bucketed Adam state (``Packed`` moments) saves with its
    ``bucket_layout`` and restores at the same shard count; a template
    padded longer (another shard count) takes each bucket's true size
    and zeros after it, JAX's reshard-on-read; a flat leaf with no
    recorded layout still raises."""
    model = gpt_tiny(**CFG, device="cpu", seed=0)
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    tx = training.adam(1e-2, bucketed=True)
    state = tx.init(params)
    from apex_tpu_torch.multi_tensor.buckets import BucketStore
    store = BucketStore(params)
    with CheckpointManager(str(tmp_path)) as mgr:
        mgr.save(3, state, bucket_layout=ckpt.bucket_layout(store, 1),
                 block=True)
        restored = mgr.restore(like=tx.init(params))
    _assert_same(restored.state, state)
    wide = state._replace(exp_avg=state.exp_avg._replace(data=tuple(
        torch.zeros(d.numel() + 3) for d in state.exp_avg.data)))
    got = load_checkpoint_dir(str(tmp_path), wide).state
    for a, b in zip(got.exp_avg.data, state.exp_avg.data):
        assert a.numel() == b.numel() + 3
        assert torch.equal(a[:b.numel()], b) and not a[b.numel():].any()
    with CheckpointManager(str(tmp_path / "plain")) as mgr:
        mgr.save(3, state, block=True)
    with pytest.raises(ValueError, match="not a recorded flat bucket"):
        load_checkpoint_dir(str(tmp_path / "plain"), wide)


# -- v2: the layout against JAX's ------------------------------------------------

def _write_both(root, steps=(3, 6, 9, 12)):
    """The same values through JAX's manager and the port's, into
    ``root/jax`` and ``root/port``."""
    jdir, tdir = str(root / "jax"), str(root / "port")
    with jckpt.CheckpointManager(jdir, keep=10, async_write=False,
                                 procs=(0, 1)) as jm:
        for s in steps:
            jm.save(s, _jstate(), loader_state={"cursor": s})
    with CheckpointManager(tdir, keep=10) as tm:
        for s in steps:
            tm.save(s, _state(), loader_state={"cursor": s})
    return jdir, tdir


def _shard(step_dir):
    return glob.glob(os.path.join(step_dir, "shard_*.npz"))[0]


def _flip(step_dir):
    path = _shard(step_dir)
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(path, "wb").write(bytes(data))


def _truncate(step_dir):
    with open(_shard(step_dir), "r+b") as f:
        f.truncate(16)


def _no_manifest(step_dir):
    for m in glob.glob(os.path.join(step_dir, "manifest_*.json")):
        os.remove(m)


def _no_shard(step_dir):
    os.remove(_shard(step_dir))


def _tmp_debris(step_dir):
    """A mid-write crash: the shard only as ``.tmp``, no manifest."""
    path = _shard(step_dir)
    os.replace(path, path + ".tmp")
    _no_manifest(step_dir)


def _bad_version(step_dir):
    m = glob.glob(os.path.join(step_dir, "manifest_*.json"))[0]
    doc = json.load(open(m))
    doc["version"] = 99
    json.dump(doc, open(m, "w"))


CORRUPT = {"flipped_byte": _flip, "truncated_shard": _truncate,
           "missing_manifest": _no_manifest, "missing_shard": _no_shard,
           "tmp_debris": _tmp_debris, "newer_version": _bad_version}


def test_layout_equals_jax_file_for_file(tmp_path):
    jdir, tdir = _write_both(tmp_path)
    for (js, jd), (ts, td) in zip(jckpt.list_checkpoints(jdir),
                                  list_checkpoints(tdir)):
        assert js == ts and os.path.basename(jd) == os.path.basename(td)
        assert sorted(os.listdir(jd)) == sorted(os.listdir(td))
        jm = json.load(open(glob.glob(os.path.join(jd, "manifest_*"))[0]))
        tm = json.load(open(glob.glob(os.path.join(td, "manifest_*"))[0]))
        assert sorted(jm) == sorted(tm)
        for key in ("format", "version", "step", "shard", "n_shards",
                    "file", "loader", "buckets"):
            assert jm[key] == tm[key], key
        with np.load(_shard(jd)) as a, np.load(_shard(td)) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("kind", sorted(CORRUPT))
@pytest.mark.parametrize("where", [-1, -2])
def test_corrupted_directories_read_as_jax_reads_them(tmp_path, kind,
                                                      where):
    """The newest (or the one before it) step corrupted by the same
    helper in both directories: both packages list the same steps and
    pick the same newest valid one, on both directories."""
    jdir, tdir = _write_both(tmp_path)
    for d in (jdir, tdir):
        CORRUPT[kind](list_checkpoints(d)[where][1])
    for d in (jdir, tdir):
        want_list = [(s, os.path.basename(p))
                     for s, p in jckpt.list_checkpoints(d)]
        got_list = [(s, os.path.basename(p)) for s, p in list_checkpoints(d)]
        assert got_list == want_list
        want = jckpt.latest_checkpoint(d)
        got = latest_checkpoint(d)
        assert (got and os.path.basename(got)) == \
            (want and os.path.basename(want))
    expect = "step_00000009" if where == -1 else "step_00000012"
    assert os.path.basename(latest_checkpoint(tdir)) == expect


def test_every_step_corrupt_is_no_checkpoint(tmp_path):
    jdir, tdir = _write_both(tmp_path, steps=(1,))
    for d in (jdir, tdir):
        _flip(list_checkpoints(d)[0][1])
        assert latest_checkpoint(d) is None
        assert jckpt.latest_checkpoint(d) is None
        with pytest.raises(CheckpointError, match="no valid checkpoint"):
            load_checkpoint_dir(d, _state())
    assert CheckpointManager(tdir).restore(like=_state()) is None


def test_each_package_restores_the_others_directory(tmp_path):
    jdir, tdir = _write_both(tmp_path, steps=(2, 5))
    got = load_checkpoint_dir(jdir, _state())
    assert got.step == 5 and got.loader_state == {"cursor": 5}
    _assert_same(got.state, _state())
    jgot = jckpt.load_checkpoint_dir(tdir, _jstate())
    assert jgot.step == 5 and jgot.loader_state == {"cursor": 5}
    for k, v in _state().items():
        np.testing.assert_array_equal(
            np.asarray(jgot.state[k]).astype(np.float32),
            v.float().numpy())
    pinned = load_checkpoint_dir(tdir, _state(), step=2)
    assert pinned.step == 2


def test_restore_puts_leaves_on_the_template_device(tmp_path):
    """Each restored tensor takes its template leaf's device and dtype
    (the CPU here; ``cuda`` templates restore onto the card)."""
    state = _state()
    with CheckpointManager(str(tmp_path)) as mgr:
        mgr.save(1, state, block=True)
        restored = mgr.restore(like=state)
    for k, v in restored.state.items():
        assert v.device == state[k].device and v.dtype == state[k].dtype
