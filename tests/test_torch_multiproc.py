"""The port's multi-process runtime against the JAX package's
(``apex_tpu.parallel.multiproc``) and what reads the process identity.

* ``multiproc``: the environment's spellings and their order, the
  process identity and its errors (each held equal to JAX's under the
  same environment), ``worker_env``, ``initialize`` (a no-op without a
  coordinator, a gloo group of one with a file store, idempotent either
  way), and the spawner: two ranks that all-reduce and write, rank 1's
  output in ``GPU_1.log``; a rank that fails stops its peer; a timeout
  kills both.  ``StepPipeline`` refuses to capture a gloo group's step.
* ``CheckpointManager(procs=(i, 2))``: the port's two parts read by
  JAX's ``load_checkpoint_dir`` and JAX's two parts by the port's, bit
  for bit; a missing part makes the step invalid in both packages.
* ``directory_imagenet(host_shard=True)`` is ``host_shard=
  process_identity()`` (and JAX's stream under the same environment).
* The ImageNet trainer with ``--sync_bn`` on two CPU ranks under the
  spawner (``--fused-bn``: GroupBN ``bn_group=2``; ``--no-fused-bn``:
  the ResNet's SyncBatchNorm) against its own one-process run on the
  whole batch: every leaf of the final checkpoints within rtol/atol
  1e-4 (fp32 sums in another order); both ranks write their part.
* ``examples/simple/distributed`` on two CPU ranks against JAX's example
  step under ``shard_map`` over two devices: the printed losses within
  1e-5.

Every spawn uses a file store under ``tmp_path`` and its own timeout.
"""

import glob
import os
import re
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu import checkpoint as jckpt
from apex_tpu import data as jdata
from apex_tpu import training as jtraining
from apex_tpu.parallel import multiproc as jmp
from apex_tpu_torch import checkpoint as ckpt
from apex_tpu_torch import data, runtime, training
from apex_tpu_torch.examples.imagenet import main_amp as imagenet_main
from apex_tpu_torch.parallel import multiproc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV_NAMES = ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
             "JAX_NUM_PROCESSES", "WORLD_SIZE", "JAX_PROCESS_ID", "RANK",
             "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK")


@pytest.fixture
def clean_env(monkeypatch):
    """No launcher variables and neither package's identity cached."""
    for name in ENV_NAMES:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(multiproc, "_STATE",
                        {"initialized": False, "procs": None})
    monkeypatch.setattr(jmp, "_STATE", {"initialized": False, "procs": None})
    return monkeypatch


ENVS = {
    "none": {},
    "torchrun": dict(RANK="1", WORLD_SIZE="3", MASTER_ADDR="h",
                     MASTER_PORT="9"),
    "jax_first": dict(JAX_PROCESS_ID="2", JAX_NUM_PROCESSES="4", RANK="0",
                      WORLD_SIZE="8", JAX_COORDINATOR_ADDRESS="c:1",
                      MASTER_ADDR="h", MASTER_PORT="9"),
    "one_process": dict(RANK="0", WORLD_SIZE="1"),
    "coordinator_only": dict(COORDINATOR_ADDRESS="c:2"),
}


@pytest.mark.parametrize("name", sorted(ENVS))
def test_environment_resolution_matches_jax(clean_env, name):
    for k, v in ENVS[name].items():
        clean_env.setenv(k, v)
    assert multiproc._env_coordinator() == jmp._env_coordinator()
    for names in (multiproc._ENV_PID, multiproc._ENV_NPROC):
        assert multiproc._env_int(names) == jmp._env_int(names)
    assert multiproc.process_identity() == jmp.process_identity()
    assert multiproc.is_coordinator() == jmp.is_coordinator()


def test_bad_identity_raises_like_jax(clean_env):
    clean_env.setenv("RANK", "3")
    clean_env.setenv("WORLD_SIZE", "2")
    for mod in (multiproc, jmp):
        with pytest.raises(ValueError, match="not in"):
            mod.process_identity()
    clean_env.setenv("RANK", "x")
    for mod in (multiproc, jmp):
        with pytest.raises(ValueError, match="not an integer"):
            mod.process_identity()


def test_worker_env_matches_jax():
    base = {"PATH": "/bin", "RANK": "7"}
    got = multiproc.worker_env(1, 4, "file:///s", base)
    want = jmp.worker_env(1, 4, "file:///s", base)
    assert {k: got[k] for k in want} == want
    assert got["LOCAL_RANK"] == "1" and base["RANK"] == "7"


def test_initialize_is_idempotent_and_refuses_capture_on_gloo(clean_env,
                                                             tmp_path):
    """No coordinator: ``(0, 1)`` twice and no process group.  A file
    coordinator: a gloo group of one, made once; ``process_identity``
    reads it; a data-parallel step on it runs on the CPU, and a
    ``StepPipeline`` would refuse to capture it (gloo waits on the
    host)."""
    import torch.distributed as dist
    assert multiproc.initialize() == (0, 1) == multiproc.initialize()
    assert not dist.is_initialized()
    clean_env.setattr(multiproc, "_STATE",
                      {"initialized": False, "procs": None})
    try:
        coord = f"file://{tmp_path}/store"
        assert multiproc.initialize(coord, 1, 0, device="cpu") == (0, 1)
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        assert multiproc.initialize(coord, 1, 0, device="cpu") == (0, 1)
        assert multiproc.process_identity() == (0, 1)
        init, step = training.make_train_step(
            lambda p, b: (p["w"] * b).sum(), training.sgd(0.1),
            opt_level="O0", axis_name="data")
        assert step.process_group is dist.group.WORLD
        state, m = step(init({"w": torch.ones(3)}), torch.arange(3.0))
        torch.testing.assert_close(state.params["w"],
                                   torch.tensor([1.0, 0.9, 0.8]))
        with pytest.raises(RuntimeError, match="gloo"):
            runtime.StepPipeline(step, 2)._check_capturable()
    finally:
        multiproc.shutdown()
    assert not dist.is_initialized()


_ALLREDUCE_SCRIPT = """
import os, sys, time
import torch, torch.distributed as dist
from apex_tpu_torch.parallel import multiproc
rank, world = multiproc.initialize(device="cpu")
assert sys.argv[-2:] == ["--rank", str(rank)], sys.argv
mode = sys.argv[1]
if mode == "fail" and rank == 1:
    sys.exit(3)
if mode == "sleep":
    time.sleep(60)
t = torch.tensor([float(rank + 1)])
dist.all_reduce(t)
print(f"rank {rank} of {world} sum {t.item()}")
open(os.path.join(sys.argv[2], f"r{rank}"), "w").write(str(t.item()))
multiproc.shutdown()
"""


def test_spawner_runs_two_ranks(clean_env, tmp_path):
    """``main`` appends ``--rank i``, gives each rank its environment,
    writes rank 1's output to ``GPU_1.log``; a failing rank stops its
    peer (blocked in a collective); a timeout kills both."""
    script = tmp_path / "w.py"
    script.write_text(_ALLREDUCE_SCRIPT)
    clean_env.setenv("PYTHONPATH", REPO)
    clean_env.setenv("OMP_NUM_THREADS", "1")
    clean_env.chdir(tmp_path)
    args = ["--nproc", "2", "--timeout", "60", "--coordinator",
            f"file://{tmp_path}/s1", str(script), "ok", str(tmp_path)]
    assert multiproc.main(args) == 0
    assert [open(tmp_path / f"r{r}").read() for r in (0, 1)] == ["3.0"] * 2
    assert "rank 1 of 2 sum 3.0" in open(tmp_path / "GPU_1.log").read()
    t0 = time.monotonic()
    res = multiproc.spawn([str(script), "fail", str(tmp_path)], 2,
                          f"file://{tmp_path}/s2", timeout=60, capture=True)
    # rank 0 is killed, or fails on its own first when gloo sees the
    # peer gone; either way well before the timeout
    assert res[1]["returncode"] == 3 and res[0]["returncode"] not in (0,
                                                                      None)
    assert time.monotonic() - t0 < 30
    res = multiproc.spawn([str(script), "sleep", str(tmp_path)], 2,
                          f"file://{tmp_path}/s3", timeout=3, capture=True)
    assert [r["returncode"] for r in res] == [None, None]


# -- what reads the process identity -------------------------------------------------

def _state():
    return {"w": torch.arange(24.0), "b": torch.ones(3, dtype=torch.bfloat16),
            "n": torch.tensor(5, dtype=torch.int32),
            "v": torch.linspace(0, 1, 7)}


def _jstate():
    return {"w": jnp.arange(24.0, dtype=jnp.float32),
            "b": jnp.ones((3,), jnp.bfloat16), "n": jnp.asarray(5, jnp.int32),
            "v": jnp.linspace(0, 1, 7, dtype=jnp.float32)}


def _f32(v):
    if isinstance(v, torch.Tensor):
        return v.float().numpy()
    return np.asarray(v).astype(np.float32)


def _same_values(got, want):
    for k, v in want.items():
        np.testing.assert_array_equal(_f32(got[k]), _f32(v))


def test_checkpoint_parts_cross_read_with_jax(clean_env, tmp_path):
    """Two processes' parts: written by the port (two managers, one a
    process), read by JAX and by the port; written by JAX, read by the
    port; with one part gone the step is invalid in both packages and
    the previous step is the latest."""
    tdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    for step in (2, 4):
        for i in (0, 1):
            with ckpt.CheckpointManager(tdir, keep=5, procs=(i, 2)) as m:
                m.save(step, _state(), loader_state={"cursor": step},
                       note="x")
            with jckpt.CheckpointManager(jdir, keep=5, procs=(i, 2),
                                         async_write=False) as m:
                m.save(step, _jstate(), loader_state={"cursor": step})
    step_dir = os.path.join(tdir, "step_00000004")
    assert sorted(os.listdir(step_dir)) == [
        "manifest_00000_of_00002.json", "manifest_00001_of_00002.json",
        "shard_00000_of_00002.npz", "shard_00001_of_00002.npz"]
    with np.load(os.path.join(step_dir, "shard_00001_of_00002.npz")) as f:
        assert sorted(f.files) == ["b@dtype=bfloat16", "v"]
    jgot = jckpt.load_checkpoint_dir(tdir, _jstate())
    assert jgot.step == 4 and jgot.loader_state == {"cursor": 4}
    _same_values(jgot.state, _state())
    got = ckpt.load_checkpoint_dir(jdir, _state())
    assert got.step == 4 and got.loader_state == {"cursor": 4}
    _same_values(got.state, _jstate())
    got = ckpt.load_checkpoint_dir(tdir, _state())
    assert got.extra["note"] == "x"
    for root in (tdir, jdir):
        os.remove(glob.glob(os.path.join(root, "step_00000004",
                                         "shard_00001_*"))[0])
        for latest in (ckpt.latest_checkpoint, jckpt.latest_checkpoint):
            assert latest(root).endswith("step_00000002")
    with pytest.raises(ValueError, match="not in"):
        ckpt.CheckpointManager(tdir, procs=(2, 2))


def test_checkpoint_procs_default_to_the_process_identity(clean_env,
                                                         tmp_path):
    clean_env.setenv("RANK", "1")
    clean_env.setenv("WORLD_SIZE", "2")
    with ckpt.CheckpointManager(str(tmp_path)) as m:
        assert m.procs == (1, 2)


def _npy_tree(root, classes=("ant", "bee", "cat"), per_class=6, size=8):
    rng = np.random.RandomState(0)
    for cls in classes:
        d = root / cls
        d.mkdir()
        for i in range(per_class):
            np.save(d / f"s{i}.npy",
                    rng.randint(0, 256, (size, size, 3)).astype(np.uint8))
    return str(root)


def _descriptors(stream):
    return [(t.paths, t.labels.tolist(), t.seq) for t in stream]


@pytest.mark.parametrize("rank", [0, 1])
def test_host_shard_true_is_the_process_identity(clean_env, tmp_path, rank):
    root = _npy_tree(tmp_path)
    clean_env.setenv("RANK", str(rank))
    clean_env.setenv("WORLD_SIZE", "2")
    kw = dict(batch_size=2, image_size=8, epochs=2, seed=5, decode=False)
    got = data.directory_imagenet(root, host_shard=True, **kw)
    assert got.host_shard == (rank, 2)
    seq = _descriptors(got)
    assert seq == _descriptors(data.directory_imagenet(
        root, host_shard=multiproc.process_identity(), **kw))
    assert seq == _descriptors(jdata.directory_imagenet(
        root, host_shard=True, **kw))
    assert len(seq) == 8


# -- the trainers under the spawner ------------------------------------------------

def _spawn(argv, nproc, tmp_path, name):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for k in ENV_NAMES:
        env.pop(k, None)
    res = multiproc.spawn(argv, nproc, f"file://{tmp_path}/{name}",
                          timeout=120, capture=True, env=env, cwd=tmp_path)
    if any(r["returncode"] != 0 for r in res):
        pytest.fail("\n".join(f"rank {r['rank']} exited {r['returncode']}:"
                              f"\n{r['output']}" for r in res))
    return res


IMAGENET = ["--synthetic", "--device", "cpu", "--arch", "resnet18", "-b",
            "4", "--image-size", "32", "--prof", "2", "--steps-per-call",
            "2", "--sync_bn"]


@pytest.mark.parametrize("bn", ["--fused-bn", "--no-fused-bn"])
def test_imagenet_sync_bn_two_ranks_equal_one_process(clean_env, tmp_path,
                                                      bn):
    args = IMAGENET + [bn]
    _spawn(["-m", "apex_tpu_torch.examples.imagenet.main_amp", *args,
            "--checkpoint-dir", str(tmp_path / "two")], 2, tmp_path, "s")
    assert imagenet_main.main(args + ["--checkpoint-dir",
                                      str(tmp_path / "one")]) == 0
    step_dir = ckpt.latest_checkpoint(str(tmp_path / "two"))
    assert len(glob.glob(os.path.join(step_dir, "shard_*_of_00002.npz"))) \
        == 2
    like = imagenet_main.build(imagenet_main.parse(args))[0]
    two = ckpt.load_checkpoint_dir(str(tmp_path / "two"), like)
    one = ckpt.load_checkpoint_dir(str(tmp_path / "one"), like)
    assert two.step == one.step == 2
    a = torch.utils._pytree.tree_leaves(two.state)
    b = torch.utils._pytree.tree_leaves(one.state)
    assert len(a) == len(b) > 100
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-4)


def test_simple_distributed_example_matches_jax(clean_env, tmp_path):
    res = _spawn(["-m", "apex_tpu_torch.examples.simple.distributed."
                  "distributed_data_parallel", "--device", "cpu", "--steps",
                  "101"], 2, tmp_path, "s")
    out = res[0]["output"]
    assert "world size 2 (cpu)" in out
    got = [float(v) for v in re.findall(r"step \d+  loss ([\d.]+)", out)]
    n, d_in, d_out, world = 64, 1024, 16, 2
    rng = np.random.RandomState(0)
    x = rng.randn(n * world, d_in).astype(np.float32)
    y = rng.randn(n * world, d_out).astype(np.float32)
    params = {"w": (rng.randn(d_in, d_out) * 0.01).astype(np.float32),
              "b": np.zeros((d_out,), np.float32)}

    def loss_fn(p, batch):
        xb, yb = batch
        pred = xb @ p["w"] + p["b"]
        return jnp.mean((pred.astype(jnp.float32) - yb) ** 2)

    init_fn, step_fn = jtraining.make_train_step(
        loss_fn, jtraining.sgd(lr=1e-3), opt_level="O1", axis_name="data")
    mesh = Mesh(np.array(jax.devices("cpu")[:world]), ("data",))
    step = jax.jit(shard_map(step_fn, mesh=mesh,
                             in_specs=(P(), (P("data"), P("data"))),
                             out_specs=(P(), P())))
    state = init_fn(params)
    want = []
    for t in range(101):
        state, m = step(state, (x, y))
        if t % 100 == 0:
            want.append(float(m["loss"]))
    assert len(got) == 2
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_initialize_takes_local_device_ids_like_jax(clean_env):
    """``local_device_ids`` (JAX's fourth argument): one id, or a
    one-item sequence, names ``cuda:<id>``; more ids, or ``device=``
    beside it, raise ``ValueError`` (NCCL takes one rank a GPU).  In
    one process both packages return ``(0, 1)`` and join nothing."""
    import inspect
    import torch.distributed as dist
    jparams = list(inspect.signature(jmp.initialize).parameters)
    tparams = list(inspect.signature(multiproc.initialize).parameters)
    assert tparams[:4] == jparams[:4] == [
        "coordinator_address", "num_processes", "process_id",
        "local_device_ids"]
    assert multiproc._local_device(3, None) == torch.device("cuda", 3)
    assert multiproc._local_device([1], None) == torch.device("cuda", 1)
    with pytest.raises(ValueError, match="one rank a GPU"):
        multiproc.initialize(local_device_ids=[0, 1])
    with pytest.raises(ValueError, match="not both"):
        multiproc.initialize(local_device_ids=0, device="cpu")
    assert multiproc.initialize(local_device_ids=[0]) == (0, 1) \
        == jmp.initialize(local_device_ids=[0])
    assert not dist.is_initialized()
