"""DP x FSDP training on the mesh front end — counterpart of
``examples/simple/mesh/fsdp_train.py``.

One :class:`~apex_tpu_torch.parallel.mesh.MeshPlan` (``--dp`` and
``--fsdp``, by default pure FSDP over every rank) gives the batch split,
the ZeRO state partitioning (``--zero 2`` shards the optimizer state,
``--zero 3`` the parameters too, gathered bucket by bucket inside the
step), the pipelined loop (``StepPipeline(wrap=ms.pipeline_wrap(state))``
cuts each rank's rows from the global window) and the state ledger.
Each rank is a process started by the spawner:

    python -m apex_tpu_torch.parallel.multiproc --nproc 4 \\
        --coordinator file:///tmp/mesh_store -m \\
        apex_tpu_torch.examples.simple.mesh.fsdp_train --device cpu \\
        --zero 3 --steps 32

Runs on CUDA (NCCL, one rank a card) unless given ``--device cpu``
(gloo).  Every data shard draws its rows from its own stream, as the JAX
example's processes do; here the global window is made on every rank
and ``wrap=`` takes this rank's rows of it.
"""

from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch

from .... import runtime, training
from ...._device import resolve_device
from ....parallel import mesh, multiproc

D_in, D_hidden, D_out = 256, 512, 64


def parse(argv=None):
    ap = argparse.ArgumentParser(description="DP x FSDP on the mesh")
    ap.add_argument("--dp", type=int, default=None,
                    help="data-parallel axis size (default: 1)")
    ap.add_argument("--fsdp", type=int, default=None,
                    help="state-sharding axis size (default: every rank)")
    ap.add_argument("--zero", type=int, default=2, choices=(1, 2, 3))
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--steps-per-call", type=int, default=4)
    ap.add_argument("--batch", type=int, default=16,
                    help="per-data-shard batch size")
    ap.add_argument("--opt-level", default="O2")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--rank", type=int, default=None,
                    help="the rank this process joins as (the spawner "
                         "appends it; default: RANK from the environment)")
    return ap.parse_args(argv)


def loss_fn(p, batch):
    x, y = batch
    h = torch.relu(x @ p["l1.w"].to(x.dtype) + p["l1.b"].to(x.dtype))
    pred = h @ p["l2.w"].to(x.dtype) + p["l2.b"].to(x.dtype)
    return ((pred.float() - y) ** 2).mean()


def run(argv=None, log=print) -> dict:
    """Train; returns the losses read one window behind and the final
    state."""
    args = parse(argv)
    device = resolve_device(args.device)
    rank, world = multiproc.initialize(process_id=args.rank, device=device)
    if not torch.distributed.is_initialized():
        # one process: a group of one, so the plan has a rank to lay out
        store = tempfile.mkdtemp(prefix="fsdp_train_")
        multiproc.shutdown()
        multiproc.initialize(f"file://{store}/store", 1, 0, device=device)
    if args.fsdp is None and args.dp is None:
        plan = mesh.MeshPlan.auto()
    else:
        dp = args.dp or 1
        plan = mesh.MeshPlan(dp=dp, fsdp=args.fsdp or world // dp)
    coordinator = rank == 0
    if coordinator:
        log(f"{plan} zero={args.zero} opt_level={args.opt_level} "
            f"process {rank}/{world}")
    rng = np.random.RandomState(0)

    def tensor(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)
    params = {"l1.w": tensor(rng.randn(D_in, D_hidden) * 0.05),
              "l1.b": tensor(np.zeros(D_hidden)),
              "l2.w": tensor(rng.randn(D_hidden, D_out) * 0.05),
              "l2.b": tensor(np.zeros(D_out))}
    ms = mesh.make_mesh_train_step(loss_fn, training.adam(1e-3), plan,
                                   zero=args.zero,
                                   opt_level=args.opt_level,
                                   loss_scale="dynamic")
    state = ms.init(params)
    spec = ms.state_spec(state)
    led = plan.state_bytes((state.params, state.opt_state),
                           (spec.params, spec.opt_state))
    if coordinator:
        log(f"state: {led['global_bytes'] / 1e6:.2f} MB global, "
            f"{led['bytes_per_device'] / 1e6:.2f} MB/device "
            f"(ratio {led['ratio']})")
    k = args.steps_per_call
    pipe = runtime.StepPipeline(ms.step_fn, k, wrap=ms.pipeline_wrap(state))

    def batches():
        # the global batch of every data shard's rows, one stream each
        streams = [np.random.RandomState(1 + i)
                   for i in range(plan.data_world)]
        for _ in range(args.steps):
            parts = [(r.randn(args.batch, D_in), r.randn(args.batch, D_out)
                      * 0.1) for r in streams]
            yield tuple(tensor(np.concatenate(p)) for p in zip(*parts))

    windows = list(runtime.window_batches(batches(), k))
    pipe.warmup(state, windows[0][0])
    reader = runtime.DeferredMetrics()
    losses = []

    def emit(wm):
        vals = wm.fetch()
        for j in range(wm.n_valid):
            losses.append(float(vals["loss"][j]))
            if coordinator:
                log(f"step {wm.step + j:4d}  loss {losses[-1]:.6f}")
    for window, n_valid in windows:
        state, metrics = pipe.step_window(state, window, n_valid)
        prev = reader.push(metrics, n_valid)
        if prev is not None:
            emit(prev)
    for wm in reader.flush():
        emit(wm)
    if coordinator:
        log(f"final loss {losses[-1]:.6f}")
        log("done")
    return dict(losses=losses, state=state, plan=plan, ms=ms, ledger=led)


def main(argv=None) -> int:
    try:
        run(argv)
    finally:
        multiproc.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
