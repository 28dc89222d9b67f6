"""Minimal data-parallel amp example — counterpart of
``examples/simple/distributed/distributed_data_parallel.py``.

The JAX example runs one SPMD program whose ``shard_map`` splits the
batch over the devices; here each rank is a process (started by the
spawner, ``run.sh``), takes its ``N`` rows of the same global batch of
``N x world`` rows, and ``make_train_step(axis_name="data")`` averages
the gradients over the group, so every rank holds the same parameters:

    python -m apex_tpu_torch.parallel.multiproc --nproc 2 \\
        -m apex_tpu_torch.examples.simple.distributed.distributed_data_parallel \\
        --device cpu

Runs on CUDA (NCCL, one rank a card) unless given ``--device cpu``
(gloo); ``--backend gloo`` runs the ranks on one card, eagerly.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.distributed as dist

from .... import training
from ...._device import resolve_device
from ....parallel import multiproc

N, D_in, D_out = 64, 1024, 16


def parse(argv=None):
    p = argparse.ArgumentParser(description="data-parallel amp, linear model")
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--backend", default=None,
                   help="nccl or gloo (default: nccl on CUDA, gloo on CPU)")
    p.add_argument("--rank", type=int, default=None,
                   help="set by the spawner")
    return p.parse_args(argv)


def run(args, log=print) -> dict:
    """Train; returns the final parameters and losses (rank 0 logs)."""
    device = resolve_device(args.device)
    rank, world = multiproc.initialize(device=device, backend=args.backend)
    if not multiproc.is_coordinator():
        def log(*_, **__):
            return None
    log(f"world size {world} ({device.type})")

    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(N * world, D_in).astype(np.float32))
    y = torch.from_numpy(rng.randn(N * world, D_out).astype(np.float32))
    params = {"w": torch.from_numpy(
                  (rng.randn(D_in, D_out) * 0.01).astype(np.float32)),
              "b": torch.zeros((D_out,), dtype=torch.float32)}
    rows = slice(rank * N, (rank + 1) * N)
    batch = (x[rows].to(device), y[rows].to(device))
    params = {k: v.to(device) for k, v in params.items()}

    def loss_fn(p, batch):
        xb, yb = batch
        pred = xb @ p["w"].to(xb.dtype) + p["b"].to(xb.dtype)
        return torch.mean((pred.float() - yb) ** 2)

    # O1: the parameters stay fp32
    init_fn, step_fn = training.make_train_step(
        loss_fn, training.sgd(lr=1e-3), opt_level="O1",
        axis_name="data" if dist.is_initialized() else None)
    state = init_fn(params)
    losses = []
    for t in range(args.steps):
        state, metrics = step_fn(state, batch)
        if t % 100 == 0:
            losses.append(float(metrics["loss"]))
            log(f"step {t}  loss {losses[-1]:.6f}")
    losses.append(float(metrics["loss"]))
    log("final loss", losses[-1])
    return {"params": state.params, "losses": losses}


def main(argv=None) -> int:
    run(parse(argv))
    multiproc.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
