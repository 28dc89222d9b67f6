"""The multi-process runtime: ``torch.distributed`` start-up, the process
identity and the local spawner — counterpart of
``apex_tpu/parallel/multiproc.py``.

JAX's mesh axis ``"data"`` is, in the port, a ``torch.distributed``
process group with one device per rank (PyTorch's own idiom and the
reference apex's).  Three layers live here:

* :func:`initialize` — the per-process entry.  The coordinator address,
  the rank and the world size default from the environment, in JAX's
  spellings first (``JAX_COORDINATOR_ADDRESS``, ``JAX_PROCESS_ID``,
  ``JAX_NUM_PROCESSES``), then torchrun's (``MASTER_ADDR`` +
  ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``).  With none of them it is a
  no-op returning ``(0, 1)``; with a coordinator it calls
  ``init_process_group`` (NCCL for a CUDA device, gloo for the CPU) even
  at a world of one, as JAX's calls ``jax.distributed.initialize``.  It
  is idempotent, and a process group someone else made is adopted.
* :func:`process_identity` / :func:`is_coordinator` — the one source of
  process identity for the rest of the port (the checkpoint's shards,
  the directory stream's ``host_shard=True``, the trainers' prints).
* :func:`spawn` and :func:`main` — the local spawner (``python -m
  apex_tpu_torch.parallel.multiproc --nproc N script.py ...``): one
  worker per rank with :func:`worker_env` set and ``--rank i`` appended,
  as JAX's does; rank 0 writes to the terminal and rank i > 0 to
  ``GPU_<i>.log``.  A worker that fails stops the others, so no rank
  waits forever in a collective its peer will never join.

A coordinator is ``host:port`` (a TCP store on ``host``), or any
``init_method`` URL ``torch.distributed`` takes (``tcp://host:port``,
``file:///path``: a file store, which needs no port).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["initialize", "process_identity", "is_coordinator", "worker_env",
           "spawn", "main", "shutdown", "LOG_NAME"]

_STATE = {"initialized": False, "procs": None}

#: env spellings of each field, first hit wins (JAX's first, then the
#: torchrun convention the spawner also sets)
_ENV_COORD = ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS")
_ENV_NPROC = ("JAX_NUM_PROCESSES", "WORLD_SIZE")
_ENV_PID = ("JAX_PROCESS_ID", "RANK")

#: where the spawner sends rank i > 0's output (the reference apex's name)
LOG_NAME = "GPU_{}.log"


def _env_int(names) -> Optional[int]:
    for n in names:
        v = os.environ.get(n)
        if v is not None and v.strip():
            try:
                return int(v)
            except ValueError:
                raise ValueError(f"env {n}={v!r} is not an integer")
    return None


def _env_coordinator() -> Optional[str]:
    for n in _ENV_COORD:
        v = os.environ.get(n)
        if v:
            return v
    host, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    if host and port:
        return f"{host}:{port}"
    return None


def _init_method(coordinator: str) -> str:
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def _local_device(local_device_ids, device) -> torch.device:
    """The CUDA device ``local_device_ids`` names (one id, or a sequence
    of one)."""
    if device is not None:
        raise ValueError("pass device= or local_device_ids=, not both")
    ids = ([local_device_ids] if isinstance(local_device_ids, int)
           else list(local_device_ids))
    if len(ids) != 1:
        raise ValueError(
            f"local_device_ids={local_device_ids!r}: NCCL takes one rank a "
            f"GPU, so a process drives exactly one device id")
    return torch.device("cuda", int(ids[0]))


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids=None, *,
               device=None, backend: Optional[str] = None
               ) -> Tuple[int, int]:
    """Join the process group; returns ``(rank, world_size)``.

    Every argument defaults from the environment (the module docstring).
    Without a coordinator and at a count of at most one it does nothing
    and returns ``(0, 1)``, so an entry point calls it unconditionally.
    ``device`` (default CUDA) picks the backend: NCCL for a CUDA device
    (which becomes the current device, ``cuda:<rank % visible>``), gloo
    for the CPU; ``backend`` overrides it (``"gloo"`` on CUDA tensors
    takes ``all_reduce`` and ``broadcast`` only, eagerly).
    ``local_device_ids`` (JAX's argument) names this process's GPU: one
    id, or a one-item sequence, is ``device=torch.device("cuda", id)``;
    NCCL takes one rank a GPU, so more ids raise ``ValueError``, as does
    passing ``device`` beside it.  A second call returns the identity
    the first established."""
    if local_device_ids is not None:
        device = _local_device(local_device_ids, device)
    if _STATE["initialized"]:
        return _STATE["procs"]
    if dist.is_initialized():                  # someone else made it
        _STATE.update(initialized=True,
                      procs=(dist.get_rank(), dist.get_world_size()))
        return _STATE["procs"]
    if coordinator_address is None:
        coordinator_address = _env_coordinator()
    if num_processes is None:
        num_processes = _env_int(_ENV_NPROC)
    if process_id is None:
        process_id = _env_int(_ENV_PID)
    if (num_processes is None or num_processes <= 1) \
            and coordinator_address is None:
        _STATE.update(initialized=True, procs=(0, 1))
        return _STATE["procs"]
    if coordinator_address is None:
        raise ValueError(f"{num_processes} processes need a coordinator "
                         f"(JAX_COORDINATOR_ADDRESS or MASTER_ADDR + "
                         f"MASTER_PORT)")
    world = 1 if num_processes is None else int(num_processes)
    rank = 0 if process_id is None else int(process_id)
    if not 0 <= rank < world:
        raise ValueError(f"process id {rank} not in [0, {world})")
    from .._device import resolve_device
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count()
                              if dev.index is None else dev.index)
    dist.init_process_group(
        backend=backend, init_method=_init_method(coordinator_address),
        world_size=world, rank=rank)
    _STATE.update(initialized=True,
                  procs=(dist.get_rank(), dist.get_world_size()))
    return _STATE["procs"]


def shutdown() -> None:
    """Leave the process group :func:`initialize` made (or adopted) and
    forget the identity; the cached sub-groups and the registered mesh
    go with it."""
    from . import distributed
    distributed._SUBGROUPS.clear()
    distributed._MESH.update(names=(), shape=())
    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE.update(initialized=False, procs=None)


def process_identity() -> Tuple[int, int]:
    """``(rank, world_size)`` of this process, in JAX's resolution order:
    the identity :func:`initialize` established; a live process group
    someone else made; the launcher's environment (a spawned worker that
    has not called :func:`initialize` yet still owns its shard);
    ``(0, 1)``."""
    if _STATE["initialized"]:
        return _STATE["procs"]
    if dist.is_available() and dist.is_initialized():
        return (dist.get_rank(), dist.get_world_size())
    pid, n = _env_int(_ENV_PID), _env_int(_ENV_NPROC)
    if pid is not None and n is not None and n > 1:
        if not 0 <= pid < n:
            raise ValueError(f"process id {pid} not in [0, {n}) "
                             f"(check RANK/WORLD_SIZE env)")
        return (pid, n)
    return (0, 1)


def is_coordinator() -> bool:
    """True on rank 0: gate single-writer work (log lines, manifest
    extras) on this."""
    return process_identity()[0] == 0


def worker_env(rank: int, nproc: int, coordinator: str,
               base: Optional[dict] = None) -> dict:
    """The environment one spawned worker needs (shared by :func:`spawn`
    and the tests, so the spawner and :func:`initialize`'s autodetection
    cannot drift)."""
    env = dict(os.environ if base is None else base)
    env.update(RANK=str(rank), WORLD_SIZE=str(nproc), LOCAL_RANK=str(rank),
               JAX_COORDINATOR_ADDRESS=coordinator,
               JAX_NUM_PROCESSES=str(nproc),
               JAX_PROCESS_ID=str(rank))
    return env


def spawn(argv: Sequence[str], nproc: int, coordinator: str, *,
          timeout: Optional[float] = None, capture: bool = False,
          env: Optional[dict] = None,
          cwd: Optional[str] = None) -> List[dict]:
    """Run ``python argv... --rank i`` for i in ``range(nproc)`` with
    :func:`worker_env`, and wait for all of them.

    Rank 0 writes to this process's output, rank i > 0 to
    ``GPU_<i>.log`` in ``cwd`` (default: the working directory);
    ``capture=True`` keeps every rank's output instead.  As
    soon as one worker exits non-zero, or ``timeout`` seconds pass, the
    others are killed.  Returns one dict a rank: ``rank``, ``returncode``
    (None: killed at the timeout; -9: killed after a peer failed),
    ``output`` (``capture``) or ``log``."""
    procs, sinks = [], []
    for rank in range(nproc):
        wenv = worker_env(rank, nproc, coordinator, env)
        cmd = [sys.executable, *argv, "--rank", str(rank)]
        if capture:
            out = subprocess.PIPE
        elif rank == 0:
            out = None
        else:
            path = os.path.join(cwd or os.getcwd(), LOG_NAME.format(rank))
            out = open(path, "w")
            sinks.append(out)
        procs.append(subprocess.Popen(
            cmd, env=wenv, cwd=cwd, stdout=out,
            stderr=subprocess.STDOUT if capture else None,
            text=True))
    outputs = [None] * nproc
    if capture:
        import threading

        def drain(i):
            outputs[i] = procs[i].stdout.read()
        readers = [threading.Thread(target=drain, args=(i,), daemon=True)
                   for i in range(nproc)]
        for t in readers:
            t.start()
    deadline = None if timeout is None else time.monotonic() + timeout
    timed_out = False
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs):
                break
            if deadline is not None and time.monotonic() > deadline:
                timed_out = True
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        if capture:
            for t in readers:
                t.join()
        for s in sinks:
            s.close()
    results = []
    for rank, p in enumerate(procs):
        rc = None if timed_out and p.returncode == -9 else p.returncode
        r = {"rank": rank, "returncode": rc}
        if capture:
            r["output"] = outputs[rank]
        elif rank:
            r["log"] = os.path.join(cwd or os.getcwd(),
                                    LOG_NAME.format(rank))
        results.append(r)
    return results


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    parser = argparse.ArgumentParser(
        add_help=False, allow_abbrev=False,
        description="python -m apex_tpu_torch.parallel.multiproc --nproc N "
                    "script.py [args]: one worker per rank")
    parser.add_argument("--nproc", type=int,
                        default=int(os.environ.get("WORLD_SIZE", "1")))
    parser.add_argument("--coordinator", type=str, default="127.0.0.1:12355")
    parser.add_argument("--timeout", type=float, default=None,
                        help="kill every worker after this many seconds")
    args, rest = parser.parse_known_args(argv)
    results = spawn(rest, args.nproc, args.coordinator, timeout=args.timeout)
    bad = [r for r in results if r["returncode"] != 0]
    for r in bad:
        print(f"multiproc: rank {r['rank']} exited {r['returncode']}",
              file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
