"""ImageNet training with amp — counterpart of
``examples/imagenet/main_amp.py``.

A ResNet (NHWC) trained by ``make_train_step`` with SGD (momentum,
weight decay on every parameter, lr scaled by ``batch / 256``) and the
BatchNorm running statistics as the model state, at the chosen opt level
(bf16 compute under O1-O3, fp32 under O0).  With ``--synthetic`` (or no
``data``) the batch is the JAX example's synthetic batch: the first
batch of ``synthetic_imagenet`` (byte for byte the JAX stream's),
normalized on the device and reused every step, as the JAX example
reuses its staged synthetic window.  Given a ``data`` directory
(``root/<class>/*.{npy,jpg,jpeg,png}``), the batches are
``data.directory_imagenet(..., decode=False)`` windows assembled by
``--workers`` threads (``load_batch``, then ``--augment``'s fused crop,
flip and normalize at the JAX example's per-batch seed, else the
normalize) and staged ``--loader-depth`` ahead through
``runtime.stage_windows``; the run ends with the loader's stall line.

``--checkpoint-dir DIR`` saves the state (parameters, SGD momentum,
BatchNorm statistics, scaler) every ``--checkpoint-every`` steps at a
window boundary, asynchronously (``checkpoint.CheckpointManager``), with
the loader's state taken at the loop's boundary (``stream.state_dict(
consumed=step)``, never the stream's own cursor, which runs ahead), and
a final one at the stopping step; ``--resume`` restores the newest valid
one and the stream's position, so a killed run resumed ends bit for bit
where an uninterrupted one does; ``--drain`` (the default) stops at the
next window boundary on SIGTERM/SIGINT, after a final checkpoint.

    python -m apex_tpu_torch.examples.imagenet.main_amp --synthetic \\
        --arch resnet50 -b 128 --opt-level O2
    python -m apex_tpu_torch.examples.imagenet.main_amp --synthetic \\
        --device cpu --arch resnet18 -b 4 --image-size 32 --prof 4 \\
        --steps-per-call 2
    python -m apex_tpu_torch.examples.imagenet.main_amp DIR --augment \\
        --device cpu --arch resnet18 -b 4 --image-size 32 --epochs 2 \\
        --steps-per-call 2 --checkpoint-dir CKPT --checkpoint-every 2

Defaults as in the JAX example: ``--pallas-conv`` (every convolution,
the stem included, through ``ops.PallasConv`` and the port's NHWC
implicit-GEMM conv kernels; on the CPU their plain version, an fp32
upcast of ``F.conv2d``), ``--fused-bn`` (every ``bn -> relu ->
(+residual)`` chain through ``contrib.groupbn.BatchNorm2d_NHWC`` and the
BN-epilogue kernels) and ``--fused-loss`` (the softmax cross-entropy
kernels, ``padding_idx=-1``: every label is a class).
``--no-pallas-conv`` runs the convolutions through ``F.conv2d`` (cuDNN
on the card) with the same parameters; ``--no-fused-bn`` keeps the plain
flax-style BatchNorm with explicit ReLU and residual adds;
``--no-fused-loss`` the log_softmax + gather composition; ``--bucketed``
keeps the SGD momentum in flat buckets (``training.sgd(bucketed=True)``).
The run ends
with the conv sites' count, as the JAX example's ``tune:`` line does.

The loop runs on :class:`apex_tpu_torch.runtime.StepPipeline`, as the
JAX example's does: ``--steps-per-call K`` runs K steps per host call
(on CUDA one captured graph of K steps, captured before step 0 under
``--aot-warmup``, the default), ``--prof`` and ``--print-freq`` round up
to multiples of K, and the metrics are read one window behind.
``--compilation-cache DIR`` keeps the built kernels in DIR.

Data parallel, as the JAX example's mesh: the trainer calls
``parallel.multiproc.initialize()`` first (a no-op in one process, so a
plain run is exactly a one-process run), and under the spawner

    python -m apex_tpu_torch.parallel.multiproc --nproc N \
        -m apex_tpu_torch.examples.imagenet.main_amp --synthetic ...

each rank steps on its rows ``[r B/N, (r+1) B/N)`` of the same global
batch (``-b`` stays the global batch) with its gradients averaged over
the group (``make_train_step(axis_name="data")``); a ``data`` directory
gives each rank every N-th batch of ``B / N`` images
(``host_shard=True``).  ``--sync_bn`` sums the BatchNorm statistics over
the group: with ``--fused-bn`` through GroupBN ``bn_group=N``, without
through the ResNet's ``sync_bn`` (SyncBatchNorm); in one process it
passes no group, so the statistics are the process's own.  Rank 0
prints; every rank writes its shard of each checkpoint.  On CUDA the
group is NCCL and the K-step graph holds the collectives.
``--stats-json PATH`` writes the run's step times, the pipeline's counts
and every kernel's and collective's launches (rank 0).

``--telemetry PATH`` records the run's event stream (window replays,
captures, the one-window-behind metric reads, the loader's waits and
staging, checkpoints, collectives, the memory peak; ``{rank}`` in PATH
gives each rank its stream, which ``python -m apex_tpu_torch.prof.fleet``
merges), ``--watchdog`` folds the run-health rules over it (on by
default with ``--telemetry``), ``--metrics-port`` and
``--metrics-textfile`` export live Prometheus metrics; the run's last
line is ``health:``, with the conv sites published as counters.  A run
without them is bit for bit the same.

Runs on CUDA unless given ``--device cpu``; raises without a GPU.
"""

from __future__ import annotations

import argparse
import functools
import json
import zlib

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ... import _build, cache, checkpoint, runtime, training
from ..._device import resolve_device
from ...parallel import multiproc
from ...contrib.groupbn import BatchNorm2d_NHWC
from ...contrib.xentropy import softmax_cross_entropy_loss
from ...data import (augment_images, directory_imagenet, format_loader_line,
                     load_batch, normalize_images, synthetic_imagenet)
from ...models import ResNet18, ResNet34, ResNet50, ResNet101, ResNet152
from .. import _telemetry
from ...ops import (PallasConv, conv_dispatch_stats, publish_conv_counters,
                   reset_conv_dispatch_stats)

ARCHS = {"resnet18": ResNet18, "resnet34": ResNet34, "resnet50": ResNet50,
         "resnet101": ResNet101, "resnet152": ResNet152}


def parse(argv=None):
    p = argparse.ArgumentParser(
        description="ResNet ImageNet training with amp on the port")
    p.add_argument("data", nargs="?", default=None,
                   help="the dataset: root/<class>/*.{npy,jpg,jpeg,png} "
                        "(without it, or with --synthetic, the synthetic "
                        "batch)")
    p.add_argument("--arch", "-a", default="resnet18", choices=sorted(ARCHS))
    p.add_argument("--epochs", default=90, type=int)
    p.add_argument("--steps-per-epoch", default=100, type=int)
    p.add_argument("-b", "--batch-size", default=256, type=int)
    p.add_argument("--lr", "--learning-rate", default=0.1, type=float,
                   help="scaled by batch / 256")
    p.add_argument("--momentum", default=0.9, type=float)
    p.add_argument("--weight-decay", "--wd", default=1e-4, type=float)
    p.add_argument("--print-freq", "-p", default=10, type=int)
    p.add_argument("--prof", default=-1, type=int,
                   help="stop after N steps")
    p.add_argument("--opt-level", type=str, default="O0")
    p.add_argument("--bucketed", action="store_true",
                   help="flat-bucket optimizer state: the SGD momentum "
                        "carried as a few large per-dtype buffers "
                        "instead of one per parameter (bit for bit the "
                        "leafwise update)")
    p.add_argument("--keep-batchnorm-fp32", type=str, default=None)
    p.add_argument("--loss-scale", type=str, default=None,
                   help="a number, or 'dynamic'")
    p.add_argument("--fused-bn", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--fused-loss", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--pallas-conv", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="route the ResNet convs through the port's NHWC "
                        "implicit-GEMM conv kernels (ops.PallasConv via "
                        "the conv_cls= hook); --no-pallas-conv runs them "
                        "through F.conv2d with the same parameters")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--workers", default=4, type=int,
                   help="loader threads, each assembling whole K-step "
                        "windows (decode, augment, stack)")
    p.add_argument("--loader-depth", default=2, type=int,
                   help="staged windows held ahead of the loop")
    p.add_argument("--augment", action="store_true",
                   help="random crop and horizontal flip fused with the "
                        "normalize in one native pass (images loaded at "
                        "image-size + 32 and cropped back; real data)")
    p.add_argument("--image-size", default=224, type=int)
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu")
    p.add_argument("--steps-per-call", default=1, type=int,
                   help="K steps per host call (runtime.StepPipeline: on "
                        "CUDA one captured graph of K steps)")
    p.add_argument("--aot-warmup", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="capture the K-step graph before step 0 (the "
                        "default); without it the first window captures")
    p.add_argument("--compilation-cache", default=None, metavar="DIR",
                   help="build and keep the kernels in DIR "
                        "(cache.enable)")
    p.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                   help="save the state every --checkpoint-every steps "
                        "(async; the 3 newest kept) and at the end")
    p.add_argument("--checkpoint-every", default=100, type=int,
                   help="save cadence in steps (at window boundaries)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the newest valid checkpoint under "
                        "--checkpoint-dir: state, step and loader position")
    p.add_argument("--drain", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="on SIGTERM/SIGINT finish the window, write a "
                        "final checkpoint and stop")
    p.add_argument("--sync_bn", action="store_true",
                   help="BatchNorm statistics summed over the process "
                        "group (GroupBN bn_group=world with --fused-bn, "
                        "else SyncBatchNorm)")
    p.add_argument("--rank", type=int, default=None,
                   help="set by the spawner; the rank comes from its "
                        "environment")
    p.add_argument("--stats-json", default=None, metavar="PATH",
                   help="write step times, pipeline counts and launches "
                        "to PATH (rank 0)")
    _telemetry.add_flags(p)
    return p.parse_args(argv)


def _synthetic(args) -> bool:
    return args.synthetic or args.data is None


def _loss_scale(value):
    if value in (None, "dynamic"):
        return value
    return float(value)


def synthetic_batch(batch_size: int, image_size: int, device):
    """The JAX example's synthetic batch: the first of
    ``synthetic_imagenet``, normalized; ``(images [B, S, S, 3] fp32,
    labels [B] int64)`` on ``device``."""
    imgs, labels = next(synthetic_imagenet(batch_size, image_size, steps=1))
    x = normalize_images(torch.from_numpy(imgs).to(device))
    return x, torch.from_numpy(labels.astype(np.int64)).to(device)


def image_loss(logits, labels, fused: bool = True):
    """Mean cross entropy of fp32 logits: the fused kernels
    (``padding_idx=-1``, smoothing 0) or log_softmax + gather."""
    if fused:
        return softmax_cross_entropy_loss(logits.float(), labels,
                                          smoothing=0.0,
                                          padding_idx=-1).mean()
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, labels[:, None]).mean()


def _world(args):
    """``(rank, world size, axis)`` after joining the process group
    (``axis`` "data" when there is a group, else None); ``-b`` must
    divide over the world."""
    rank, world = multiproc.initialize(device=args.device)
    if args.batch_size % world:
        raise SystemExit(f"global batch {args.batch_size} must divide over "
                         f"{world} processes")
    return rank, world, ("data" if dist.is_initialized() else None)


def build(args):
    """``(state, step_fn, batch)`` for the parsed arguments (``batch``
    this rank's rows of the synthetic batch, None for a ``data``
    directory)."""
    rank, world, axis = _world(args)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dtype = (torch.bfloat16 if args.opt_level in ("O1", "O2", "O3")
             else torch.float32)
    sync = axis if args.sync_bn else None
    norm_cls = None
    if args.fused_bn:
        norm_cls = functools.partial(
            BatchNorm2d_NHWC, bn_group=world if sync else 1, axis_name=sync,
            world_size=world if sync else None)
    model = ARCHS[args.arch](num_classes=1000, dtype=dtype,
                             norm_cls=norm_cls,
                             sync_bn=args.sync_bn and not args.fused_bn,
                             axis_name=sync,
                             conv_cls=PallasConv if args.pallas_conv else None,
                             device=device, seed=0)
    reset_conv_dispatch_stats()
    fused_loss = args.fused_loss

    def loss_fn(p, ms, batch):
        xb, yb = batch
        logits, new_ms = model.apply(p, ms, xb, train=True)
        return image_loss(logits, yb, fused_loss), new_ms

    keep_bn = args.keep_batchnorm_fp32
    if isinstance(keep_bn, str):
        keep_bn = keep_bn == "True"
    lr = args.lr * args.batch_size / 256.0
    init_fn, step_fn = training.make_train_step(
        loss_fn, training.sgd(lr=lr, momentum=args.momentum,
                              weight_decay=args.weight_decay,
                              bucketed=args.bucketed),
        opt_level=args.opt_level, loss_scale=_loss_scale(args.loss_scale),
        keep_batchnorm_fp32=keep_bn, axis_name=axis, has_model_state=True)
    params, batch_stats = model.variables()
    state = init_fn({k: v.detach() for k, v in params.items()},
                    {k: v.clone() for k, v in batch_stats.items()})
    batch = None
    if _synthetic(args):
        rows = args.batch_size // world
        batch = tuple(t[rank * rows:(rank + 1) * rows].contiguous()
                      for t in synthetic_batch(args.batch_size,
                                               args.image_size, device))
    return state, step_fn, batch


def assemble_fn(args):
    """The loader's transform of one :class:`~apex_tpu_torch.data.
    BatchFiles`: ``(fp32 NHWC images, int64 labels)``, through the fused
    augment at the JAX example's per-batch seed (the paths' crc32 mixed
    with the global ``seq``, so a resumed run replays the same crops and
    flips) with ``--augment``, else the normalize."""
    def assemble(task):
        imgs, labels = load_batch(task)
        if args.augment:
            rng = np.random.RandomState(
                (zlib.crc32("|".join(task.paths).encode())
                 ^ (task.seq * 2654435761)) & 0x7FFFFFFF)
            imgs = augment_images(imgs, args.image_size, rng)
        else:
            imgs = normalize_images(imgs).numpy()
        return imgs, labels.astype(np.int64)
    return assemble


def train(args, log=print) -> dict:
    """Run the steps (``--prof`` of this run, else ``epochs *
    steps_per_epoch`` synthetic steps or the stream's ``epochs`` passes,
    less the resumed steps), rounded up to a multiple of
    ``--steps-per-call``, in windows of K; returns the per-step losses,
    loss scales and seconds, the images per step, the final state, the
    step it stands at, the pipeline's counts and, for a ``data``
    directory, the loader's counters.  A step's seconds are its window's
    over K, timed on the device's timeline (CUDA events; the host clock
    on the CPU) from the end of one window to the end of the next, gaps
    the host leaves included (a loader stall among them)."""
    if args.compilation_cache:
        cache.enable(args.compilation_cache)
    state, step_fn, batch = build(args)
    _, world, _ = _world(args)
    if not multiproc.is_coordinator():
        def log(*_, **__):
            return None
    device = next(iter(state.params.values())).device
    n_params = sum(p.numel() for p in state.params.values())
    k = max(1, args.steps_per_call)
    synthetic = _synthetic(args)
    log(f"{args.arch}  {n_params / 1e6:.1f}M params  opt_level = "
        f"{args.opt_level}  fused_bn={args.fused_bn}  "
        f"fused_loss={args.fused_loss}  pallas_conv={args.pallas_conv}  "
        f"bucketed={args.bucketed}  steps_per_call {k}  on {device}")
    mgr, restored = checkpoint.open_for_training(
        args.checkpoint_dir, state, every_steps=args.checkpoint_every,
        resume=args.resume, log=log)
    start_step, loader_sd = 0, None
    if restored is not None:
        state, start_step = restored.state, restored.step
        loader_sd = restored.loader_state
    stream = None
    if synthetic:
        steps = max(0, args.epochs * args.steps_per_epoch - start_step)
        # the synthetic batch is reused every step: one window of K views
        window = tuple(t.unsqueeze(0).expand(k, *t.shape) for t in batch)
    else:
        load_size = args.image_size + (32 if args.augment else 0)
        stream = directory_imagenet(args.data, args.batch_size // world,
                                    load_size, epochs=args.epochs,
                                    decode=False,
                                    host_shard=True if world > 1 else None)
        if start_step:
            if loader_sd and "cursor" in loader_sd and "seed" in loader_sd:
                stream.resume(loader_sd)
            else:
                stream.skip(start_step)
        steps = max(0, args.epochs * stream.batches_per_epoch - start_step)
        rows = args.batch_size // world
        window = (torch.zeros((k, rows, args.image_size, args.image_size, 3),
                              device=device),
                  torch.zeros((k, rows), dtype=torch.int64, device=device))
    if args.prof >= 0:
        steps = min(steps, args.prof)
    steps = runtime.round_steps(steps, k, "--prof", log)
    print_freq = runtime.round_steps(max(1, args.print_freq), k,
                                     "--print-freq", log)
    res = dict(losses=[], loss_scales=[], step_s=[],
               images_per_step=args.batch_size)
    pipe = runtime.StepPipeline(step_fn, k)
    if args.aot_warmup:
        pipe.warmup(state, window)
    if synthetic:
        windows = ((window, k) for _ in range(steps // k))
    else:
        windows = runtime.stage_windows(
            stream, k, transform=assemble_fn(args), device=device,
            workers=max(1, args.workers), depth=max(1, args.loader_depth))
    last = runtime.mark(device)

    def emit(wm):
        nonlocal last
        vals = wm.fetch()
        step_s = runtime.seconds_between(last, wm.end) / wm.n_valid
        last = wm.end
        for j in range(wm.n_valid):
            i = start_step + wm.step + j
            res["losses"].append(float(vals["loss"][j]))
            res["loss_scales"].append(float(vals["loss_scale"][j]))
            res["step_s"].append(step_s)
            if i % print_freq == 0 or wm.step + j == steps - 1:
                log(f"iter {i}  loss {res['losses'][-1]:.4f}  speed "
                    f"{args.batch_size / step_s:.1f} img/s  "
                    f"loss_scale {res['loss_scales'][-1]:.0f}")

    def loader_state(step):
        # at the loop's boundary: one batch a step, whatever the loader
        # has pulled ahead
        if stream is None:
            return {"cursor": int(step)}
        return stream.state_dict(consumed=step)

    state, reader = pipe.run(state, windows, steps=steps, on_metrics=emit,
                             manager=mgr, start_step=start_step,
                             loader_state=loader_state, drain=args.drain,
                             log=log)
    gstep = start_step + reader.steps_pushed
    if stream is not None:
        res["loader"] = windows.stats.as_dict()
        log(format_loader_line(res["loader"]))
    mem = pipe.memory_stats()
    if mem is not None:
        log(f"memory: peak {mem['peak_bytes'] / 2**30:.2f} GiB allocated")
    res["state"] = state
    res["step"] = gstep
    res["pipeline"] = pipe.stats
    return res


def write_stats(path: str, res: dict) -> None:
    """The run's numbers as JSON: steps, per-step seconds and losses, the
    pipeline's counts, the world size and every counted kernel's and
    collective's launches (``_build.COUNTED``, the non-zero ones)."""
    stats = dict(steps=len(res["losses"]), step_s=res["step_s"],
                 losses=res["losses"], pipeline=res["pipeline"],
                 world=multiproc.process_identity()[1],
                 launches={w.__name__: w.launches for w in _build.COUNTED
                           if w.launches})
    with open(path, "w") as f:
        json.dump(stats, f, indent=1)


def _health_extras(rec) -> str:
    """The conv sites, published into the registry before the recorder
    closes (so the ``summary`` carries them), for the ``health:`` line."""
    publish_conv_counters(rec.metrics)
    fb = rec.metrics.counter("conv_fallback_sites").value
    pl = rec.metrics.counter("conv_pallas_sites").value
    return f"  conv-sites {pl or 0}p/{fb or 0}xla" if fb or pl else ""


def run(argv=None) -> dict:
    """The CLI's run: :func:`train` under the recorder the telemetry flags
    ask for, closed (and the ``health:`` line printed) however it ends.
    Returns :func:`train`'s result."""
    args = parse(argv)
    coordinator = multiproc.is_coordinator()
    if coordinator:
        print("opt_level =", args.opt_level)
    rec = _telemetry.start(args, "imagenet", arch=args.arch,
                           opt_level=args.opt_level,
                           batch_size=args.batch_size,
                           steps_per_call=args.steps_per_call)
    try:
        res = train(args)
    finally:
        if rec is not None:
            _telemetry.finish(rec, args, extras=_health_extras(rec),
                              log=print if coordinator else
                              (lambda *a, **k: None))
    if not all(np.isfinite(res["losses"])):
        raise SystemExit("training diverged: a loss is not finite")
    if coordinator:
        cs = conv_dispatch_stats()
        print(f"conv sites {cs['pallas_sites']} kernel / "
              f"{cs['fallback_sites']} plain-fallback "
              f"{cs['fallback_reasons'] or ''}".rstrip())
        if args.stats_json:
            write_stats(args.stats_json, res)
        print("done")
    multiproc.shutdown()
    return res


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
