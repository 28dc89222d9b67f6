"""DCGAN with amp — counterpart of ``examples/dcgan/main_amp.py``: two
models, two Adam optimizers and THREE losses, each with its own loss
scaler (the reference's baseline config 5).

Two modes, as in the JAX example:

* the default, **pipelined**: one step function carries both parameter
  trees, both Adam states and the three ``LossScalerState``s; an
  iteration is the D phase (G's forward, detached, then D's gradients on
  the real batch under scaler 0 and on the fakes under scaler 1, their
  unscaled sum one Adam step that is skipped on the device when either
  overflowed) and the G phase (G's gradients through the UPDATED
  discriminator under scaler 2).  ``runtime.StepPipeline`` runs
  ``--steps-per-call`` K iterations a host call: on the card one
  captured graph of K iterations.  O0 and O1 only.
* ``--imperative``: the reference's surface — ``amp.initialize([netG,
  netD], [optG, optD], num_losses=3)``, ``amp.scale_loss(loss_id=0/1/2)``
  and ``FusedAdam.step()``; the two D losses accumulate into one D step
  (each ``scale_loss`` moves its unscaled gradients into fp32 master
  gradients and adds them).

Above O0 the three scalers are dynamic in both modes (the JAX example's
pipelined mode and the reference's default; the overflow of one loss
halves only its scaler and skips only its optimizer's step).  Both modes
discard the BatchNorm statistics a forward computes, as the JAX example
drops the updated ``batch_stats``: the models' running statistics stay
as they were built.  The images are ``data.synthetic_imagenet`` at 64 x
64 (the JAX stream's bytes) scaled to ``x / 255 - 0.5``, the noise
``RandomState(0)`` gaussians, ``--data-pool`` batches staged once and
cycled.

The pipelined mode checkpoints the whole GAN (both parameter trees, both
Adam states, the three scaler states) with ``--checkpoint-dir DIR``
every ``--checkpoint-every`` iterations at a window boundary
(``checkpoint.CheckpointManager``) and at the last one; ``--resume``
restores the newest valid one and runs on to ``niter *
iters_per_epoch``, bit for bit an uninterrupted run.  ``--imperative``
refuses them, as the JAX example does: its state lives in the modules
and optimizers, not in one carry.

    python -m apex_tpu_torch.examples.dcgan.main_amp --niter 1
    python -m apex_tpu_torch.examples.dcgan.main_amp --imperative
    python -m apex_tpu_torch.examples.dcgan.main_amp --device cpu \\
        --ngf 8 --ndf 8 --batchSize 4 --iters-per-epoch 4 \\
        --steps-per-call 2
    python -m apex_tpu_torch.examples.dcgan.main_amp --device cpu \\
        --ngf 8 --ndf 8 --batchSize 4 --iters-per-epoch 4 --imperative

``--telemetry PATH``, ``--watchdog``, ``--metrics-port`` and
``--metrics-textfile`` are the JAX example's: the pipelined mode records
its window replays, captures and the one-window-behind metric reads;
``--imperative`` records each ``FusedAdam.step()`` as an ``opt_step``
span and its skips.  A run without them is bit for bit the same.

Runs on CUDA unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import itertools
import time

import numpy as np
import torch
from torch.func import functional_call

from ... import amp, checkpoint, runtime, training
from ..._device import resolve_device
from ...amp import autocast
from ...amp.loss_scaler import LossScaler
from ...data import synthetic_imagenet
from ...models import Discriminator, Generator
from ...optimizers import FusedAdam
from .. import _telemetry


def parse(argv=None):
    p = argparse.ArgumentParser(description="DCGAN with amp on the port")
    p.add_argument("--batchSize", type=int, default=64)
    p.add_argument("--nz", type=int, default=100)
    p.add_argument("--ngf", type=int, default=64)
    p.add_argument("--ndf", type=int, default=64)
    p.add_argument("--niter", type=int, default=1)
    p.add_argument("--iters-per-epoch", type=int, default=20)
    p.add_argument("--lr", type=float, default=0.0002)
    p.add_argument("--beta1", type=float, default=0.5)
    p.add_argument("--opt_level", type=str, default="O1")
    p.add_argument("--print-freq", type=int, default=1,
                   help="print the losses every N iterations (0: only "
                        "the last); the pipelined mode prints whole "
                        "windows, one window behind")
    p.add_argument("--data-pool", type=int, default=8,
                   help="synthetic batches staged once and cycled")
    p.add_argument("--warmup", type=int, default=4,
                   help="iterations left out of the steady rate")
    p.add_argument("--steps-per-call", type=int, default=8,
                   help="pipelined mode: K iterations a host call (on "
                        "CUDA one captured graph of K iterations)")
    p.add_argument("--imperative", action="store_true",
                   help="amp.initialize(num_losses=3) + scale_loss("
                        "loss_id) + FusedAdam.step() instead of the "
                        "pipelined step")
    p.add_argument("--drain", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="on SIGTERM/SIGINT finish the window (the "
                        "iteration) and stop (runtime.GracefulShutdown)")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu")
    p.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                   help="pipelined mode: save the whole GAN state every "
                        "--checkpoint-every iterations and at the end")
    p.add_argument("--checkpoint-every", type=int, default=100,
                   help="save cadence in iterations (at window "
                        "boundaries)")
    p.add_argument("--resume", action="store_true",
                   help="pipelined mode: resume from the newest valid "
                        "checkpoint under --checkpoint-dir")
    _telemetry.add_flags(p)
    return p.parse_args(argv)


def _refuse_not_ported(args):
    if args.imperative and (args.checkpoint_dir or args.resume):
        raise SystemExit(
            "--checkpoint-dir/--resume need the pipelined default (the "
            "functional state carry is what the manager snapshots); drop "
            "--imperative")


def bce_with_logits(logits, target: float):
    """The JAX example's loss: ``mean(max(z, 0) - z t + log1p(exp(-|z|)))``
    of the fp32 logits."""
    z = logits.to(torch.float32)
    return torch.mean(torch.clamp(z, min=0.0) - z * target
                      + torch.log1p(torch.exp(-torch.abs(z))))


def build_models(args, device):
    """``(netG, netD)`` at the arguments' widths, fp32, seeds 0 and 1."""
    return (Generator(ngf=args.ngf, nc=3, nz=args.nz, device=device, seed=0),
            Discriminator(ndf=args.ndf, device=device, seed=1))


def synthetic_pool(args, device):
    """``--data-pool`` ``(real [B, 64, 64, 3], noise [B, nz])`` fp32
    batches on ``device``: the JAX example's pool, byte for byte."""
    rng = np.random.RandomState(0)
    imgs = [im for im, _ in synthetic_imagenet(
        args.batchSize, 64, steps=max(1, args.data_pool))]
    return [(torch.from_numpy(im.astype(np.float32) / 255.0 - 0.5)
             .to(device),
             torch.from_numpy(rng.randn(args.batchSize, args.nz)
                              .astype(np.float32)).to(device))
            for im in imgs]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _dynamic(args) -> bool:
    return args.opt_level != "O0"


def _stats_copy(net):
    """Fresh copies of ``net``'s running statistics: a forward in
    training form writes its batch statistics into them, and they are
    dropped (the JAX example discards the updated ``batch_stats``)."""
    return {k: v.clone() for k, v in net.named_buffers()}


def _forward(net, params, x):
    """``net(x)`` in training form with ``params`` (None: the module's
    own) and thrown-away statistics."""
    swap = _stats_copy(net)
    if params is not None:
        swap.update(params)
    return functional_call(net, swap, (x,))


# -- pipelined mode -----------------------------------------------------------

def build_pipelined(args, netG, netD):
    """``(state, step_fn)``: the pure iteration over both parameter
    trees, both Adam states and the three scaler states."""
    if args.opt_level not in ("O0", "O1"):
        raise SystemExit(f"pipelined dcgan supports O0/O1 (the reference "
                         f"example's levels); got {args.opt_level}: use "
                         f"--imperative for the other opt levels")
    if args.opt_level == "O1":
        amp.init()                       # the O1 policy inside the step
    dynamic = _dynamic(args)
    scalers = [LossScaler("dynamic" if dynamic else 1.0) for _ in range(3)]
    tx = training.adam(lr=args.lr, beta1=args.beta1, beta2=0.999)
    device = next(netG.parameters()).device
    gp = {k: v.detach().clone() for k, v in netG.named_parameters()}
    dp = {k: v.detach().clone() for k, v in netD.named_parameters()}
    state = {"g": gp, "d": dp, "g_opt": tx.init(gp), "d_opt": tx.init(dp),
             "s0": scalers[0].init(device), "s1": scalers[1].init(device),
             "s2": scalers[2].init(device)}

    def grads_of(loss_fn, params, scale):
        """(the loss times ``scale``, the gradients of that)."""
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        with torch.enable_grad():
            loss = loss_fn(leaves).to(torch.float32) * scale
            grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), dict(zip(leaves, grads))

    def step_fn(state, batch):
        real, noise = batch
        # (1) the D phase: G's forward detached, both D losses each under
        # its scaler, one Adam step on the unscaled sum, skipped on the
        # device when either overflowed
        with torch.no_grad():
            fake = _forward(netG, state["g"], noise)
        err_r, g_r = grads_of(lambda p: bce_with_logits(
            _forward(netD, p, real), 1.0), state["d"], state["s0"].loss_scale)
        err_f, g_f = grads_of(lambda p: bce_with_logits(
            _forward(netD, p, fake), 0.0), state["d"], state["s1"].loss_scale)
        g_r, s0 = scalers[0].unscale(g_r, state["s0"])
        g_f, s1 = scalers[1].unscale(g_f, state["s1"])
        mask_d = (torch.logical_not(s0.overflow | s1.overflow)
                  if dynamic else None)
        g_d = {k: g_r[k] + g_f[k] for k in g_r}
        d_new, d_opt = tx.update(g_d, state["d_opt"], state["d"],
                                 apply_mask=mask_d)
        # (2) the G phase against the UPDATED discriminator
        err_g, g_g = grads_of(lambda p: bce_with_logits(
            _forward(netD, d_new, _forward(netG, p, noise)), 1.0),
            state["g"], state["s2"].loss_scale)
        g_g, s2 = scalers[2].unscale(g_g, state["s2"])
        mask_g = torch.logical_not(s2.overflow) if dynamic else None
        g_new, g_opt = tx.update(g_g, state["g_opt"], state["g"],
                                 apply_mask=mask_g)
        metrics = {"loss_d": (err_r / state["s0"].loss_scale
                              + err_f / state["s1"].loss_scale),
                   "loss_g": err_g / state["s2"].loss_scale,
                   "scale": state["s2"].loss_scale}
        autocast.clear_cast_cache()
        return {"g": g_new, "d": d_new, "g_opt": g_opt, "d_opt": d_opt,
                "s0": scalers[0].update_scale(s0),
                "s1": scalers[1].update_scale(s1),
                "s2": scalers[2].update_scale(s2)}, metrics

    return state, step_fn


def stack_window(pool, k: int):
    """K pool batches stacked on a leading axis (the reused window)."""
    return tuple(torch.stack(xs) for xs in
                 zip(*(pool[i % len(pool)] for i in range(k))))


def train_pipelined(args, netG, netD, log=print) -> dict:
    """Run to iteration ``niter * iters_per_epoch`` (rounded up to a
    multiple of K; from the resumed iteration under ``--resume``) in
    windows of K, checkpointing under ``--checkpoint-dir``; returns the
    per-iteration losses, the steady iterations a second, the final
    state, the iteration it stands at and the pipeline's counts."""
    state, step_fn = build_pipelined(args, netG, netD)
    device = next(netG.parameters()).device
    k = max(1, args.steps_per_call)
    total = runtime.round_steps(args.niter * args.iters_per_epoch, k,
                                "--niter * --iters-per-epoch", log)
    mgr, restored = checkpoint.open_for_training(
        args.checkpoint_dir, state, every_steps=args.checkpoint_every,
        resume=args.resume, log=log, unit="iter")
    start = 0
    if restored is not None:
        state, start = restored.state, restored.step
    total -= start
    window = stack_window(synthetic_pool(args, device), k)
    pipe = runtime.StepPipeline(step_fn, k)
    pipe.warmup(state, window)
    print_every = max(1, -(-args.print_freq // k)) if args.print_freq else 0
    ipe = args.iters_per_epoch
    res = dict(loss_d=[], loss_g=[])
    clock = {"steady": None, "warm": 0, "end": None}

    def emit(wm):
        vals = wm.fetch()
        # the read waits for its window: the device is done up to here
        clock["end"] = time.perf_counter()
        for j in range(wm.n_valid):
            res["loss_d"].append(float(vals["loss_d"][j]))
            res["loss_g"].append(float(vals["loss_g"][j]))
        done = start + wm.step + wm.n_valid
        if (print_every and (wm.step // k) % print_every == 0) \
                or done >= start + total:
            log(f"[{(done - 1) // ipe}/{args.niter}][{(done - 1) % ipe}/"
                f"{ipe}] Loss_D: {res['loss_d'][-1]:.4f} "
                f"Loss_G: {res['loss_g'][-1]:.4f}")

    def steady_clock(n):
        if clock["steady"] is None and args.warmup <= n < total:
            _sync(device)
            clock["steady"] = time.perf_counter()
            clock["warm"] = n

    t0 = time.perf_counter()
    state, reader = pipe.run(state, itertools.repeat((window, k)),
                             steps=total, on_metrics=emit,
                             on_window=steady_clock, manager=mgr,
                             start_step=start, drain=args.drain, log=log,
                             unit="iter")
    t1 = clock["end"] if clock["end"] is not None else time.perf_counter()
    res["step"] = start + reader.steps_pushed
    n_steady = reader.steps_pushed - clock["warm"]
    res["it_per_s"] = (n_steady / (t1 - clock["steady"])
                       if clock["steady"] is not None and n_steady > 0
                       else None)
    res["seconds"] = t1 - t0
    res["iters"] = reader.steps_pushed
    res["state"] = state
    res["pipeline"] = pipe.stats
    mem = pipe.memory_stats()
    if mem is not None:
        log(f"memory: peak {mem['peak_bytes'] / 2**30:.2f} GiB allocated")
        res["peak_bytes"] = mem["peak_bytes"]
    return res


# -- imperative mode ----------------------------------------------------------

def train_imperative(args, netG, netD, log=print, on_iter=None) -> dict:
    """The reference's loop through ``amp.initialize`` with three
    scalers, ``amp.scale_loss`` and ``FusedAdam``; ``on_iter(i)`` (a
    test hook) runs before iteration ``i`` and may return a factor
    for ``(errD_real, errD_fake, errG)`` (an inf injects an overflow).
    Returns the per-iteration losses, the steady iterations a second and
    the optimizers."""
    optG = FusedAdam(netG.parameters(), lr=args.lr,
                     betas=(args.beta1, 0.999))
    optD = FusedAdam(netD.parameters(), lr=args.lr,
                     betas=(args.beta1, 0.999))
    [netG, netD], [optG, optD] = amp.initialize(
        [netG, netD], [optG, optD], opt_level=args.opt_level,
        num_losses=3, loss_scale="dynamic" if _dynamic(args) else None,
        verbosity=0)
    device = next(netG.parameters()).device
    pool = synthetic_pool(args, device)
    g_params = list(netG.parameters())
    total = args.niter * args.iters_per_epoch
    ipe = args.iters_per_epoch
    stop = runtime.GracefulShutdown().install() if args.drain else None
    res = dict(loss_d=[], loss_g=[])
    t0 = t_steady = time.perf_counter()
    n = 0
    for it in range(total):
        if it == args.warmup:
            _sync(device)
            t_steady = time.perf_counter()
        mult = on_iter(it) if on_iter is not None else None
        mult = mult or (1.0, 1.0, 1.0)
        real, noise = pool[it % len(pool)]
        # (1) D: the two losses into one step (loss ids 0 and 1)
        optD.zero_grad()
        with torch.no_grad():
            fake = _forward(netG, None, noise)
        err_r = bce_with_logits(_forward(netD, None, real), 1.0) * mult[0]
        with amp.scale_loss(err_r, optD, loss_id=0) as scaled:
            scaled.backward()
        err_f = bce_with_logits(_forward(netD, None, fake), 0.0) * mult[1]
        with amp.scale_loss(err_f, optD, loss_id=1) as scaled:
            scaled.backward()
        optD.step()
        # (2) G through the updated D (loss id 2); D's weights take no
        # gradient
        optG.zero_grad()
        err_g = bce_with_logits(_forward(netD, None, _forward(
            netG, None, noise)), 1.0) * mult[2]
        with amp.scale_loss(err_g, optG, loss_id=2) as scaled:
            scaled.backward(inputs=g_params)
        optG.step()
        n += 1
        if (args.print_freq and (it + 1) % args.print_freq == 0) \
                or it + 1 == total:
            vals = torch.stack([err_r.detach() + err_f.detach(),
                                err_g.detach()]).tolist()     # one read
            res["loss_d"].append(vals[0])
            res["loss_g"].append(vals[1])
            log(f"[{it // ipe}/{args.niter}][{it % ipe}/{ipe}] "
                f"Loss_D: {vals[0]:.4f} Loss_G: {vals[1]:.4f}")
        if stop is not None and stop.draining:
            log(f"drain: stopping at iter {n} ({stop.reason})")
            break
    _sync(device)
    t1 = time.perf_counter()
    if stop is not None:
        stop.uninstall()
    n_steady = n - min(args.warmup, n)
    res["it_per_s"] = (n_steady / (t1 - t_steady) if n_steady > 0
                       and n > args.warmup else None)
    res["seconds"] = t1 - t0
    res["iters"] = n
    res["optimizers"] = (optG, optD)
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device)
        log(f"memory: peak {peak / 2**30:.2f} GiB allocated")
        res["peak_bytes"] = peak
    return res


def run(argv=None, log=print) -> dict:
    """The CLI's run: the mode's trainer under the recorder the telemetry
    flags ask for, closed (and the ``health:`` line printed) however it
    ends.  Returns the trainer's result."""
    args = parse(argv)
    _refuse_not_ported(args)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    netG, netD = build_models(args, device)
    mode = "imperative" if args.imperative else "pipelined"
    log(f"dcgan {mode}  opt_level = {args.opt_level}  batch "
        f"{args.batchSize}  nz {args.nz}  ngf {args.ngf}  ndf "
        f"{args.ndf}  on {device}")
    rec = _telemetry.start(args, "dcgan", log=log, mode=mode,
                           opt_level=args.opt_level,
                           steps_per_call=args.steps_per_call)
    try:
        res = (train_imperative if args.imperative else train_pipelined)(
            args, netG, netD, log=log)
    finally:
        amp.shutdown()
        _telemetry.finish(rec, args, log=log)
    losses = res["loss_d"] + res["loss_g"]
    if not all(np.isfinite(losses)):
        raise SystemExit("training diverged: a loss is not finite")
    if res["it_per_s"] is not None:
        log(f"steady {res['it_per_s']:.2f} it/s")
    log(f"done: {res['iters']} iters in {res['seconds']:.1f} s")
    res["nets"] = (netG, netD)
    return res


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
