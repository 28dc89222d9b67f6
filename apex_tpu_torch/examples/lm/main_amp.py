"""Causal-LM pretraining with amp — counterpart of ``examples/lm/main_amp.py``.

GPT with flash attention and FusedLayerNorm (their forward and backward
kernels on the card), trained by ``make_train_step`` with Adam at the
chosen opt level, on the JAX example's synthetic batch (numpy
``RandomState(0)`` token ids in ``[1, vocab)``, next-token pairs, so
``T' = seq_len - 1`` tokens per row).  The loss is the JAX example's:
by default (``--fused-loss``) the fused softmax cross-entropy kernels
(``contrib.xentropy``), with ``--no-fused-loss`` the log_softmax +
gather composition; both label-smoothed, ``padding_idx`` 0 masked, the
mean over every token.  Weight decay applies to every parameter, as the
JAX example's ``training.adam(lr, weight_decay=...)`` does.

The loop runs on :class:`apex_tpu_torch.runtime.StepPipeline`, as the
JAX example's does: ``--steps-per-call K`` runs K steps per host call
(on CUDA one captured graph of K steps, captured before step 0 under
``--aot-warmup``, the default), ``--steps`` rounds up to a multiple of
K, and the losses are read one window behind
(:class:`~apex_tpu_torch.runtime.DeferredMetrics`).
``--compilation-cache DIR`` keeps the built kernels and the tuner's
configs in DIR (:func:`apex_tpu_torch.cache.enable`); the run ends with
the ``tune:`` line when a kernel consulted the tuner's cache.

``--checkpoint-dir DIR`` saves the state (fp32 masters, Adam moments and
step, the scaler) every ``--checkpoint-every`` steps at a window
boundary, asynchronously (``checkpoint.CheckpointManager``), and at the
last step; ``--resume`` restores the newest valid one and runs on to
``--steps`` (a global count), so a killed and resumed run ends bit for
bit where an uninterrupted one does; ``--drain`` (the default) stops at
the next window boundary on SIGTERM/SIGINT after a final checkpoint.

    python -m apex_tpu_torch.examples.lm.main_amp --synthetic --steps 5
    python -m apex_tpu_torch.examples.lm.main_amp --synthetic --steps 32 \\
        --steps-per-call 8
    python -m apex_tpu_torch.examples.lm.main_amp --synthetic --steps 4 \\
        --steps-per-call 2 --device cpu --vocab 256 --hidden 64 --layers 2 \\
        --heads 4 --seq-len 33
    python -m apex_tpu_torch.examples.lm.main_amp --synthetic --steps 8 \\
        --steps-per-call 2 --device cpu --vocab 256 --hidden 64 --layers 2 \\
        --heads 4 --seq-len 33 --checkpoint-dir CKPT --checkpoint-every 2 \\
        --resume

``--telemetry PATH`` records the run's event stream (the window
replays and captures, the one-window-behind metric reads with the loss
and the loss scale, checkpoints, the memory peak; ``python -m
apex_tpu_torch.prof.timeline PATH`` reads it), ``--watchdog`` folds the
run-health rules over it (on by default with ``--telemetry``; a
``health:`` line at exit), ``--metrics-port`` and ``--metrics-textfile``
export live Prometheus metrics; each defaults from the JAX example's
environment variable.  A run without them is bit for bit the same.

``--attention`` picks the GPT's attention (``flash`` by default: the
kernels on CUDA).  ``--sp N`` is JAX's sequence parallelism: one process
a rank under :mod:`apex_tpu_torch.parallel.multiproc` (the world must be
N ranks), the mesh axis ``sp`` over them, ``--attention`` ``ring``,
``ring_flash`` (the flash kernels a ring step) or ``ulysses``, and
``--seq-len`` 1 + a multiple of N.  The next-token pairs are built on
the whole sequence before it is sharded; each rank's step
(``make_train_step(axis_name="sp")``) sees its contiguous shard of T',
which the pipeline's ``wrap=`` cuts from each ``[K, B, T']`` window (JAX's
``P(None, None, "sp")``), and the gradients and the loss are averaged
over the ranks.  On CUDA the ranks run NCCL, one card a rank (not yet
run on more than one card)::

    python -m apex_tpu_torch.parallel.multiproc --nproc 2 \
        --coordinator file:///tmp/sp_store -m \
        apex_tpu_torch.examples.lm.main_amp --synthetic --device cpu \
        --vocab 256 --hidden 64 --layers 2 --heads 4 --seq-len 33 \
        --sp 2 --attention ring_flash

Runs on CUDA unless given ``--device cpu``; raises without a GPU.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from ... import cache, checkpoint, runtime, training
from ..._device import resolve_device
from ...contrib.xentropy import softmax_cross_entropy_loss
from ...models import GPT
from ...prof.capture import scope
from ...tune import dispatch as tune_dispatch
from .. import _telemetry


def parse(argv=None):
    p = argparse.ArgumentParser(
        description="GPT causal-LM pretraining with amp on the port")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("-b", "--batch-size", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=256)
    p.add_argument("--vocab", type=int, default=8192)
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--opt-level", type=str, default="O2")
    p.add_argument("--loss-scale", type=str, default=None,
                   help="a number, or 'dynamic' (default: the opt "
                        "level's, static 1.0)")
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--weight-decay", type=float, default=0.1)
    p.add_argument("--smoothing", type=float, default=0.0)
    p.add_argument("--fused-loss", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="the fused softmax cross-entropy kernels (the "
                        "default); --no-fused-loss is the log_softmax + "
                        "gather composition")
    p.add_argument("--kv-heads", type=int, default=None,
                   help="GQA/MQA: kv heads shared across query heads "
                        "(must divide --heads)")
    p.add_argument("--attention", type=str, default="flash",
                   choices=["full", "blockwise", "flash", "ring",
                            "ring_flash", "ulysses"],
                   help="the GPT's attention_impl (ring, ring_flash and "
                        "ulysses are sequence parallel: --sp)")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel ways: one process a rank, the "
                        "world size")
    p.add_argument("--rank", type=int, default=None,
                   help="the rank this process joins --sp's group as "
                        "(the spawner appends it; default: RANK from the "
                        "environment)")
    p.add_argument("--window", type=int, default=None,
                   help="sliding-window local attention (causal; needs "
                        "--attention flash)")
    p.add_argument("--steps-per-call", type=int, default=1,
                   help="K steps per host call (runtime.StepPipeline: on "
                        "CUDA one captured graph of K steps); --steps "
                        "rounds up to a multiple of K")
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
    p.add_argument("--checkpoint-every", type=int, default=100,
                   help="save cadence in steps (at window boundaries)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the newest valid checkpoint under "
                        "--checkpoint-dir: state and step counter")
    p.add_argument("--drain", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="on SIGTERM/SIGINT finish the window, write a "
                        "final checkpoint and stop")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu")
    _telemetry.add_flags(p)
    return p.parse_args(argv)


def lm_loss(logits, labels, smoothing: float = 0.0, fused: bool = False):
    """Mean label-smoothed next-token loss over ``[..., V]`` logits, in
    fp32; label 0 is padding and contributes 0.  ``fused``: the fused
    cross-entropy kernels; otherwise the JAX example's
    ``--no-fused-loss`` composition."""
    with scope("loss"):
        flat = logits.reshape(-1, logits.shape[-1])
        labels = labels.reshape(-1)
        if fused:
            return softmax_cross_entropy_loss(flat, labels, smoothing).mean()
        logp = F.log_softmax(flat.float(), dim=-1)
        nll = -logp.gather(-1, labels[:, None])[:, 0]
        smooth = -logp.mean(dim=-1)
        losses = (1.0 - smoothing) * nll + smoothing * smooth
        return torch.where(labels == 0, 0.0, losses).mean()


def synthetic_batch(batch_size: int, seq_len: int, vocab: int, device):
    """The JAX example's batch: ``(x, y)`` next-token pairs of
    ``[batch_size, seq_len - 1]`` ids."""
    ids = np.random.RandomState(0).randint(1, vocab, (batch_size, seq_len))
    ids = torch.from_numpy(ids).to(device)
    return ids[:, :-1], ids[:, 1:]


_SEQUENCE_PARALLEL = ("ring", "ring_flash", "ulysses")
#: the mesh axis the sequence is sharded over (JAX's)
SP_AXIS = "sp"


def sequence_shard(tree, axis: int):
    """This rank's contiguous shard on ``axis`` of every tensor of
    ``tree``, the shards in rank order over :data:`SP_AXIS`."""
    from ...parallel.distributed import axis_index, axis_size
    n, r = axis_size(SP_AXIS), axis_index(SP_AXIS)

    def one(t):
        size = t.shape[axis] // n
        return t.narrow(axis, r * size, size)
    return tuple(one(t) for t in tree)


def sp_wrap(fn):
    """``StepPipeline``'s ``wrap=`` for ``--sp``: the window function on
    this rank's shard of T' of each ``[K, B, T']`` window."""
    def wrapped(state, window, valid):
        return fn(state, sequence_shard(window, 2), valid)
    return wrapped


def _join_sp(args, device) -> None:
    """Join the ``--sp`` ranks' process group and lay the ``sp`` axis
    over it."""
    from ...parallel import distributed, multiproc
    _, world = multiproc.initialize(process_id=args.rank, device=device)
    if world != args.sp:
        raise SystemExit(
            f"--sp {args.sp} runs one process a rank: start {args.sp} "
            f"ranks (python -m apex_tpu_torch.parallel.multiproc --nproc "
            f"{args.sp} ...); the world has {world}")
    distributed.register_mesh((SP_AXIS,), (args.sp,))


def _loss_scale(value):
    if value in (None, "dynamic"):
        return value
    return float(value)


def build(args):
    """``(state, step_fn, batch)`` for the parsed arguments; ``batch`` is
    the whole sequence's (under ``--sp`` a rank steps on
    :func:`sequence_shard` of it on axis 1, after joining the ranks)."""
    if not args.synthetic:
        raise SystemExit("only --synthetic data is implemented; pass "
                         "--synthetic")
    sp = args.sp
    if sp > 1 and args.attention not in _SEQUENCE_PARALLEL:
        raise SystemExit(
            f"--sp {sp} shards the sequence; attention_impl="
            f"{args.attention!r} is shard-local and would silently attend "
            f"within shards only — use ring, ring_flash or ulysses")
    if sp == 1 and args.attention in _SEQUENCE_PARALLEL:
        raise SystemExit(f"--attention {args.attention} shards the "
                         f"sequence over --sp ranks: give --sp > 1")
    if args.window is not None and args.attention != "flash":
        raise SystemExit("--window needs --attention flash")
    if args.kv_heads is not None and args.attention not in (
            "flash", "blockwise", "full"):
        raise SystemExit("--kv-heads needs --attention flash/blockwise/full "
                         "(GQA is shard-local; ring/ulysses paths are MHA)")
    if sp > 1 and (args.seq_len - 1) % sp:
        raise SystemExit(f"--seq-len must be 1 + multiple of --sp "
                         f"(got {args.seq_len}, sp={sp})")
    device = resolve_device(args.device)
    if sp > 1:
        _join_sp(args, device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    model = GPT(vocab_size=args.vocab, hidden_size=args.hidden,
                num_layers=args.layers, num_heads=args.heads,
                mlp_dim=4 * args.hidden, max_len=args.seq_len,
                dtype=torch.bfloat16, attention_impl=args.attention,
                num_kv_heads=args.kv_heads, window=args.window,
                sp_axis=SP_AXIS if sp > 1 else None, device=device, seed=0)
    smoothing, fused = args.smoothing, args.fused_loss

    def loss_fn(params, batch):
        x, y = batch
        return lm_loss(functional_call(model, params, (x,)), y, smoothing,
                       fused)

    init_fn, step_fn = training.make_train_step(
        loss_fn, training.adam(args.lr, weight_decay=args.weight_decay),
        opt_level=args.opt_level, loss_scale=_loss_scale(args.loss_scale),
        axis_name=SP_AXIS if sp > 1 else None)
    state = init_fn(model.state_dict())
    batch = synthetic_batch(args.batch_size, args.seq_len, args.vocab,
                            device)
    return state, step_fn, batch


def train(args, log=print) -> dict:
    """Run to step ``args.steps`` (rounded up to a multiple of
    ``--steps-per-call``; from the resumed step under ``--resume``) in
    windows of K; returns the per-step losses, loss scales and seconds,
    the tokens per step, the final state, the step it stands at, the
    pipeline's counts and the last checkpoint's ``stats``.  A window's metrics are read one window behind; a
    step's seconds are its window's over K, timed on the device's
    timeline (CUDA events; the host clock on the CPU) from the end of one
    window to the end of the next, gaps the host leaves included."""
    if args.compilation_cache:
        cache.enable(args.compilation_cache)
    state, step_fn, batch = build(args)
    n_params = sum(p.numel() for p in state.params.values())
    k = max(1, args.steps_per_call)
    log(f"GPT {args.layers}L/{args.hidden}H  {n_params / 1e6:.1f}M params  "
        f"attention={args.attention}  opt_level = {args.opt_level}  "
        f"steps_per_call {k}  on {batch[0].device}")
    steps = runtime.round_steps(args.steps, k, "--steps", log)
    mgr, restored = checkpoint.open_for_training(
        args.checkpoint_dir, state, every_steps=args.checkpoint_every,
        resume=args.resume, log=log)
    start_step = 0
    if restored is not None:
        state, start_step = restored.state, restored.step
    tokens = args.batch_size * (args.seq_len - 1)
    res = dict(losses=[], loss_scales=[], step_s=[], tokens_per_step=tokens)
    # the synthetic batch is reused every step: one window of K views
    window = tuple(t.unsqueeze(0).expand(k, *t.shape) for t in batch)
    pipe = runtime.StepPipeline(step_fn, k,
                                wrap=sp_wrap if args.sp > 1 else None)
    if args.aot_warmup:
        pipe.warmup(state, window)
    last = runtime.mark(batch[0].device)

    def emit(wm):
        nonlocal last
        vals = wm.fetch()
        step_s = runtime.seconds_between(last, wm.end) / wm.n_valid
        last = wm.end
        for j in range(wm.n_valid):
            loss = float(vals["loss"][j])
            res["losses"].append(loss)
            res["loss_scales"].append(float(vals["loss_scale"][j]))
            res["step_s"].append(step_s)
            log(f"step {start_step + wm.step + j}  loss {loss:.4f}  "
                f"loss_scale {res['loss_scales'][-1]:.0f}  "
                f"{tokens / step_s:,.0f} tok/s")

    windows = ((window, min(k, steps - done))
               for done in range(start_step, steps, k))
    state, reader = pipe.run(state, windows, on_metrics=emit, manager=mgr,
                             start_step=start_step, drain=args.drain,
                             log=log)
    done = start_step + reader.steps_pushed
    mem = pipe.memory_stats()
    if mem is not None:
        log(f"memory: peak {mem['peak_bytes'] / 2**30:.2f} GiB allocated")
    res["state"] = state
    res["step"] = done
    res["checkpoint"] = dict(mgr.stats) if mgr is not None else None
    res["pipeline"] = pipe.stats
    return res


def run(argv=None, log=print) -> dict:
    """The CLI's run: :func:`train` under the recorder the telemetry flags
    ask for, closed (and the ``health:`` line printed) however the run
    ends.  Returns :func:`train`'s result."""
    args = parse(argv)
    rec = _telemetry.start(args, "lm", log=log, opt_level=args.opt_level,
                           attention=args.attention,
                           steps_per_call=args.steps_per_call)
    try:
        res = train(args, log=log)
    finally:
        _telemetry.finish(rec, args, log=log)
    if not all(np.isfinite(res["losses"])):
        raise SystemExit("training diverged: a loss is not finite")
    line = tune_dispatch.coverage_line()
    if line:
        log(line)
    return res


def main(argv=None) -> int:
    from ...parallel import multiproc
    try:
        run(argv)
    finally:
        multiproc.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
