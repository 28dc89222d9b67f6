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
``--compilation-cache DIR`` keeps the built kernels in DIR
(:func:`apex_tpu_torch.cache.enable`).

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

Runs on CUDA unless given ``--device cpu``; raises without a GPU.  Not
ported: sequence parallelism (``--sp``, ROADMAP queue 1 item 3,
"Sharding").
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
    p.add_argument("--window", type=int, default=None,
                   help="sliding-window local attention (causal)")
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


def _loss_scale(value):
    if value in (None, "dynamic"):
        return value
    return float(value)


def build(args):
    """``(state, step_fn, batch)`` for the parsed arguments."""
    if not args.synthetic:
        raise SystemExit("only --synthetic data is implemented; pass "
                         "--synthetic")
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    model = GPT(vocab_size=args.vocab, hidden_size=args.hidden,
                num_layers=args.layers, num_heads=args.heads,
                mlp_dim=4 * args.hidden, max_len=args.seq_len,
                dtype=torch.bfloat16, attention_impl="flash",
                num_kv_heads=args.kv_heads, window=args.window,
                device=device, seed=0)
    smoothing, fused = args.smoothing, args.fused_loss

    def loss_fn(params, batch):
        x, y = batch
        return lm_loss(functional_call(model, params, (x,)), y, smoothing,
                       fused)

    init_fn, step_fn = training.make_train_step(
        loss_fn, training.adam(args.lr, weight_decay=args.weight_decay),
        opt_level=args.opt_level, loss_scale=_loss_scale(args.loss_scale))
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
        f"attention=flash  opt_level = {args.opt_level}  steps_per_call "
        f"{k}  on {batch[0].device}")
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
    pipe = runtime.StepPipeline(step_fn, k)
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
                           attention="flash",
                           steps_per_call=args.steps_per_call)
    try:
        res = train(args, log=log)
    finally:
        _telemetry.finish(rec, args, log=log)
    if not all(np.isfinite(res["losses"])):
        raise SystemExit("training diverged: a loss is not finite")
    return res


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
