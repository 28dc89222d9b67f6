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

    python -m apex_tpu_torch.examples.lm.main_amp --synthetic --steps 5
    python -m apex_tpu_torch.examples.lm.main_amp --synthetic --steps 3 \\
        --device cpu --vocab 256 --hidden 64 --layers 2 --heads 4 --seq-len 33

Runs on CUDA unless given ``--device cpu``; raises without a GPU.  Not
ported: sequence parallelism, step chaining, checkpointing and
telemetry.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from ... import training
from ..._device import resolve_device
from ...contrib.xentropy import softmax_cross_entropy_loss
from ...models import GPT


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
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu")
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
    """Run ``args.steps`` steps; returns the per-step losses, loss
    scales and wall seconds, and the tokens per step.  Each step ends by
    reading its loss, which waits for the device, so a step's seconds
    are the time from its launch to the end of its work on the device."""
    state, step_fn, batch = build(args)
    n_params = sum(p.numel() for p in state.params.values())
    log(f"GPT {args.layers}L/{args.hidden}H  {n_params / 1e6:.1f}M params  "
        f"attention=flash  opt_level = {args.opt_level}  on "
        f"{batch[0].device}")
    tokens = args.batch_size * (args.seq_len - 1)
    res = dict(losses=[], loss_scales=[], step_s=[], tokens_per_step=tokens)
    for i in range(args.steps):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = metrics["loss"].item()
        res["step_s"].append(time.perf_counter() - t0)
        res["losses"].append(loss)
        res["loss_scales"].append(metrics["loss_scale"].item())
        log(f"step {i}  loss {loss:.4f}  loss_scale "
            f"{res['loss_scales'][-1]:.0f}  "
            f"{tokens / res['step_s'][-1]:,.0f} tok/s")
    res["state"] = state
    return res


def main(argv=None) -> int:
    res = train(parse(argv))
    if not all(np.isfinite(res["losses"])):
        raise SystemExit("training diverged: a loss is not finite")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
