"""Serve a GPT causal LM with the port's engine — counterpart of
``examples/serving/serve_lm.py``.

    python -m apex_tpu_torch.serving --model gpt2_small --dtype bfloat16 \\
        --requests 16 --max-new 32 --buckets 256,1024 --max-seqs 8
    python -m apex_tpu_torch.serving --model gpt_tiny --dtype float32 \\
        --buckets 64,128 --device cpu
    python -m apex_tpu_torch.serving --model gpt_tiny --dtype float32 \\
        --buckets 64,128 --device cpu --checkpoint-dir CKPT --watch

Weights are random, made from ``--seed``, unless ``--checkpoint-dir``
names an LM trainer's checkpoint directory
(``apex_tpu_torch.examples.lm.main_amp --checkpoint-dir``, O2 Adam): then
the model takes the widths its newest valid step records (vocabulary,
hidden size, layers, heads, MLP width, ``max_len``) and its fp32 masters
(``convert.gpt_params_from_train_state``), and ``--watch`` keeps
watching the directory, adopting each newer valid step between
scheduler steps (the engine's ``watch_dir``).  Prompts are synthetic:
lengths drawn uniformly from ``[4, max bucket - max_new)``, token ids
from ``[1, vocab)``.  Runs on CUDA unless ``--device cpu``; prints the
same summary lines as ``serve_lm.py``: the warmup's captured graphs (one
prefill and one decode a bucket; none on the CPU, which runs the plain
step bodies), then the served load with its AOT misses, graph replays
and hot-swaps.  ``--telemetry PATH`` records the engine's events with the
watchdog (``APEX_TPU_TELEMETRY`` also does), ``--trace-sample N`` traces
every Nth request as a span tree and ``--slo SPEC`` folds the requests
into goodput and burn rates, as the JAX script's flags do; read them
with ``python -m apex_tpu_torch.prof.requests PATH``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time

import numpy as np
import torch

from ..checkpoint import (CheckpointError, latest_checkpoint,
                          load_checkpoint_dir)
from ..convert import gpt_params_from_train_state, lm_train_state_like
from .. import telemetry
from ..models import gpt2_small, gpt_tiny
from .engine import ServingEngine

_MODELS = {"gpt2_small": gpt2_small, "gpt_tiny": gpt_tiny}
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _widths(checkpoint_dir) -> dict:
    """The GPT widths of an LM trainer checkpoint, from the leaf shapes
    its newest valid step's manifest records."""
    step_dir = latest_checkpoint(checkpoint_dir)
    if step_dir is None:
        raise CheckpointError(f"no valid checkpoint under "
                              f"{checkpoint_dir!r}")
    with open(glob.glob(os.path.join(step_dir, "manifest_*.json"))[0],
              encoding="utf-8") as f:
        leaves = json.load(f)["leaves"]

    def shape(name):
        return leaves[f"params/{name}"]["shape"]
    vocab, hidden = shape("wte")
    return dict(vocab_size=vocab, hidden_size=hidden,
                max_len=shape("wpe")[0],
                num_layers=sum(k.endswith(".ln1.scale") for k in leaves
                               if k.startswith("params/")),
                num_heads=shape("block_0.attention.query.kernel")[1],
                mlp_dim=shape("block_0.mlp_up.kernel")[1])


def _pct(values, q):
    return values[min(len(values) - 1, int(q * (len(values) - 1)))] * 1e3


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m apex_tpu_torch.serving")
    ap.add_argument("--model", choices=sorted(_MODELS), default="gpt2_small")
    ap.add_argument("--dtype", choices=sorted(_DTYPES), default="bfloat16")
    ap.add_argument("--requests", type=int, default=16,
                    help="closed-loop load: this many synthetic prompts")
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--buckets", default="256,1024",
                    help="comma-separated sequence-length buckets")
    ap.add_argument("--max-seqs", type=int, default=8,
                    help="decode batch width (concurrent sequences)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: cuda (fails without a GPU)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="load the weights from the newest valid step of "
                         "an LM trainer's checkpoint directory")
    ap.add_argument("--watch", action="store_true",
                    help="keep watching --checkpoint-dir and hot-swap "
                         "each newer valid step between scheduler steps")
    ap.add_argument("--telemetry", default=None,
                    help="JSONL stream path (env APEX_TPU_TELEMETRY)")
    ap.add_argument("--trace-sample", type=int, default=None, metavar="N",
                    help="trace every Nth request as a span tree (0/unset: "
                         "off; env APEX_TPU_TRACE_SAMPLE); read it with "
                         "python -m apex_tpu_torch.prof.requests")
    ap.add_argument("--slo", default=None, metavar="SPEC",
                    help="a latency SLO, e.g. "
                         "'ttft_p99<200ms,tpot_p99<30ms' (env "
                         "APEX_TPU_SLO): goodput and burn-rate gauges, "
                         "slo_burn/slo_exhausted alerts")
    args = ap.parse_args(argv)
    if args.watch and not args.checkpoint_dir:
        ap.error("--watch needs --checkpoint-dir")
    rec = None
    if args.telemetry or (os.environ.get("APEX_TPU_TELEMETRY") or "").strip():
        rec = telemetry.start(args.telemetry, watchdog=True,
                              example="serve_lm",
                              trace_sample_n=args.trace_sample,
                              slo=args.slo)
    try:
        _serve(args)
    finally:
        if rec is not None:
            slo_eng = rec.slo
            rec.close()
            if slo_eng is not None and slo_eng.last is not None:
                print("slo:", slo_eng.format_line())
            print("health:", rec.watchdog.format_line())
            if args.trace_sample:
                print(f"requests: python -m apex_tpu_torch.prof.requests "
                      f"{rec.path}"
                      + (f" --slo '{args.slo}'" if args.slo else ""))


def _serve(args) -> None:
    # the LM head is an fp32 product: keep TF32 off on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    buckets = tuple(int(b) for b in args.buckets.split(","))
    widths = _widths(args.checkpoint_dir) if args.checkpoint_dir else {}
    model = _MODELS[args.model](dtype=_DTYPES[args.dtype],
                                device=args.device, seed=args.seed, **widths)
    like, start_step = None, None
    if args.checkpoint_dir:
        like = lm_train_state_like(model)
        restored = load_checkpoint_dir(args.checkpoint_dir, like)
        model.load_state_dict(gpt_params_from_train_state(restored))
        start_step = restored.step
        print(f"loaded checkpoint step {start_step} from "
              f"{args.checkpoint_dir}")
    rng = np.random.RandomState(args.seed)
    eng = ServingEngine(
        model, buckets=buckets, page_size=args.page_size,
        max_seqs=args.max_seqs, device=args.device,
        watch_dir=args.checkpoint_dir if args.watch else None,
        extract=gpt_params_from_train_state, watch_like=like,
        watch_from_step=start_step)
    try:
        t0 = time.perf_counter()
        eng.warmup()
        print(f"warmup: {len(buckets)} bucket(s), "
              f"{eng.stats['captures']} graph(s) captured in "
              f"{time.perf_counter() - t0:.1f}s")
        prompts = [rng.randint(1, model.vocab_size, (int(n),))
                   for n in rng.randint(4, max(buckets) - args.max_new,
                                        args.requests)]
        t0 = time.perf_counter()
        results = eng.generate(prompts, max_new_tokens=args.max_new)
        wall = time.perf_counter() - t0
        ok = [r for r in results if r.ok]
        lats = sorted(r.timings["total_s"] for r in ok)
        print(f"served {len(ok)}/{len(results)} requests, "
              f"{eng.stats['tokens_out']} tokens in {wall:.2f}s "
              f"({eng.stats['tokens_out'] / wall:.1f} tok/s), "
              f"p99 latency {_pct(lats, 0.99):.1f} ms, "
              f"rejected {eng.stats['rejected']}, aot misses "
              f"{eng.stats['aot_misses']}, replays "
              f"{eng.stats['replays']}, hotswaps {eng.stats['hotswaps']}")
        ttfts = sorted(r.timings["ttft_s"] for r in ok)
        tpots = sorted(r.timings["tpot_s"] for r in ok
                       if r.timings["tpot_s"] is not None)
        if ttfts:
            print(f"ttft p50 {_pct(ttfts, 0.5):.1f} / "
                  f"p99 {_pct(ttfts, 0.99):.1f} ms"
                  + (f", tpot p50 {_pct(tpots, 0.5):.2f} / "
                     f"p99 {_pct(tpots, 0.99):.2f} ms" if tpots else ""))
    finally:
        eng.close()


if __name__ == "__main__":
    main()
