"""prof example 4 — capture, parse and the joined report.

The counterpart of ``examples/prof/end_to_end.py``: a measured trace of
three BERT-tiny O2 training steps (``prof.trace``), the static analysis
of the same step, and measured microseconds joined onto analytic FLOPs
and bytes per op.  On the CPU the trace holds no device kernel, and the
report shows the static columns alone.

    python -m apex_tpu_torch.examples.prof.end_to_end [LOGDIR] [--device cpu]
"""

from __future__ import annotations

import tempfile

import numpy as np
import torch
import torch.nn.functional as F

from ... import prof, training
from ...models.bert import bert_tiny
from ._common import device, parser


def build(dev):
    """``(state, step_fn, batch)``: BERT-tiny's O2 Adam step on a
    classification batch of 8 x 64 tokens, from seed 0."""
    model = bert_tiny(dtype=torch.bfloat16, attention_impl="flash",
                      device=dev, seed=0)
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, 1024, (8, 64))).to(dev)
    labels = torch.from_numpy(rng.randint(0, 2, (8,))).to(dev)

    def loss_fn(p, batch):
        ids_b, y = batch
        logits = torch.func.functional_call(model, p, (ids_b,))
        return F.cross_entropy(logits.float(), y)

    init_fn, step_fn = training.make_train_step(
        loss_fn, training.adam(1e-3), opt_level="O2")
    return init_fn(model.state_dict()), step_fn, (ids, labels)


def main(argv=None) -> int:
    p = parser("capture -> parse -> joined report")
    p.add_argument("logdir", nargs="?", default=None)
    args = p.parse_args(argv)
    logdir = args.logdir or tempfile.mkdtemp(prefix="apex_tpu_torch_prof_")
    state, step_fn, batch = build(device(args))
    state, metrics = step_fn(state, batch)       # warm: builds, allocates
    float(metrics["loss"])
    with prof.trace(logdir) as tr:
        for _ in range(3):
            state, metrics = step_fn(state, batch)
            tr.step()
        float(metrics["loss"])
    print("trace written to", logdir)
    profile = prof.profile_function(step_fn, state, batch)
    trace = prof.parse_trace(logdir)
    print(f"{len(trace.records)} device kernels measured")
    print(prof.attach_measured(profile, trace, top=20))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
