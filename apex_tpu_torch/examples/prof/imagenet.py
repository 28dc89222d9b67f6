"""prof example 5 — an ImageNet model's training step.

The counterpart of ``examples/prof/imagenet.py``: any model of the
port's ResNet family (as the ImageNet trainer builds it: the conv
kernels through ``PallasConv``, the fused BN epilogue, the fused loss),
its whole amp training step (forward, backward, the optimizer update)
in the static report, each hand-written kernel counted once by its
formula; then three steps measured and joined.  The reference's CLI:

    python -m apex_tpu_torch.examples.prof.imagenet -m resnet50 -b 32 -o sgd
    python -m apex_tpu_torch.examples.prof.imagenet -m resnet18 -b 4 \\
        --image-size 32 --device cpu
"""

from __future__ import annotations

import functools
import tempfile

import torch

from ... import prof, training
from ...contrib.groupbn import BatchNorm2d_NHWC
from ...ops import PallasConv
from ..imagenet.main_amp import ARCHS, image_loss, synthetic_batch
from ._common import device, parser


def build(arch, batch, opt, image_size, opt_level, dev):
    """``(state, step_fn, batch)`` of ``arch``'s amp training step."""
    model = ARCHS[arch](num_classes=1000, dtype=torch.bfloat16
                        if opt_level != "O0" else torch.float32,
                        norm_cls=functools.partial(BatchNorm2d_NHWC,
                                                   bn_group=1),
                        conv_cls=PallasConv, device=dev, seed=0)

    def loss_fn(p, ms, b):
        logits, new_ms = model.apply(p, ms, b[0], train=True)
        return image_loss(logits, b[1]), new_ms

    tx = (training.sgd(0.1, momentum=0.9) if opt == "sgd"
          else training.adam(1e-3))
    init_fn, step_fn = training.make_train_step(
        loss_fn, tx, opt_level=opt_level, has_model_state=True)
    params, stats = model.variables()
    state = init_fn({k: v.detach() for k, v in params.items()},
                    {k: v.clone() for k, v in stats.items()})
    return state, step_fn, synthetic_batch(batch, image_size, dev)


def main(argv=None) -> int:
    p = parser("profile an ImageNet model's training step")
    p.add_argument("-m", default="resnet18", choices=sorted(ARCHS))
    p.add_argument("-b", type=int, default=8)
    p.add_argument("-o", default="sgd", choices=["sgd", "adam"])
    p.add_argument("--image-size", type=int, default=64)
    p.add_argument("--opt-level", default="O2")
    args = p.parse_args(argv)
    state, step_fn, batch = build(args.m, args.b, args.o, args.image_size,
                                  args.opt_level, device(args))
    profile = prof.profile_function(step_fn, state, batch)
    print(f"== {args.m} b{args.b} {args.opt_level} {args.o}: static ==")
    print(profile.summary(top=15))
    state, metrics = step_fn(state, batch)        # warm outside the trace
    float(metrics["loss"])
    logdir = tempfile.mkdtemp(prefix="apex_tpu_torch_prof_imagenet_")
    with prof.trace(logdir) as tr:
        for _ in range(3):
            state, metrics = step_fn(state, batch)
            tr.step()
        float(metrics["loss"])
    trace = prof.parse_trace(logdir)
    print(f"== measured: {len(trace.records)} device kernels ==")
    print(prof.attach_measured(profile, trace, top=15))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
