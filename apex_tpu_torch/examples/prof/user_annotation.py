"""prof example 2 — user ranges in the report.

The counterpart of ``examples/prof/user_annotation.py``:
``prof.annotate`` and ``prof.scope`` name a block's regions; after
``prof.init()`` every annotated call records a marker with its
arguments' shapes, and the analysis attributes each op to its scope.

    python -m apex_tpu_torch.examples.prof.user_annotation [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from ... import prof
from ._common import device, parser


@prof.annotate("bottleneck_block")
def bottleneck(x, w1, w2):
    with prof.scope("pointwise_in"):
        h = x @ w1
    with prof.scope("activation"):
        h = torch.relu(h)
    with prof.scope("pointwise_out"):
        return h @ w2 + x


def main(argv=None) -> int:
    args = parser("named ranges in the cost report").parse_args(argv)
    dev = device(args)
    prof.init()                                 # enable the call markers
    try:
        rng = np.random.RandomState(0)
        x, w1, w2 = (torch.from_numpy(rng.rand(*s).astype(np.float32))
                     .to(dev) for s in ((64, 256), (256, 64), (64, 256)))
        y = bottleneck(x, w1, w2)
        print("markers recorded:", len(prof.MARKERS))
        print(prof.MARKERS[-1]["op"], prof.MARKERS[-1]["args"][0])
        profile = prof.profile_function(bottleneck, x, w1, w2)
        for r in profile.records[:10]:
            if r.name:
                print(f"{r.name:<40} {r.op:<16} {r.flops:>12.0f} flops")
        print("output", tuple(y.shape), float(y.float().sum()))
    finally:
        prof.init(enable_markers=False)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
