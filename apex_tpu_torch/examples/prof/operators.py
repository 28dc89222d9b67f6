"""prof example 8 — an operator sweep inside a profiling window.

The counterpart of ``examples/prof/operators.py``: the elementary tensor
operators (unary and binary dunders, comparisons, matmul, integer ops)
in a ``prof.trace`` window — only the work issued inside it is
captured, as with ``profiler.start()`` / ``stop()`` — and their
analytic costs.

    python -m apex_tpu_torch.examples.prof.operators [LOGDIR] [--device cpu]
"""

from __future__ import annotations

import tempfile

import numpy as np
import torch

from ... import prof
from ._common import device, parser

UNARY = ["__abs__", "__neg__"]
BINARY = ["__add__", "__sub__", "__mul__", "__truediv__", "__pow__",
          "__matmul__"]
COMPARE = ["__lt__", "__le__", "__eq__", "__ne__", "__ge__", "__gt__"]
INT_BINARY = ["__and__", "__or__", "__xor__", "__lshift__", "__rshift__",
              "__mod__", "__floordiv__"]


@prof.annotate("operator_sweep")
def sweep(fa, fb, ia, ib):
    outs = []
    for op in UNARY:
        outs.append(getattr(fa, op)())
    for op in BINARY:
        outs.append(getattr(fa, op)(fb))
    for op in COMPARE:
        outs.append(getattr(fa, op)(fb).float())
    for op in INT_BINARY:
        outs.append(getattr(ia, op)(ib).float())
    return sum(o.float().sum() for o in outs)


def main(argv=None) -> int:
    p = parser("operator sweep in a profiling window")
    p.add_argument("logdir", nargs="?", default=None)
    args = p.parse_args(argv)
    dev = device(args)
    logdir = args.logdir or tempfile.mkdtemp(
        prefix="apex_tpu_torch_prof_ops_")
    rng = np.random.RandomState(0)
    fa, fb = (torch.from_numpy((rng.rand(256, 256) + 0.5)
                               .astype(np.float32)).to(dev)
              for _ in range(2))
    ia = torch.from_numpy(rng.randint(1, 100, (256, 256))
                          .astype(np.int32)).to(dev)
    ib = torch.from_numpy(rng.randint(1, 8, (256, 256))
                          .astype(np.int32)).to(dev)
    float(sweep(fa, fb, ia, ib))                # outside the window
    with prof.trace(logdir):                    # profiler.start()
        total = float(sweep(fa, fb, ia, ib))
    float(sweep(fa, fb, ia, ib))                # after stop(): not traced
    print(f"operator sweep total {total:.3e}; trace in {logdir}")
    print(prof.profile_function(sweep, fa, fb, ia, ib).summary(top=12))
    n_ops = len(UNARY) + len(BINARY) + len(COMPARE) + len(INT_BINARY)
    print(f"swept {n_ops} operators")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
