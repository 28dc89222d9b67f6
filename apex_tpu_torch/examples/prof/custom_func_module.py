"""prof example 3 — a custom autograd function in the profile.

The counterpart of ``examples/prof/custom_func_module.py``: a
``torch.autograd.Function`` whose forward and backward open their own
ranges, so both show under recognizable names; the backward's ops land
in the forward's region with its own scope inside.

    python -m apex_tpu_torch.examples.prof.custom_func_module [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from ... import prof
from ._common import device, parser


class Swishish(torch.autograd.Function):
    """``x * sigmoid(beta * x)`` with a hand-written backward."""

    @staticmethod
    def forward(ctx, x, beta):
        with prof.scope("swishish_fwd"):
            s = torch.sigmoid(beta * x)
            ctx.save_for_backward(x, s, beta)
            return x * s

    @staticmethod
    def backward(ctx, g):
        x, s, beta = ctx.saved_tensors
        with prof.scope("swishish_bwd"):
            ds = s * (1 - s)
            dx = g * (s + x * beta * ds)
            dbeta = (g * x * x * ds).sum()
            return dx, dbeta


def main(argv=None) -> int:
    args = parser("a custom autograd function's costs").parse_args(argv)
    dev = device(args)
    x = torch.from_numpy(np.random.RandomState(0).rand(512, 512)
                         .astype(np.float32)).to(dev).requires_grad_(True)
    beta = torch.tensor(1.5, device=dev, requires_grad=True)

    def grads(x, beta):
        return torch.autograd.grad(Swishish.apply(x, beta).sum(), (x, beta))

    profile = prof.profile_function(grads, x, beta)
    print(profile.summary(top=12))
    bwd = [r for r in profile.records if "swishish_bwd" in r.name]
    print(f"\ncustom-backward ops profiled: {len(bwd)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
