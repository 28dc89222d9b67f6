"""prof example 7 — the library's own fused components.

The counterpart of ``examples/prof/apex_ops.py``: the cost records of
the bucketed ``FusedAdam`` update over a whole parameter set, and of
``FusedLayerNorm`` forward and backward — one ``layer_norm_fwd`` and one
``layer_norm_bwd`` record, the kernels' own formulas, whether the call
would launch the Triton kernels (a CUDA tensor) or run their plain
versions (a CPU one).

    python -m apex_tpu_torch.examples.prof.apex_ops [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from ... import prof
from ...normalization import FusedLayerNorm
from ...optimizers import FusedAdam
from ._common import device, parser


def main(argv=None) -> int:
    args = parser("the fused components' cost records").parse_args(argv)
    dev = device(args)
    rng = np.random.RandomState(0)

    params = []
    for _ in range(8):
        params.append(torch.nn.Parameter(torch.from_numpy(
            (rng.randn(128, 128) / 11).astype(np.float32)).to(dev)))
        params.append(torch.nn.Parameter(torch.zeros(128, device=dev)))
    opt = FusedAdam(params, lr=1e-3, bucketed=True)
    for p in params:
        p.grad = torch.full_like(p, 1e-3)
    opt.step()                       # the state exists before the count

    @prof.annotate("fused_adam_step")
    def adam_step():
        opt.step()

    print("== FusedAdam (bucketed) update ==")
    print(prof.profile_function(adam_step).summary(top=8))

    ln = FusedLayerNorm(256, device=dev)
    x = torch.from_numpy(rng.randn(64, 256).astype(np.float32)).to(dev)

    def ln_grads(x):
        x = x.detach().requires_grad_(True)
        loss = (ln(x).float() ** 2).sum()
        return torch.autograd.grad(loss, [x, *ln.parameters()])

    profile = prof.profile_function(ln_grads, x)
    print("== FusedLayerNorm fwd+bwd ==")
    print(profile.summary(top=8))
    kernels = [r.op for r in profile.records if r.op.startswith("layer_norm")]
    print("kernel records:", kernels)
    g = ln_grads(x)                  # and both really run
    print("adam ok:", float(params[0].detach().flatten()[0]),
          " ln grad ok:", float(g[0].flatten()[0]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
