"""prof example 6 — naming a captured graph in profiles.

The counterpart of ``examples/prof/jit_function.py``.  The port's
compiled program is a CUDA graph (``cache.warmup``): its Python body,
and every range it opens, runs once, at capture.  A replay launches the
recorded kernels with no range of their own, so the profile names them
by the range AROUND the replay (``prof.parse`` attributes a graph's
kernels to the ranges enclosing its ``cudaGraphLaunch``).  Hence:

1. ``prof.annotate`` on the function names its ops in the analysis and
   in an eager trace, and records call markers — at capture only, for a
   captured step;
2. the same on a method;
3. a step captured by someone else: wrap each replay in ``prof.scope``.

On the CPU nothing is captured (``cache.warmup`` returns the function):
every call is eager, and the ranges are there on every call.

    python -m apex_tpu_torch.examples.prof.jit_function [--device cpu]
"""

from __future__ import annotations

import tempfile

import torch

from ... import cache, prof
from ._common import device, parser


@prof.annotate("foo")
def foo(x, y):
    return torch.sigmoid(x) + y


class Model:
    def __init__(self, w):
        self.w = w

    @prof.annotate("Model.forward")
    def forward(self, x):
        return torch.tanh(x @ self.w)


def third_party(x):
    return torch.exp(x) * 2.0


def main(argv=None) -> int:
    args = parser("naming captured graphs").parse_args(argv)
    dev = device(args)
    prof.init()                                 # enable the call markers
    try:
        x = torch.zeros((4, 4), device=dev)
        y = torch.ones((4, 4), device=dev)
        m = Model(torch.ones((4, 8), device=dev))
        foo_step = cache.warmup(foo, x, y)      # captured on CUDA
        third = cache.warmup(third_party, x)
        logdir = tempfile.mkdtemp(prefix="apex_tpu_torch_prof_graph_")
        with prof.trace(logdir):
            z = foo_step(x, y)                  # replay: no range inside
            h = m.forward(x)                    # eager: its own range
            with prof.scope("third_party"):     # the range around a replay
                t = third(x)
        print("foo:", float(z.sum()), " forward:", float(h.sum()),
              " third_party:", float(t.sum()))
        trace = prof.parse_trace(logdir)
        regions = sorted({r.hlo_module or "<unattributed>"
                          for r in trace.records})
        print("kernel regions in the trace:", regions)
        p = prof.profile_function(foo, x, y)
        print(p.summary(top=5))
        recorded = [mk["op"] for mk in prof.MARKERS]
        print("markers recorded:", recorded)
        if "foo" not in recorded or "Model.forward" not in recorded:
            raise SystemExit("markers missing")
    finally:
        prof.init(enable_markers=False)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
