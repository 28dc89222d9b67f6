"""prof example 1 — a LeNet-style model walked through the analysis.

The counterpart of ``examples/prof/lenet.py``: a small convnet with
``prof.scope`` regions, its training step's per-op FLOPs and bytes from
the analytic walk (fake tensors: nothing runs), and the total.

    python -m apex_tpu_torch.examples.prof.lenet [--device cpu]

:func:`entry` is the ``--fn`` target the ``prof.analysis``,
``prof.roofline`` and ``prof.memory`` CLIs profile by default (on the
CPU).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ... import prof
from ._common import device, parser


class LeNet(nn.Module):
    """The JAX example's LeNet (NCHW here): two 5x5 'SAME' convs with
    ReLU and 2x2 max-pools, then 120 -> 84 -> 10 dense layers."""

    def __init__(self, device=None):
        super().__init__()
        self.conv1 = nn.Conv2d(1, 6, 5, padding="same", device=device)
        self.conv2 = nn.Conv2d(6, 16, 5, padding="same", device=device)
        self.fc1 = nn.Linear(16 * 8 * 8, 120, device=device)
        self.fc2 = nn.Linear(120, 84, device=device)
        self.fc3 = nn.Linear(84, 10, device=device)

    def forward(self, x):                       # x: [N, 1, 32, 32]
        with prof.scope("conv1"):
            x = F.relu(self.conv1(x))
        x = F.max_pool2d(x, 2)
        with prof.scope("conv2"):
            x = F.relu(self.conv2(x))
        x = F.max_pool2d(x, 2)
        x = x.flatten(1)
        with prof.scope("classifier"):
            x = F.relu(self.fc1(x))
            x = F.relu(self.fc2(x))
            return self.fc3(x)


def train_step(model):
    """``step(params, x, y) -> grads``: one cross-entropy gradient of
    the model at ``params``."""
    def step(params, x, y):
        logits = torch.func.functional_call(model, params, (x,))
        loss = F.cross_entropy(logits, y)
        return torch.autograd.grad(loss, list(params.values()))
    return step


def example(dev, batch: int = 8):
    """``(step, (params, x, y))`` on ``dev``, from seed 0."""
    torch.manual_seed(0)
    model = LeNet(device=dev)
    params = {k: v.detach().requires_grad_(True)
              for k, v in model.named_parameters()}
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(batch, 1, 32, 32).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 10, (batch,)))
    return train_step(model), (params, x.to(dev), y.to(dev))


def entry():
    """The CLIs' default target: LeNet's training step on the CPU."""
    return example(torch.device("cpu"))


def main(argv=None) -> int:
    args = parser("LeNet's per-op cost report").parse_args(argv)
    step, ex = example(device(args))
    profile = prof.profile_function(step, *ex)
    print(profile.summary(top=15))
    print("\ntotal GFLOPs: {:.3f}".format(profile.total_flops / 1e9))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
