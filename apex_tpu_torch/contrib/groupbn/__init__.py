"""GroupBN — NHWC BatchNorm with the reference's constructor surface.

Counterpart of ``apex_tpu/contrib/groupbn/__init__.py``: a thin wrapper
over :class:`apex_tpu_torch.parallel.SyncBatchNorm` under the name
``bn`` (so parameters read ``<site>.bn.scale``, as in flax), NHWC, with
the fused ``bn_relu`` / ``bn_add_relu`` epilogue (``fuse_relu``, ``z``).
``bn_group > 1`` shares statistics across processes, which is not ported
yet and raises.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ...parallel.sync_batchnorm import SyncBatchNorm

__all__ = ["BatchNorm2d_NHWC"]


class BatchNorm2d_NHWC(nn.Module):
    """Reference ctor ``BatchNorm2d_NHWC(planes, fuse_relu=False,
    bn_group=1)``; ``forward(x, z=None, use_running_average=None)``.
    ``num_features`` is required here (torch creates parameters at
    construction)."""

    fuse_relu: bool = False

    def __init__(self, num_features: int, fuse_relu: bool = False,
                 bn_group: int = 1, eps: float = 1e-5, momentum: float = 0.1,
                 axis_name: Optional[str] = None,
                 world_size: Optional[int] = None,
                 use_running_average: Optional[bool] = None,
                 scale_init: Callable = torch.ones,
                 bias_init: Callable = torch.zeros, *, device=None):
        super().__init__()
        if bn_group > 1:
            raise NotImplementedError(
                "bn_group > 1 (statistics shared across processes) is not "
                "ported yet")
        self.fuse_relu = fuse_relu
        # group size 1 == no cross-replica sync, whatever axis_name says
        self.bn = SyncBatchNorm(
            num_features, eps=eps, momentum=momentum, channel_last=True,
            fuse_relu=fuse_relu, use_running_average=use_running_average,
            scale_init=scale_init, bias_init=bias_init, device=device)

    def forward(self, x, z=None, use_running_average=None):
        return self.bn(x, z=z, use_running_average=use_running_average)
