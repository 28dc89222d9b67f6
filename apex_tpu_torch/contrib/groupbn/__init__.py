"""GroupBN — NHWC BatchNorm with the reference's constructor surface.

Counterpart of ``apex_tpu/contrib/groupbn/__init__.py``: a thin wrapper
over :class:`apex_tpu_torch.parallel.SyncBatchNorm` under the name
``bn`` (so parameters read ``<site>.bn.scale``, as in flax), NHWC, with
the fused ``bn_relu`` / ``bn_add_relu`` epilogue (``fuse_relu``, ``z``).
``bn_group > 1`` shares statistics among that many processes: the world
of ``world_size`` ranks on ``axis_name`` is cut into contiguous blocks of
``bn_group`` ranks (as ``create_syncbn_process_group`` cuts it), each a
sub-group of SyncBatchNorm's.  The reference exchanges the statistics
through CUDA IPC peer buffers; here they are one ``all_reduce`` over the
sub-group, as JAX's is one ``psum``.
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
    construction).  ``bn_group > 1`` needs ``world_size`` (divisible by
    it) and ``axis_name``; ``bn_group == 1`` syncs nothing, whatever
    ``axis_name`` says."""

    fuse_relu: bool = False

    def __init__(self, num_features: int, fuse_relu: bool = False,
                 bn_group: int = 1, eps: float = 1e-5, momentum: float = 0.1,
                 axis_name: Optional[str] = None,
                 world_size: Optional[int] = None,
                 use_running_average: Optional[bool] = None,
                 scale_init: Callable = torch.ones,
                 bias_init: Callable = torch.zeros, *, device=None):
        super().__init__()
        process_group = None
        if bn_group > 1:
            if world_size is None:
                raise ValueError("bn_group > 1 requires world_size")
            if axis_name is None:
                raise ValueError(
                    "bn_group > 1 requires axis_name (the group the "
                    "replicas live on); without it statistics would stay "
                    "per-replica")
            if world_size % bn_group != 0:
                raise ValueError(f"world_size {world_size} not divisible "
                                 f"by bn_group {bn_group}")
            process_group = [list(range(i, i + bn_group))
                             for i in range(0, world_size, bn_group)]
        else:
            axis_name = None
        self.fuse_relu = fuse_relu
        self.bn_group = int(bn_group)
        self.bn = SyncBatchNorm(
            num_features, eps=eps, momentum=momentum, axis_name=axis_name,
            process_group=process_group, channel_last=True,
            fuse_relu=fuse_relu, use_running_average=use_running_average,
            scale_init=scale_init, bias_init=bias_init, device=device)

    def forward(self, x, z=None, use_running_average=None):
        return self.bn(x, z=z, use_running_average=use_running_average)
