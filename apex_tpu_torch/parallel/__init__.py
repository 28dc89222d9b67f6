"""Parallel: SyncBatchNorm on one process and the LARC gradient rewrite
(the cross-process statistics, DDP and the mesh wait for the
data-parallel slice)."""

from .LARC import GradientTransformation, larc_gradients, larc_transform
from .sync_batchnorm import (SyncBatchNorm, adopt_batchnorm_stats,
                             welford_parallel)

__all__ = ["GradientTransformation", "SyncBatchNorm",
           "adopt_batchnorm_stats", "larc_gradients", "larc_transform",
           "welford_parallel"]
