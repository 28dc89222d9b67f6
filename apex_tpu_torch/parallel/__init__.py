"""Parallel: SyncBatchNorm on one process, the LARC gradient rewrite and
its optimizer wrapper (the cross-process statistics, DDP and the mesh
wait for the data-parallel slice)."""

from .LARC import LARC, GradientTransformation, larc_gradients, larc_transform
from .sync_batchnorm import (SyncBatchNorm, adopt_batchnorm_stats,
                             welford_parallel)

__all__ = ["GradientTransformation", "LARC", "SyncBatchNorm",
           "adopt_batchnorm_stats", "larc_gradients", "larc_transform",
           "welford_parallel"]
