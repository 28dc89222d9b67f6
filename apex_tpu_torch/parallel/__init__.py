"""Parallel: SyncBatchNorm on one process (the cross-process statistics,
DDP and the mesh wait for the data-parallel slice)."""

from .sync_batchnorm import (SyncBatchNorm, adopt_batchnorm_stats,
                             welford_parallel)

__all__ = ["SyncBatchNorm", "adopt_batchnorm_stats", "welford_parallel"]
