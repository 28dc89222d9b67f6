"""Parallel: data parallelism over ``torch.distributed`` (DDP,
``Reducer``, the gradient and parameter collectives, the multi-process
runtime), SyncBatchNorm across processes, the LARC gradient rewrite and
its optimizer wrapper, the functional sharding primitives over a
process group (ZeRO-1, tensor, expert and pipeline parallelism),
sequence parallelism (ring, ring-flash and Ulysses attention) and the
mesh front end (``MeshPlan``, ZeRO 1-3) — counterpart of
``apex_tpu/parallel/__init__.py``."""

from typing import Optional

import torch
from torch import nn

from .distributed import (DistributedDataParallel, Reducer,
                          broadcast_params, group_psum, reduce_gradients)
from .expert_parallel import MoEAux, moe_layer
from .LARC import LARC, GradientTransformation, larc_gradients, larc_transform
from .mesh import (MeshPlan, MeshTrainStep, MeshZeroState,
                   make_mesh_train_step, zero_sharded)
from .pipeline import (spmd_pipeline, spmd_pipeline_interleaved,
                       stack_interleaved_stage_params, stack_stage_params)
from .ring_attention import (ring_attention, ring_flash_attention,
                             ulysses_attention)
from .sync_batchnorm import (SyncBatchNorm, adopt_batchnorm_stats,
                             welford_parallel)
from .tensor_parallel import (column_parallel_dense, row_parallel_dense,
                              shard_column, shard_row, tp_mlp,
                              tp_self_attention)
from .zero import Zero1State, zero1, zero1_partition_spec

__all__ = ["DistributedDataParallel", "GradientTransformation", "LARC",
           "MeshPlan", "MeshTrainStep", "MeshZeroState", "MoEAux",
           "Reducer", "SyncBatchNorm", "Zero1State",
           "adopt_batchnorm_stats", "broadcast_params",
           "column_parallel_dense", "convert_syncbn_model",
           "create_syncbn_process_group", "group_psum", "initialize",
           "is_coordinator", "larc_gradients", "larc_transform",
           "make_mesh_train_step", "moe_layer", "process_identity",
           "reduce_gradients", "ring_attention", "ring_flash_attention",
           "row_parallel_dense", "shard_column", "shard_row",
           "spmd_pipeline", "spmd_pipeline_interleaved",
           "stack_interleaved_stage_params", "stack_stage_params",
           "tp_mlp", "tp_self_attention", "ulysses_attention",
           "welford_parallel", "zero1", "zero1_partition_spec",
           "zero_sharded"]


def __getattr__(name):
    # the multiproc names load on first use: importing the module here
    # would put it in sys.modules before ``python -m
    # apex_tpu_torch.parallel.multiproc`` runs it
    if name in ("initialize", "is_coordinator", "process_identity"):
        from . import multiproc
        return getattr(multiproc, name)
    raise AttributeError(name)


def _sync_bn_like(bn: nn.Module, axis_name, process_group, channel_last):
    """The :class:`SyncBatchNorm` that replaces ``bn`` (torch's
    ``_BatchNorm`` or the models' flax-style ``BatchNorm``), its affine
    parameters and running statistics copied."""
    from ..models.resnet import BatchNorm as FlaxStyleBatchNorm
    if isinstance(bn, FlaxStyleBatchNorm):
        num_features = bn.scale.shape[0]
        scale, bias = bn.scale, bn.bias
        mean, var = bn.mean, bn.var
        kw = dict(eps=bn.epsilon, momentum=1.0 - bn.momentum, affine=True,
                  track_running_stats=True,
                  channel_last=True if channel_last is None
                  else channel_last)
    else:
        if bn.momentum is None:
            raise ValueError("a BatchNorm with momentum=None (a cumulative "
                             "average) has no SyncBatchNorm counterpart")
        num_features = bn.num_features
        scale, bias = bn.weight, bn.bias
        mean, var = bn.running_mean, bn.running_var
        kw = dict(eps=bn.eps, momentum=bn.momentum, affine=bn.affine,
                  track_running_stats=bn.track_running_stats,
                  channel_last=bool(channel_last))
    ref = scale if scale is not None else mean
    sync = SyncBatchNorm(num_features, axis_name=axis_name,
                         process_group=process_group,
                         device=ref.device if ref is not None else "cpu",
                         **kw)
    with torch.no_grad():
        if scale is not None and sync.scale is not None:
            sync.scale.copy_(scale)
            sync.bias.copy_(bias)
        if mean is not None:
            sync.running_mean.copy_(mean)
            sync.running_var.copy_(var)
    return sync


def convert_syncbn_model(module: nn.Module, axis_name="data",
                         process_group=None,
                         channel_last: Optional[bool] = None) -> nn.Module:
    """Replace every BatchNorm under ``module`` (torch's
    ``BatchNorm1d/2d/3d`` and the models' flax-style ``BatchNorm``) with
    a :class:`SyncBatchNorm` on ``axis_name`` / ``process_group``,
    walking ``named_children`` and copying the affine parameters and the
    running statistics, as the reference does
    (``apex/parallel/__init__.py:20-52``).  ``channel_last`` None keeps
    each norm's own channel axis (last for the flax-style norm, 1 for
    torch's).  The flax-style norm's running ``mean``/``var`` become
    ``running_mean``/``running_var`` (JAX's ``adopt_batchnorm_stats``).
    Returns the module (``module`` itself, changed in place, unless it
    is a BatchNorm)."""
    from ..models.resnet import BatchNorm as FlaxStyleBatchNorm
    norms = (nn.modules.batchnorm._BatchNorm, FlaxStyleBatchNorm)
    if isinstance(module, norms):
        return _sync_bn_like(module, axis_name, process_group, channel_last)
    for name, child in module.named_children():
        new = convert_syncbn_model(child, axis_name, process_group,
                                   channel_last)
        if new is not child:
            setattr(module, name, new)
    return module


def create_syncbn_process_group(group_size: int,
                                world_size: Optional[int] = None):
    """The world cut into BN sub-groups of ``group_size`` consecutive
    ranks (reference ``apex/parallel/__init__.py:55-96``): a list of rank
    lists, JAX's ``axis_index_groups``, for ``SyncBatchNorm(
    process_group=...)``; each rank makes every group at its first use.
    ``group_size=0`` means the whole world: None.  ``world_size``
    defaults to the process count."""
    if group_size == 0:
        return None
    if world_size is None:
        from .multiproc import process_identity
        world_size = process_identity()[1]
    if world_size < group_size:
        raise ValueError("world_size < group_size")
    if world_size % group_size != 0:
        raise ValueError("world_size must be divisible by group_size")
    return [list(range(g * group_size, (g + 1) * group_size))
            for g in range(world_size // group_size)]
