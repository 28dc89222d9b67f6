"""SyncBatchNorm — counterpart of ``apex_tpu/parallel/sync_batchnorm.py``.

Statistics follow the JAX ``_global_moments`` (``:54-79``): fp32 sum and
sum of squares over every axis but the channel axis and the element
count, ``[sum, sum_sq, count]`` concatenated and, across processes, one
``all_reduce`` over the group (:func:`apex_tpu_torch.parallel.
distributed.group_psum`); then ``mean = sum / n`` and ``var = sum_sq / n
- mean^2``.  They are plain torch ops that autograd tracks, and the
``all_reduce`` is a Function whose backward all-reduces the cotangent
(the transpose of ``psum``), so the gradient of the whole BatchNorm is
exact across ranks as in one process: the epilogue's Function hands back
cotangents for ``mean`` and ``invstd``.  Without a group the same
arithmetic runs on this process's sums alone.
Running statistics use the torch momentum convention (``running = (1 -
momentum) * running + momentum * batch``) with the unbiased variance,
and are buffers (``running_mean``, ``running_var``) updated in place,
as ``torch.nn.BatchNorm2d`` updates its own; a caller that wants the
functional form passes copies through ``torch.func.functional_call``.

``channel_last`` (NHWC, the default) sends the elementwise tail —
normalize, affine, the optional residual ``z`` and ``fuse_relu`` —
through :func:`apex_tpu_torch.normalization.fused_bn_act.
bn_relu_residual` (the BN-epilogue kernels on the card).  The NCHW tail
is plain torch.

``axis_name`` is ``"data"`` (the default group that
:func:`apex_tpu_torch.parallel.multiproc.initialize` made) or a
``ProcessGroup``; ``process_group`` is JAX's ``axis_index_groups``, a
list of rank lists, each a sub-group (:func:`~apex_tpu_torch.parallel.
create_syncbn_process_group`).  Without ``axis_name`` the statistics are
this process's, whatever ``process_group`` says, as in JAX.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from .._device import resolve_device
from ..normalization.fused_bn_act import bn_relu_residual
from .distributed import group_psum


def welford_parallel(mean, var, count):
    """Combine per-group ``(mean, biased var, count)`` stacked along axis
    0 into the global ``(mean, var)`` (the JAX ``welford_parallel``)."""
    count = torch.as_tensor(count, dtype=torch.float32)
    total = count.sum(0)
    mean_all = (mean * count).sum(0) / total
    ex2 = ((var + mean ** 2) * count).sum(0) / total
    return mean_all, ex2 - mean_all ** 2


def _global_moments(x, reduce_axes, axis_name=None, process_group=None):
    """fp32 ``(mean, var, count)`` over ``reduce_axes`` of x and, with
    ``axis_name``, over the group's ranks (``count`` a ``[C]`` tensor)."""
    xf = x.float()
    local_sum = xf.sum(reduce_axes)
    local_sqr = torch.square(xf).sum(reduce_axes)
    n = 1
    for a in reduce_axes:
        n *= x.shape[a]
    stacked = torch.cat([local_sum, local_sqr,
                         torch.full_like(local_sum, float(n))])
    if axis_name is not None:
        stacked = group_psum(stacked, axis_name, process_group)
    total_sum, total_sqr, count = stacked.chunk(3)
    mean = total_sum / count
    var = total_sqr / count - torch.square(mean)
    return mean, var, count


class SyncBatchNorm(nn.Module):
    """BatchNorm with the reference module's arguments: ``momentum`` is
    the torch momentum (weight of the new batch statistic); parameters
    are fp32 ``scale`` and ``bias`` (flax's names), the running stats
    fp32 buffers ``running_mean`` (zeros) and ``running_var`` (ones).
    ``scale_init`` / ``bias_init`` take a shape and return a tensor (the
    flax initializer hook: ``scale_init=torch.zeros`` for a residual block's
    last BN).  ``forward(x, z=None, use_running_average=None)``."""

    fuse_relu: bool = False

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 track_running_stats: bool = True,
                 axis_name=None, process_group=None,
                 channel_last: bool = True, fuse_relu: bool = False,
                 use_running_average: Optional[bool] = None,
                 scale_init: Callable = torch.ones,
                 bias_init: Callable = torch.zeros,
                 *, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.axis_name = axis_name
        self.process_group = process_group
        self.num_features = int(num_features)
        self.eps = float(eps)
        self.momentum = float(momentum)
        self.affine = affine
        self.track_running_stats = track_running_stats
        self.channel_last = channel_last
        self.fuse_relu = fuse_relu
        self.use_running_average = use_running_average
        c = self.num_features
        self.register_buffer("running_mean", torch.zeros(c, device=dev))
        self.register_buffer("running_var", torch.ones(c, device=dev))
        if affine:
            self.scale = nn.Parameter(scale_init((c,)).float().to(dev))
            self.bias = nn.Parameter(bias_init((c,)).float().to(dev))
        else:
            self.scale = self.bias = None

    def forward(self, x, z=None, use_running_average=None):
        use_ra = use_running_average
        if use_ra is None:
            use_ra = self.use_running_average
        channel_axis = x.dim() - 1 if self.channel_last else 1
        reduce_axes = tuple(a for a in range(x.dim()) if a != channel_axis)
        if use_ra:
            mean, var = self.running_mean, self.running_var
        else:
            mean, var, count = _global_moments(
                x, reduce_axes, self.axis_name, self.process_group)
            if self.track_running_stats:
                with torch.no_grad():
                    unbiased = var * count / torch.clamp(count - 1, min=1)
                    self.running_mean.copy_(
                        (1 - self.momentum) * self.running_mean
                        + self.momentum * mean)
                    self.running_var.copy_(
                        (1 - self.momentum) * self.running_var
                        + self.momentum * unbiased)
        invstd = torch.rsqrt(var + self.eps)
        if self.channel_last:
            return bn_relu_residual(x, mean, invstd, self.scale, self.bias,
                                    z=z, relu=self.fuse_relu)
        stat_shape = [self.num_features if a == channel_axis else 1
                      for a in range(x.dim())]
        out = (x.float() - mean.reshape(stat_shape)) \
            * invstd.reshape(stat_shape)
        if self.affine:
            out = out * self.scale.reshape(stat_shape) \
                + self.bias.reshape(stat_shape)
        if z is not None:
            out = out + z.float()
        if self.fuse_relu:
            out = torch.relu(out)
        return out.to(x.dtype)


def adopt_batchnorm_stats(batch_stats):
    """Rename plain BatchNorm running stats (``mean``/``var``) to
    :class:`SyncBatchNorm`'s (``running_mean``/``running_var``), leaving
    everything else alone, in a nested dict (the flax ``batch_stats``
    tree, before :func:`apex_tpu_torch.convert.resnet_variables_from_jax`
    flattens it)."""
    def _rename(d):
        if isinstance(d, dict):
            if set(d) == {"mean", "var"}:
                return {"running_mean": d["mean"], "running_var": d["var"]}
            return {k: _rename(v) for k, v in d.items()}
        return d
    return _rename(batch_stats)
