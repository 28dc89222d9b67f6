"""ResNet family (NHWC) — counterpart of ``apex_tpu/models/resnet.py``.

The public layout is the flax model's: NHWC input, fp32 logits, and
parameters under flax's names and layouts (``conv_init.kernel`` of shape
``[7, 7, 3, 64]``, ``stage1_block1.bn1.bn.scale``, ``head.kernel`` of
shape ``[2048, 1000]``), so :mod:`apex_tpu_torch.convert` moves weights
between the packages unchanged.  Running statistics are buffers (flax's
``batch_stats`` collection).

* Convolutions keep their ``[KH, KW, Cin, Cout]`` kernels and are
  computed by ``F.conv2d`` (cuDNN on the card) on the NCHW view of the
  NHWC tensor, whose strides are channels-last: no copy in or out.
  flax's ``'SAME'`` padding is asymmetric where the total is odd (a
  stride-2 3x3 conv on an even map pads ``(0, 1)``); such a conv pads
  explicitly first.  ``conv_cls`` swaps in another conv class with
  ``Conv``'s constructor and parameters, e.g.
  :class:`apex_tpu_torch.ops.PallasConv` (the port's implicit-GEMM conv
  kernels, TPU kernels 1-3), which pads nothing: it reads zeros for
  taps outside the image.
* The norm-factory hook: when the norm supports the fused-epilogue
  contract (a ``fuse_relu`` flag and a ``z`` residual argument:
  :class:`~apex_tpu_torch.contrib.groupbn.BatchNorm2d_NHWC`,
  :class:`~apex_tpu_torch.parallel.SyncBatchNorm`), every ``bn -> relu
  -> (+residual)`` chain is one epilogue (the BN-epilogue kernels on the
  card); the plain flax-style :class:`BatchNorm` (the default) keeps the
  explicit ``relu(bn(y) + residual)`` statements.
* ``dtype`` is the compute dtype of the convolutions, the plain
  BatchNorm's output and the head, as in flax (bf16 under O1-O3).

A norm factory is called ``norm(num_features, [fuse_relu=True],
[scale_init=torch.zeros], device=...)`` at construction, and its modules
``bn(x, [z], use_running_average=not train)``.

``remat`` recomputes activations in the backward instead of keeping
them, per residual block, through ``torch.utils.checkpoint``
(non-reentrant), as JAX's ``nn.remat`` does:

* ``"full"``: only each block's input is kept; the backward runs the
  whole block forward again.
* ``"conv_out"``: a bottleneck block keeps exactly its conv outputs (and
  its input); each stretch between two convs (BN, ReLU and the next
  conv, or the last BN, the residual's BN, the add and the ReLU) runs
  again in the backward.  A basic block names no conv output in JAX, so
  it recomputes as under ``"full"``.

Each recomputed stretch runs to its end, so the recompute launches the
conv-forward and BN-epilogue kernels again: a ResNet-50 step at
``"conv_out"`` launches 85 conv forwards (53 + 32) and 105 BN forwards
(53 + 52), at ``"full"`` 105 and 105; the backward kernels are not
repeated.  The running statistics a recompute writes are put back, so
they advance once a step.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils.stateless import _reparametrize_module
from torch.utils import checkpoint as _checkpoint

from .._device import resolve_device
from ..prof.capture import scope
from .bert import DenseGeneral, lecun_normal_


def _norm_factory_cls(norm) -> Any:
    """The module class under a (possibly nested) functools.partial."""
    while isinstance(norm, functools.partial):
        norm = norm.func
    return norm


def norm_supports_epilogue(norm) -> bool:
    """True when ``norm`` builds modules with the fused-epilogue contract
    (``fuse_relu`` flag, ``z=`` residual argument)."""
    return hasattr(_norm_factory_cls(norm), "fuse_relu")


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """flax/XLA ``'SAME'``: ``ceil(size / s)`` outputs, the total padding
    split low ``total // 2``, high the rest."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv`` without bias on NHWC input: ``kernel`` ``[KH, KW,
    Cin, Cout]`` (lecun-normal from ``generator``), ``padding`` ``'SAME'``
    or ``[(lo, hi), (lo, hi)]``; input and kernel cast to ``dtype``."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Sequence[int], strides: Sequence[int] = (1, 1),
                 padding: Any = "SAME", dtype: torch.dtype = torch.float32,
                 *, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kh, kw = kernel_size
        self.kernel_size = (kh, kw)
        self.strides = tuple(strides)
        self.padding = padding
        self.dtype = dtype
        kernel = lecun_normal_(torch.empty(kh, kw, in_features, features),
                               kh * kw * in_features, generator)
        self.kernel = nn.Parameter(kernel.to(resolve_device(device)))

    def forward(self, x):
        if self.padding == "SAME":
            pads = [_same_pads(n, k, s) for n, k, s in
                    zip(x.shape[1:3], self.kernel_size, self.strides)]
        else:
            pads = [tuple(p) for p in self.padding]
        x = x.to(self.dtype)
        if any(lo != hi for lo, hi in pads):
            (hlo, hhi), (wlo, whi) = pads
            x = F.pad(x, (0, 0, wlo, whi, hlo, hhi))
            pads = [(0, 0), (0, 0)]
        w = self.kernel.to(self.dtype).permute(3, 2, 0, 1)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=self.strides,
                     padding=(pads[0][0], pads[1][0]))
        return y.permute(0, 2, 3, 1)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` in training form (the ``--no-fused-bn`` arm):
    ``momentum`` is flax's (the weight of the running value), statistics
    fp32 with ``var = max(0, E[x^2] - mean^2)`` (biased, also in the
    running value), parameters ``scale``/``bias`` and buffers
    ``mean``/``var``; the output is in ``dtype``."""

    def __init__(self, num_features: int, momentum: float = 0.99,
                 epsilon: float = 1e-5, dtype: torch.dtype = torch.float32,
                 scale_init=torch.ones, bias_init=torch.zeros, *,
                 device=None):
        super().__init__()
        dev = resolve_device(device)
        c = int(num_features)
        self.momentum = float(momentum)
        self.epsilon = float(epsilon)
        self.dtype = dtype
        self.scale = nn.Parameter(scale_init((c,)).float().to(dev))
        self.bias = nn.Parameter(bias_init((c,)).float().to(dev))
        self.register_buffer("mean", torch.zeros(c, device=dev))
        self.register_buffer("var", torch.ones(c, device=dev))

    def forward(self, x, use_running_average: bool = False):
        if use_running_average:
            mean, var = self.mean, self.var
        else:
            red = tuple(range(x.dim() - 1))
            xf = x.float()
            mean = xf.mean(red)
            var = torch.clamp(torch.square(xf).mean(red)
                              - torch.square(mean), min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        y = x - mean
        y = y * (torch.rsqrt(var + self.epsilon) * self.scale) + self.bias
        return y.to(self.dtype)


@contextlib.contextmanager
def _restoring(stats):
    """Put ``stats`` back as they were when the block leaves: a
    recompute must not advance the running statistics a second time."""
    saved = [t.clone() for t in stats]
    try:
        yield
    finally:
        with torch.no_grad():
            for t, v in zip(stats, saved):
                t.copy_(v)


class _Block(nn.Module):
    """What the two residual blocks share: the norm routing and the
    rematerialization (``remat``)."""

    remat: Any = False

    def _recomputed(self, fn, *xs):
        """``fn(*xs)`` under non-reentrant ``torch.utils.checkpoint``.
        The block's parameters go in as inputs and, with its buffers, are
        put back on the block for the recompute: a caller's
        ``functional_call`` swaps them in only for the forward.  The
        recompute runs to the end of ``fn`` and restores the running
        statistics (the buffers) it updates."""
        names, params = zip(*self.named_parameters())
        stats = dict(self.named_buffers())
        n = len(xs)

        def run(*flat):
            with _reparametrize_module(
                    self, {**dict(zip(names, flat[n:])), **stats}):
                return fn(*flat[:n])

        with _checkpoint.set_checkpoint_early_stop(False):
            return _checkpoint.checkpoint(
                run, *xs, *params, use_reentrant=False,
                preserve_rng_state=False,
                context_fn=lambda: (contextlib.nullcontext(),
                                    _restoring(stats.values())))

    def forward(self, x, train: bool = True):
        if self.remat == "full" or (self.remat == "conv_out"
                                    and not hasattr(self, "_conv_out")):
            return self._recomputed(lambda t: self._forward(t, train), x)
        if self.remat == "conv_out":
            return self._conv_out(x, train)
        return self._forward(x, train)

    def _bn(self, name, features, fused, **kw):
        self.add_module(name, (self.norm_act if fused else self.norm)(
            features, **kw))

    def _bn_relu(self, name, y, train):
        bn = getattr(self, name)
        if self.norm_act is not None:
            return bn(y, use_running_average=not train)
        return F.relu(bn(y, use_running_average=not train))

    def _bn_add_relu(self, name, y, residual, train):
        """The trailing ``bn -> (+residual) -> relu`` chain: the apex
        ``bn_add_relu`` epilogue when the norm supports it."""
        bn = getattr(self, name)
        if self.norm_act is not None:
            return bn(y, residual, use_running_average=not train)
        return F.relu(residual + bn(y, use_running_average=not train))

    def _residual(self, x, train):
        if not hasattr(self, "downsample_conv"):
            return x
        return self.downsample_bn(self.downsample_conv(x),
                                  use_running_average=not train)


class BottleneckBlock(_Block):
    expansion = 4

    def __init__(self, in_features: int, filters: int,
                 strides: Tuple[int, int], conv, norm, norm_act=None):
        super().__init__()
        self.norm, self.norm_act = norm, norm_act
        fused = norm_act is not None
        out = filters * 4
        self.conv1 = conv(in_features, filters, (1, 1))
        self._bn("bn1", filters, fused)
        self.conv2 = conv(filters, filters, (3, 3), strides)
        self._bn("bn2", filters, fused)
        self.conv3 = conv(filters, out, (1, 1))
        if in_features != out or tuple(strides) != (1, 1):
            self.downsample_conv = conv(in_features, out, (1, 1), strides)
            self._bn("downsample_bn", out, False)
        self._bn("bn3", out, fused, scale_init=torch.zeros)

    def _forward(self, x, train):
        y = self._bn_relu("bn1", self.conv1(x), train)
        y = self._bn_relu("bn2", self.conv2(y), train)
        y = self.conv3(y)
        return self._bn_add_relu("bn3", y, self._residual(x, train), train)

    def _conv_out(self, x, train):
        """The stretches between the conv outputs, each recomputed."""
        y = self.conv1(x)
        y = self._recomputed(
            lambda t: self.conv2(self._bn_relu("bn1", t, train)), y)
        y = self._recomputed(
            lambda t: self.conv3(self._bn_relu("bn2", t, train)), y)
        if not hasattr(self, "downsample_conv"):
            return self._recomputed(
                lambda t, r: self._bn_add_relu("bn3", t, r, train), y, x)
        return self._recomputed(
            lambda t, r: self._bn_add_relu(
                "bn3", t, self.downsample_bn(r, use_running_average=not
                                             train), train),
            y, self.downsample_conv(x))


class BasicBlock(_Block):
    expansion = 1

    def __init__(self, in_features: int, filters: int,
                 strides: Tuple[int, int], conv, norm, norm_act=None):
        super().__init__()
        self.norm, self.norm_act = norm, norm_act
        fused = norm_act is not None
        self.conv1 = conv(in_features, filters, (3, 3), strides)
        self._bn("bn1", filters, fused)
        self.conv2 = conv(filters, filters, (3, 3))
        if in_features != filters or tuple(strides) != (1, 1):
            self.downsample_conv = conv(in_features, filters, (1, 1),
                                        strides)
            self._bn("downsample_bn", filters, False)
        self._bn("bn2", filters, fused, scale_init=torch.zeros)

    def _forward(self, x, train):
        y = self._bn_relu("bn1", self.conv1(x), train)
        y = self.conv2(y)
        return self._bn_add_relu("bn2", y, self._residual(x, train), train)


class ResNet(nn.Module):
    """``forward(x, train=True) -> logits``: ``x`` ``[N, H, W, C]``,
    logits fp32 ``[N, num_classes]``.  ``norm_cls`` injects a norm factory
    (e.g. ``functools.partial(BatchNorm2d_NHWC, bn_group=1)``);
    ``fused_epilogue`` None fuses when the norm supports it, True
    requires it, False keeps the explicit statements.  Parameters are
    made on the CPU from a ``torch.Generator`` seeded with ``seed``
    (lecun-normal kernels, as flax initializes them; the numbers differ
    from JAX's), then moved to ``device``.  ``conv_cls`` (None:
    :class:`Conv`) builds every conv, the stem included, with the same
    arguments, so the parameters and their names do not change.
    ``remat``: ``False``, ``"full"`` (or ``True``) or ``"conv_out"`` (the
    module docstring).  ``sync_bn`` (when no ``norm_cls`` is given) makes
    every norm a :class:`~apex_tpu_torch.parallel.SyncBatchNorm` with
    ``momentum=bn_momentum`` whose statistics are summed over
    ``axis_name`` (``"data"`` or a ``ProcessGroup``; None: this
    process's) and ``bn_process_group`` (rank lists), as the JAX model's;
    it names the running statistics ``running_mean``/``running_var`` and
    takes the fused epilogue.  The statistics are synced in training
    only: evaluation reads the running statistics."""

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype: torch.dtype = torch.float32, sync_bn: bool = False,
                 axis_name=None, bn_process_group=None,
                 bn_momentum: float = 0.1, norm_cls: Any = None,
                 conv_cls: Any = None,
                 fused_epilogue: Optional[bool] = None, remat: Any = False,
                 *, in_channels: int = 3, device=None, seed: int = 0):
        super().__init__()
        if remat is True:
            remat = "full"
        if remat not in (False, None, "full", "conv_out"):
            raise ValueError(f"remat must be False, 'full', or "
                             f"'conv_out'; got {remat!r}")
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.dtype = dtype
        conv = functools.partial(conv_cls or Conv, dtype=dtype, device=dev,
                                 generator=gen)
        if norm_cls is not None:
            norm = functools.partial(norm_cls, device=dev)
        elif sync_bn:
            from ..parallel.sync_batchnorm import SyncBatchNorm
            norm = functools.partial(SyncBatchNorm, momentum=bn_momentum,
                                     axis_name=axis_name,
                                     process_group=bn_process_group,
                                     device=dev)
        else:
            norm = functools.partial(BatchNorm, momentum=1.0 - bn_momentum,
                                     epsilon=1e-5, dtype=dtype, device=dev)
        fused = fused_epilogue
        if fused is None:
            fused = norm_supports_epilogue(norm)
        elif fused and not norm_supports_epilogue(norm):
            raise ValueError(
                f"fused_epilogue=True but norm factory "
                f"{_norm_factory_cls(norm).__name__} has no fuse_relu/z "
                f"contract — use SyncBatchNorm / contrib.groupbn."
                f"BatchNorm2d_NHWC or pass fused_epilogue=False")
        norm_act = functools.partial(norm, fuse_relu=True) if fused else None
        self.fused = fused

        self.conv_init = conv(in_channels, num_filters, (7, 7), (2, 2),
                              padding=[(3, 3), (3, 3)])
        self.bn_init = (norm_act or norm)(num_filters)
        self.block_names = []
        features = num_filters
        for i, block_size in enumerate(stage_sizes):
            for j in range(block_size):
                strides = (2, 2) if i > 0 and j == 0 else (1, 1)
                name = f"stage{i + 1}_block{j + 1}"
                block = block_cls(features, num_filters * 2 ** i, strides,
                                  conv=conv, norm=norm, norm_act=norm_act)
                block.remat = remat or False
                self.add_module(name, block)
                self.block_names.append(name)
                features = num_filters * 2 ** i * block_cls.expansion
        self.head = DenseGeneral((features,), (num_classes,), dtype,
                                 device=dev, generator=gen)

    def forward(self, x, train: bool = True):
        with scope("stem"):
            x = self.conv_init(x)
            x = self.bn_init(x, use_running_average=not train)
            if not self.fused:
                x = F.relu(x)
            x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(
                0, 2, 3, 1)
        for name in self.block_names:
            with scope(name):
                x = getattr(self, name)(x, train)
        with scope("head"):
            x = x.mean(dim=(1, 2))
            return self.head(x).float()

    def variables(self):
        """``(params, batch_stats)``: the parameters and the running
        statistics by ``state_dict`` name (flax's ``params`` and
        ``batch_stats`` collections, flattened)."""
        return (dict(self.named_parameters()), dict(self.named_buffers()))

    def apply(self, params, batch_stats, x, train: bool = True):
        """``(logits, new_batch_stats)`` of the model on ``params`` and
        ``batch_stats`` (mappings of ``state_dict`` names), as flax's
        ``model.apply(..., mutable=["batch_stats"])``: the statistics are
        updated in copies, the inputs are left as they are."""
        stats = {k: v.clone() for k, v in batch_stats.items()}
        logits = torch.func.functional_call(self, {**params, **stats}, (x,),
                                            {"train": train})
        return logits, stats


ResNet18 = functools.partial(ResNet, stage_sizes=[2, 2, 2, 2],
                             block_cls=BasicBlock)
ResNet34 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3],
                             block_cls=BasicBlock)
ResNet50 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3],
                             block_cls=BottleneckBlock)
ResNet101 = functools.partial(ResNet, stage_sizes=[3, 4, 23, 3],
                              block_cls=BottleneckBlock)
ResNet152 = functools.partial(ResNet, stage_sizes=[3, 8, 36, 3],
                              block_cls=BottleneckBlock)
