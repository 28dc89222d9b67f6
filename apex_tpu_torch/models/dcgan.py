"""DCGAN generator and discriminator (NHWC) — counterpart of
``apex_tpu/models/dcgan.py``, at flax's semantics: the multi-model,
multi-loss path of the DCGAN trainer (the reference's baseline config 5).

Parameters keep the flax names and layouts (``project.kernel``
``[nz, 4*4*ngf*8]``, ``deconv1.kernel`` ``[4, 4, ngf*8, ngf*4]`` (HWIO),
``conv1.kernel`` ``[4, 4, 3, ndf]``, ``bn0.scale``, ``head.bias``; the
running statistics ``bn0.mean``/``bn0.var`` are buffers), so
:mod:`apex_tpu_torch.convert` moves weights unchanged.  Every layer is
its flax counterpart's computation:

* :class:`Dense`, :class:`Conv` and :class:`ConvTranspose` take the
  product first (``x @ kernel``, ``F.conv2d``, ``F.conv_transpose2d``)
  and add the bias after it, as flax adds it after ``dot_general`` /
  ``conv_general_dilated``: under the O1 policy the product runs in
  bf16 and the fp32 bias makes the layer's output fp32, dtype for dtype
  as in JAX.
* flax's ``ConvTranspose`` (``transpose_kernel=False``, ``'SAME'``) is a
  correlation of the stride-dilated input, padded by
  ``lax.conv_transpose``'s ``'SAME'`` rule (``k + s - 2`` in all, the
  low side ``ceil`` of half when ``s <= k - 1``, else ``k - 1``), with
  the kernel unflipped.  ``F.conv_transpose2d`` computes a correlation
  of the dilated input padded by ``k - 1 - p`` on both sides with the
  flipped kernel, so the layer hands it the flipped kernel and the
  larger of the two pads, and crops the output where the other side is
  narrower (4 x 4 stride 2 pads ``(2, 2)``: nothing to crop).
* The norms are the port's flax-style
  :class:`~apex_tpu_torch.models.resnet.BatchNorm` (momentum 0.99, eps
  1e-5, biased batch variance, fp32 statistics).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device
from .bert import lecun_normal_
from .resnet import BatchNorm, _same_pads

__all__ = ["Conv", "ConvTranspose", "Dense", "Discriminator", "Generator",
           "conv_transpose_pads"]


def _generator(seed) -> Optional[torch.Generator]:
    if seed is None:
        return None
    return torch.Generator().manual_seed(int(seed))


class Dense(nn.Module):
    """flax ``nn.Dense``: ``kernel`` ``[in, out]`` (lecun normal),
    ``bias`` zeros; ``x @ kernel + bias`` in ``dtype``."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.dtype = dtype
        self.kernel = nn.Parameter(lecun_normal_(
            torch.empty(in_features, features), in_features,
            generator).to(dev))
        self.bias = nn.Parameter(torch.zeros(features, device=dev))

    def forward(self, x):
        return (x.to(self.dtype) @ self.kernel.to(self.dtype)
                + self.bias.to(self.dtype))


class _ConvBase(nn.Module):
    def __init__(self, in_features: int, features: int,
                 kernel_size: Sequence[int], strides: Sequence[int],
                 dtype: torch.dtype, device, generator):
        super().__init__()
        dev = resolve_device(device)
        kh, kw = kernel_size
        self.kernel_size = (kh, kw)
        self.strides = tuple(strides)
        self.dtype = dtype
        self.kernel = nn.Parameter(lecun_normal_(
            torch.empty(kh, kw, in_features, features),
            kh * kw * in_features, generator).to(dev))
        self.bias = nn.Parameter(torch.zeros(features, device=dev))

    def _finish(self, y_nchw):
        return y_nchw.permute(0, 2, 3, 1) + self.bias.to(self.dtype)


class Conv(_ConvBase):
    """flax ``nn.Conv`` with bias, ``'SAME'`` padding, on NHWC input:
    ``kernel`` ``[KH, KW, Cin, Cout]``; ``F.conv2d`` then the bias."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Sequence[int] = (4, 4),
                 strides: Sequence[int] = (2, 2),
                 dtype: torch.dtype = torch.float32, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_features, features, kernel_size, strides, dtype,
                         device, generator)

    def forward(self, x):
        pads = [_same_pads(n, k, s) for n, k, s in
                zip(x.shape[1:3], self.kernel_size, self.strides)]
        x = x.to(self.dtype)
        if any(lo != hi for lo, hi in pads):
            (hlo, hhi), (wlo, whi) = pads
            x = F.pad(x, (0, 0, wlo, whi, hlo, hhi))
            pads = [(0, 0), (0, 0)]
        w = self.kernel.to(self.dtype).permute(3, 2, 0, 1)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=self.strides,
                     padding=(pads[0][0], pads[1][0]))
        return self._finish(y)


def conv_transpose_pads(k: int, s: int):
    """``lax.conv_transpose``'s ``'SAME'`` padding of the dilated input:
    ``(low, high)``."""
    pad_len = k + s - 2
    lo = k - 1 if s > k - 1 else int(math.ceil(pad_len / 2))
    return lo, pad_len - lo


class ConvTranspose(_ConvBase):
    """flax ``nn.ConvTranspose`` (``transpose_kernel=False``, ``'SAME'``,
    bias) on NHWC input: ``kernel`` ``[KH, KW, Cin, Cout]``; a
    ``F.conv_transpose2d`` with the spatially flipped kernel (see the
    module docstring), then the bias."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Sequence[int] = (4, 4),
                 strides: Sequence[int] = (2, 2),
                 dtype: torch.dtype = torch.float32, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_features, features, kernel_size, strides, dtype,
                         device, generator)

    def forward(self, x):
        pads = [conv_transpose_pads(k, s)
                for k, s in zip(self.kernel_size, self.strides)]
        # conv_transpose2d pads the dilated input by k - 1 - p on both
        # sides: pad both by the larger side, then crop the other
        wide = [max(lo, hi) for lo, hi in pads]
        if any(w > k - 1 for w, k in zip(wide, self.kernel_size)):
            raise NotImplementedError(
                f"'SAME' padding {pads} wider than the kernel less one")
        # [KH, KW, Cin, Cout] -> [Cin, Cout, KH, KW], flipped in H and W
        w = self.kernel.to(self.dtype).permute(2, 3, 0, 1).flip(2, 3)
        y = F.conv_transpose2d(
            x.to(self.dtype).permute(0, 3, 1, 2), w, stride=self.strides,
            padding=tuple(k - 1 - m for k, m in zip(self.kernel_size, wide)))
        (hlo, hhi), (wlo, whi) = pads
        y = y[:, :, wide[0] - hlo:y.shape[2] - (wide[0] - hhi),
              wide[1] - wlo:y.shape[3] - (wide[1] - whi)]
        return self._finish(y)


class Generator(nn.Module):
    """``z [B, nz] -> [B, 4, 4, ngf*8] -> ... -> [B, 64, 64, nc]`` in
    ``tanh``; every BatchNorm in training form unless ``train=False``."""

    def __init__(self, ngf: int = 64, nc: int = 3, nz: int = 100,
                 dtype: torch.dtype = torch.float32, *, device=None,
                 seed: Optional[int] = 0):
        super().__init__()
        gen = _generator(seed)
        kw = dict(device=device, generator=gen)
        self.ngf, self.nc, self.nz, self.dtype = ngf, nc, nz, dtype
        self.project = Dense(nz, 4 * 4 * ngf * 8, dtype, **kw)
        self.bn0 = BatchNorm(ngf * 8, dtype=dtype, device=device)
        chans = [ngf * 8, ngf * 4, ngf * 2, ngf]
        for i in range(3):
            setattr(self, f"deconv{i + 1}",
                    ConvTranspose(chans[i], chans[i + 1], dtype=dtype, **kw))
            setattr(self, f"bn{i + 1}",
                    BatchNorm(chans[i + 1], dtype=dtype, device=device))
        self.deconv_out = ConvTranspose(ngf, nc, dtype=dtype, **kw)

    def forward(self, z, train: bool = True):
        ra = not train
        x = self.project(z).reshape(z.shape[0], 4, 4, self.ngf * 8)
        x = F.relu(self.bn0(x, use_running_average=ra))
        for i in range(1, 4):
            x = getattr(self, f"deconv{i}")(x)
            x = F.relu(getattr(self, f"bn{i}")(x, use_running_average=ra))
        x = self.deconv_out(x)
        return torch.tanh(x.to(torch.float32))


class Discriminator(nn.Module):
    """``[B, 64, 64, 3] -> [B, 1]`` fp32 logits: four stride-2 4x4 convs
    (BatchNorm after the last three, leaky ReLU 0.2), the spatial mean,
    the head."""

    def __init__(self, ndf: int = 64, nc: int = 3,
                 dtype: torch.dtype = torch.float32, *, device=None,
                 seed: Optional[int] = 1):
        super().__init__()
        gen = _generator(seed)
        kw = dict(device=device, generator=gen)
        self.dtype = dtype
        chans = [nc, ndf, ndf * 2, ndf * 4, ndf * 8]
        for i in range(4):
            setattr(self, f"conv{i + 1}",
                    Conv(chans[i], chans[i + 1], dtype=dtype, **kw))
        for i in range(2, 5):
            setattr(self, f"bn{i}",
                    BatchNorm(chans[i], dtype=dtype, device=device))
        self.head = Dense(ndf * 8, 1, dtype, **kw)

    def forward(self, x, train: bool = True):
        ra = not train
        x = x.to(self.dtype)
        x = F.leaky_relu(self.conv1(x), 0.2)
        for i in range(2, 5):
            x = getattr(self, f"conv{i}")(x)
            x = F.leaky_relu(getattr(self, f"bn{i}")(
                x, use_running_average=ra), 0.2)
        x = torch.mean(x, dim=(1, 2))
        return self.head(x).to(torch.float32)
