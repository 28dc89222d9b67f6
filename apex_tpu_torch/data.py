"""Synthetic ImageNet batches and their normalization — counterpart of
``synthetic_imagenet``, ``normalize_images``, ``IMAGENET_MEAN`` and
``IMAGENET_STD`` of ``apex_tpu/data.py``.

The bytes come from the JAX package's counter-based lattice (block ``i``
of 8 bytes is ``splitmix64(seed + i)``, little-endian; the labels ride
on the same lattice after the image block), in this module's own numpy
copy, so a batch here is the JAX example's batch byte for byte.  The
native C++ tier, real-data loading and augmentation are not ported yet.
"""

from __future__ import annotations

import sys
from typing import Iterator, Sequence, Tuple

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

_MASK = 0xFFFFFFFFFFFFFFFF


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 over a uint64 lattice (wrapping arithmetic)."""
    with np.errstate(over="ignore"):
        z = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def synth_bytes(nbytes: int, seed: int) -> np.ndarray:
    """``nbytes`` pseudorandom bytes: block ``i`` of 8 is
    ``splitmix64(seed + i)`` in little-endian order."""
    if nbytes < 0:
        raise ValueError(f"nbytes must be >= 0, got {nbytes}")
    if sys.byteorder != "little":
        raise RuntimeError("synth_bytes assumes a little-endian host")
    lattice = (np.arange((nbytes + 7) // 8, dtype=np.uint64)
               + np.uint64(int(seed) & _MASK))
    return _splitmix64(lattice).view(np.uint8)[:nbytes]


def synthetic_imagenet(batch_size: int, image_size: int = 224,
                       num_classes: int = 1000, steps: int = 100,
                       seed: int = 0
                       ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """``steps`` batches of uint8 NHWC images and int32 labels,
    deterministic in ``(seed, step)``: the JAX stream's counter ranges."""
    nbytes = batch_size * image_size * image_size * 3
    for step in range(steps):
        base = (seed * 0x9E3779B97F4A7C15
                + step * (nbytes // 8 + batch_size + 2)) & _MASK
        imgs = synth_bytes(nbytes, base).reshape(batch_size, image_size,
                                                 image_size, 3)
        lab_base = (base + nbytes // 8 + 1) & _MASK
        with np.errstate(over="ignore"):
            lattice = (np.uint64(lab_base)
                       + np.arange(batch_size, dtype=np.uint64))
        labels = (_splitmix64(lattice)
                  % np.uint64(num_classes)).astype(np.int32)
        yield imgs, labels


def normalize_images(u8_batch, mean: Sequence[float] = IMAGENET_MEAN,
                     std: Sequence[float] = IMAGENET_STD) -> torch.Tensor:
    """uint8 NHWC (a tensor on any device, or a numpy array) to fp32
    NHWC on the same device, ``x * (1 / (255 * std)) + (-mean / std)``
    per channel in fp32: the JAX package's native normalize, the same
    arithmetic in the same order."""
    x = torch.as_tensor(u8_batch)
    mean_t = torch.tensor(mean, dtype=torch.float32, device=x.device)
    std_t = torch.tensor(std, dtype=torch.float32, device=x.device)
    if mean_t.numel() != x.shape[-1] or std_t.numel() != x.shape[-1]:
        raise ValueError("mean/std length must equal the channel count")
    scale = 1.0 / (255.0 * std_t)
    bias = -mean_t / std_t
    return x.float() * scale + bias
