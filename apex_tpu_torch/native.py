"""The host runtime (``csrc/apex_runtime.cpp``) through ``ctypes`` —
counterpart of ``apex_tpu/native.py``.

The library is the port's own copy of the JAX package's C++ source at
the same ABI (version 2), built with ``g++`` on first use into
``csrc/build/`` (:func:`apex_tpu_torch._build.load`).  Unlike the JAX
loader there is no numpy tier on the path and no switch to force one: a
failed build or a library of another ABI raises.  The numpy versions
stay beside each function as ``_*_ref`` (the plain versions the tests
hold the library against, bit for bit).

Functions: :func:`flatten` / :func:`unflatten` (host buffers packed into
one byte buffer and back), :func:`u8_to_f32_nhwc` (the normalize
epilogue), :func:`synth_bytes` (the splitmix64 byte stream behind the
synthetic batches) and :func:`crop_flip_normalize` (the fused
augmentation epilogue).
"""

from __future__ import annotations

import ctypes
import os
import sys
import threading
from typing import List, Sequence

import numpy as np

from . import _build

_ABI_VERSION = 2
_LIB_NAME = "apex_runtime"
_lock = threading.Lock()
_lib = None

_DEFAULT_THREADS = max(1, (os.cpu_count() or 1) - 1)
_MASK = 0xFFFFFFFFFFFFFFFF

_i64p = ctypes.POINTER(ctypes.c_int64)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_f32p = ctypes.POINTER(ctypes.c_float)


def _declare(lib) -> None:
    lib.apex_runtime_abi_version.restype = ctypes.c_int64
    lib.apex_flatten.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), _i64p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int]
    lib.apex_unflatten.argtypes = [
        ctypes.c_void_p, _i64p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_int]
    lib.apex_u8_to_f32_nhwc.argtypes = [
        _u8p, _f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        _f32p, _f32p, ctypes.c_int]
    lib.apex_synth_u8.argtypes = [_u8p, ctypes.c_int64, ctypes.c_uint64,
                                  ctypes.c_int]
    lib.apex_crop_flip_norm_u8_f32.argtypes = [
        _u8p, _f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), _u8p, _f32p, _f32p, ctypes.c_int]


def _load():
    """The runtime library, built and loaded on first use; raises when it
    cannot be built or reports another ABI version."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = _build.load(_LIB_NAME, host=True)
        lib.apex_runtime_abi_version.restype = ctypes.c_int64
        got = lib.apex_runtime_abi_version()
        if got != _ABI_VERSION:
            raise RuntimeError(
                f"{_LIB_NAME}: the library in {_build.BUILD_DIR} reports "
                f"ABI {got}, this module needs {_ABI_VERSION}; delete it to "
                f"rebuild from csrc/{_LIB_NAME}.cpp")
        _declare(lib)
        _lib = lib
        return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


# -- flatten / unflatten --------------------------------------------------------

def flatten(arrays: Sequence[np.ndarray], threads: int = _DEFAULT_THREADS
            ) -> np.ndarray:
    """Pack host arrays into one contiguous uint8 buffer (the reference's
    ``apex_C.flatten``)."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    sizes = np.array([a.nbytes for a in arrays], np.int64)
    out = np.empty(int(sizes.sum()), np.uint8)
    srcs = (ctypes.c_void_p * len(arrays))(*[a.ctypes.data for a in arrays])
    _load().apex_flatten(srcs, _ptr(sizes, ctypes.c_int64), len(arrays),
                         out.ctypes.data_as(ctypes.c_void_p), threads)
    return out


def _flatten_ref(arrays: Sequence[np.ndarray]) -> np.ndarray:
    return np.concatenate([np.ascontiguousarray(a).view(np.uint8).reshape(-1)
                           for a in arrays] or [np.empty(0, np.uint8)])


def unflatten(flat: np.ndarray, like: Sequence[np.ndarray],
              threads: int = _DEFAULT_THREADS) -> List[np.ndarray]:
    """Split a flat byte buffer back into arrays shaped like ``like``
    (the reference's ``apex_C.unflatten``)."""
    flat = np.ascontiguousarray(flat.view(np.uint8).reshape(-1))
    outs = [np.empty(a.shape, a.dtype) for a in like]
    sizes = np.array([a.nbytes for a in outs], np.int64)
    if int(sizes.sum()) != flat.nbytes:
        raise ValueError(f"flat buffer has {flat.nbytes} bytes, targets "
                         f"need {int(sizes.sum())}")
    dsts = (ctypes.c_void_p * len(outs))(*[o.ctypes.data for o in outs])
    _load().apex_unflatten(flat.ctypes.data_as(ctypes.c_void_p),
                           _ptr(sizes, ctypes.c_int64), len(outs), dsts,
                           threads)
    return outs


def _unflatten_ref(flat: np.ndarray, like: Sequence[np.ndarray]
                   ) -> List[np.ndarray]:
    flat = np.ascontiguousarray(flat.view(np.uint8).reshape(-1))
    outs, off = [], 0
    for a in like:
        n = int(np.prod(a.shape, dtype=np.int64)) * np.dtype(a.dtype).itemsize
        outs.append(flat[off:off + n].view(a.dtype).reshape(a.shape).copy())
        off += n
    return outs


# -- normalize ------------------------------------------------------------------

def _affine(mean, std, c: int):
    """``mean`` and ``std`` as contiguous fp32 arrays of ``c`` values."""
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    if mean.size != c or std.size != c:
        raise ValueError("mean/std length must equal channel count")
    return mean, std


def u8_to_f32_nhwc(images: np.ndarray, mean: Sequence[float],
                   std: Sequence[float],
                   threads: int = _DEFAULT_THREADS) -> np.ndarray:
    """uint8 NHWC to float32, ``x * (1 / (255 std)) + (-mean / std)`` per
    channel."""
    images = np.ascontiguousarray(images, np.uint8)
    n, h, w, c = images.shape
    mean, std = _affine(mean, std, c)
    out = np.empty((n, h, w, c), np.float32)
    _load().apex_u8_to_f32_nhwc(
        _ptr(images, ctypes.c_uint8), _ptr(out, ctypes.c_float), n, h * w, c,
        _ptr(mean, ctypes.c_float), _ptr(std, ctypes.c_float), threads)
    return out


def _u8_to_f32_nhwc_ref(images: np.ndarray, mean: Sequence[float],
                        std: Sequence[float]) -> np.ndarray:
    images = np.ascontiguousarray(images, np.uint8)
    mean, std = _affine(mean, std, images.shape[-1])
    scale = np.float32(1.0) / (np.float32(255.0) * std)
    bias = -mean / std
    return images.astype(np.float32) * scale + bias


# -- synthetic bytes ------------------------------------------------------------

def _splitmix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 over a uint64 lattice (wrapping arithmetic)."""
    with np.errstate(over="ignore"):
        z = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def _check_synth(nbytes: int) -> None:
    if nbytes < 0:
        raise ValueError(f"nbytes must be >= 0, got {nbytes}")
    if sys.byteorder != "little":
        raise RuntimeError("synth_bytes assumes a little-endian host")


def synth_bytes(nbytes: int, seed: int,
                threads: int = _DEFAULT_THREADS) -> np.ndarray:
    """``nbytes`` pseudorandom bytes: block ``i`` of 8 is
    ``splitmix64(seed + i)``, little-endian, filled in parallel."""
    _check_synth(nbytes)
    out = np.empty(nbytes, np.uint8)
    _load().apex_synth_u8(_ptr(out, ctypes.c_uint8), nbytes,
                          ctypes.c_uint64(int(seed) & _MASK), threads)
    return out


def _synth_bytes_ref(nbytes: int, seed: int) -> np.ndarray:
    _check_synth(nbytes)
    lattice = (np.arange((nbytes + 7) // 8, dtype=np.uint64)
               + np.uint64(int(seed) & _MASK))
    return _splitmix64(lattice).view(np.uint8)[:nbytes]


# -- crop / flip / normalize ----------------------------------------------------

def _check_crop(images, out_size, offsets, flips, mean, std):
    images = np.ascontiguousarray(images, np.uint8)
    n, h, w, c = images.shape
    oh = ow = int(out_size)
    if oh > h or ow > w:
        raise ValueError(f"crop {oh}x{ow} exceeds image {h}x{w}")
    offsets = np.ascontiguousarray(offsets, np.int32).reshape(n, 2)
    if (offsets[:, 0] < 0).any() or (offsets[:, 0] > h - oh).any() \
            or (offsets[:, 1] < 0).any() or (offsets[:, 1] > w - ow).any():
        raise ValueError("crop offsets out of bounds")
    flips = np.ascontiguousarray(flips, np.uint8).reshape(n)
    mean, std = _affine(mean, std, c)
    return images, oh, offsets, flips, mean, std


def crop_flip_normalize(images: np.ndarray, out_size: int,
                        offsets: np.ndarray, flips: np.ndarray,
                        mean: Sequence[float], std: Sequence[float],
                        threads: int = _DEFAULT_THREADS) -> np.ndarray:
    """One pass over the output pixels: each image's ``out_size`` crop at
    ``offsets[i] = (oy, ox)``, flipped left-right where ``flips[i]``,
    normalized as :func:`u8_to_f32_nhwc`.  The randomness is the
    caller's (offsets and flips come in)."""
    images, o, offsets, flips, mean, std = _check_crop(
        images, out_size, offsets, flips, mean, std)
    n, h, w, c = images.shape
    out = np.empty((n, o, o, c), np.float32)
    _load().apex_crop_flip_norm_u8_f32(
        _ptr(images, ctypes.c_uint8), _ptr(out, ctypes.c_float),
        n, h, w, c, o, o, _ptr(offsets, ctypes.c_int32),
        _ptr(flips, ctypes.c_uint8), _ptr(mean, ctypes.c_float),
        _ptr(std, ctypes.c_float), threads)
    return out


def _crop_flip_normalize_ref(images: np.ndarray, out_size: int,
                             offsets: np.ndarray, flips: np.ndarray,
                             mean: Sequence[float], std: Sequence[float]
                             ) -> np.ndarray:
    images, o, offsets, flips, mean, std = _check_crop(
        images, out_size, offsets, flips, mean, std)
    crops = []
    for i in range(images.shape[0]):
        oy, ox = int(offsets[i, 0]), int(offsets[i, 1])
        crop = images[i, oy:oy + o, ox:ox + o]
        crops.append(crop[:, ::-1] if flips[i] else crop)
    return _u8_to_f32_nhwc_ref(np.stack(crops), mean, std)
