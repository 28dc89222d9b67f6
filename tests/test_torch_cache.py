"""The port's warm-start module (``apex_tpu_torch.cache``) against the
JAX package's ``apex_tpu.cache``: the same signature keys for the same
arrays (``tests/test_cache.py``'s pins), static parameters that tell
buckets apart, ``abstractify``, the build directory ``enable`` installs,
and ``warmup`` on the CPU (the plain step itself: nothing to capture).
Capture and replay run on the card (``tests/test_torch_kernels_cuda.py``
and ``chip_smoke.py``)."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from apex_tpu import cache as jcache
from apex_tpu_torch import _build, cache


def test_signature_equals_jax_signature():
    win = (np.zeros((2, 3), np.float32), np.ones((2,), np.int32))
    sig = cache.signature(win)
    assert sig == jcache.signature(win) == ("float32[2, 3]", "int32[2]")
    tensors = (torch.zeros((2, 3)), torch.ones((2,), dtype=torch.int32))
    assert cache.signature(tensors) == sig
    assert cache.signature(tensors) == cache.signature(tensors)   # stable
    assert cache.signature((jnp.zeros((2, 3), jnp.float32),
                            np.ones((2,), np.int32))) == sig
    # at most ``limit`` leading leaves, non-array leaves by type
    long = tuple(torch.zeros((i + 1,)) for i in range(20))
    assert cache.signature(long) == jcache.signature(
        tuple(np.zeros((i + 1,), np.float32) for i in range(20)))
    assert len(cache.signature(long)) == 16
    assert cache.signature((3, torch.zeros(2))) == jcache.signature(
        (3, np.zeros(2, np.float32)))


def test_signature_static_params_distinguish_buckets():
    win = (torch.zeros((2, 3)),)
    s64 = cache.signature(win, static=(64,))
    s128 = cache.signature(win, static=(128,))
    assert s64 != s128
    assert s64[:-1] == s128[:-1] == cache.signature(win)
    assert s64 == jcache.signature((np.zeros((2, 3), np.float32),),
                                   static=(64,))
    assert cache.signature(win, static=("prefill", 64)) \
        != cache.signature(win, static=(64, "prefill"))
    assert cache.signature(win, static=("prefill", 64)) == jcache.signature(
        (np.zeros((2, 3), np.float32),), static=("prefill", 64))


def test_signature_names_a_device_other_than_the_cpu():
    """A CUDA tensor keys apart from a CPU tensor of the same shape: a
    graph takes only its own device's inputs."""
    spec = cache.TensorSpec((2, 3), torch.float32, torch.device("cuda", 0))
    assert cache.signature((spec,)) == ("float32[2, 3]@cuda:0",)
    assert cache.signature((cache.TensorSpec((2, 3), torch.float32),)) \
        == ("float32[2, 3]",)


def test_abstractify_specs_and_pass_through():
    x = torch.ones((4, 4), dtype=torch.bfloat16)
    sx, sy, three = cache.abstractify((x, np.ones((4,), np.int64), 3))
    assert sx == cache.TensorSpec((4, 4), torch.bfloat16,
                                  torch.device("cpu"))
    assert sy.shape == (4,) and sy.dtype == torch.int64
    assert three == 3
    assert cache.abstractify({"a": sx})["a"] is sx
    j = jcache.abstractify((jnp.ones((4, 4)),))[0]
    assert cache.abstractify((x,))[0].shape == j.shape


def test_warmup_on_the_cpu_is_the_plain_step():
    def step(x, y):
        return x * 2 + y
    fn = cache.warmup(step, torch.ones(3), torch.zeros(3))
    assert fn is step
    assert cache.warmup(step, torch.ones(3), device="cpu") is step
    torch.testing.assert_close(fn(torch.ones(3), torch.ones(3)),
                               torch.full((3,), 3.0))


def test_enable_points_the_kernel_builds_at_the_directory(tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setitem(cache._STATE, "dir", None)
    monkeypatch.delenv("TRITON_CACHE_DIR", raising=False)
    assert not cache.is_enabled() and cache.cache_dir() is None
    got = cache.enable(str(tmp_path / "warm"))
    assert got == str(tmp_path / "warm") and os.path.isdir(got)
    assert cache.is_enabled() and cache.cache_dir() == got
    assert _build.BUILD_DIR == got
    assert os.environ["TRITON_CACHE_DIR"] == os.path.join(got, "triton")
    assert cache.enable(got) == got                       # idempotent


def test_captured_refuses_new_fixed_arguments():
    """A graph fixes its non-tensor arguments at capture; a call with
    others is an error, not a replay of the wrong program (checked
    without a card on an object built around the plain path)."""
    cap = cache.Captured.__new__(cache.Captured)
    leaves, cap._spec = torch.utils._pytree.tree_flatten((torch.ones(2), 4))
    cap._static = [torch.ones(2), 4]
    cap._tensors, cap._others = [0], [1]
    with pytest.raises(ValueError, match="captured with 4"):
        cap(torch.ones(2), 5)
    with pytest.raises(ValueError, match="do not match"):
        cap(torch.ones(2))
