"""The port's host runtime (``apex_tpu_torch.native``, built from its own
``csrc/apex_runtime.cpp``) and directory stream against the JAX
package's (oracle ``tests/test_native_data.py``).

Bit for bit on the same seeds: ``synth_bytes``, ``u8_to_f32_nhwc``,
``crop_flip_normalize``, ``flatten``/``unflatten`` and
``augment_images`` equal ``apex_tpu.native`` / ``apex_tpu.data`` and
their own numpy ``_*_ref``.  The library is built from the port's
source, and bad inputs raise.  ``DirectoryImagenet`` over one directory
yields the same ``(paths, labels, seq)`` sequence as JAX's: shuffled and
not, two epochs, ``drop_last`` on and off, host shards ``(0, 2)`` and
``(1, 2)``, ``.npy`` and JPEG files.
"""

import ctypes
import os

import numpy as np
import pytest

from apex_tpu import data as jdata
from apex_tpu import native as jnative
from apex_tpu_torch import _build, data, native

MEAN, STD = data.IMAGENET_MEAN, data.IMAGENET_STD


# -- the host runtime -----------------------------------------------------------

def test_library_builds_from_the_ports_source():
    lib = native._load()
    assert isinstance(lib, ctypes.CDLL)
    assert lib.apex_runtime_abi_version() == native._ABI_VERSION == 2
    path = _build.build("apex_runtime", host=True)
    assert os.path.dirname(path) == _build.BUILD_DIR
    src = os.path.join(os.path.dirname(native.__file__), "csrc",
                       "apex_runtime.cpp")
    assert os.path.exists(src)
    assert not hasattr(native, "available")      # no numpy tier to report


@pytest.mark.parametrize("nbytes,seed", [(0, 1), (13, 5), (4096, 7),
                                         (100003, 2 ** 64 - 3)])
def test_synth_bytes_equals_jax_and_reference(nbytes, seed):
    got = native.synth_bytes(nbytes, seed)
    assert got.dtype == np.uint8 and got.shape == (nbytes,)
    np.testing.assert_array_equal(got, jnative.synth_bytes(nbytes, seed))
    np.testing.assert_array_equal(got, native._synth_bytes_ref(nbytes, seed))
    with pytest.raises(ValueError, match=">= 0"):
        native.synth_bytes(-1, 0)


@pytest.mark.parametrize("shape", [(2, 5, 7, 3), (1, 16, 16, 3),
                                   (3, 4, 4, 1)])
def test_u8_to_f32_equals_jax_and_reference(shape):
    rng = np.random.RandomState(sum(shape))
    imgs = rng.randint(0, 256, shape).astype(np.uint8)
    c = shape[-1]
    mean, std = MEAN[:c], STD[:c]
    got = native.u8_to_f32_nhwc(imgs, mean, std)
    np.testing.assert_array_equal(got, jnative.u8_to_f32_nhwc(imgs, mean,
                                                              std))
    np.testing.assert_array_equal(got, native._u8_to_f32_nhwc_ref(
        imgs, mean, std))
    with pytest.raises(ValueError, match="channel"):
        native.u8_to_f32_nhwc(imgs, MEAN + (0.5,), STD + (0.5,))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_crop_flip_normalize_equals_jax_and_reference(seed):
    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 256, (4, 12, 14, 3)).astype(np.uint8)
    offsets = np.stack([rng.randint(0, 5, 4), rng.randint(0, 7, 4)],
                       axis=1).astype(np.int32)
    flips = (rng.rand(4) < 0.5).astype(np.uint8)
    got = native.crop_flip_normalize(imgs, 8, offsets, flips, MEAN, STD)
    np.testing.assert_array_equal(got, jnative.crop_flip_normalize(
        imgs, 8, offsets, flips, MEAN, STD))
    np.testing.assert_array_equal(got, native._crop_flip_normalize_ref(
        imgs, 8, offsets, flips, MEAN, STD))


def test_crop_flip_normalize_validates():
    imgs = np.zeros((2, 8, 8, 3), np.uint8)
    with pytest.raises(ValueError, match="exceeds"):
        native.crop_flip_normalize(imgs, 9, np.zeros((2, 2), np.int32),
                                   np.zeros(2, np.uint8), MEAN, STD)
    with pytest.raises(ValueError, match="out of bounds"):
        native.crop_flip_normalize(imgs, 4,
                                   np.array([[0, 0], [5, 0]], np.int32),
                                   np.zeros(2, np.uint8), MEAN, STD)


def test_flatten_unflatten_equal_jax_and_reference():
    rng = np.random.RandomState(0)
    arrays = [rng.randn(3, 4).astype(np.float32),
              np.arange(7, dtype=np.int64),
              rng.randint(0, 255, (5,)).astype(np.uint8),
              rng.randn(2, 2).astype(np.float16)]
    flat = native.flatten(arrays)
    np.testing.assert_array_equal(flat, jnative.flatten(arrays))
    np.testing.assert_array_equal(flat, native._flatten_ref(arrays))
    for got, ref, want in zip(native.unflatten(flat, arrays),
                              native._unflatten_ref(flat, arrays), arrays):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(ref, want)
    with pytest.raises(ValueError, match="bytes"):
        native.unflatten(flat[:-1], arrays)


@pytest.mark.parametrize("flip", [True, False])
def test_augment_images_equals_jax(flip):
    rng = np.random.RandomState(3)
    imgs = rng.randint(0, 256, (5, 20, 18, 3)).astype(np.uint8)
    got = data.augment_images(imgs, 16, np.random.RandomState(9), flip=flip)
    want = jdata.augment_images(imgs, 16, np.random.RandomState(9),
                                flip=flip)
    assert got.shape == (5, 16, 16, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_synthetic_imagenet_through_the_library_equals_jax():
    for (gi, gl), (wi, wl) in zip(
            data.synthetic_imagenet(3, 16, num_classes=10, steps=2, seed=4),
            jdata.synthetic_imagenet(3, 16, num_classes=10, steps=2,
                                     seed=4)):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)


# -- the directory stream -------------------------------------------------------

def _npy_tree(root, classes=("ant", "bee", "cat"), per_class=5, size=8):
    rng = np.random.RandomState(0)
    for cls in classes:
        d = root / cls
        d.mkdir()
        for i in range(per_class):
            np.save(d / f"s{i}.npy",
                    rng.randint(0, 256, (size, size, 3)).astype(np.uint8))
    return str(root)


def _jpeg_tree(root):
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.RandomState(1)
    for cls in ("cat", "dog"):
        d = root / cls
        d.mkdir()
        for i in range(3):
            Image.fromarray(rng.randint(0, 255, (40, 52, 3)).astype(
                np.uint8)).save(d / f"img_{i}.jpg")
        np.save(d / "extra.npy", rng.randint(0, 255, (32, 32, 3)).astype(
            np.uint8))
    return str(root)


def _descriptors(stream):
    return [(t.paths, t.labels.tolist(), t.image_size, t.seq) for t in stream]


STREAMS = {
    "shuffled_two_epochs": dict(batch_size=4, epochs=2, seed=11),
    "in_order": dict(batch_size=4, epochs=1, shuffle=False),
    "keep_last": dict(batch_size=4, epochs=2, drop_last=False, seed=3),
    "shard_0_of_2": dict(batch_size=2, epochs=2, seed=5, host_shard=(0, 2)),
    "shard_1_of_2": dict(batch_size=2, epochs=2, seed=5, host_shard=(1, 2)),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_directory_stream_sequence_equals_jax(tmp_path, name):
    root = _npy_tree(tmp_path)
    kw = dict(STREAMS[name], image_size=8, decode=False)
    got = data.directory_imagenet(root, **kw)
    want = jdata.directory_imagenet(root, **kw)
    assert got.batches_per_epoch == want.batches_per_epoch
    seq = _descriptors(got)
    assert seq == _descriptors(want) and seq
    decoded = list(data.directory_imagenet(root, **dict(kw, decode=True)))
    jdecoded = list(jdata.directory_imagenet(root, **dict(kw, decode=True)))
    for (a, la), (b, lb) in zip(decoded, jdecoded):
        assert a.dtype == np.uint8 and la.dtype == np.int32
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)


def test_directory_stream_jpeg_and_npy_equal_jax(tmp_path):
    """JPEG through PIL (imported at use) and ``.npy`` in one tree,
    resized to 32: the decoded batches equal JAX's."""
    root = _jpeg_tree(tmp_path)
    got = list(data.directory_imagenet(root, batch_size=2, image_size=32,
                                       epochs=2, seed=2))
    want = list(jdata.directory_imagenet(root, batch_size=2, image_size=32,
                                         epochs=2, seed=2))
    assert len(got) == len(want) == 8        # 8 files a pass, batch 2
    for (a, la), (b, lb) in zip(got, want):
        assert a.shape == (2, 32, 32, 3)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)


def test_load_batch_equals_jax(tmp_path):
    root = _npy_tree(tmp_path, size=10)
    task = next(data.directory_imagenet(root, batch_size=3, image_size=6,
                                        decode=False))
    jtask = next(jdata.directory_imagenet(root, batch_size=3, image_size=6,
                                          decode=False))
    imgs, labels = data.load_batch(task)
    jimgs, jlabels = jdata.load_batch(jtask)
    assert imgs.shape == (3, 6, 6, 3)
    np.testing.assert_array_equal(imgs, jimgs)
    np.testing.assert_array_equal(labels, jlabels)


def test_directory_stream_epochs_none_and_close(tmp_path):
    import itertools
    root = _npy_tree(tmp_path)
    unending = data.directory_imagenet(root, batch_size=4, image_size=8,
                                       epochs=None, workers=2)
    assert len(list(itertools.islice(unending, 9))) == 9
    unending.close()
    assert list(unending) == []


def test_directory_stream_refusals(tmp_path):
    root = _npy_tree(tmp_path)
    # host_shard=True (ported) is this process's identity, here (0, 1)
    assert data.directory_imagenet(root, batch_size=2,
                                   host_shard=True).host_shard == (0, 1)
    with pytest.raises(ValueError, match="host_shard"):
        data.directory_imagenet(root, batch_size=2, host_shard=(2, 2))
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(ValueError, match="no class"):
        data.directory_imagenet(str(empty), batch_size=2)
