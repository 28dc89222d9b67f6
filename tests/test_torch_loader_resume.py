"""Loader resume in the port against the JAX package's (oracle
``tests/test_loader_resume.py``): ``DirectoryImagenet.state_dict`` →
``resume`` replays the identical tail across epoch reshuffles and host
shards, ``skip`` equals consuming, a mismatched schedule is rejected,
and ``PrefetchLoader.state_dict`` (ordered, 1 and 3 workers, decode and
augment in the workers) rewinds to the delivered count, so the resumed
augmented stream equals both the uninterrupted one and JAX's; completion
order delivers the exact set, and its ``state_dict`` refuses."""

import zlib

import numpy as np
import pytest
import torch

from apex_tpu import data as jdata
from apex_tpu_torch.data import (BatchFiles, PrefetchLoader, augment_images,
                                 directory_imagenet, load_batch)


def _npy_tree(root, per_class=6, classes=2, size=16):
    rng = np.random.RandomState(7)
    for c in range(classes):
        d = root / f"class{c}"
        d.mkdir()
        for i in range(per_class):
            np.save(d / f"s{i}.npy",
                    rng.randint(0, 256, (size, size, 3)).astype(np.uint8))
    return str(root)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _batch_key(batch):
    imgs, labels = batch
    return (_np(imgs).tobytes(), _np(labels).tobytes())


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for (a, la), (b, lb) in zip(got, want):
        np.testing.assert_array_equal(_np(a), _np(b))
        np.testing.assert_array_equal(_np(la), _np(lb))


@pytest.mark.parametrize("host_shard", [None, (0, 2), (1, 2)])
def test_stream_resume_replays_identical_tail(tmp_path, host_shard):
    root = _npy_tree(tmp_path, per_class=10)
    kw = dict(batch_size=4, image_size=16, epochs=3, seed=5,
              host_shard=host_shard)
    full = list(directory_imagenet(root, **kw))
    _assert_batches_equal(full, list(jdata.directory_imagenet(root, **kw)))
    cut = len(full) // 2 + 1
    consumed = directory_imagenet(root, **kw)
    for _ in range(cut):
        next(consumed)
    sd = consumed.state_dict()
    assert sd["cursor"] == cut
    jconsumed = jdata.directory_imagenet(root, **kw)
    for _ in range(cut):
        next(jconsumed)
    assert sd == jconsumed.state_dict()
    tail = list(directory_imagenet(root, **kw).resume(sd))
    _assert_batches_equal(tail, full[cut:])


def test_skip_equals_consume_and_seq_is_stable(tmp_path):
    root = _npy_tree(tmp_path)
    kw = dict(batch_size=4, image_size=16, epochs=2, decode=False)
    a = directory_imagenet(root, **kw)
    for _ in range(3):
        next(a)
    b = directory_imagenet(root, **kw).skip(3)
    ta, tb = next(a), next(b)
    assert isinstance(ta, BatchFiles)
    assert ta.paths == tb.paths and ta.seq == tb.seq == 3
    np.testing.assert_array_equal(ta.labels, tb.labels)
    jt = next(jdata.directory_imagenet(root, **kw).skip(3))
    assert jt.paths == ta.paths and jt.seq == ta.seq


@pytest.mark.parametrize("field,value", [("seed", 6), ("batch_size", 2),
                                         ("shuffle", False)])
def test_resume_rejects_mismatched_schedule(tmp_path, field, value):
    root = _npy_tree(tmp_path)
    kw = dict(batch_size=4, image_size=16, seed=5)
    sd = directory_imagenet(root, **kw).state_dict()
    other = directory_imagenet(root, **dict(kw, **{field: value}))
    with pytest.raises(ValueError, match="resume mismatch"):
        other.resume(sd)


def _augment_transform(image_size):
    """The ImageNet trainer's recipe: the rng seeded from the batch's
    paths and its global ``seq``, so a descriptor draws the same crops
    and flips on any worker."""
    def assemble(task):
        imgs, labels = load_batch(task)
        rng = np.random.RandomState(
            (zlib.crc32("|".join(task.paths).encode())
             ^ (task.seq * 2654435761)) & 0x7FFFFFFF)
        return augment_images(imgs, image_size - 4, rng), labels
    return assemble


def _jax_augmented(root, kw, image_size):
    """JAX's augmented stream for the same descriptors."""
    out = []
    for task in jdata.directory_imagenet(root, **kw):
        imgs, labels = jdata.load_batch(task)
        rng = np.random.RandomState(
            (zlib.crc32("|".join(task.paths).encode())
             ^ (task.seq * 2654435761)) & 0x7FFFFFFF)
        out.append((jdata.augment_images(imgs, image_size - 4, rng),
                    labels))
    return out


@pytest.mark.parametrize("workers", [1, 3])
def test_prefetch_resume_ordered_replays_identical(tmp_path, workers):
    root = _npy_tree(tmp_path)
    kw = dict(batch_size=4, image_size=16, epochs=2, seed=3, decode=False)
    assemble = _augment_transform(16)

    def loader_for(stream):
        return PrefetchLoader(stream, depth=2, workers=workers,
                              transform=assemble, device="cpu")

    with loader_for(directory_imagenet(root, **kw)) as full_loader:
        full = list(full_loader)
    _assert_batches_equal(full, _jax_augmented(root, kw, 16))
    cut = len(full) // 2 + 1
    loader = loader_for(directory_imagenet(root, **kw))
    it = iter(loader)
    for _ in range(cut):
        next(it)
    sd = loader.state_dict()
    loader.close()
    assert sd["delivered"] == cut and sd["source"]["cursor"] == cut
    resumed = directory_imagenet(root, **kw).resume(sd["source"])
    with loader_for(resumed) as resumed_loader:
        tail = list(resumed_loader)
    _assert_batches_equal(tail, full[cut:])


def test_prefetch_resume_completion_order_delivers_exact_set(tmp_path):
    root = _npy_tree(tmp_path)
    kw = dict(batch_size=4, image_size=16, epochs=2, seed=3, decode=False)
    assemble = _augment_transform(16)
    full = _jax_augmented(root, kw, 16)
    cut = len(full) // 2
    with PrefetchLoader(directory_imagenet(root, **kw).skip(cut), depth=2,
                        workers=3, transform=assemble, ordered=False,
                        device="cpu") as loader:
        tail = list(loader)
    assert len(tail) == len(full) - cut
    assert sorted(_batch_key(b) for b in tail) == \
        sorted(_batch_key(b) for b in full[cut:])


def test_prefetch_state_dict_rejects_completion_order(tmp_path):
    root = _npy_tree(tmp_path)
    loader = PrefetchLoader(
        directory_imagenet(root, batch_size=4, image_size=16, decode=False),
        workers=2, transform=load_batch, ordered=False, device="cpu")
    with loader:
        it = iter(loader)
        next(it)
        with pytest.raises(ValueError, match="ordered"):
            loader.state_dict()


def test_prefetch_state_dict_of_a_plain_source():
    """A source without the resume protocol: the delivered count only."""
    with PrefetchLoader(iter(range(10)), device="cpu") as loader:
        it = iter(loader)
        for _ in range(4):
            next(it)
        assert loader.state_dict() == {"delivered": 4}


def test_stream_survives_host_shard_cursor_math(tmp_path):
    root = _npy_tree(tmp_path, per_class=8)
    kw = dict(batch_size=2, image_size=16, seed=3, epochs=2)
    full = list(directory_imagenet(root, **kw))
    shards = []
    for i in range(2):
        s = directory_imagenet(root, host_shard=(i, 2), **kw)
        s.skip(2)
        shards.append(list(s))
    interleaved = [b for pair in zip(*shards) for b in pair]
    _assert_batches_equal(interleaved, full[4:])
