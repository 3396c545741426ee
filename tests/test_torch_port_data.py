"""The port's loaders against the JAX package's, batch for batch.

Both are numpy; the port builds the native libraries from native/ into
build/quant_tpu_torch/, the JAX package into quant_tpu/data/. The
native shuffle gives another order than the numpy fallback, and the
native JPEG decoder other pixels than PIL, so each test first asserts
that both sides take the same backend. Datasets are written by the
tests: MNIST IDX (gzipped), CIFAR-10 and CIFAR-100 pickles, a few JPEGs
in the ImageNet folder layout; and the synthetic loader.
"""

import gzip
import pickle
import struct

import numpy as np
import pytest

from quant_tpu.data import loaders as jloaders
from quant_tpu.data import native as jnative
from quant_tpu.data import native_jpeg as jnative_jpeg
from quant_tpu_torch.data import loaders as tloaders
from quant_tpu_torch.data import native as tnative
from quant_tpu_torch.data import native_jpeg as tnative_jpeg


def assert_same_backends():
    assert tnative.AVAILABLE == jnative.AVAILABLE
    assert tnative_jpeg.AVAILABLE == jnative_jpeg.AVAILABLE


def epochs(loader, n=2):
    """n passes of a loader, as lists of (images, labels)."""
    return [list(loader) for _ in range(n)]


def assert_batches_equal(want, got):
    assert len(want) == len(got)
    for we, ge in zip(want, got):
        assert len(we) == len(ge) and len(we) > 0
        for (wx, wy), (gx, gy) in zip(we, ge):
            assert gx.dtype == wx.dtype == np.float32
            assert gy.dtype == wy.dtype == np.int32
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)


def both(name, **kw):
    return (getattr(jloaders, name)(**kw), getattr(tloaders, name)(**kw))


def write_idx(path, arr, magic):
    with gzip.open(path, 'wb') as f:
        f.write(struct.pack('>I', magic))
        f.write(struct.pack('>' + 'I' * arr.ndim, *arr.shape))
        f.write(arr.tobytes())


@pytest.fixture(scope='module')
def mnist_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp('mnist')
    rng = np.random.default_rng(0)
    for prefix, n in (('train', 70), ('t10k', 23)):
        write_idx(d / f'{prefix}-images-idx3-ubyte.gz',
                  rng.integers(0, 256, (n, 28, 28), dtype=np.uint8), 0x803)
        write_idx(d / f'{prefix}-labels-idx1-ubyte.gz',
                  rng.integers(0, 10, n, dtype=np.uint8), 0x801)
    return d


@pytest.mark.parametrize('drop_last', [False, True])
def test_mnist_idx(mnist_dir, drop_last):
    assert_same_backends()
    j, t = both('MNISTDataLoader', dataset_path=str(mnist_dir),
                train_batch_size=16, test_batch_size=10, seed=3,
                drop_last=drop_last)
    assert_batches_equal(epochs(j.get_train_loader()),
                         epochs(t.get_train_loader()))
    assert_batches_equal(epochs(j.get_test_loader(), 1),
                         epochs(t.get_test_loader(), 1))
    assert len(t.get_train_loader()) == (4 if drop_last else 5)


def _cifar(tmp_path_factory, files, label_key):
    d = tmp_path_factory.mktemp('cifar')
    rng = np.random.default_rng(1)
    for name, n in files:
        with open(d / name, 'wb') as f:
            pickle.dump({b'data': rng.integers(0, 256, (n, 3072),
                                               dtype=np.uint8),
                         label_key: list(rng.integers(0, 100, n))}, f)
    return d


@pytest.mark.parametrize('name,files,key', [
    ('CIFAR10DataLoader', [(f'data_batch_{i}', 7) for i in range(1, 6)]
     + [('test_batch', 9)], b'labels'),
    ('CIFAR100DataLoader', [('train', 30), ('test', 9)], b'fine_labels'),
])
def test_cifar_pickles_crop_flip_over_two_epochs(tmp_path_factory, name,
                                                  files, key):
    assert_same_backends()
    d = _cifar(tmp_path_factory, files, key)
    j, t = both(name, dataset_path=str(d), train_batch_size=8,
                test_batch_size=4, seed=5, test_subset=7)
    want = epochs(j.get_train_loader())
    got = epochs(t.get_train_loader())
    assert_batches_equal(want, got)
    # The two epochs shuffle and crop differently.
    assert not np.array_equal(got[0][0][0], got[1][0][0])
    test = epochs(t.get_test_loader(), 1)
    assert_batches_equal(epochs(j.get_test_loader(), 1), test)
    assert sum(len(y) for _, y in test[0]) == 7  # test_subset


@pytest.mark.parametrize('drop_last', [False, True])
def test_synthetic(drop_last):
    assert_same_backends()
    kw = dict(image_shape=(8, 8, 3), num_classes=5, train_size=37,
              test_size=11, train_batch_size=8, test_batch_size=4, seed=9,
              drop_last=drop_last, test_subset=6)
    j, t = both('SyntheticDataLoader', **kw)
    assert_batches_equal(epochs(j.get_train_loader()),
                         epochs(t.get_train_loader()))
    assert_batches_equal(epochs(j.get_test_loader(), 1),
                         epochs(t.get_test_loader(), 1))


def test_set_epoch_replays_a_pass():
    """The port's one addition: set_epoch(e) makes the next pass the
    e-th pass (from 0) of a fresh loader, as a restored run needs."""
    t = tloaders.SyntheticDataLoader(image_shape=(4, 4, 1), train_size=20,
                                     train_batch_size=8, seed=2)
    fresh = epochs(t.get_train_loader(), 3)
    loader = t.get_train_loader()
    loader.set_epoch(2)
    assert_batches_equal([fresh[2]], [list(loader)])


@pytest.fixture(scope='module')
def imagenet_dir(tmp_path_factory):
    from PIL import Image
    d = tmp_path_factory.mktemp('imagenet')
    rng = np.random.default_rng(4)
    for split, n in (('train', 3), ('val', 2)):
        for cname in ('n01', 'n02'):
            (d / split / cname).mkdir(parents=True)
            for i in range(n):
                h, w = rng.integers(160, 300, 2)
                img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                Image.fromarray(img).save(d / split / cname / f'{i}.jpg',
                                          quality=90)
    return d


def test_imagenet_jpegs(imagenet_dir):
    assert_same_backends()
    j, t = both('ImageNetDataLoader', dataset_path=str(imagenet_dir),
                train_batch_size=4, test_batch_size=3, seed=1, workers=2)
    want = epochs(j.get_train_loader())
    got = epochs(t.get_train_loader())
    assert_batches_equal(want, got)
    assert got[0][0][0].shape == (4, 224, 224, 3)
    assert_batches_equal(epochs(j.get_test_loader(), 1),
                         epochs(t.get_test_loader(), 1))
    loader = t.get_train_loader()
    loader.set_epoch(1)
    assert_batches_equal([got[1]], [list(loader)])


def test_registry_and_native_batch_match():
    assert set(tloaders.DATASET_REGISTRY) == set(jloaders.DATASET_REGISTRY)
    assert_same_backends()
    rng = np.random.default_rng(7)
    src = rng.standard_normal((10, 6, 6, 3)).astype(np.float32)
    order = tnative.shuffled_order(10, 4)
    np.testing.assert_array_equal(order, jnative.shuffled_order(10, 4))
    pad = np.array([0.1, -0.2, 0.3], np.float32)
    for augment in (False, True):
        np.testing.assert_array_equal(
            tnative.make_batch(src, order, 2, 5, 4, 11, augment, pad),
            jnative.make_batch(src, order, 2, 5, 4, 11, augment, pad))
