"""Dataset readers and batched loaders (port of quant_tpu/data/loaders.py).

numpy, as in the JAX package, with the same readers, normalizations,
augmentations and seeds, so a loader gives the JAX loader's batches
element for element where both take the same native backend
(`native.AVAILABLE`):
  * MNIST     — IDX files (optionally gzipped), mean 0.1307 / std 0.3081
  * CIFAR-10  — pickled batches, (0.4914,0.4822,0.4465)/(0.2470,0.2435,0.2616)
  * CIFAR-100 — train RandomCrop(32, pad=4) + HFlip,
                (0.5071,0.4865,0.4409)/(0.2673,0.2564,0.2762)
  * ImageNet  — the train/val class-folder layout; train
                RandomResizedCrop(224) + HFlip + ColorJitter, test
                Resize(256) + CenterCrop(224); never downloads
  * synthetic — seeded N(0, 1) images and uniform labels
  * `test_subset`, `drop_last` and the `cleanup()` hook

All loaders emit (images NHWC float32 normalized, labels int32) numpy
batches; train.engine moves them to the card. One addition to the JAX
loaders: `set_epoch(epoch)` on a train loader sets the epoch its next
pass shuffles and augments for (the JAX loaders count passes from 0), so
a restored run draws the batches the uninterrupted run would have.
"""

import gzip
import logging
import pickle
import struct
from pathlib import Path
from typing import Callable, Iterable, Iterator, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)


class BatchIterable:
    """Reshuffled-per-epoch batched view over in-memory arrays."""

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 batch_size: int, shuffle: bool, seed: int = 0,
                 augment: Optional[Callable] = None,
                 drop_last: bool = False,
                 pad_value: Optional[np.ndarray] = None):
        self.images, self.labels = images, labels
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.augment = augment
        self.drop_last = drop_last
        self.pad_value = pad_value
        self._epoch = 0
        self._seed = seed

    @property
    def num_examples(self) -> int:
        return len(self.labels)

    def __len__(self) -> int:
        n = self.num_examples
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        """The next pass shuffles and augments as pass `epoch` (from 0)."""
        self._epoch = epoch

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        from quant_tpu_torch.data import native
        n = self.num_examples
        epoch_seed = self._seed + self._epoch
        if self.shuffle:
            order = native.shuffled_order(n, epoch_seed)
        else:
            order = np.arange(n, dtype=np.int32)
        aug_rng = np.random.default_rng(self._seed + 10_000 + self._epoch)
        self._epoch += 1
        end = (n // self.batch_size) * self.batch_size if self.drop_last else n
        use_native_aug = (self.augment == 'crop_flip'
                          and self.images.ndim == 4)
        for start in range(0, end, self.batch_size):
            idx = order[start:start + self.batch_size]
            bsz = len(idx)
            if use_native_aug:
                # Fused native gather + crop/flip (C++ path when built).
                imgs = native.make_batch(self.images, order, start, bsz,
                                         pad=4, seed=epoch_seed,
                                         augment=True,
                                         pad_value=self.pad_value)
            else:
                imgs = self.images[idx]
                if callable(self.augment):
                    imgs = self.augment(imgs, aug_rng)
            yield imgs.astype(np.float32), self.labels[idx].astype(np.int32)


def random_crop_flip(images: np.ndarray, rng: np.random.Generator,
                     pad: int = 4,
                     pad_value: Optional[np.ndarray] = None) -> np.ndarray:
    """RandomCrop(H, pad) + horizontal flip, vectorized over the batch.

    pad_value fills out-of-bounds pixels per channel (the normalized value
    of a raw black pixel, matching torchvision's pad-then-normalize
    ordering; defaults to zeros)."""
    n, h, w, c = images.shape
    padded = np.pad(images, ((0, 0), (pad, pad), (pad, pad), (0, 0)),
                    mode='constant')
    if pad_value is not None:
        pv = np.asarray(pad_value, images.dtype)
        padded[:, :pad, :, :] = pv
        padded[:, -pad:, :, :] = pv
        padded[:, :, :pad, :] = pv
        padded[:, :, -pad:, :] = pv
    ys = rng.integers(0, 2 * pad + 1, n)
    xs = rng.integers(0, 2 * pad + 1, n)
    flips = rng.random(n) < 0.5
    out = np.empty_like(images)
    for i in range(n):
        crop = padded[i, ys[i]:ys[i] + h, xs[i]:xs[i] + w]
        out[i] = crop[:, ::-1] if flips[i] else crop
    return out


_GRAY = np.array([0.299, 0.587, 0.114], np.float32)  # ITU-R 601-2 luma


def apply_color_jitter(img: np.ndarray, fb: float, fc: float,
                       fs: float,
                       order: object = (0, 1, 2)) -> np.ndarray:
    """Deterministic core of ColorJitter on a [0,1] float HWC image.

    torchvision semantics (reference data_loaders.py:334 uses
    ColorJitter(0.4, 0.4, 0.4)): each transform blends toward a target
    and clamps to [0,1]; they are applied in a random order.
      brightness: img * fb
      contrast:   img * fc + (1 - fc) * mean(gray(img))
      saturation: img * fs + (1 - fs) * gray(img) (per pixel)
    """
    for which in order:
        if which == 0:
            img = img * fb
        elif which == 1:
            mean = (img @ _GRAY).mean(dtype=np.float32)
            img = img * fc + (1.0 - fc) * mean
        else:
            gray = (img @ _GRAY)[..., None]
            img = img * fs + (1.0 - fs) * gray
        img = np.clip(img, 0.0, 1.0)
    return img


def color_jitter(img: np.ndarray, rng: np.random.Generator,
                 brightness: float = 0.4, contrast: float = 0.4,
                 saturation: float = 0.4) -> np.ndarray:
    """Random ColorJitter: factors ~ U[max(0, 1-a), 1+a], random order."""
    fb = rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
    fc = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)
    fs = rng.uniform(max(0.0, 1 - saturation), 1 + saturation)
    order = rng.permutation(3)
    return apply_color_jitter(img, fb, fc, fs, order)


class QuantDataLoader:
    """Base loader: reference QuantDataLoader ABC semantics."""

    def __init__(self, dataset_path: str = '', train_batch_size: int = 64,
                 test_batch_size: int = 256, workers: int = 0,
                 download: bool = False, test_subset: Optional[int] = None,
                 seed: int = 0, drop_last: bool = False, **_unused):
        self.dataset_path = Path(dataset_path)
        self.train_batch_size = train_batch_size
        self.test_batch_size = test_batch_size
        self.test_subset = test_subset
        self.seed = seed
        self.drop_last = drop_last
        self.workers = workers

    def get_train_loader(self) -> BatchIterable:
        raise NotImplementedError

    def get_test_loader(self) -> BatchIterable:
        raise NotImplementedError

    def cleanup(self) -> None:
        """Post-run hook (reference data_loaders.py:59-61)."""

    def _subset(self, images: np.ndarray, labels: np.ndarray
                ) -> tuple[np.ndarray, np.ndarray]:
        if self.test_subset:
            return images[:self.test_subset], labels[:self.test_subset]
        return images, labels


def _read_idx(path: Path) -> np.ndarray:
    """Read an MNIST idx file (optionally gzipped)."""
    opener = gzip.open if path.suffix == '.gz' else open
    with opener(path, 'rb') as f:
        magic = struct.unpack('>I', f.read(4))[0]
        ndim = magic & 0xFF
        shape = struct.unpack('>' + 'I' * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), np.uint8).reshape(shape)


def _find(path: Path, names: list[str]) -> Path:
    for name in names:
        for cand in (path / name, path / (name + '.gz'),
                     path / 'MNIST' / 'raw' / name,
                     path / 'MNIST' / 'raw' / (name + '.gz')):
            if cand.exists():
                return cand
    raise FileNotFoundError(f'None of {names} under {path} '
                            '(downloads are not supported; place the '
                            'dataset files there)')


class MNISTDataLoader(QuantDataLoader):
    """MNIST from idx files; normalize (0.1307, 0.3081)."""

    MEAN, STD = 0.1307, 0.3081

    def _load(self, split: str) -> tuple[np.ndarray, np.ndarray]:
        prefix = 'train' if split == 'train' else 't10k'
        images = _read_idx(_find(self.dataset_path,
                                 [f'{prefix}-images-idx3-ubyte',
                                  f'{prefix}-images.idx3-ubyte']))
        labels = _read_idx(_find(self.dataset_path,
                                 [f'{prefix}-labels-idx1-ubyte',
                                  f'{prefix}-labels.idx1-ubyte']))
        x = (images.astype(np.float32) / 255.0 - self.MEAN) / self.STD
        return x[..., None], labels

    def get_train_loader(self) -> BatchIterable:
        x, y = self._load('train')
        return BatchIterable(x, y, self.train_batch_size, shuffle=True,
                             seed=self.seed, drop_last=self.drop_last)

    def get_test_loader(self) -> BatchIterable:
        x, y = self._subset(*self._load('test'))
        return BatchIterable(x, y, self.test_batch_size, shuffle=False)


class _CIFARBase(QuantDataLoader):
    mean: np.ndarray
    std: np.ndarray
    train_files: list[str]
    test_files: list[str]
    label_key: bytes

    def _load(self, files: Sequence
              ) -> tuple[np.ndarray, np.ndarray]:
        xs, ys = [], []
        for name in files:
            for cand in (self.dataset_path / name,
                         *self.dataset_path.glob(f'*/{name}')):
                if cand.exists():
                    with open(cand, 'rb') as f:
                        d = pickle.load(f, encoding='bytes')
                    xs.append(d[b'data'])
                    ys.append(np.asarray(d[self.label_key]))
                    break
            else:
                raise FileNotFoundError(f'{name} under {self.dataset_path}')
        x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        x = (x.astype(np.float32) / 255.0 - self.mean) / self.std
        return x, np.concatenate(ys)

    def get_train_loader(self) -> BatchIterable:
        x, y = self._load(self.train_files)
        # Reference aug order is pad-raw-then-normalize: the 4px border of
        # shifted crops is a raw black pixel, i.e. (0 - mean)/std after
        # normalization (torchvision RandomCrop + Normalize).
        pad_value = (0.0 - self.mean) / self.std
        return BatchIterable(x, y, self.train_batch_size, shuffle=True,
                             seed=self.seed, augment='crop_flip',
                             drop_last=self.drop_last, pad_value=pad_value)

    def get_test_loader(self) -> BatchIterable:
        x, y = self._subset(*self._load(self.test_files))
        return BatchIterable(x, y, self.test_batch_size, shuffle=False)


class CIFAR10DataLoader(_CIFARBase):
    mean = np.array([0.4914, 0.4822, 0.4465], np.float32)
    std = np.array([0.2470, 0.2435, 0.2616], np.float32)
    train_files = [f'data_batch_{i}' for i in range(1, 6)]
    test_files = ['test_batch']
    label_key = b'labels'


class CIFAR100DataLoader(_CIFARBase):
    mean = np.array([0.5071, 0.4865, 0.4409], np.float32)
    std = np.array([0.2673, 0.2564, 0.2762], np.float32)
    train_files = ['train']
    test_files = ['test']
    label_key = b'fine_labels'


class ImageNetDataLoader(QuantDataLoader):
    """ImageNet from the standard train/val class-folder layout.

    Decoding uses the native libjpeg pipeline when available (fused
    scaled-DCT decode + crop + resize, native/quantjpeg.cpp; disable
    with native_decode=False) with per-file PIL fallback for non-JPEG
    inputs. Train aug parity with the reference
    (data_loaders.py:330-338): RandomResizedCrop(224) + HFlip +
    ColorJitter(0.4, 0.4, 0.4); test: Resize(256) + CenterCrop(224);
    ImageNet normalization. Images are decoded lazily per batch (the full
    set does not fit in RAM).

    Pipeline: per-image decode fans out over a thread pool (`workers`
    threads, default 8 — PIL decode/IO release the GIL) and a background
    producer keeps 2 batches prefetched, so host input work overlaps
    device compute (the reference's num_workers analog,
    data_loaders.py:345). Each image draws its augmentation from its own
    rng seeded by (seed, epoch, index): deterministic under any thread
    interleaving.
    """

    MEAN = np.array([0.485, 0.456, 0.406], np.float32)
    STD = np.array([0.229, 0.224, 0.225], np.float32)
    CROP, RESIZE = 224, 256
    JITTER = (0.4, 0.4, 0.4)

    def __init__(self, *args, native_decode: bool = True, **kwargs):
        super().__init__(*args, **kwargs)
        try:
            from PIL import Image  # noqa: F401
            self._pil = True
        except ImportError:  # pragma: no cover
            self._pil = False
        if native_decode:
            from quant_tpu_torch.data import native_jpeg
            self._native = native_jpeg.AVAILABLE
        else:
            self._native = False

    def _index_split(self, split: str) -> tuple[list, np.ndarray]:
        root = self.dataset_path / split
        if not root.is_dir():
            raise FileNotFoundError(f'{root} (downloads are not supported)')
        classes = sorted(p.name for p in root.iterdir() if p.is_dir())
        files, labels = [], []
        for li, cname in enumerate(classes):
            for f in sorted((root / cname).iterdir()):
                files.append(f)
                labels.append(li)
        return files, np.asarray(labels, np.int64)

    def _train_box(self, w: int, h: int,
                   rng: np.random.Generator) -> tuple:
        """RandomResizedCrop(224) box draw: scale (0.08,1.0), ratio
        (3/4,4/3), 10 tries then full image (reference
        data_loaders.py:330-338 / torchvision semantics)."""
        for _ in range(10):
            area = w * h * rng.uniform(0.08, 1.0)
            ratio = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
            cw = int(round(np.sqrt(area * ratio)))
            ch = int(round(np.sqrt(area / ratio)))
            if cw <= w and ch <= h:
                x0 = int(rng.integers(0, w - cw + 1))
                y0 = int(rng.integers(0, h - ch + 1))
                return (x0, y0, cw, ch)
        return None  # full image

    def _eval_geometry(self, w: int, h: int) -> tuple:
        """Resize (min side -> 256) dims and the 224 center-crop box in
        RESIZED coordinates (reference data_loaders.py:356-363)."""
        scale = self.RESIZE / min(w, h)
        w2 = max(self.CROP, int(round(w * scale)))
        h2 = max(self.CROP, int(round(h * scale)))
        return w2, h2, (w2 - self.CROP) // 2, (h2 - self.CROP) // 2

    def _decode(self, path: object, train: bool,
                rng: Optional[np.random.Generator]) -> np.ndarray:
        """One image -> normalized float32 (224, 224, 3).

        The native libjpeg path (fused scaled decode + crop + resize)
        serves JPEG files; PIL serves everything else. Geometry is
        drawn ONCE from `rng` before the backend choice, so seeds
        reproduce regardless of which backend handles which file.
        """
        img = None
        data = dims = None
        if self._native:
            from quant_tpu_torch.data import native_jpeg
            data = path.read_bytes()
            dims = native_jpeg.probe(data)
        if dims is not None:
            w, h = dims
        else:
            import io

            from PIL import Image
            img = Image.open(io.BytesIO(data) if data is not None
                             else path).convert('RGB')
            w, h = img.size

        box = flip = None
        if train:
            box = self._train_box(w, h, rng)
            flip = rng.random() < 0.5

        arr8 = None
        if dims is not None:
            if train:
                arr8 = native_jpeg.decode_crop_resize(
                    data, box, (self.CROP, self.CROP), flip)
            else:
                # Same two-step as the PIL path (resize min-side to 256,
                # center-crop 224) so both backends see identical
                # geometry; libjpeg's scaled decode still kicks in for
                # large sources since the full image downsizes ~4x.
                w2, h2, x0, y0 = self._eval_geometry(w, h)
                full = native_jpeg.decode_crop_resize(data, None, (w2, h2))
                if full is not None:
                    arr8 = full[y0:y0 + self.CROP, x0:x0 + self.CROP]

        if arr8 is None:  # no native lib, non-JPEG file, or decode error
            import io

            from PIL import Image
            if img is None:
                img = Image.open(io.BytesIO(data) if data is not None
                                 else path).convert('RGB')
            if train:
                if box is not None:
                    x0, y0, cw, ch = box
                    img = img.crop((x0, y0, x0 + cw, y0 + ch))
                img = img.resize((self.CROP, self.CROP), Image.BILINEAR)
                if flip:
                    img = img.transpose(Image.FLIP_LEFT_RIGHT)
            else:
                w2, h2, x0, y0 = self._eval_geometry(w, h)
                img = img.resize((w2, h2), Image.BILINEAR)
                img = img.crop((x0, y0, x0 + self.CROP, y0 + self.CROP))
            arr8 = np.asarray(img, np.uint8)

        factors = order = None
        if train:
            b, c, s = self.JITTER
            factors = (rng.uniform(max(0.0, 1 - b), 1 + b),
                       rng.uniform(max(0.0, 1 - c), 1 + c),
                       rng.uniform(max(0.0, 1 - s), 1 + s))
            order = rng.permutation(3)
        if self._native:
            out = native_jpeg.jitter_norm(arr8, self.MEAN, self.STD,
                                          factors, order)
            if out is not None:
                return out
        arr = arr8.astype(np.float32) / 255.0
        if train:
            arr = apply_color_jitter(arr, *factors, order)
        return (arr - self.MEAN) / self.STD

    def _loader(self, split: str, batch_size: int,
                train: bool) -> Iterable:
        from concurrent.futures import ThreadPoolExecutor

        from quant_tpu_torch.data.prefetch import PrefetchIterable

        files, labels = self._index_split(split)
        if not train:
            files, labels = self._subset(np.asarray(files, object), labels)
        loader_self = self
        nworkers = self.workers or 8

        class _Lazy:
            num_examples = len(labels)
            _epoch = 0

            def __len__(self):
                return -(-len(labels) // batch_size)

            def set_epoch(self, epoch: int) -> None:
                type(self)._epoch = epoch

            def __iter__(self):
                order = np.arange(len(labels))
                epoch = type(self)._epoch
                type(self)._epoch += 1
                if train:
                    np.random.default_rng(
                        loader_self.seed + epoch).shuffle(order)

                def decode_one(i):
                    rng = np.random.default_rng(np.random.SeedSequence(
                        [loader_self.seed, epoch, int(i)]))
                    return loader_self._decode(files[i], train, rng)

                with ThreadPoolExecutor(nworkers) as pool:
                    for s in range(0, len(labels), batch_size):
                        idx = order[s:s + batch_size]
                        imgs = np.stack(list(pool.map(decode_one, idx)))
                        yield imgs, labels[idx].astype(np.int32)

        return PrefetchIterable(_Lazy(), depth=2)

    def get_train_loader(self) -> object:
        return self._loader('train', self.train_batch_size, train=True)

    def get_test_loader(self) -> object:
        return self._loader('val', self.test_batch_size, train=False)


class SyntheticDataLoader(QuantDataLoader):
    """Random data with fixed shapes — the test/bench workhorse (the
    reference's RandomQuantDataLoader analog, tests/data/helpers.py)."""

    def __init__(self, *args: object,
                 image_shape: Sequence[int] = (28, 28, 1),
                 num_classes: int = 10,
                 train_size: int = 256, test_size: int = 256, **kwargs):
        super().__init__(*args, **kwargs)
        self.image_shape = tuple(image_shape)
        self.num_classes = num_classes
        rng = np.random.default_rng(self.seed)
        self._train = (rng.standard_normal(
            (train_size,) + self.image_shape).astype(np.float32),
            rng.integers(0, num_classes, train_size))
        self._test = (rng.standard_normal(
            (test_size,) + self.image_shape).astype(np.float32),
            rng.integers(0, num_classes, test_size))

    def get_train_loader(self) -> BatchIterable:
        return BatchIterable(*self._train, self.train_batch_size,
                             shuffle=True, seed=self.seed,
                             drop_last=self.drop_last)

    def get_test_loader(self) -> BatchIterable:
        x, y = self._subset(*self._test)
        return BatchIterable(x, y, self.test_batch_size, shuffle=False)


DATASET_REGISTRY = {
    'mnist': MNISTDataLoader,
    'cifar10': CIFAR10DataLoader,
    'cifar100': CIFAR100DataLoader,
    'imagenet': ImageNetDataLoader,
    'synthetic': SyntheticDataLoader,
}
