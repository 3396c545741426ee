"""Input pipelines (port of quant_tpu/data): datasets read from their
on-disk formats (MNIST IDX, CIFAR pickles, the ImageNet folder layout)
into host numpy arrays, augmented with numpy or the native library, and
streamed as NHWC float32 batches."""

from quant_tpu_torch.data.loaders import (
    QuantDataLoader,
    MNISTDataLoader,
    CIFAR10DataLoader,
    CIFAR100DataLoader,
    ImageNetDataLoader,
    SyntheticDataLoader,
    DATASET_REGISTRY,
)

__all__ = [
    'QuantDataLoader', 'MNISTDataLoader', 'CIFAR10DataLoader',
    'CIFAR100DataLoader', 'ImageNetDataLoader', 'SyntheticDataLoader',
    'DATASET_REGISTRY',
]
