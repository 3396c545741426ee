"""Device selection and float32 precision for the port's entry points.

Entry points default to CUDA and raise when it is missing; only an
explicit 'cpu' runs on the CPU (the kernels' plain twins). Every entry
point that runs a model does so under `full_precision`: float32 convs
and matmuls at full float32 precision, as the JAX package computes them
(PyTorch's process default runs cuDNN's float32 convs in TF32).
"""

import contextlib
from typing import Iterator, Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = 'cuda') -> torch.device:
    """Return torch.device(device); raise if CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            f'device {dev} requested but CUDA is not available; pass '
            "device='cpu' explicitly to run the plain PyTorch path.")
    if dev.type not in ('cuda', 'cpu'):
        raise ValueError(f'unsupported device {dev} (cuda or cpu)')
    return dev


def tf32_flags() -> tuple[bool, bool]:
    """(float32 matmuls in TF32, cuDNN float32 convs in TF32), as set."""
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


@contextlib.contextmanager
def full_precision() -> Iterator[None]:
    """TF32 off for float32 matmuls and cuDNN convs inside; the caller's
    flags back on exit. Usable as a decorator. bf16 and int8 work is
    unaffected (TF32 applies to float32 operands only)."""
    saved = tf32_flags()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
