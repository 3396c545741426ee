"""Device selection for the port's entry points.

Entry points default to CUDA and raise when it is missing; only an
explicit 'cpu' runs on the CPU (the kernels' plain twins).
"""

from typing import Union

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
