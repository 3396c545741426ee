"""Activation clamps and the eval form of the ls-1 quantizer (port of
quant_tpu/ops/quantize.py:37-81, 149-156).

Scales are solved in float32 over a row view (rows = out-channels for
weights, samples for activations); x_q keeps x's dtype.
"""

from functools import partial
from typing import Callable, Optional

import torch

from quant_tpu_torch.ops.ste import binary_sign


def clamp_identity(x: torch.Tensor) -> torch.Tensor:
    """Identity clamp."""
    return x


def clamp_symmetric(x: torch.Tensor, alpha: float) -> torch.Tensor:
    """Clamp x to [-alpha, +alpha]."""
    return torch.clamp(x, -alpha, alpha)


def get_clamp_fn(kind: str = 'identity',
                 alpha: float = 2.0) -> Callable:
    """Resolve a clamp config ({'kind': ..., 'alpha': ...})."""
    if kind == 'identity':
        return clamp_identity
    if kind == 'symmetric':
        return partial(clamp_symmetric, alpha=alpha)
    raise ValueError(f'{kind} is not a valid clamping function.')


def quantizer_ls_1(x: torch.Tensor, v1: Optional[torch.Tensor] = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """1-bit least-squares quantization, eval form.

    v1 is the per-row mean(|x|) in float32 when not supplied. Returns
    ((1, rows) scales, v1 * sign(x)) with sign(0) = +1.
    """
    rows = x.reshape(x.shape[0], -1)
    if v1 is None:
        v1 = rows.to(torch.float32).abs().mean(dim=-1)
    v1 = v1.reshape(-1)
    per_row = v1.reshape((-1,) + (1,) * (x.ndim - 1)).to(x.dtype)
    return v1[None, :], per_row * binary_sign(x)
