"""Sign function with sign(0) = +1 and its straight-through estimator
(port of quant_tpu/ops/ste.py).

`torch.sign(0)` is 0, so the port never uses it for sign planes.
"""

from typing import Any

import torch


def binary_sign(x: torch.Tensor) -> torch.Tensor:
    """Return -1 where x < 0 and +1 where x >= 0, in x's dtype."""
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return torch.where(x < 0, -one, one)


class _Binarize(torch.autograd.Function):
    """binary_sign forward; the gradient passes where |x| <= 1 (closed
    window, NaN excluded) and is zero elsewhere (ste.py:33-40)."""

    @staticmethod
    def forward(ctx: Any, x: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x.abs() <= 1.0)
        return binary_sign(x)

    @staticmethod
    def backward(ctx: Any, g: torch.Tensor) -> torch.Tensor:
        mask, = ctx.saved_tensors
        return torch.where(mask, g, torch.zeros((), dtype=g.dtype,
                                                device=g.device))


def binarize(x: torch.Tensor) -> torch.Tensor:
    """Binarize x to {-1, +1} with the clipped straight-through gradient.

    Where autograd records nothing (no grad mode, or x needs no
    gradient) this is binary_sign itself, so eval forwards pay no
    autograd bookkeeping.
    """
    if torch.is_grad_enabled() and x.requires_grad:
        return _Binarize.apply(x)
    return binary_sign(x)
