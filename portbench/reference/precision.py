"""The chain's precision: where a configuration states a chain dtype
(`eval_dtype`, `train_dtype`), its values are held in that dtype, computed
in float32 and rounded once (round to nearest even), and so are their
gradients. A float32 chain rounds nothing."""

from typing import Callable

import torch

Round = Callable[[torch.Tensor], torch.Tensor]


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


def rounding(dtype: torch.dtype) -> Round:
    """Values, and the gradients that flow back through them, rounded
    to `dtype` and held in float32."""
    class _Round(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t):
            return t.to(dtype).to(t.dtype)

        @staticmethod
        def backward(ctx, g):
            return g.to(dtype).to(g.dtype)

    return _Round.apply


_CHAINS = {'bfloat16': rounding(torch.bfloat16),
           'float16': rounding(torch.float16)}


def chain(dtype: str) -> Round:
    """The rounding of a chain held in `dtype` (a name, as configured)."""
    if dtype == 'float32':
        return identity
    return _CHAINS[dtype]
