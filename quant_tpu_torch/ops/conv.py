"""Convolution primitives in the JAX package's layout (NHWC / HWIO).

Port of quant_tpu/ops/conv.py:24-58, 106-122. The JAX package left these
to XLA; here they are PyTorch ops (F.conv2d / F.max_pool2d) over NCHW
views of NHWC tensors, so the callers keep the reference's layouts.
"""

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F

IntOr2 = Union[int, Sequence[int]]


def _pair(v: IntOr2) -> tuple[int, int]:
    if isinstance(v, int):
        return (v, v)
    a, b = v
    return (int(a), int(b))


def conv2d(x: torch.Tensor, w: torch.Tensor, *,
           stride: IntOr2 = 1, padding: IntOr2 = 0,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """2D convolution, NHWC x HWIO -> NHWC, symmetric integer padding.

    Computes in x's dtype (w must match). The bias is added after the
    conv's output rounding, in that dtype, as XLA does for `y + bias`.
    """
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=_pair(stride), padding=_pair(padding))
    y = y.permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias
    return y.contiguous()


def max_pool2d(x: torch.Tensor, *, kernel_size: IntOr2, stride: IntOr2,
               padding: IntOr2 = 0) -> torch.Tensor:
    """Max pooling over NHWC spatial dims, padded with -inf."""
    ph, pw = _pair(padding)
    xp = F.pad(x.permute(0, 3, 1, 2), (pw, pw, ph, ph),
               value=float('-inf'))
    y = F.max_pool2d(xp, kernel_size=_pair(kernel_size),
                     stride=_pair(stride))
    return y.permute(0, 2, 3, 1).contiguous()


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> (N, C) mean; reduced-precision inputs sum in float32 and
    round once, as jnp.mean does."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return x.float().mean(dim=(1, 2)).to(x.dtype)
    return x.mean(dim=(1, 2))
