"""Convolution primitives in the JAX package's layout (NHWC / HWIO).

Port of quant_tpu/ops/conv.py:24-122. The JAX package left these
to XLA; here they are PyTorch ops (F.conv2d / F.max_pool2d) over NCHW
views of NHWC tensors, so the callers keep the reference's layouts.
All of them are differentiable: `max_pool2d` routes a window's gradient
to its first maximum in row-major order, as XLA's select_and_scatter
does for reduce_window. A conv's output dtype is its operands' (JAX's
callers pass preferred_element_type equal to it: float32, or the
train_dtype of a bf16 chain, whose output stays bf16).
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


def stem_conv_s2d(x: torch.Tensor, w: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact space-to-depth form of a 7x7/stride-2/pad-3 stem conv (port
    of quant_tpu/ops/conv.py:61-103): 2x2 pixel blocks become 4*C
    channels and the conv becomes one 4x4/stride-1 conv over them.

    out[i, j] reads padded rows 2i+1..2i+7 of pad((4, 2)). Row 2i+1+di
    lies in block i + (1+di)//2 at parity (1+di)%2, so tap (di, dj) of
    the 7x7 kernel lands on block tap ((1+di)//2, (1+dj)//2) and block
    channel (r_i*2 + r_j)*C + c; the (r=0, a=0) slots are never read and
    stay zero. Same NHWC / HWIO layouts and dtype rules as `conv2d`.
    """
    n, h, wdt, c = x.shape
    kh, kw, _, cout = w.shape
    if (kh, kw) != (7, 7) or h % 2 or wdt % 2:
        raise ValueError('stem_conv_s2d needs a 7x7/s2/p3 stem on '
                         'even spatial dims.')
    xp = F.pad(x, (0, 0, 4, 2, 4, 2))
    hb, wb = (h + 6) // 2, (wdt + 6) // 2
    xs = xp.reshape(n, hb, 2, wb, 2, c).permute(0, 1, 3, 2, 4, 5)
    xs = xs.reshape(n, hb, wb, 4 * c)

    w4 = w.new_zeros((4, 4, 4 * c, cout))
    for di in range(7):
        a, r = (1 + di) // 2, (1 + di) % 2
        for dj in range(7):
            b, s = (1 + dj) // 2, (1 + dj) % 2
            w4[a, b, (r * 2 + s) * c:(r * 2 + s + 1) * c] = w[di, dj]
    return conv2d(xs, w4, bias=bias)


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
