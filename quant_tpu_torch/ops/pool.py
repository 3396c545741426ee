"""Stem max pool kernel wrapper (port of quant_tpu/ops/pool.py:107-150).

`max_pool_3x3_s2_p1` launches the CUDA kernel in csrc/pool.cu for a CUDA
tensor and runs its plain twin, `ops.conv.max_pool2d`, for a CPU tensor.
Both take the max over the same 9 values, with NaN propagated as
lax.max does, so they agree exactly: equal values, NaN where the other
has NaN (its payload may differ). The kernel has no backward: where
autograd would record the pool, the wrapper raises, and train forwards
take `ops.conv.max_pool2d` (JAX's train path is reduce_window too).
"""

import ctypes

import torch

from quant_tpu_torch import _build
from quant_tpu_torch.ops.conv import IntOr2, _pair, max_pool2d

_SIG = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4 \
    + [ctypes.c_void_p]
_SIGNATURES = {'qtt_max_pool_3x3_s2_p1_f32': _SIG,
               'qtt_max_pool_3x3_s2_p1_bf16': _SIG,
               'qtt_max_pool_vector_bytes': [ctypes.c_longlong,
                                             ctypes.c_void_p,
                                             ctypes.c_void_p]}
_ENTRY = {torch.float32: 'qtt_max_pool_3x3_s2_p1_f32',
          torch.bfloat16: 'qtt_max_pool_3x3_s2_p1_bf16'}

launches = _build.LaunchCounter('max_pool_3x3_s2_p1')


def pool_fusable(x_shape: tuple[int, ...], kernel_size: IntOr2,
                 stride: IntOr2, padding: IntOr2) -> bool:
    """True when max_pool_3x3_s2_p1 computes this pool exactly."""
    _, h, w, _ = x_shape
    return (_pair(kernel_size) == (3, 3) and _pair(stride) == (2, 2)
            and _pair(padding) == (1, 1) and h % 2 == 0 and w % 2 == 0)


def vector_bytes(c: int, itemsize: int, *ptrs: int) -> int:
    """Bytes each load and store of the kernel moves for C channels of
    `itemsize` bytes at these addresses: the widest of 16, 8, 4 and 2
    that divides a pixel's C * itemsize bytes and every pointer, as the
    launcher in csrc/pool.cu chooses (a float32 route is never narrower
    than 4)."""
    v = 16
    while v > 2 and ((c * itemsize) % v or any(p % v for p in ptrs)):
        v //= 2
    return v


def max_pool_3x3_s2_p1(x: torch.Tensor) -> torch.Tensor:
    """3x3/stride-2/pad-1 max pool, NHWC, H and W even. Raises where
    autograd would need its gradient (the kernel has no backward)."""
    _build.require(x.ndim == 4, f'expected NHWC, got shape {x.shape}')
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError('max_pool_3x3_s2_p1 has no backward; a '
                           'forward that needs the gradient takes '
                           'ops.conv.max_pool2d')
    n, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f'fused pool needs even H, W; got {(h, w)}')
    if _build.on_cpu(x):
        return max_pool2d(x, kernel_size=3, stride=2, padding=1)
    _build.require(x.dtype in _ENTRY, f'unsupported dtype {x.dtype}')
    _build.require(x.is_contiguous(), 'x must be contiguous')
    out = torch.empty((n, h // 2, w // 2, c), dtype=x.dtype, device=x.device)
    lib = _build.load('pool', _SIGNATURES)
    status = getattr(lib, _ENTRY[x.dtype])(
        _build.ptr(x), _build.ptr(out), n, h, w, c, _build.stream(x))
    _build.check(lib, status, 'max_pool_3x3_s2_p1')
    launches.bump()
    return out
