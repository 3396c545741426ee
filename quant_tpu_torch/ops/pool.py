"""Stem max pool kernel wrapper (port of quant_tpu/ops/pool.py:107-150).

`max_pool_3x3_s2_p1` launches the CUDA kernel in csrc/pool.cu for a CUDA
tensor and runs its plain twin, `ops.conv.max_pool2d`, for a CPU tensor.
Both take the max over the same 9 values, with NaN propagated as
lax.max does, so they agree exactly: equal values, NaN where the other
has NaN (its payload may differ). The kernel has no backward: where
autograd would record the pool, the wrapper raises, and train forwards
take `ops.conv.max_pool2d` (JAX's train path is reduce_window too).

Both take a row band (`pad_top`, parallel/spatial.py): with pad_top = 0
the input is a band with the one row above it that the rank received,
and the pool pads no row at the top; the default pad_top = 1 is the
whole map's pool.
"""

import ctypes

import torch

from quant_tpu_torch import _build
from quant_tpu_torch.ops.conv import IntOr2, _pair, max_pool2d

_SIG = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 \
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
                 stride: IntOr2, padding: IntOr2, pad_top: int = 1) -> bool:
    """True when max_pool_3x3_s2_p1 computes this pool exactly (of a
    band with `pad_top` 0: the band and the row above it)."""
    _, h, w, _ = x_shape
    return (_pair(kernel_size) == (3, 3) and _pair(stride) == (2, 2)
            and _pair(padding) == (1, 1) and pad_top in (0, 1)
            and (h + pad_top) % 2 == 1 and w % 2 == 0)


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


def max_pool_3x3_s2_p1_plain(x: torch.Tensor,
                             pad_top: int = 1) -> torch.Tensor:
    """Plain twin: ops.conv.max_pool2d of x with -inf rows (pad_top, 0)
    above and below and -inf columns (1, 1)."""
    if pad_top == 1:
        return max_pool2d(x, kernel_size=3, stride=2, padding=1)
    return max_pool2d(x, kernel_size=3, stride=2, padding=(0, 1))


def max_pool_3x3_s2_p1(x: torch.Tensor, pad_top: int = 1) -> torch.Tensor:
    """3x3/stride-2/pad-1 max pool, NHWC, W even and H even (pad_top 1,
    the whole map) or odd (pad_top 0: a band and the row above it; see
    the module docstring); H // 2 rows out. Raises where autograd would
    need its gradient (the kernel has no backward)."""
    _build.require(x.ndim == 4, f'expected NHWC, got shape {x.shape}')
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError('max_pool_3x3_s2_p1 has no backward; a '
                           'forward that needs the gradient takes '
                           'ops.conv.max_pool2d')
    n, h, w, c = x.shape
    if pad_top not in (0, 1):
        raise ValueError(f'pad_top must be 0 or 1, got {pad_top}')
    if (h + pad_top) % 2 == 0 or w % 2:
        raise ValueError(f'fused pool needs even W and H + pad_top odd; '
                         f'got {(h, w)} at pad_top {pad_top}')
    if _build.on_cpu(x):
        return max_pool_3x3_s2_p1_plain(x, pad_top)
    _build.require(x.dtype in _ENTRY, f'unsupported dtype {x.dtype}')
    _build.require(x.is_contiguous(), 'x must be contiguous')
    out = torch.empty((n, h // 2, w // 2, c), dtype=x.dtype, device=x.device)
    lib = _build.load('pool', _SIGNATURES)
    status = getattr(lib, _ENTRY[x.dtype])(
        _build.ptr(x), _build.ptr(out), n, h, w, c, pad_top,
        _build.stream(x))
    _build.check(lib, status, 'max_pool_3x3_s2_p1')
    launches.bump()
    return out
