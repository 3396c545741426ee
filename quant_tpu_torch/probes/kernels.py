"""Wrappers of the chip-probe kernels in csrc/probe.cu, with their plain
twins (port of the Pallas kernels in tools/probe_r2.py:408-464 and
tools/probe_r3.py:304-357).

`add` and `tiled_matmul` launch their CUDA kernel for CUDA tensors and
run their plain twin for CPU tensors; nothing else falls back.
"""

import ctypes

import torch

from quant_tpu_torch import _build

# Output tile of one block, and the K slice depth of each input type.
TILE_M = TILE_N = 128
TILE_K = {torch.bfloat16: 32, torch.int8: 64}
# int8 products are at most 128 * 128 = 2^14, so the kernel's int32 sum
# cannot overflow while K <= 2^17.
MAX_INT8_K = 2 ** 17

_MM = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_SIGNATURES = {
    'qtt_add_f32': [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                            ctypes.c_void_p],
    'qtt_tiled_matmul_bf16': _MM,
    'qtt_tiled_matmul_s8': _MM,
}
_MM_ENTRY = {torch.bfloat16: 'qtt_tiled_matmul_bf16',
             torch.int8: 'qtt_tiled_matmul_s8'}

add_launches = _build.LaunchCounter('add_f32')
matmul_launches = {torch.bfloat16: _build.LaunchCounter('tiled_matmul_bf16'),
                   torch.int8: _build.LaunchCounter('tiled_matmul_int8')}


def add_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain twin of `add`."""
    return x + y


def add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x + y for two contiguous float32 tensors of one shape."""
    _build.require(x.shape == y.shape, f'shapes differ: {x.shape} vs '
                   f'{y.shape}')
    _build.require(x.dtype == torch.float32 and y.dtype == torch.float32,
                   f'add takes float32, got {x.dtype} and {y.dtype}')
    if _build.on_cpu(x, y):
        return add_plain(x, y)
    _build.require(x.is_contiguous() and y.is_contiguous(),
                   'x and y must be contiguous')
    out = torch.empty_like(x)
    # 16-byte loads only when all three arrays start on 16 bytes (a view
    # with a storage offset may not).
    vec4 = all(t.data_ptr() % 16 == 0 for t in (x, y, out))
    lib = _build.load('probe', _SIGNATURES)
    status = lib.qtt_add_f32(_build.ptr(x), _build.ptr(y), _build.ptr(out),
                             x.numel(), int(vec4), _build.stream(x))
    _build.check(lib, status, 'add')
    add_launches.bump()
    return out


def tiled_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain twin of `tiled_matmul`: bf16 sums in float32 (on CUDA only
    with TF32 off, as chip_smoke.py sets it) and rounds to nearest even;
    int8 sums in float64 (exact while |sum| < 2^53), then casts to int64
    and wraps to int8."""
    if a.dtype == torch.int8:
        return (a.double() @ b.double()).to(torch.int64).to(torch.int8)
    return (a.float() @ b.float()).to(a.dtype)


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> int:
    """Largest distance between two bf16 tensors in units in the last
    place (bit patterns mapped onto a monotone integer line)."""
    def ordered(t: torch.Tensor) -> torch.Tensor:
        v = t.view(torch.int16).to(torch.int32)
        return torch.where(v < 0, -32768 - v, v)
    return int((ordered(got) - ordered(want)).abs().max().item())


def tiled_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-major A (M, K) @ B (K, N) in the inputs' type, on the tensor
    cores.

    bf16 inputs are summed in float32 and the result rounded to bf16;
    int8 inputs are summed in int32 and the result wrapped to int8, as
    the Pallas kernels' `acc.astype(o_ref.dtype)` does. M and N must be
    multiples of 128 and K of TILE_K[dtype].
    """
    _build.require(a.ndim == 2 and b.ndim == 2, 'a and b must be 2-D')
    _build.require(a.dtype == b.dtype and a.dtype in TILE_K,
                   f'tiled_matmul takes bf16 or int8 pairs, got {a.dtype} '
                   f'and {b.dtype}')
    m, k = a.shape
    k2, n = b.shape
    _build.require(k == k2, f'contraction differs: {a.shape} @ {b.shape}')
    tk = TILE_K[a.dtype]
    _build.require(m > 0 and n > 0 and k > 0 and m % TILE_M == 0
                   and n % TILE_N == 0 and k % tk == 0,
                   f'shape ({m}, {k}) @ ({k}, {n}) is not a multiple of the '
                   f'tile ({TILE_M}, {tk}) @ ({tk}, {TILE_N})')
    _build.require(a.dtype != torch.int8 or k <= MAX_INT8_K,
                   f'int8 K {k} > {MAX_INT8_K} could overflow int32')
    if _build.on_cpu(a, b):
        return tiled_matmul_plain(a, b)
    _build.require(a.is_contiguous() and b.is_contiguous(),
                   'a and b must be contiguous (row-major)')
    _build.require(a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0,
                   'a and b must start on 16 bytes')
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    lib = _build.load('probe', _SIGNATURES)
    status = getattr(lib, _MM_ENTRY[a.dtype])(
        _build.ptr(a), _build.ptr(b), _build.ptr(out), m, n, k,
        _build.stream(a))
    _build.check(lib, status, 'tiled_matmul')
    matmul_launches[a.dtype].bump()
    return out
