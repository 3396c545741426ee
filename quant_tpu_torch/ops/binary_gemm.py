"""XNOR-popcount binary GEMM over packed sign words (port of
quant_tpu/ops/binary_gemm.py:64-135).

    dot(m, n) = K_pad - 2 * sum_w popcount(A[m, w] XOR Bt[w, n])
    C[m, n]   = dot * vx[m] * vw[n] - (K_pad - K) * (vx[m] * vw[n])

Pad bits are set in both operands, so they XOR to zero and inflate each
dot by the same K_pad - K, which the last term removes.
"""

import ctypes

import torch

from quant_tpu_torch import _build
from quant_tpu_torch.ops.packing import WORD, pack_signs, unpack_signs

_SIGNATURES = {'qtt_xnor_gemm': [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
               + [ctypes.c_void_p]}

launches = _build.LaunchCounter('xnor_gemm')


def xnor_gemm_plain(a_packed: torch.Tensor, bt_packed: torch.Tensor,
                    vx: torch.Tensor, vw: torch.Tensor,
                    k_total: int) -> torch.Tensor:
    """Plain twin of the kernel: unpack both operands (pad bits too) and
    take the dot in float32 (exact below 2^24), with the kernel's
    epilogue order."""
    k_padded = a_packed.shape[1] * WORD
    a = unpack_signs(a_packed, k_padded)               # (M, Kp)
    b = unpack_signs(bt_packed.t(), k_padded)          # (N, Kp)
    vx = vx.to(torch.float32).reshape(-1, 1)
    vw = vw.to(torch.float32).reshape(1, -1)
    out = (a @ b.t()) * vx * vw
    if k_padded != k_total:
        out = out - (k_padded - k_total) * (vx * vw)
    return out


def xnor_gemm(a_packed: torch.Tensor, bt_packed: torch.Tensor,
              vx: torch.Tensor, vw: torch.Tensor,
              k_total: int) -> torch.Tensor:
    """Scaled binary GEMM from packed signs.

    Args:
        a_packed: (M, W) int32 packed sign words of A (M, K).
        bt_packed: (W, N) int32 packed sign words of B (K, N), word axis
            leading.
        vx: (M,) row scales; vw: (N,) column scales.
        k_total: unpacked contraction length K.

    Returns:
        (M, N) float32: (vx ⊗ vw) * (A·B).
    """
    _build.require(a_packed.ndim == 2 and bt_packed.ndim == 2,
                   'a_packed and bt_packed must be 2-D')
    m, w_words = a_packed.shape
    w2, n = bt_packed.shape
    _build.require(w_words == w2, f'word axes differ: {a_packed.shape} '
                   f'vs {bt_packed.shape}')
    _build.require(0 < k_total <= w_words * WORD
                   and w_words == -(-k_total // WORD),
                   f'k_total {k_total} does not fit {w_words} words')
    _build.require(vx.shape == (m,) and vw.shape == (n,),
                   'vx must be (M,) and vw (N,)')
    _build.require(a_packed.dtype == torch.int32
                   and bt_packed.dtype == torch.int32,
                   'packed operands must be int32')
    if _build.on_cpu(a_packed, bt_packed, vx, vw):
        return xnor_gemm_plain(a_packed, bt_packed, vx, vw, k_total)
    _build.require(a_packed.is_contiguous() and bt_packed.is_contiguous(),
                   'packed operands must be contiguous')
    vx = vx.to(torch.float32).contiguous()
    vw = vw.to(torch.float32).contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=a_packed.device)
    lib = _build.load('xnor', _SIGNATURES)
    status = lib.qtt_xnor_gemm(
        _build.ptr(a_packed), _build.ptr(bt_packed), _build.ptr(vx),
        _build.ptr(vw), _build.ptr(out), m, w_words, n, k_total,
        _build.stream(a_packed))
    _build.check(lib, status, 'xnor_gemm')
    launches.bump()
    return out


def xnor_gemm_reference(a_signs: torch.Tensor, b_signs: torch.Tensor,
                        vx: torch.Tensor, vw: torch.Tensor) -> torch.Tensor:
    """Dense oracle: (A @ B) * vx ⊗ vw in float32."""
    dot = a_signs.to(torch.float32) @ b_signs.to(torch.float32)
    return dot * vx.reshape(-1, 1) * vw.reshape(1, -1)


def pack_for_xnor(a_signs: torch.Tensor, b_signs: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack dense {-1,+1} operands A (M,K), B (K,N) for xnor_gemm."""
    return (pack_signs(a_signs),
            pack_signs(b_signs.t()).t().contiguous())
