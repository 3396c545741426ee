"""Bit-packing of sign planes (port of quant_tpu/ops/packing.py).

Bit j of word w is set iff element 32w+j is >= 0; pad bits (K % 32 != 0)
are set. Words are int32: they are built in int64 and cast, because a set
bit 31 makes the word negative.
"""

import torch

WORD = 32


def packed_width(k: int) -> int:
    """Number of int32 words needed for k signs."""
    return -(-k // WORD)


def _bit_weights(device: torch.device) -> torch.Tensor:
    return torch.bitwise_left_shift(
        torch.ones(WORD, dtype=torch.int64, device=device),
        torch.arange(WORD, dtype=torch.int64, device=device))


def pack_signs(x: torch.Tensor) -> torch.Tensor:
    """Pack signs of the last axis: (..., K) float -> (..., ceil(K/32)) i32."""
    k = x.shape[-1]
    wd = packed_width(k)
    bits = x >= 0
    pad = wd * WORD - k
    if pad:
        ones = torch.ones(x.shape[:-1] + (pad,), dtype=torch.bool,
                          device=x.device)
        bits = torch.cat([bits, ones], dim=-1)
    bits = bits.reshape(x.shape[:-1] + (wd, WORD)).to(torch.int64)
    words = (bits * _bit_weights(x.device)).sum(dim=-1)
    # Two's-complement wrap of the high bit: 2^31 -> -2^31.
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32)


def unpack_signs(words: torch.Tensor, k: int,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Unpack int32 words back to {-1,+1} values: (..., W) -> (..., K)."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(WORD, dtype=torch.int64, device=words.device)
    bits = torch.bitwise_right_shift(w[..., None], shifts) & 1
    flat = bits.reshape(words.shape[:-1] + (words.shape[-1] * WORD,))
    return (flat[..., :k].to(dtype) * 2 - 1)
