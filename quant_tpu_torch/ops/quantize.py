"""Activation clamps, the scheme registry and the quantizers (port of
quant_tpu/ops/quantize.py:37-156 and quant_tpu/nn/layers.py:34-66).

Scales are solved in float32 over a detached row view (rows =
out-channels for weights, samples for activations), so no gradient
reaches them; x_q keeps x's dtype, each scale cast to it first, and is
differentiable in x through the straight-through `binarize` (gf-k's
value recursion included: each pass binarizes x - result). Each
quantizer returns ((k, rows) scales, x_q) and solves its scales when
none are given: ls-1 and gf-k by means, ls-2 and ls-T by the
least-squares optimum `ops.optimal.opt_v1` over every `skip`-th element
of a row (mode 'exact', 'reference' or 'lloyd'). `solve_scales` gives
the scales alone, as JAX's jitted forwards compute them where x_q is
dead.
"""

import re
from functools import partial
from typing import Callable, Optional

import torch

from quant_tpu_torch.ops.optimal import lloyd_solve, opt_v1
from quant_tpu_torch.ops.ste import binarize, binary_sign

_LS_SCALES = {'fp': 0, 'ls-1': 1, 'ls-2': 2, 'ls-T': 1}


def clamp_identity(x: torch.Tensor) -> torch.Tensor:
    """Identity clamp."""
    return x


def clamp_symmetric(x: torch.Tensor, alpha: float) -> torch.Tensor:
    """Clamp x to [-alpha, +alpha] as jnp.clip does: min(max(x, -alpha),
    alpha), whose gradient is 0.5 at x = +-alpha (a tie of max or min
    splits it), where torch.clamp's is 1."""
    lo = torch.tensor(-alpha, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo), -lo)


def get_clamp_fn(kind: str = 'identity',
                 alpha: float = 2.0) -> Callable:
    """Resolve a clamp config ({'kind': ..., 'alpha': ...})."""
    if kind == 'identity':
        return clamp_identity
    if kind == 'symmetric':
        return partial(clamp_symmetric, alpha=alpha)
    raise ValueError(f'{kind} is not a valid clamping function.')


def validate_scheme(scheme: str) -> None:
    """Raise on a scheme that is not fp, ls-1, ls-2, ls-T or gf-<k>."""
    if scheme not in _LS_SCALES and not re.fullmatch(r'gf-\d+', scheme):
        raise ValueError(
            f'Scheme {scheme} is invalid. Please see docs for valid schemes.')


def scheme_num_scales(scheme: str) -> int:
    """Number of scale vectors (k) a scheme tracks."""
    validate_scheme(scheme)
    if scheme in _LS_SCALES:
        return _LS_SCALES[scheme]
    return int(scheme.split('-')[1])


def _rows(x: torch.Tensor) -> torch.Tensor:
    """Detached row view in x's dtype (opt_v1 solves it in float32)."""
    return x.detach().reshape(x.shape[0], -1)


def _rows32(x: torch.Tensor) -> torch.Tensor:
    """Detached float32 row view: the solver operand."""
    return _rows(x).to(torch.float32)


def _per_row(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A (rows,) scale vector against x's trailing dims, in x's dtype."""
    return v.reshape((-1,) + (1,) * (x.ndim - 1)).to(x.dtype)


def quantizer_fp(x: torch.Tensor, vs: Optional[torch.Tensor] = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-precision passthrough: ((0, rows) scales, x)."""
    del vs
    return torch.zeros((0, x.shape[0]), dtype=x.dtype, device=x.device), x


def quantizer_ls_1(x: torch.Tensor, v1: Optional[torch.Tensor] = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """1-bit least-squares quantization.

    v1 is the per-row mean(|x|) in float32 when not supplied. Returns
    ((1, rows) scales, v1 * binarize(x)) with sign(0) = +1.
    """
    if v1 is None:
        v1 = _rows32(x).abs().mean(dim=-1)
    v1 = v1.reshape(-1)
    return v1[None, :], _per_row(v1, x) * binarize(x)


def _solve_ls_2(x: torch.Tensor, skip: int, mode: str) -> torch.Tensor:
    """(2, rows): v1 = opt_v1 of the rows, v2 = mean |residual|, both
    over the float32 rows; 'lloyd' solves both in one lloyd_solve."""
    if mode == 'lloyd':
        return lloyd_solve(_rows(x), ternary=False, skip=skip, with_v2=True)
    xd = _rows32(x)
    v1 = opt_v1(xd, ternary=False, skip=skip, mode=mode)
    residual = xd - v1[:, None] * binary_sign(xd)
    return torch.stack([v1, residual.abs().mean(dim=-1)])


def quantizer_ls_2(x: torch.Tensor, vs: Optional[torch.Tensor] = None,
                   skip: int = 3, mode: str = 'exact'
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """2-bit least-squares quantization: x_q = v1*b1 + v2*sign(x - v1*b1).

    v1 is the per-row least-squares optimum (opt_v1 over every skip-th
    element), v2 the mean absolute residual, unless vs gives (2, rows).
    """
    if vs is None:
        vs = _solve_ls_2(x, skip, mode)
    v1, v2 = vs[0].reshape(-1), vs[1].reshape(-1)
    b1 = binarize(x)
    v1b = _per_row(v1, x)
    x_q = v1b * b1 + _per_row(v2, x) * binarize(x - v1b * b1)
    return torch.stack([v1, v2]), x_q


def quantizer_ls_ternary(x: torch.Tensor, vs: Optional[torch.Tensor] = None,
                         skip: int = 3, mode: str = 'exact'
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Ternary least-squares quantization: x_q = v1*(b1 + sign(x -
    v1*b1)), values in {-2v1, 0, +2v1}; v1 the per-row ternary optimum
    (opt_v1) unless vs gives (1, rows)."""
    v1 = (opt_v1(_rows(x), ternary=True, skip=skip, mode=mode)
          if vs is None else vs[0].reshape(-1))
    b1 = binarize(x)
    v1b = _per_row(v1, x)
    return v1[None, :], v1b * (b1 + binarize(x - v1b * b1))


def quantizer_gf(x: torch.Tensor, k: int, vs: Optional[torch.Tensor] = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy-foldable k-bit quantization: pass i takes v_i = mean
    |residual| (float32, over the row) unless vs gives it, and adds
    v_i * sign(x - result) to the result."""
    if vs is None:
        vs = _solve_gf(x, k)
    result = torch.zeros_like(x)
    saved = []
    for i in range(k):
        v = vs[i].reshape(-1)
        saved.append(v)
        result = result + _per_row(v, x) * binarize(x - result)
    return torch.stack(saved), result


def _solve_gf(x: torch.Tensor, k: int) -> torch.Tensor:
    """(k, rows): v_i = mean |residual| of the float32 rows, greedily."""
    residual = _rows32(x)
    saved = []
    for _ in range(k):
        v = residual.abs().mean(dim=-1)
        saved.append(v)
        residual = residual - v[:, None] * binary_sign(residual)
    return torch.stack(saved)


def solve_scales(scheme: str, x: torch.Tensor, skip: int = 3,
                 mode: str = 'exact') -> Optional[torch.Tensor]:
    """The (k, rows) scales the quantizer of `scheme` solves for x, without
    x_q (None for fp): the same float32 ops as the quantizers'."""
    validate_scheme(scheme)
    if scheme == 'fp':
        return None
    if scheme == 'ls-1':
        return _rows32(x).abs().mean(dim=-1)[None, :]
    if scheme == 'ls-2':
        return _solve_ls_2(x, skip, mode)
    if scheme == 'ls-T':
        return opt_v1(_rows(x), ternary=True, skip=skip, mode=mode)[None]
    return _solve_gf(x, scheme_num_scales(scheme))


def quantize_with_scheme(scheme: str, x: torch.Tensor,
                         vs: Optional[torch.Tensor], skip: int = 3,
                         mode: str = 'exact'
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dispatch to the quantizer of `scheme`: ((k, rows) scales, x_q);
    skip and mode reach the ls-2 and ls-T solves."""
    validate_scheme(scheme)
    if scheme == 'fp':
        return quantizer_fp(x, vs)
    if scheme == 'ls-1':
        return quantizer_ls_1(x, vs[0] if vs is not None else None)
    if scheme == 'ls-2':
        return quantizer_ls_2(x, vs, skip, mode)
    if scheme == 'ls-T':
        return quantizer_ls_ternary(x, vs, skip, mode)
    return quantizer_gf(x, scheme_num_scales(scheme), vs)
