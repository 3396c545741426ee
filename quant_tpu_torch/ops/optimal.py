"""Least-squares-optimal v1 for the 2-bit and ternary quantizers (port of
quant_tpu/ops/optimal.py).

For each row of a 2D matrix, v1 minimises the k = 2 (or ternary)
least-squares quantization cost (Pouransari et al., CVPR-W 2020, eq.
8/9). Every candidate's cost is closed-form in prefix sums of the sorted
magnitudes a_1 <= ... <= a_M (p = #a_k <= v, C_p their sum, A2 = sum
a_k^2):

    S_r  = v*(2p - M) + C_M - 2*C_p
    S_r2 = A2 - 2*v*C_M + M*v^2
    cost^2 = S_r2 - S_r^2/M                (2-bit, v2 = mean residual)
    cost^2 = S_r2 - 2*v*S_r + M*v^2        (ternary, v2 = v)

Modes:

* 'exact': the continuous optimum. The cost is piecewise convex-quadratic
  between sorted magnitudes; each piece's stationary point, clipped into
  its interval, is a candidate, and the cheapest candidate wins.
* 'reference': the candidate rule of the solver in apple/ml-quant
  (quant/binary/optimal.py): sorted data values at interior positions
  where the stationarity test holds, the ternary min > mean/2 edge
  (candidate mean/2), and v1 = 0 for a row with no candidate.
* 'lloyd': sort-free 1-D 2-means on |row| (the threshold between the two
  magnitude clusters is v1): 12 fixed iterations from three starts, the
  cheapest by the same closed-form cost.

The JAX package computes this in XLA (sort, cumsum, elementwise, argmin);
so does this port, with PyTorch's ops, in float32 on detached rows. Op
order follows JAX's, so a difference comes only from the order of a
reduction (cumsum, sum), a few ulps.

'lloyd' on a CUDA tensor is one launch of the kernel in csrc/solve.cu
(`lloyd_solve`), which also gives ls-2's v2 (`with_v2`); on a CPU tensor
its plain twin, `lloyd_solve_plain`, the PyTorch ops above. Both run the
same float32 ops and differ only in the order of their sums; the kernel's
order is fixed, so a row gives the same bits in every call.
"""

import ctypes

import torch

from quant_tpu_torch import _build
from quant_tpu_torch.ops.ste import binary_sign

_SOLVE_SIG = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
              ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              ctypes.c_void_p, ctypes.c_void_p]
_SIGNATURES = {'qtt_lloyd_solve_rows_f32': _SOLVE_SIG,
               'qtt_lloyd_solve_rows_bf16': _SOLVE_SIG,
               'qtt_lloyd_solve_layout': [ctypes.c_int, ctypes.c_int,
                                          ctypes.c_longlong, ctypes.c_int,
                                          ctypes.c_void_p]}
_ENTRY = {torch.float32: 'qtt_lloyd_solve_rows_f32',
          torch.bfloat16: 'qtt_lloyd_solve_rows_bf16'}
LAYOUT_KEYS = ('cluster', 'threads', 'rounds', 'smem_bytes', 'on_chip',
               'registers', 'blocks_per_sm')

launches = _build.LaunchCounter('lloyd_solve_rows')


def _candidate_costs(m: int, v: torch.Tensor, prefix_count: torch.Tensor,
                     prefix_sum: torch.Tensor, total_sum: torch.Tensor,
                     total_sq: torch.Tensor, ternary: bool) -> torch.Tensor:
    """Closed-form LS cost^2 of candidates v (see module docstring)."""
    s_r = v * (2.0 * prefix_count - m) + total_sum - 2.0 * prefix_sum
    s_r2 = total_sq - 2.0 * v * total_sum + m * v * v
    if ternary:
        return s_r2 - 2.0 * v * s_r + m * v * v
    return s_r2 - (s_r * s_r) / m


def _sorted_stats(matrix: torch.Tensor, skip: int) -> tuple:
    """(sorted |x[:, ::skip]|, its cumsum, total sum, total square sum),
    float32. The stride runs over the row as flattened, which for
    activations is the NHWC order."""
    x = matrix.detach().to(torch.float32)
    a = torch.sort(x[..., ::skip].abs(), dim=-1).values  # (R, M) ascending
    c = torch.cumsum(a, dim=-1)
    return a, c, c[:, -1:], (a * a).sum(dim=-1, keepdim=True)


def _take(vals: torch.Tensor, costs: torch.Tensor) -> torch.Tensor:
    best = torch.argmin(costs, dim=-1)
    return torch.take_along_dim(vals, best[:, None], dim=-1)[:, 0]


def _opt_v1_exact(a: torch.Tensor, c: torch.Tensor, total_sum: torch.Tensor,
                  total_sq: torch.Tensor, ternary: bool) -> torch.Tensor:
    r, m = a.shape
    # Split p = number of magnitudes <= v, for p = 1..M-1 (interval
    # [a_{p-1}, a_p]) plus p = 0 (interval [0, a_0], ternary only: the
    # 2-bit cost is constant below a_0).
    p = torch.arange(1, m, dtype=a.dtype, device=a.device)[None, :]
    s_p = c[:, :-1]
    if ternary:
        stat = (total_sum - s_p) / (2.0 * (m - p))
    else:
        stat = (p * total_sum - 2.0 * p * s_p + m * s_p) / (2.0 * p * (m - p))
    # jnp.clip: min(max(x, lo), hi), NaN propagated.
    v = torch.minimum(torch.maximum(stat, a[:, :-1]), a[:, 1:])
    costs = _candidate_costs(m, v, p, s_p, total_sum, total_sq, ternary)
    if ternary:
        v0 = torch.minimum(torch.clamp_min(total_sum / (2.0 * m), 0.0),
                           a[:, :1])
        zeros = torch.zeros((r, 1), dtype=a.dtype, device=a.device)
        cost0 = _candidate_costs(m, v0, zeros, zeros, total_sum, total_sq,
                                 True)
        v = torch.cat([v0, v], dim=-1)
        costs = torch.cat([cost0, costs], dim=-1)
    return _take(v, costs)


def _opt_v1_reference(a: torch.Tensor, c: torch.Tensor,
                      total_sum: torch.Tensor, total_sq: torch.Tensor,
                      ternary: bool) -> torch.Tensor:
    r, m = a.shape
    kw = dict(dtype=a.dtype, device=a.device)
    inf = torch.tensor(float('inf'), **kw)
    cand_vals, cand_costs = [], []
    if m >= 3:
        # Interior positions i = 1..M-2; candidates are the sorted values
        # a_i where the stationarity test passes.
        interior, nxt = a[:, 1:-1], a[:, 2:]
        left_mean = (c / torch.arange(1, m + 1, **kw))[:, 1:-1]
        right_count = torch.arange(m - 1, -1, -1, **kw)
        right_count[-1] = 1.0
        right_mean = ((total_sum - c) / right_count)[:, 1:-1]
        m2 = 0.5 * right_mean
        mask = (interior <= m2) & (m2 <= nxt)
        if not ternary:
            m1 = 0.5 * (left_mean + right_mean)
            mask = mask | ((interior <= m1) & (m1 <= nxt))
        costs = _candidate_costs(
            m, interior, prefix_count=torch.arange(2, m, **kw)[None, :],
            prefix_sum=c[:, 1:-1], total_sum=total_sum, total_sq=total_sq,
            ternary=ternary)
        cand_vals.append(interior)
        cand_costs.append(torch.where(mask, costs, inf))
        has_candidate = mask.any(dim=-1, keepdim=True)
    else:
        has_candidate = torch.zeros((r, 1), dtype=torch.bool, device=a.device)
    if ternary:
        # The optimum below min |row|: candidate mean/2, active iff
        # min > mean/2.
        v_edge = total_sum / (2.0 * m)
        edge_active = a[:, :1] > v_edge
        zeros = torch.zeros((r, 1), **kw)
        edge_cost = _candidate_costs(m, v_edge, zeros, zeros, total_sum,
                                     total_sq, True)
        cand_vals.append(v_edge)
        cand_costs.append(torch.where(edge_active, edge_cost, inf))
        has_candidate = has_candidate | edge_active
    # v = 0 for rows with no candidate (the reference pads its ragged
    # candidate list with zeros).
    zero = torch.zeros((r, 1), **kw)
    zero_cost = _candidate_costs(m, zero, zero, zero, total_sum, total_sq,
                                 ternary)
    cand_vals.append(zero)
    cand_costs.append(torch.where(has_candidate, inf, zero_cost))
    return _take(torch.cat(cand_vals, dim=-1), torch.cat(cand_costs, dim=-1))


def _opt_v1_lloyd(matrix: torch.Tensor, ternary: bool, skip: int = 1,
                  iters: int = 12) -> torch.Tensor:
    """1-D 2-means on |row| by Lloyd's fixed point from three starts
    (0.5, 1 and the midway-to-max multiples of the mean, halved for
    ternary); an empty cluster keeps the threshold."""
    a = matrix.detach()[..., ::skip].to(torch.float32).abs()[:, None, :]
    m = a.shape[-1]
    total = a.sum(dim=-1, keepdim=True)                    # (R, 1, 1)
    total_sq = (a * a).sum(dim=-1, keepdim=True)
    mean = total / m
    amax = a.amax(dim=-1, keepdim=True)
    scale = 0.5 if ternary else 1.0
    v1 = scale * torch.cat([0.5 * mean, mean, 0.5 * (mean + amax)],
                           dim=1)                          # (R, 3, 1)
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    for _ in range(iters):
        upper = a > v1
        n2 = upper.sum(dim=-1, keepdim=True).to(a.dtype)
        s2 = torch.where(upper, a, zero).sum(dim=-1, keepdim=True)
        c2 = s2 / torch.clamp_min(n2, 1.0)
        if ternary:
            v1 = torch.where(n2 > 0, 0.5 * c2, v1)
        else:
            n1 = m - n2
            c1 = (total - s2) / torch.clamp_min(n1, 1.0)
            v1 = torch.where((n2 > 0) & (n2 < m), 0.5 * (c1 + c2), v1)
    lower = a <= v1
    n1 = lower.sum(dim=-1).to(a.dtype)                     # (R, 3)
    c_low = torch.where(lower, a, zero).sum(dim=-1)
    costs = _candidate_costs(m, v1[..., 0], n1, c_low, total[..., 0],
                             total_sq[..., 0], ternary)
    return _take(v1[..., 0], costs)


def lloyd_solve_plain(rows: torch.Tensor, ternary: bool, skip: int,
                      with_v2: bool) -> torch.Tensor:
    """Plain twin of lloyd_solve: v1 by `_opt_v1_lloyd` over the float32
    rows, and with_v2 also v2 = mean |row - v1 * sign(row)|."""
    xd = rows.detach().to(torch.float32)
    v1 = _opt_v1_lloyd(xd, ternary, skip)
    if not with_v2:
        return v1
    residual = xd - v1[:, None] * binary_sign(xd)
    return torch.stack([v1, residual.abs().mean(dim=-1)])


def lloyd_solve(rows: torch.Tensor, ternary: bool, skip: int,
                with_v2: bool) -> torch.Tensor:
    """The 'lloyd' solve of each row of a 2D (R, N) tensor, bf16 or
    float32, detached: v1 (R,), or with_v2 the (2, R) ls-2 scales (v1 and
    the mean absolute residual over the whole row), float32. One kernel
    launch for a CUDA tensor, the plain twin for a CPU one."""
    _build.require(rows.ndim == 2, f'expected (R, N) rows, got {rows.shape}')
    if _build.on_cpu(rows):
        return lloyd_solve_plain(rows, ternary, skip, with_v2)
    _build.require(rows.dtype in _ENTRY, f'unsupported dtype {rows.dtype}')
    rows = rows.detach()
    if rows.stride(1) != 1:
        rows = rows.contiguous()
    r, n = rows.shape
    out = torch.empty((2, r) if with_v2 else (r,), dtype=torch.float32,
                      device=rows.device)
    lib = _build.load('solve', _SIGNATURES)
    status = getattr(lib, _ENTRY[rows.dtype])(
        _build.ptr(rows), rows.stride(0), r, n, skip, int(ternary),
        int(with_v2), _build.ptr(out), _build.stream(rows))
    _build.check(lib, status, 'lloyd_solve_rows')
    launches.bump()
    return out


def lloyd_solve_layout(dtype: torch.dtype, rows: int, n: int,
                       skip: int = 3) -> dict[str, int]:
    """How lloyd_solve launches for R rows of N values of `dtype`
    (LAYOUT_KEYS: cluster size, threads a block, rounds, dynamic shared
    memory, on chip or streamed, registers a thread, blocks an SM), from
    the built library on the current CUDA device."""
    _build.require(dtype in _ENTRY, f'unsupported dtype {dtype}')
    lib = _build.load('solve', _SIGNATURES)
    info = (ctypes.c_int * len(LAYOUT_KEYS))()
    status = lib.qtt_lloyd_solve_layout(int(dtype == torch.bfloat16), rows,
                                        n, skip, info)
    _build.check(lib, status, 'lloyd_solve_layout')
    return dict(zip(LAYOUT_KEYS, info))


def opt_v1(matrix: torch.Tensor, ternary: bool, skip: int = 1,
           mode: str = 'exact') -> torch.Tensor:
    """Optimal per-row v1 for the ls-2 / ls-T quantizers.

    Args:
        matrix: 2D tensor (rows, features); each row is solved on its own.
        ternary: solve the ternary (v2 = v1) cost instead of the 2-bit.
        skip: column stride subsampling the solve (the weight and
            activation quantizers use 3); honoured by every mode.
        mode: 'exact', 'reference' or 'lloyd' (module docstring).

    Returns:
        v1 of shape (rows,), float32, detached.
    """
    if mode == 'lloyd':
        return lloyd_solve(matrix, ternary, skip, with_v2=False)
    if mode not in ('exact', 'reference'):
        raise ValueError(f"opt_v1 mode must be 'exact', 'reference' or "
                         f"'lloyd', got {mode}")
    a, c, total_sum, total_sq = _sorted_stats(matrix, skip)
    if mode == 'exact':
        return _opt_v1_exact(a, c, total_sum, total_sq, ternary)
    return _opt_v1_reference(a, c, total_sum, total_sq, ternary)
