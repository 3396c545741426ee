"""The lloyd solve kernel (quant_tpu_torch/csrc/solve.cu, through
ops.optimal.lloyd_solve) against its plain twin and JAX's scales.

The tests marked `card` need a CUDA card and skip elsewhere (the `card`
fixture decides, never the import). On the card:

    python -m pytest tests/test_torch_port_solve_kernel.py -m card -q

The file imports no JAX (the card's machine has none): JAX's scales of
the oracle rows come from tests/data_oracle/lloyd_jax.npz, which
tests/test_torch_port_optimal.py holds to JAX itself. Limits are
chip_smoke's SOLVE_TOL / SOLVE_COST_TOL: v1 within a few float32 ulps
(only the order of the kernel's float32 sums differs), else a cost no
higher than the twin's within 1e-5 of the row's norm; v2 within the same
tolerance where v1 is.
"""

import os

import numpy as np
import pytest
import torch

from quant_tpu_torch.ops import optimal as O

TOL = dict(rtol=1e-5, atol=1e-6)
COST_TOL = 1e-5
ORACLE = os.path.join(os.path.dirname(__file__), 'data_oracle',
                      'lloyd_jax.npz')
DTYPES = [torch.float32, torch.bfloat16]
# The row lengths of the 16 binary-conv inputs of the benchmark's
# ResNet-18 at 224 px (NHWC): layer1's four and layer2's first conv,
# layer2's other three and layer3's first, and so on.
CELL_ROWS = ((200_704, 5), (100_352, 4), (50_176, 4), (25_088, 3))


@pytest.fixture
def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


def _cost(rows: np.ndarray, v1: np.ndarray, ternary: bool) -> np.ndarray:
    """The least-squares cost of each row's v1, in float64."""
    rows = rows.astype(np.float64)
    v1 = v1.astype(np.float64)[:, None]
    s2 = rows - v1 * np.where(rows < 0, -1.0, 1.0)
    v2 = v1 if ternary else np.abs(s2).mean(axis=1, keepdims=True)
    return np.linalg.norm(s2 - v2 * np.where(s2 < 0, -1.0, 1.0), axis=1)


def assert_scales(rows: np.ndarray, skip: int, ternary: bool,
                  got: np.ndarray, want: np.ndarray) -> None:
    """got against want, (2, R) or (R,): v1 within TOL or no costlier,
    v2 within TOL where v1 is; NaN where want has NaN."""
    got = got.reshape(-1, rows.shape[0])
    want = want.reshape(got.shape)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    v1, w1 = np.nan_to_num(got[0]), np.nan_to_num(want[0])
    close = np.isclose(v1, w1, **TOL)
    far = ~close & ~np.isnan(want[0])
    if far.any():
        sub = rows[far][:, ::skip]
        norms = np.linalg.norm(sub.astype(np.float64), axis=1)
        assert (_cost(sub, v1[far], ternary)
                <= _cost(sub, w1[far], ternary) + COST_TOL * norms).all()
    if got.shape[0] == 2:
        np.testing.assert_allclose(np.nan_to_num(got[1])[close],
                                   np.nan_to_num(want[1])[close], **TOL)


def _rows(r: int, n: int, seed: int) -> torch.Tensor:
    """R rows of N values: clamped normal activations (the symmetric
    clamp at 2, as the recipes'), every fourth row heavy-tailed."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((r, n), generator=g)
    x[::4] = x[::4].sign() * torch.empty((len(x[::4]), n)).log_normal_(
        0.0, 1.0, generator=g)
    return x.clamp(-2.0, 2.0)


def _against_twin(x: torch.Tensor, ternary: bool, skip: int = 3) -> None:
    """The kernel on the card against the twin on the CPU, same rows."""
    with_v2 = not ternary
    got = O.lloyd_solve(x, ternary, skip, with_v2)
    assert got.shape == ((2, x.shape[0]) if with_v2 else (x.shape[0],))
    want = O.lloyd_solve_plain(x.cpu(), ternary, skip, with_v2)
    assert_scales(x.float().cpu().numpy(), skip, ternary, got.cpu().numpy(),
                  want.numpy())


@pytest.mark.card
@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('ternary', [False, True])
@pytest.mark.parametrize('skip', [1, 3])
def test_kernel_matches_jax_oracle_and_twin(card, dtype, ternary, skip):
    """The normal, lognormal, bimodal, constant, zero and repeated rows:
    in float32 against JAX's scales, in both dtypes against the twin."""
    oracle = np.load(ORACLE)
    rows = oracle['rows']
    x = torch.from_numpy(rows).to(card, dtype)
    _against_twin(x, ternary, skip)
    if dtype == torch.float32:
        got = O.lloyd_solve(x, ternary, skip, not ternary).cpu().numpy()
        assert_scales(rows, skip, ternary, got,
                      oracle[f'{"lsT" if ternary else "ls2"}_s{skip}'])


@pytest.mark.card
@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('ternary', [False, True])
def test_kernel_at_the_cells_row_shapes(card, dtype, ternary):
    """The 16 conv inputs' row lengths at batch 256, one call a length;
    and a forward's 16 calls launch the kernel 16 times."""
    before = O.launches.count
    for i, (n, _) in enumerate(CELL_ROWS):
        _against_twin(_rows(256, n, i).to(card, dtype), ternary)
    assert O.launches.count - before == len(CELL_ROWS)  # the twin: none
    x = _rows(256, CELL_ROWS[-1][0], 9).to(card, dtype)
    before = O.launches.count
    for _ in range(sum(c for _, c in CELL_ROWS)):
        O.lloyd_solve(x, ternary, 3, not ternary)
    assert O.launches.count - before == 16


@pytest.mark.card
@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('r,n', [(1, 1), (1, 2), (3, 7), (2, 24), (5, 97),
                                 (512, 300), (1, 200_704), (4, 401_408),
                                 (2, 1_500_000), (1, 3_000_000)])
def test_kernel_rows_and_lengths(card, dtype, r, n):
    """R from 1 to 512 and N from 1 past the float32 rows one block holds
    (clusters of 2-8 blocks) and past what 8 blocks hold (samples read
    from device memory every pass), both schemes."""
    x = _rows(r, n, r * 7 + n).to(card, dtype)
    for ternary in (False, True):
        _against_twin(x, ternary)


@pytest.mark.card
@pytest.mark.parametrize('dtype', DTYPES)
def test_kernel_layouts(card, dtype):
    """The split the launcher takes: one block a row where the samples
    fit, a cluster where they do not or where few rows leave SMs idle,
    and the samples streamed past 8 blocks."""
    lay = O.lloyd_solve_layout(dtype, 256, 200_704)
    assert lay['cluster'] == (2 if dtype == torch.float32 else 1)
    assert lay['on_chip'] == 1 and lay['registers'] > 0
    assert lay['blocks_per_sm'] >= 1
    assert O.lloyd_solve_layout(dtype, 4, 200_704)['cluster'] == 8
    assert O.lloyd_solve_layout(dtype, 1, 8_000_000)['on_chip'] == 0


@pytest.mark.card
@pytest.mark.parametrize('dtype', DTYPES)
def test_kernel_special_rows(card, dtype):
    """A NaN row gives NaN, an inf row what the twin gives, a zero row 0,
    a constant row keeps its starts (a cluster that empties keeps its
    threshold), a row of one value and zeros too."""
    n = 3000
    x = torch.zeros((6, n))
    x[0, 6] = float('nan')
    x[1] = float('nan')
    x[2, 9] = float('inf')
    x[4] = -0.75
    x[5, ::3] = 1.5
    x = x.to(card, dtype)
    for ternary in (False, True):
        got = O.lloyd_solve(x, ternary, 3, not ternary).cpu()
        want = O.lloyd_solve_plain(x.cpu(), ternary, 3, not ternary)
        torch.testing.assert_close(got, want, equal_nan=True, **TOL)
        v1 = got.reshape(-1, 6)[0]
        assert v1[:2].isnan().all() and v1[3] == 0.0


@pytest.mark.card
@pytest.mark.parametrize('dtype', DTYPES)
def test_kernel_same_bits_every_call(card, dtype):
    """Two calls give the same bits, and a row gives the same bits alone
    as among 256 rows (another split over blocks, one order of sums)."""
    x = _rows(256, 100_352, 3).to(card, dtype)
    a = O.lloyd_solve(x, False, 3, True)
    assert torch.equal(a, O.lloyd_solve(x, False, 3, True))
    for i in (0, 5, 255):
        assert torch.equal(O.lloyd_solve(x[i:i + 1], False, 3, True)[:, 0],
                           a[:, i])
        assert torch.equal(O.lloyd_solve(x[i:i + 2], True, 3, False)[0],
                           O.lloyd_solve(x, True, 3, False)[i])


@pytest.mark.card
def test_kernel_refuses_other_dtypes(card):
    """float16 and float64 CUDA rows are refused, not solved."""
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(ValueError, match='dtype'):
            O.lloyd_solve(torch.zeros((2, 6), device=card, dtype=dtype),
                          False, 3, True)
