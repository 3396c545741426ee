"""Parity of the port's least-squares solver (ops.optimal.opt_v1) and the
ls-2 / ls-T batch solves with quant_tpu's.

The same seeded numpy rows go through JAX's opt_v1 (XLA: sort, cumsum,
argmin) and the port's (torch.sort, torch.cumsum, torch.argmin). Both
follow one op order, but XLA and torch sum a cumsum or a row in another
order, so v1 may differ by a few float32 ulps: rows are held to V1_TOL,
and a row past it must cost no more than JAX's v1 does (a near tie in
argmin may pick the other of two candidates of equal cost). Reference
mode, whose candidates are data values, is also held to the frozen
oracle of the reference solver at the JAX test's tolerance.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quant_tpu.ops.optimal import opt_v1
from quant_tpu.ops.quantize import quantizer_ls_2, quantizer_ls_ternary
from quant_tpu_torch.ops import optimal as T
from quant_tpu_torch.ops import quantize as TQ

# JAX's functions under jit, one compile per shape and static argument.
j_opt_v1 = jax.jit(opt_v1, static_argnums=(1, 2, 3))
j_ls_2 = jax.jit(quantizer_ls_2, static_argnames=('skip', 'mode'))
j_ls_t = jax.jit(quantizer_ls_ternary, static_argnames=('skip', 'mode'))

# v1 within a few float32 ulps of JAX's (seen: <= 4.1e-7 relative).
V1_TOL = dict(rtol=1e-5, atol=1e-6)
# A row past V1_TOL: its cost within this share of the row's norm of the
# cost of JAX's v1.
COST_TOL = 1e-5
# The frozen oracle, at tests/ops/test_optimal.py's tolerance.
ORACLE_TOL = dict(rtol=1e-5, atol=1e-6)
ORACLE = os.path.join(os.path.dirname(__file__), 'data_oracle',
                      'reference_oracle.npz')
MODES = ['exact', 'reference', 'lloyd']
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _rows(seed: int) -> np.ndarray:
    """Normal, heavy-tailed (lognormal) and bimodal rows, constant rows,
    zero rows, and rows of repeated values (ties in the sort)."""
    rng = np.random.default_rng(seed)
    m = 150
    sign = np.where(rng.standard_normal((6, m)) < 0, -1.0, 1.0)
    return np.concatenate([
        rng.standard_normal((6, m)),
        rng.lognormal(0.0, 1.5, (6, m)) * sign,
        np.concatenate([rng.normal(3.0, 0.2, (3, m // 2)),
                        rng.normal(-0.3, 0.2, (3, m // 2))], axis=1),
        np.full((2, m), 3.0), np.full((1, m), -0.5),
        np.zeros((2, m)),
        rng.integers(-3, 4, (3, m)).astype(np.float64),
    ]).astype(np.float32)


def _cost(row: np.ndarray, v1: float, ternary: bool) -> float:
    """The LS cost of v1 on a row, in float64."""
    row = row.astype(np.float64)
    s2 = row - v1 * np.where(row < 0, -1.0, 1.0)
    v2 = v1 if ternary else np.mean(np.abs(s2))
    return float(np.linalg.norm(s2 - v2 * np.where(s2 < 0, -1.0, 1.0)))


def _assert_v1_match(rows, skip, got, want, ternary):
    assert got.shape == want.shape and got.dtype == np.float32
    close = np.isclose(got, want, **V1_TOL)
    for i in np.flatnonzero(~close):
        row = rows[i, ::skip]
        c_got, c_want = _cost(row, got[i], ternary), _cost(row, want[i],
                                                           ternary)
        assert c_got <= c_want + COST_TOL * np.linalg.norm(row), (
            i, got[i], want[i], c_got, c_want)


@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('ternary', [False, True])
@pytest.mark.parametrize('skip', [1, 3])
def test_opt_v1_matches_jax(mode, ternary, skip):
    rows = _rows(skip)
    want = np.asarray(j_opt_v1(jnp.asarray(rows), ternary, skip, mode))
    got = T.opt_v1(torch.from_numpy(rows), ternary, skip, mode).numpy()
    _assert_v1_match(rows, skip, got, want, ternary)


@pytest.mark.parametrize('ternary', [False, True])
@pytest.mark.parametrize('skip', [1, 3])
def test_opt_v1_reference_mode_matches_the_oracle(ternary, skip):
    oracle = np.load(ORACLE)
    got = T.opt_v1(torch.from_numpy(oracle['opt_x2d']), ternary, skip,
                   'reference').numpy()
    want = oracle[f'opt_v1_t{int(ternary)}_s{skip}']
    np.testing.assert_allclose(got, want, **ORACLE_TOL)


@pytest.mark.parametrize('m', [1, 2])
def test_opt_v1_short_rows_match_jax(m):
    """M < 3: reference mode has no interior candidate (the ternary edge
    or v = 0 decide); exact mode at M = 2 has one split."""
    rows = np.random.default_rng(m).standard_normal((5, m)).astype(
        np.float32)
    cases = [('reference', False), ('reference', True), ('exact', True)]
    if m == 2:
        cases.append(('exact', False))
    for mode, ternary in cases:
        want = np.asarray(j_opt_v1(jnp.asarray(rows), ternary, 1, mode))
        got = T.opt_v1(torch.from_numpy(rows), ternary, 1, mode).numpy()
        _assert_v1_match(rows, 1, got, want, ternary)


@pytest.mark.parametrize('mode', MODES)
def test_opt_v1_nan_and_inf_rows_match_jax(mode):
    """A row with a NaN, an all-inf row, a row with one inf and an all-NaN
    row: both argmins take the first minimum, NaN where JAX has NaN."""
    rows = np.array([[np.nan, 1, 2, 3], [np.inf] * 4, [1, np.inf, 2, 3],
                     [np.nan] * 4], np.float32)
    for ternary in (False, True):
        want = np.asarray(j_opt_v1(jnp.asarray(rows), ternary, 1, mode))
        got = T.opt_v1(torch.from_numpy(rows), ternary, 1, mode).numpy()
        np.testing.assert_array_equal(got, want)


def test_opt_v1_rejects_an_unknown_mode():
    with pytest.raises(ValueError, match='mode'):
        T.opt_v1(torch.zeros(2, 4), False, mode='sorted')


def _activations(seed: int) -> np.ndarray:
    """NHWC activations (the solves' skip runs over the NHWC flattening),
    a heavy-tailed sample and a zero sample among them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, 5, 6, 7)) * 1.5
    x[1] = rng.lognormal(0.0, 1.0, x[1].shape) * np.sign(x[1])
    x[3] = 0.0
    return x.astype(np.float32)


@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('tdtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('scheme', ['ls-2', 'ls-T'])
def test_least_squares_quantizers_match_jax(scheme, tdtype, mode):
    """The batch solves of quantizer_ls_2 / quantizer_ls_ternary (skip 3,
    float32 over the rows whatever x's dtype) and their x_q, in x's
    dtype. x_q is held to the scales' tolerance: a sign sits within an
    ulp of a residual only by accident of these seeds, and none does."""
    t = torch.from_numpy(_activations(7)).to(tdtype)
    jx = jnp.asarray(t.float().numpy(), JDT[tdtype])
    j_fn, t_fn = ((j_ls_2, TQ.quantizer_ls_2) if scheme == 'ls-2'
                  else (j_ls_t, TQ.quantizer_ls_ternary))
    jvs, jq = j_fn(jx, None, skip=3, mode=mode)
    tvs, tq = t_fn(t, None, skip=3, mode=mode)
    assert tq.dtype == tdtype and tvs.dtype == torch.float32
    np.testing.assert_allclose(tvs.numpy(), np.asarray(jvs), **V1_TOL)
    np.testing.assert_allclose(tq.float().numpy(),
                               np.asarray(jq).astype(np.float32),
                               rtol=1e-5 if tdtype == torch.float32 else 1e-2,
                               atol=1e-6)
    # The scales alone, as an 'off' forward solves them, are the same.
    torch.testing.assert_close(TQ.solve_scales(scheme, t, 3, mode), tvs,
                               rtol=0, atol=0)


# The lloyd solve: lloyd_solve's plain twin (the CPU path) against the
# eager ops it replaced and against JAX; the kernel itself runs on the
# card only (tests/test_torch_port_solve_kernel.py, which holds it to the
# twin and to LLOYD_ORACLE, JAX's scales of these rows, without JAX).
LLOYD_ORACLE = os.path.join(os.path.dirname(__file__), 'data_oracle',
                            'lloyd_jax.npz')
LLOYD_ORACLE_SEED = 11


def lloyd_oracle() -> dict[str, np.ndarray]:
    """JAX's lloyd scales of _rows(LLOYD_ORACLE_SEED): 'ls2_s<skip>'
    (2, rows) and 'lsT_s<skip>' (1, rows), skip 1 and 3."""
    rows = _rows(LLOYD_ORACLE_SEED)
    out = {'rows': rows}
    for skip in (1, 3):
        out[f'ls2_s{skip}'] = np.asarray(
            j_ls_2(jnp.asarray(rows), None, skip=skip, mode='lloyd')[0])
        out[f'lsT_s{skip}'] = np.asarray(
            j_ls_t(jnp.asarray(rows), None, skip=skip, mode='lloyd')[0])
    return out


def _eager_lloyd(x: torch.Tensor, ternary: bool, skip: int) -> torch.Tensor:
    """The ls-2 / ls-T lloyd solve as the eager ops computed it before
    the kernel: (2, rows) or (1, rows)."""
    xd = x.detach().reshape(x.shape[0], -1).to(torch.float32)
    v1 = T._opt_v1_lloyd(xd, ternary, skip)
    if ternary:
        return v1[None]
    residual = xd - v1[:, None] * torch.where(xd < 0, -1.0, 1.0)
    return torch.stack([v1, residual.abs().mean(dim=-1)])


@pytest.mark.parametrize('tdtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('ternary', [False, True])
@pytest.mark.parametrize('skip', [1, 3])
def test_lloyd_twin_equals_the_eager_solve(tdtype, ternary, skip):
    """Bit for bit, on the _rows families and on NHWC activations, both
    through lloyd_solve_plain and through the quantizers' solves."""
    for x in (torch.from_numpy(_rows(5)),
              torch.from_numpy(_activations(8))):
        x = x.to(tdtype)
        want = _eager_lloyd(x, ternary, skip)
        rows = x.reshape(x.shape[0], -1)
        got = T.lloyd_solve_plain(rows, ternary, skip, with_v2=not ternary)
        assert torch.equal(got.reshape(want.shape), want)
        scheme = 'ls-T' if ternary else 'ls-2'
        assert torch.equal(TQ.solve_scales(scheme, x, skip, 'lloyd'), want)
        assert torch.equal(T.opt_v1(rows, ternary, skip, 'lloyd'), want[0])


@pytest.mark.parametrize('ternary', [False, True])
@pytest.mark.parametrize('skip', [1, 3])
def test_lloyd_twin_matches_jax_scales(ternary, skip):
    """v1 at V1_TOL (else a cost no higher, COST_TOL), ls-2's v2 at
    V1_TOL where v1 is, against JAX's quantizer_ls_2 / _ternary, over the
    normal, lognormal, bimodal, constant, zero and repeated rows."""
    oracle = lloyd_oracle()
    rows = oracle['rows']
    want = oracle[f'{"lsT" if ternary else "ls2"}_s{skip}']
    got = T.lloyd_solve(torch.from_numpy(rows), ternary, skip,
                        with_v2=not ternary).numpy().reshape(want.shape)
    _assert_v1_match(rows, skip, got[0], want[0], ternary)
    if not ternary:
        close = np.isclose(got[0], want[0], **V1_TOL)
        np.testing.assert_allclose(got[1][close], want[1][close], **V1_TOL)


def test_lloyd_oracle_is_jax():
    """The committed oracle the card tests read is JAX's output today."""
    stored = np.load(LLOYD_ORACLE)
    fresh = lloyd_oracle()
    assert set(stored.files) == set(fresh)
    for k, v in fresh.items():
        np.testing.assert_array_equal(stored[k], v, err_msg=k)


def test_lloyd_cpu_tensors_never_reach_the_kernel(monkeypatch):
    """Every lloyd caller on a CPU tensor takes the plain twin: nothing
    is built or loaded and the kernel's launch counter stays 0."""
    from quant_tpu_torch import _build

    def refuse(*args, **kw):
        raise AssertionError('a CPU solve reached _build')

    monkeypatch.setattr(_build, 'load', refuse)
    monkeypatch.setattr(_build, 'build', refuse)
    T.launches.reset()
    x = torch.from_numpy(_activations(9))
    for tdtype in (torch.float32, torch.bfloat16):
        xt = x.to(tdtype)
        TQ.quantizer_ls_2(xt, None, skip=3, mode='lloyd')
        TQ.quantizer_ls_ternary(xt, None, skip=3, mode='lloyd')
        TQ.solve_scales('ls-2', xt, 3, 'lloyd')
        T.opt_v1(xt.reshape(4, -1), True, 1, 'lloyd')
    assert T.launches.count == 0


def test_lloyd_solve_refuses_other_devices():
    """A tensor neither on the CPU nor on CUDA is refused, as is a
    matrix that is not 2D."""
    with pytest.raises(ValueError, match='CPU or CUDA'):
        T.lloyd_solve(torch.zeros((2, 6), device='meta'), False, 3, True)
    with pytest.raises(ValueError, match='rows'):
        T.lloyd_solve(torch.zeros(6), False, 3, True)
