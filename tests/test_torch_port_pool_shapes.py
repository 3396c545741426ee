"""The stem pool's plain twin against JAX at the shapes chip_smoke.py
holds the CUDA kernel to, with NaN and +-inf planted.

On the card chip_smoke.py checks `max_pool_3x3_s2_p1` equal to its twin
at `POOL_CHECK_SHAPES` (and their offset views) by a NaN-aware
comparison; here, on the same values, the twin is checked against JAX's
`max_pool2d` (lax.reduce_window with lax.max) and the Pallas kernel in
interpret mode (the check shapes are small enough for it, ~0.3 s
each): NaN wherever JAX has NaN, every other element exact. Also here:
the route rule the wrapper mirrors from csrc/pool.cu, and the
comparison chip_smoke.py uses.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from quant_tpu.ops.conv import max_pool2d as j_max_pool2d
from quant_tpu.ops.pool import max_pool_3x3_s2_p1 as j_pool
from quant_tpu_torch.ops.pool import max_pool_3x3_s2_p1, vector_bytes

JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
DTYPES = [torch.float32, torch.bfloat16]


def _inputs(shape, dtype, seed):
    """Seeded normal values in `dtype` with NaN and +-inf planted as
    chip_smoke.py plants them, and their float32 numpy copy (exact)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    x = chip_smoke.plant_specials(x.to(dtype), seed)
    return x, x.float().numpy()


def _assert_same(got: np.ndarray, want: np.ndarray) -> None:
    """NaN exactly where want has NaN, every other element equal."""
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan], want[~nan])


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('shape', chip_smoke.POOL_CHECK_SHAPES, ids=str)
def test_pool_twin_matches_reduce_window(shape, dtype):
    x, xf = _inputs(shape, dtype, 1)
    assert np.isnan(xf).any() and np.isposinf(xf).any()
    want = np.asarray(j_max_pool2d(jnp.asarray(xf, JDT[dtype]),
                                   kernel_size=3, stride=2, padding=1),
                      np.float32)
    assert np.isnan(want).any()
    assert np.isneginf(want[:, 0, 0, 0]).all()  # the all -inf window
    # The offset view chip_smoke.py sends down the narrowest route.
    view = torch.empty(x.numel() + 1, dtype=dtype)[1:].view(shape)
    view.copy_(x)
    for xin in (x, view):
        got = max_pool_3x3_s2_p1(xin)
        assert got.dtype == dtype and tuple(got.shape) == want.shape
        _assert_same(got.float().numpy(), want)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('shape', chip_smoke.POOL_CHECK_SHAPES, ids=str)
def test_pool_twin_matches_pallas_interpret(shape, dtype):
    x, xf = _inputs(shape, dtype, 2)
    want = np.asarray(j_pool(jnp.asarray(xf, JDT[dtype]), interpret=True),
                      np.float32)
    _assert_same(max_pool_3x3_s2_p1(x).float().numpy(), want)


def test_nan_in_a_window_yields_nan():
    """The issue's case: NaN at (1, 1) of a 4x4 map reaches all four
    outputs, as lax.max propagates it."""
    for dtype in DTYPES:
        x = torch.zeros(1, 4, 4, 1, dtype=dtype)
        x[0, 1, 1, 0] = float('nan')
        assert max_pool_3x3_s2_p1(x).isnan().all()


@pytest.mark.parametrize('c,itemsize,ptrs,want', [
    (64, 2, (0,), 16),        # the serving map, bf16
    (8, 2, (256, 512), 16),
    (12, 2, (0,), 8),         # 24 bytes a pixel
    (70, 2, (0,), 4),         # 140 bytes a pixel
    (3, 2, (0,), 2),          # 6 bytes a pixel: one bf16 a load
    (64, 2, (2,), 2),         # a view one bf16 in
    (64, 2, (0, 8), 8),       # the output off 16 bytes
    (64, 4, (0,), 16),
    (3, 4, (0,), 4),          # 12 bytes a pixel
    (70, 4, (0,), 8),         # 280 bytes a pixel
    (64, 4, (4,), 4),         # a view one float in: never below 4
    (1, 4, (0, 4), 4),
])
def test_vector_bytes_route(c, itemsize, ptrs, want):
    assert vector_bytes(c, itemsize, *ptrs) == want


def test_pool_check_shapes_cover_every_route():
    """chip_smoke.POOL_CHECK_SHAPES and their offset views take every
    load width of each dtype (POOL_ROUTES), as chip_smoke.py requires of
    the launcher on the card."""
    for dtype, routes in chip_smoke.POOL_ROUTES.items():
        size = torch.empty(0, dtype=dtype).element_size()
        seen = {vector_bytes(s[-1], size, off)
                for s in chip_smoke.POOL_CHECK_SHAPES for off in (0, size)}
        assert seen == routes, dtype


def test_check_equal_holds_nan_positions_not_payloads():
    want = torch.tensor([1.0, float('nan'), float('-inf'), float('inf')])
    other_nan = want.clone()
    other_nan.view(torch.int32)[1] = 0x7FFFFFFF  # another NaN payload
    assert chip_smoke.check_equal('x', other_nan, want, nan_ok=True) == 0.0
    with pytest.raises(AssertionError, match='differs'):
        chip_smoke.check_equal('x', want.clone(), want)  # NaN != NaN
    moved = torch.tensor([float('nan'), 1.0, float('-inf'), float('inf')])
    with pytest.raises(AssertionError, match='NaN positions'):
        chip_smoke.check_equal('x', moved, want, nan_ok=True)
    off = torch.tensor([2.0, float('nan'), float('-inf'), float('inf')])
    with pytest.raises(AssertionError, match=r'max abs err 1\.0'):
        chip_smoke.check_equal('x', off, want, nan_ok=True)
    flipped = torch.tensor([1.0, float('nan'), float('inf'), float('inf')])
    with pytest.raises(AssertionError, match='differs'):
        chip_smoke.check_equal('x', flipped, want, nan_ok=True)
    bf = want.to(torch.bfloat16)
    assert chip_smoke.check_equal('x', bf.clone(), bf, nan_ok=True) == 0.0


def test_plant_specials_is_seeded_and_plants_each_value():
    a = chip_smoke.plant_specials(torch.zeros(2, 6, 6, 8), 3)
    b = chip_smoke.plant_specials(torch.zeros(2, 6, 6, 8), 3)
    assert torch.equal(a.isnan(), b.isnan())
    assert a.isnan().any() and a.isposinf().any() and a.isneginf().any()
    assert a[:, :2, :2, 0].isneginf().all()
    assert int((~a.isfinite()).sum()) >= 2 * 6 * 6 * 8 // 64
