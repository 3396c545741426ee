"""The packed conv's and the producer's plain twins against JAX at the
ragged shapes chip_smoke.py holds the CUDA kernels to.

On the card chip_smoke.py checks each kernel equal to its twin at
`CONV_CHECK_SHAPES` and `PACK_CHECK_SHAPES`; here, at the same shapes,
each twin is checked equal to the JAX package: `xnor_conv2d` to
`binary_conv_int8` on int8 sign planes plus the int8 branch's epilogue
(quant_tpu/ops/binary_infer.py:312-323), the producer to
`threshold_sign_planes` packed by `pack_signs`. Every comparison is
exact: the dots are integers and both sides run the same float32 ops in
the same order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from quant_tpu.ops import binary_infer as JB
from quant_tpu.ops.packing import pack_signs as j_pack_signs
from quant_tpu.ops.packing import unpack_signs as j_unpack_signs
from quant_tpu_torch.ops import binary_infer as TB
from quant_tpu_torch.ops.packing import pack_signs

JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
DTYPES = [torch.float32, torch.bfloat16]


def _np(t: torch.Tensor) -> np.ndarray:
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _jax_conv(x_signs, w_signs, vx, vw, bias, stride, padding, out_dtype):
    """JAX's int8 branch on one sign plane: exact s32 conv, then the
    scale epilogue and the bias in the out dtype."""
    y = JB.binary_conv_int8(jnp.asarray(x_signs, jnp.int8),
                            jnp.asarray(w_signs, jnp.int8),
                            stride=stride, padding=padding)
    scale = (jnp.asarray(vx).reshape(-1, 1, 1, 1)
             * jnp.asarray(vw).reshape(1, 1, 1, -1))
    return ((y * scale).astype(JDT[out_dtype])
            + jnp.asarray(bias).astype(JDT[out_dtype]))


@pytest.mark.parametrize('out_dtype', DTYPES)
@pytest.mark.parametrize('shape', chip_smoke.CONV_CHECK_SHAPES, ids=str)
def test_conv_twin_matches_jax(rng, shape, out_dtype):
    n, h, w, c, o, k, stride, padding = shape
    xs = np.where(rng.standard_normal((n, h, w, c)) < 0, -1, 1)
    ws = np.where(rng.standard_normal((k, k, c, o)) < 0, -1, 1)
    vx = rng.uniform(0.1, 1.1, n).astype(np.float32)
    vw = rng.uniform(0.01, 0.06, o).astype(np.float32)
    bias = rng.standard_normal(o).astype(np.float32)
    want = _jax_conv(xs, ws, vx, vw, bias, stride, padding, out_dtype)
    got = TB.xnor_conv2d(
        pack_signs(torch.from_numpy(xs.astype(np.float32))),
        TB.pack_weights(torch.from_numpy(ws.astype(np.float32))),
        torch.from_numpy(vx), torch.from_numpy(vw), torch.from_numpy(bias),
        in_channels=c, stride=stride, padding=padding, out_dtype=out_dtype)
    assert got.dtype == out_dtype and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))


@pytest.mark.parametrize('shape', chip_smoke.CONV_CHECK_SHAPES, ids=str)
def test_conv_twin_ignores_pad_bits(rng, shape):
    """Random words, as chip_smoke.py draws them: the pad bits past C are
    random too, and the integer dot must equal JAX's on the C channels
    the words unpack to."""
    n, h, w, c, o, k, stride, padding = shape
    wc = -(-c // 32)
    xw = rng.integers(-2 ** 31, 2 ** 31, (n, h, w, wc), dtype=np.int32)
    ww = rng.integers(-2 ** 31, 2 ** 31, (k, k, wc, o), dtype=np.int32)
    xs = np.asarray(j_unpack_signs(jnp.asarray(xw), c, dtype=jnp.int8))
    ws = np.asarray(JB.unpack_weights_int8(jnp.asarray(ww), c,
                                           dtype=jnp.int8))
    want = JB.binary_conv_int8(jnp.asarray(xs), jnp.asarray(ws),
                               stride=stride, padding=padding)
    got = TB.xnor_conv2d(torch.from_numpy(xw), torch.from_numpy(ww),
                         torch.ones(n), torch.ones(o), None, in_channels=c,
                         stride=stride, padding=padding)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize('tdtype', DTYPES)
@pytest.mark.parametrize('shape', chip_smoke.PACK_CHECK_SHAPES, ids=str)
def test_producer_twin_matches_jax(rng, shape, tdtype):
    c = shape[-1]
    thresh = (rng.standard_normal(c) * 0.5).astype(np.float32)
    flip = np.where(rng.random(c) < 0.3, -1.0, 1.0).astype(np.float32)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    # NaN and +-inf as chip_smoke.py plants them: NaN packs as sign +1.
    x = chip_smoke.plant_specials(x.to(tdtype), 0)
    x[0, 0, 0] = torch.from_numpy(thresh).to(tdtype)  # on the threshold
    planes, _ = JB.threshold_sign_planes(
        jnp.asarray(_np(x), JDT[tdtype]), 'ls-1',
        jnp.ones((1, shape[0]), jnp.float32), jnp.asarray(thresh),
        jnp.asarray(flip), None, dtype=jnp.float32)
    want = np.asarray(j_pack_signs(planes[0]))
    # The offset view chip_smoke.py sends down the scalar path.
    view = torch.empty(x.numel() + 1, dtype=tdtype)[1:].view(shape)
    view.copy_(x)
    for xin in (x, view):
        got = TB.pack_sign_planes(xin, 1, None, torch.from_numpy(thresh),
                                  torch.from_numpy(flip))
        assert got.shape == (1,) + shape[:-1] + (-(-c // 32),)
        np.testing.assert_array_equal(got[0].numpy(), want)


# Scheme pairs of the multi-plane conv: (planes, planes a scale covers)
# per side, as chip_smoke.py's PLANE_X_SCHEMES x PLANE_W_SCHEMES, minus
# ls-1 x ls-1 (the single-plane kernel above).
_PAIRS = [(xs, ws) for xs in chip_smoke.PLANE_X_SCHEMES
          for ws in chip_smoke.PLANE_W_SCHEMES if (xs, ws) != ('ls-1', 'ls-1')]
# Each check shape with two of the pairs, so that every pair meets
# several shapes and every shape two pairs; then every plane layout the
# CUDA kernel instantiates (merged planes on either side, 1-3 activation
# groups a pass, passes over weight groups and over activation groups
# past 3) at the shape that crosses its tiles' edges in M and N.
_PLANE_CASES = [(shape, _PAIRS[(i + d) % len(_PAIRS)])
                for i, shape in enumerate(chip_smoke.PLANES_CHECK_SHAPES)
                for d in (0, len(_PAIRS) // 2)]
_PLANE_CASES += [(chip_smoke.PLANES_TILE_SHAPE, (xs, ws))
                 for xs in chip_smoke.PLANES_TILE_X_SCHEMES
                 for ws in chip_smoke.PLANE_W_SCHEMES
                 if (xs, ws) != ('ls-1', 'ls-1')]


def _jax_planes_conv(xw, ww, c, vx, vw, bias, x_group, w_group, stride,
                     padding, out_dtype):
    """JAX's int8 route (binary_infer.py:268-323) on the planes the words
    unpack to: planes that share a scale merge into one operand (b1 +
    b2), then the pass loop, weight sets outer."""
    def merged(planes, group):
        return [sum(planes[g * group:(g + 1) * group])
                for g in range(len(planes) // group)]
    xs = merged([j_unpack_signs(jnp.asarray(p), c, dtype=jnp.int8)
                 for p in xw], x_group)
    ws = merged([JB.unpack_weights_int8(jnp.asarray(p), c, dtype=jnp.int8)
                 for p in ww], w_group)
    acc = None
    for j, w_signs in enumerate(ws):
        for i, x_signs in enumerate(xs):
            y = JB.binary_conv_int8(x_signs, w_signs, stride=stride,
                                    padding=padding)
            scale = (jnp.asarray(vx[i]).reshape(-1, 1, 1, 1)
                     * jnp.asarray(vw[j]).reshape(1, 1, 1, -1))
            term = (y * scale).astype(JDT[out_dtype])
            acc = term if acc is None else acc + term
    return acc + jnp.asarray(bias).astype(JDT[out_dtype])


@pytest.mark.parametrize('out_dtype', DTYPES)
@pytest.mark.parametrize('shape,pair', _PLANE_CASES, ids=str)
def test_planes_conv_twin_matches_jax(rng, shape, pair, out_dtype):
    """The multi-plane conv's twin on random words (pad bits random too)
    against JAX's int8 route: exact, with a scale of its own for every
    plane group."""
    n, h, w, c, o, k, stride, padding = shape
    (k_a, xg), (k_w, wg) = map(chip_smoke.plane_layout, pair)
    wc = -(-c // 32)
    xw = rng.integers(-2 ** 31, 2 ** 31, (k_a, n, h, w, wc), dtype=np.int32)
    ww = rng.integers(-2 ** 31, 2 ** 31, (k_w, k, k, wc, o), dtype=np.int32)
    vx = rng.uniform(0.1, 1.1, (k_a // xg, n)).astype(np.float32)
    vw = rng.uniform(0.01, 0.06, (k_w // wg, o)).astype(np.float32)
    bias = rng.standard_normal(o).astype(np.float32)
    want = _jax_planes_conv(xw, ww, c, vx, vw, bias, xg, wg, stride, padding,
                            out_dtype)
    got = TB.xnor_conv2d_planes(
        torch.from_numpy(xw), torch.from_numpy(ww), torch.from_numpy(vx),
        torch.from_numpy(vw), torch.from_numpy(bias), in_channels=c,
        x_group=xg, w_group=wg, stride=stride, padding=padding,
        out_dtype=out_dtype)
    assert got.dtype == out_dtype and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))


@pytest.mark.parametrize('k', [2, 3])
@pytest.mark.parametrize('mode', ['folded', 'unfolded'])
@pytest.mark.parametrize('tdtype', DTYPES)
@pytest.mark.parametrize('shape', chip_smoke.PLANES_PACK_SHAPES, ids=str)
def test_planes_producer_twin_matches_jax(rng, shape, tdtype, mode, k):
    """The multi-plane producer's twin against JAX's k planes of gf-k
    (ls-2's and ls-T's two are gf-2's), packed, NaN and +-inf planted as
    chip_smoke.py plants them, as given and as an offset view: folded,
    threshold_sign_planes' chain in x's dtype; unfolded,
    activation_sign_planes' in float32."""
    n, c = shape[0], shape[-1]
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    x = chip_smoke.plant_specials(x.to(tdtype), 0)
    thresh = (rng.standard_normal(c) * 0.5).astype(np.float32)
    flip = np.where(rng.random(c) < 0.3, -1.0, 1.0).astype(np.float32)
    x[0, 0, 0] = torch.from_numpy(thresh).to(tdtype)  # on the threshold
    va = rng.uniform(0.2, 0.5, (k, c)).astype(np.float32)
    vs = rng.uniform(0.2, 0.5, (k, n)).astype(np.float32)
    jx = jnp.asarray(_np(x), JDT[tdtype])
    scheme = f'gf-{k}'
    if mode == 'folded':
        planes, _ = JB.threshold_sign_planes(
            jx, scheme, jnp.asarray(vs), jnp.asarray(thresh),
            jnp.asarray(flip), jnp.asarray(va), dtype=jnp.float32)
        args = tuple(map(torch.from_numpy, (va, thresh, flip)))
    else:
        planes, _ = JB.activation_sign_planes(jx, scheme, jnp.asarray(vs),
                                              dtype=jnp.float32)
        args = (torch.from_numpy(vs),)
    want = np.stack([np.asarray(j_pack_signs(p)) for p in planes])
    view = torch.empty(x.numel() + 1, dtype=tdtype)[1:].view(shape)
    view.copy_(x)
    for xin in (x, view):
        got = TB.pack_sign_planes(xin, k, *args)
        assert got.shape == (k,) + shape[:-1] + (-(-c // 32),)
        np.testing.assert_array_equal(got.numpy(), want)
