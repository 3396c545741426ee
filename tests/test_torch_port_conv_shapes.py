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
    x = x.to(tdtype)
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
        got = TB.pack_threshold_signs(xin, torch.from_numpy(thresh),
                                      torch.from_numpy(flip))
        assert got.shape == shape[:-1] + (-(-c // 32),)
        np.testing.assert_array_equal(got.numpy(), want)
