"""Parity of the port's multi-plane schemes (ls-2, ls-T, gf-k) with JAX.

The same numpy inputs go through quant_tpu's function and the port's on
CPU tensors, where each kernel wrapper runs its plain twin. JAX runs op
by op (no jit), which rounds a bf16 chain after every op as PyTorch
does. Sign planes, packed words, integer dots and the int8 route's
convs must be equal; the bf16 route and fp activations are held within
the tolerance stated at each, since their float32 sums run in another
order than XLA's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quant_tpu.nn.layers import _quantize_with_scheme as j_quantize
from quant_tpu.nn.layers import scheme_num_scales as j_num_scales
from quant_tpu.ops import binary_infer as JB
from quant_tpu.ops.quantize import get_clamp_fn as j_clamp
from quant_tpu_torch.ops import binary_infer as TB
from quant_tpu_torch.ops.quantize import (
    get_clamp_fn, quantize_with_scheme, scheme_num_scales, validate_scheme,
)

JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
DTYPES = [torch.float32, torch.bfloat16]
SCHEMES = ['ls-1', 'ls-2', 'ls-T', 'gf-2', 'gf-3']
X_SCHEMES = SCHEMES
W_SCHEMES = ['ls-1', 'ls-2', 'ls-T']
# Distinct scales per plane (a swapped plane or scale shows), prefix sums
# inside the clamp's alpha of 2.
PLANE_SCALES = (0.9, 0.45, 0.2)


def _np(x):
    """JAX or torch array -> numpy (bf16 widened to float32, exactly)."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def _both(a, tdtype=torch.float32):
    t = torch.from_numpy(np.asarray(a, np.float32)).to(tdtype)
    return jnp.asarray(_np(t), JDT[tdtype]), t


def _scales(rng, k, rows):
    """(k, rows) scales, plane i near PLANE_SCALES[i], each row its own."""
    base = np.asarray(PLANE_SCALES[:k], np.float32)[:, None]
    return (base * rng.uniform(0.9, 1.0, (k, rows))).astype(np.float32)


def test_scheme_registry_matches_jax():
    for scheme in ('fp', *SCHEMES, 'gf-5'):
        validate_scheme(scheme)
        assert scheme_num_scales(scheme) == j_num_scales(scheme)
    for bad in ('ls-3', 'gf-', 'gf-x', 'int8'):
        with pytest.raises(ValueError, match='invalid'):
            validate_scheme(bad)


@pytest.mark.parametrize('tdtype', DTYPES)
@pytest.mark.parametrize('scheme', ['fp', *SCHEMES])
def test_quantizers_with_given_scales_match_jax(rng, scheme, tdtype):
    """With the scales given (the eval form), x_q equals JAX's: the same
    ops in x's dtype, the scales cast to it first."""
    x = rng.standard_normal((4, 3, 3, 5)).astype(np.float32) * 2
    jx, tx = _both(x, tdtype)
    k = scheme_num_scales(scheme)
    vs = _scales(rng, k, 4) if k else None
    jvs, jq = j_quantize(scheme, jx, None if vs is None else jnp.asarray(vs),
                         3, 'exact')
    tvs, tq = quantize_with_scheme(
        scheme, tx, None if vs is None else torch.from_numpy(vs))
    assert tq.dtype == tdtype
    np.testing.assert_array_equal(_np(tq), _np(jq))
    np.testing.assert_array_equal(_np(tvs), _np(jvs))


@pytest.mark.parametrize('tdtype', DTYPES)
@pytest.mark.parametrize('scheme', ['ls-1', 'gf-2', 'gf-3'])
def test_mean_solves_match_jax(rng, scheme, tdtype):
    """The batch solves that need only means: the scales sum |x| in
    another order than XLA (float32 rounding, rtol 1e-6); x_q is then
    equal wherever no sign sits within that rounding of a residual."""
    x = rng.standard_normal((4, 3, 3, 5)).astype(np.float32) * 2
    jx, tx = _both(x, tdtype)
    jvs, jq = j_quantize(scheme, jx, None, 3, 'exact')
    tvs, tq = quantize_with_scheme(scheme, tx, None)
    np.testing.assert_allclose(tvs.numpy(), np.asarray(jvs), rtol=1e-6)
    np.testing.assert_allclose(_np(tq), _np(jq), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize('skip', [1, 3])
@pytest.mark.parametrize('tdtype', DTYPES)
@pytest.mark.parametrize('scheme', ['ls-2', 'ls-T'])
def test_least_squares_solves_match_jax(rng, scheme, tdtype, skip):
    """The batch solves that need the least-squares optimum (opt_v1, the
    stride `skip` over each sample's NHWC row): v1 within a few float32
    ulps of JAX's (its cumsum sums in another order; rtol 1e-5, as
    tests/test_torch_port_optimal.py), x_q as the mean solves'."""
    x = rng.standard_normal((4, 3, 3, 5)).astype(np.float32) * 2
    jx, tx = _both(x, tdtype)
    jvs, jq = j_quantize(scheme, jx, None, skip, 'exact')
    tvs, tq = quantize_with_scheme(scheme, tx, None, skip, 'exact')
    assert tq.dtype == tdtype and tvs.shape == jvs.shape
    np.testing.assert_allclose(tvs.numpy(), np.asarray(jvs), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(_np(tq), _np(jq), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize('scheme', SCHEMES)
def test_weight_sign_planes_match_jax(rng, scheme):
    w = rng.standard_normal((6, 3, 3, 10)).astype(np.float32) * 0.3
    jw, tw = _both(w)
    vs = _scales(rng, scheme_num_scales(scheme), 6) * 0.3
    jplanes = JB.weight_sign_planes(jw, scheme, jnp.asarray(vs))
    tplanes = TB.weight_sign_planes(tw, scheme, torch.from_numpy(vs))
    assert len(tplanes) == len(jplanes) == TB.sign_planes(scheme)
    for t, j in zip(tplanes, jplanes):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    np.testing.assert_array_equal(
        TB.weight_scales_for_planes(scheme, torch.from_numpy(vs)).numpy(),
        np.asarray(JB.weight_scales_for_planes(scheme, jnp.asarray(vs))))


def _fold(rng, c, k):
    a = rng.uniform(0.3, 1.5, c) * np.where(rng.random(c) < 0.3, -1, 1)
    b = rng.uniform(-0.8, 0.8, c)
    thresh = (-b / a).astype(np.float32)
    flip = np.where(a >= 0, 1.0, -1.0).astype(np.float32)
    va = (_scales(rng, k, 1) / np.abs(a)[None, :]).astype(np.float32)
    return thresh, flip, va


@pytest.mark.parametrize('mode', ['threshold', 'activation'])
@pytest.mark.parametrize('tdtype', DTYPES)
@pytest.mark.parametrize('scheme', SCHEMES)
def test_sign_planes_match_jax(rng, scheme, tdtype, mode):
    """Both producer modes' planes and scales, exact: the folded chain in
    x's dtype, the unfolded one promoted to float32."""
    n, c = 3, 40
    k = scheme_num_scales(scheme)
    x = rng.standard_normal((n, 4, 5, c)).astype(np.float32) * 2
    thresh, flip, va = _fold(rng, c, k)
    # Values on the threshold and one plane scale past it: the residual
    # compare lands on zero in the first pixel's second channel.
    x[0, 0, 0, 0] = thresh[0]
    x[0, 0, 0, 1] = thresh[1] + flip[1] * va[0, 1]
    jx, tx = _both(x, tdtype)
    vs = _scales(rng, k, n)
    if mode == 'threshold':
        jp, js = JB.threshold_sign_planes(
            jx, scheme, jnp.asarray(vs), jnp.asarray(thresh),
            jnp.asarray(flip), jnp.asarray(va), dtype=jnp.float32)
        tp, ts = TB.threshold_sign_planes(
            tx, scheme, torch.from_numpy(vs), torch.from_numpy(thresh),
            torch.from_numpy(flip), torch.from_numpy(va),
            dtype=torch.float32)
    else:
        jp, js = JB.activation_sign_planes(jx, scheme, jnp.asarray(vs),
                                           dtype=jnp.float32)
        tp, ts = TB.activation_sign_planes(tx, scheme, torch.from_numpy(vs),
                                           dtype=torch.float32)
    assert len(tp) == len(jp) and len(ts) == len(js)
    for t, j in zip(tp + ts, jp + js):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _conv_case(rng, x_scheme, w_scheme, c=40, o=13, n=2):
    """Inputs of one packed conv: x, distinct scales, packed weight
    planes (JAX's export), bias and the threshold fold."""
    k_a, k_w = scheme_num_scales(x_scheme), scheme_num_scales(w_scheme)
    x = rng.standard_normal((n, 6, 5, c)).astype(np.float32) * 2
    w = rng.standard_normal((o, 3, 3, c)).astype(np.float32) * 0.2
    w_vs = _scales(rng, k_w, o) * 0.2
    planes = TB.weight_sign_planes(torch.from_numpy(w), w_scheme,
                                   torch.from_numpy(w_vs))
    packed = torch.stack([TB.pack_weights(torch.movedim(p, 0, -1))
                          for p in planes])
    w_scales = TB.weight_scales_for_planes(w_scheme, torch.from_numpy(w_vs))
    fold = _fold(rng, c, k_a)
    return dict(x=x, x_vs=_scales(rng, k_a, n), packed=packed.numpy(),
                w_scales=w_scales.numpy(), fold=fold,
                bias=rng.standard_normal(o).astype(np.float32), c=c)


def _both_convs(case, x_scheme, w_scheme, tdtype, route, int8=False,
                **kw):
    jx, tx = _both(case['x'], tdtype)
    common = dict(x_scheme=x_scheme, in_channels=case['c'], stride=1,
                  padding=1, w_planes_share_scale=w_scheme == 'ls-T', **kw)
    jkw = dict(common, compute_dtype=jnp.int8 if int8 else None,
               x_vs=jnp.asarray(case['x_vs']),
               w_packed=jnp.asarray(case['packed']),
               w_vs=jnp.asarray(case['w_scales']),
               bias=jnp.asarray(case['bias']), out_dtype=JDT[tdtype])
    tkw = dict(common, compute_dtype='int8' if int8 else None,
               x_vs=torch.from_numpy(case['x_vs']),
               w_packed=torch.from_numpy(case['packed']),
               w_vs=torch.from_numpy(case['w_scales']),
               bias=torch.from_numpy(case['bias']), out_dtype=tdtype)
    if route == 'threshold':
        names = ('x_thresh', 'x_flip', 'x_va')
        jkw.update(zip(names, map(jnp.asarray, case['fold'])))
        tkw.update(zip(names, map(torch.from_numpy, case['fold'])))
    else:
        jkw['clamp_fn'] = j_clamp('symmetric', 2.0)
        tkw['clamp_fn'] = get_clamp_fn('symmetric', 2.0)
    want = JB.quant_conv2d_infer(jx, **jkw)
    got = TB.quant_conv2d_infer(tx, **tkw)
    assert got.dtype == tdtype and tuple(got.shape) == want.shape
    return _np(got), _np(want)


@pytest.mark.parametrize('route', ['threshold', 'clamp'])
@pytest.mark.parametrize('tdtype', DTYPES)
@pytest.mark.parametrize('w_scheme', W_SCHEMES)
@pytest.mark.parametrize('x_scheme', X_SCHEMES)
def test_int8_route_matches_jax(rng, x_scheme, w_scheme, tdtype, route):
    """Producer + multi-plane conv (the kernels' plain twins) against
    JAX's int8 route (compute_dtype=jnp.int8, never fused): exact, the
    dots being integers and the pass loop's float ops the same, in the
    same order, each term and running sum rounded to the out dtype."""
    case = _conv_case(rng, x_scheme, w_scheme)
    got, want = _both_convs(case, x_scheme, w_scheme, tdtype, route,
                            int8=True)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('fused', [True, False])
@pytest.mark.parametrize('tdtype', DTYPES)
@pytest.mark.parametrize('x_scheme,w_scheme', [
    ('ls-2', 'ls-1'), ('gf-2', 'ls-1'), ('gf-3', 'ls-2'), ('ls-T', 'ls-T'),
    ('ls-1', 'ls-2')])
def test_bf16_route_matches_jax(rng, x_scheme, w_scheme, tdtype, fused):
    """The bf16 route: the fused bake (scales baked into bf16 operands,
    one conv) and the bf16 pass loop. Both sides sum the same bf16
    products in float32, in another order, so float32 outputs agree to
    float32 rounding of the sums (1e-5 of the largest output) and bf16
    outputs to one bf16 rounding of it (2^-7)."""
    case = _conv_case(rng, x_scheme, w_scheme)
    got, want = _both_convs(case, x_scheme, w_scheme, tdtype, 'threshold',
                            fused=fused)
    tol = (1e-5 if tdtype == torch.float32 else 2 ** -7) * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize('fused', [True, False])
@pytest.mark.parametrize('tdtype', DTYPES)
@pytest.mark.parametrize('w_scheme', W_SCHEMES)
def test_fp_activation_conv_matches_jax(rng, w_scheme, tdtype, fused):
    """fp activations against binary weights: bf16(x) convolved with the
    signs (or the baked weight), float32 sums in another order; held as
    the bf16 route."""
    case = _conv_case(rng, 'ls-1', w_scheme)
    jx, tx = _both(case['x'])
    kw = dict(in_channels=case['c'], stride=1, padding=1, fused=fused)
    want = _np(JB.fp_activation_conv_infer(
        jx, w_packed=jnp.asarray(case['packed']),
        w_vs=jnp.asarray(case['w_scales']), bias=jnp.asarray(case['bias']),
        clamp_fn=j_clamp('symmetric', 2.0), out_dtype=JDT[tdtype], **kw))
    got = TB.fp_activation_conv_infer(
        tx, w_packed=torch.from_numpy(case['packed']),
        w_vs=torch.from_numpy(case['w_scales']),
        bias=torch.from_numpy(case['bias']),
        clamp_fn=get_clamp_fn('symmetric', 2.0), out_dtype=tdtype, **kw)
    assert got.dtype == tdtype and tuple(got.shape) == want.shape
    tol = (1e-5 if tdtype == torch.float32 else 2 ** -7) * np.abs(want).max()
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=tol)


@pytest.mark.parametrize('dtype', ['int8', 'bf16'])
def test_binary_conv_on_merged_planes_is_exact(rng, dtype):
    """binary_conv_int8 on {-2, 0, 2} x {-1, 1} operands (ls-T's merged
    plane): int8 gives JAX's int32 dot, bf16 its float32 sum, exactly."""
    xs = rng.integers(-1, 2, (2, 5, 6, 40)) * 2
    ws = np.where(rng.standard_normal((3, 3, 40, 7)) < 0, -1, 1)
    jdt, tdt = ((jnp.int8, torch.int8) if dtype == 'int8'
                else (jnp.bfloat16, torch.bfloat16))
    want = JB.binary_conv_int8(jnp.asarray(xs, jdt), jnp.asarray(ws, jdt),
                               padding=1)
    got = TB.binary_conv_int8(torch.from_numpy(xs).to(tdt),
                              torch.from_numpy(ws).to(tdt), padding=1)
    assert str(got.dtype).split('.')[-1] == str(want.dtype)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
