"""Parity of the PyTorch port's ops (quant_tpu_torch.ops) with quant_tpu.

The same numpy inputs go through the JAX function (Pallas kernels in
interpret mode, as tests/ops runs them) and the port's counterpart on
CPU tensors, where each kernel wrapper runs its plain twin. Sign planes,
packed words, integer dots and max pools must be equal; each float
tolerance is stated where it is used.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from quant_tpu.nn.layers import ActivationQuantizer as JActivationQuantizer
from quant_tpu.ops import binary_gemm as JG
from quant_tpu.ops import binary_infer as JB
from quant_tpu.ops.packing import pack_signs as j_pack_signs
from quant_tpu.ops.packing import unpack_signs as j_unpack_signs
from quant_tpu.ops.pool import max_pool_3x3_s2_p1 as j_pool
from quant_tpu.ops.quantize import get_clamp_fn as j_clamp
from quant_tpu.ops.ste import binary_sign as j_sign
from quant_tpu_torch import _build
from quant_tpu_torch.nn.layers import ActivationQuantizer
from quant_tpu_torch.ops import binary_gemm as TG
from quant_tpu_torch.ops import binary_infer as TB
from quant_tpu_torch.ops.conv import max_pool2d
from quant_tpu_torch.ops.packing import pack_signs, unpack_signs
from quant_tpu_torch.ops.pool import max_pool_3x3_s2_p1, pool_fusable
from quant_tpu_torch.ops.quantize import get_clamp_fn, quantizer_ls_1
from quant_tpu_torch.ops.ste import binary_sign

JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _np(x):
    """JAX or torch array -> numpy (bf16 widened to float32, exactly)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def _both(a, tdtype=torch.float32):
    """The same values as a JAX array and a torch tensor of one dtype."""
    t = torch.from_numpy(np.asarray(a, np.float32)).to(tdtype)
    return jnp.asarray(_np(t), JDT[tdtype]), t


def test_binary_sign_zero_is_plus_one():
    vals = np.array([-2.0, -0.0, 0.0, 1e-30, -1e-30, 3.0], np.float32)
    jx, tx = _both(vals)
    got = binary_sign(tx)
    np.testing.assert_array_equal(_np(got), _np(j_sign(jx)))
    assert got[1] == 1 and got[2] == 1
    assert torch.sign(tx)[2] == 0  # the trap the port avoids


@pytest.mark.parametrize('k', [7, 32, 33, 64, 100])
def test_pack_signs_byte_equal(rng, k):
    x = rng.standard_normal((8, k)).astype(np.float32)
    x[0, :3] = 0.0  # sign(0) = +1 sets the bit
    jx, tx = _both(x)
    words = pack_signs(tx)
    assert words.dtype == torch.int32
    np.testing.assert_array_equal(words.numpy(), np.asarray(j_pack_signs(jx)))
    if k >= 32:
        assert (words < 0).any()  # bit 31 set -> negative int32 word
    back = unpack_signs(words, k)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(j_unpack_signs(jnp.asarray(words), k)))
    np.testing.assert_array_equal(back.numpy(), _np(binary_sign(tx)))


@pytest.mark.parametrize('cin,cout', [(20, 8), (40, 8), (70, 5)])
def test_pack_weights_byte_equal(rng, cin, cout):
    w = rng.standard_normal((3, 3, cin, cout)).astype(np.float32)
    jw, tw = _both(w)
    packed = TB.pack_weights(tw)
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(JB.pack_weights(jw)))
    np.testing.assert_array_equal(
        _np(TB.unpack_weights_int8(packed, cin)),
        _np(JB.unpack_weights_int8(jnp.asarray(packed.numpy()), cin)))


def test_quantizer_ls_1_and_clamps(rng):
    x = rng.standard_normal((4, 5, 5, 3)).astype(np.float32) * 3
    jx, tx = _both(x)
    from quant_tpu.ops.quantize import quantizer_ls_1 as j_ls1
    jv, jq = j_ls1(jx)
    tv, tq = quantizer_ls_1(tx)
    # mean(|x|) sums in another order: float32 rounding only.
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-6)
    for kw in ({'kind': 'identity'}, {'kind': 'symmetric', 'alpha': 2.0}):
        np.testing.assert_array_equal(get_clamp_fn(**kw)(tx).numpy(),
                                      np.asarray(j_clamp(**kw)(jx)))
    with pytest.raises(ValueError, match='valid clamping'):
        get_clamp_fn('bogus')


# The ragged shapes chip_smoke.py holds the CUDA kernel to its twin at:
# W = 1, 5 and 145 words, K % 32 != 0, M and N off the 128x128 tile, N
# odd. With these the chain kernel -> twin -> JAX is closed at each.
XNOR_GEMM_RAGGED = list(chip_smoke.XNOR_GEMM_CHECK_SHAPES)


@pytest.mark.parametrize('m,k,n', [
    (8, 64, 16), (128, 128, 128), (130, 100, 140), (16, 512 + 17, 64),
    *XNOR_GEMM_RAGGED])
def test_xnor_gemm_matches_jax(rng, m, k, n):
    a = np.where(rng.standard_normal((m, k)) < 0, -1.0, 1.0)
    b = np.where(rng.standard_normal((k, n)) < 0, -1.0, 1.0)
    vx = (rng.random(m) + 0.1).astype(np.float32)
    vw = (rng.random(n) + 0.1).astype(np.float32)
    ja, ta = _both(a)
    jb, tb = _both(b)
    jap, jbp = JG.pack_for_xnor(ja, jb)
    tap, tbp = TG.pack_for_xnor(ta, tb)
    np.testing.assert_array_equal(tap.numpy(), np.asarray(jap))
    np.testing.assert_array_equal(tbp.numpy(), np.asarray(jbp))
    want = JG.xnor_gemm(jap, jbp, jnp.asarray(vx), jnp.asarray(vw),
                        k_total=k, interpret=True)
    got = TG.xnor_gemm(tap, tbp, torch.from_numpy(vx), torch.from_numpy(vw),
                       k)
    # Integer-exact dot; the f32 scale epilogue may round differently
    # where XLA contracts it into an FMA: JAX's own test tolerance.
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-4)
    ref = TG.xnor_gemm_reference(ta, tb, torch.from_numpy(vx),
                                 torch.from_numpy(vw))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6,
                               atol=1e-4)


@pytest.mark.parametrize('k', [32, 100])
def test_xnor_gemm_unit_scales_integer_exact(rng, k):
    _unit_scales_integer_exact(rng, 32, k, 32)


@pytest.mark.parametrize('m,k,n', XNOR_GEMM_RAGGED)
def test_xnor_gemm_unit_scales_integer_exact_ragged(rng, m, k, n):
    _unit_scales_integer_exact(rng, m, k, n)


def _unit_scales_integer_exact(rng, m, k, n):
    a = np.where(rng.standard_normal((m, k)) < 0, -1.0, 1.0)
    b = np.where(rng.standard_normal((k, n)) < 0, -1.0, 1.0)
    ja, ta = _both(a)
    jb, tb = _both(b)
    tap, tbp = TG.pack_for_xnor(ta, tb)
    got = TG.xnor_gemm(tap, tbp, torch.ones(m), torch.ones(n), k)
    jap, jbp = JG.pack_for_xnor(ja, jb)
    want = JG.xnor_gemm(jap, jbp, jnp.ones(m), jnp.ones(n), k_total=k,
                        interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), a @ b)


@pytest.mark.parametrize('shape', [
    (2, 8, 8, 16), (1, 16, 8, 8), (3, 28, 28, 4), (2, 32, 32, 8)])
@pytest.mark.parametrize('tdtype', [torch.float32, torch.bfloat16])
def test_pool_matches_jax_exactly(rng, shape, tdtype):
    x = rng.standard_normal(shape).astype(np.float32)
    x[:, 0] = 100.0  # first row is every border window's max
    jx, tx = _both(x, tdtype)
    got = max_pool_3x3_s2_p1(tx)
    want = j_pool(jx, interpret=True)
    assert got.dtype == tdtype and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(_np(got), _np(want))
    plain = max_pool2d(tx, kernel_size=3, stride=2, padding=1)
    np.testing.assert_array_equal(_np(got), _np(plain))


def test_pool_predicate_and_odd_spatial():
    assert pool_fusable((1, 112, 112, 64), 3, 2, 1)
    assert pool_fusable((1, 112, 112, 64), (3, 3), (2, 2), (1, 1))
    assert not pool_fusable((1, 112, 112, 64), 2, 2, 0)
    assert not pool_fusable((1, 111, 112, 64), 3, 2, 1)
    assert not pool_fusable((1, 112, 112, 64), 3, 1, 1)
    with pytest.raises(ValueError, match='even'):
        max_pool_3x3_s2_p1(torch.zeros(1, 7, 8, 4))


def _fold_inputs(rng, c):
    a = rng.uniform(0.3, 1.5, c) * np.where(rng.random(c) < 0.3, -1, 1)
    b = rng.uniform(-0.8, 0.8, c)
    thresh = (-b / a).astype(np.float32)
    flip = np.where(a >= 0, 1.0, -1.0).astype(np.float32)
    return thresh, flip


@pytest.mark.parametrize('tdtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('c', [40, 70])
def test_producer_words_match_jax(rng, tdtype, c):
    thresh, flip = _fold_inputs(rng, c)
    x = rng.standard_normal((2, 5, 6, c)).astype(np.float32)
    # Trap: put x exactly on the threshold rounded to x's dtype, which
    # a compare against the float32 threshold would misplace.
    x[0, 0, 0] = _np(torch.from_numpy(thresh).to(tdtype))
    jx, tx = _both(x, tdtype)
    vs = jnp.ones((1, 2), jnp.float32)
    planes, _ = JB.threshold_sign_planes(
        jx, 'ls-1', vs, jnp.asarray(thresh), jnp.asarray(flip), None,
        dtype=jnp.float32)
    want = np.asarray(j_pack_signs(planes[0]))
    got = TB.pack_sign_planes(tx, 1, None, torch.from_numpy(thresh),
                              torch.from_numpy(flip))
    assert got.shape == (1, 2, 5, 6, -(-c // 32))
    got = got[0]
    np.testing.assert_array_equal(got.numpy(), want)
    tplanes, _ = TB.threshold_sign_planes(
        tx, 'ls-1', torch.ones(1, 2), torch.from_numpy(thresh),
        torch.from_numpy(flip), None, dtype=torch.float32)
    np.testing.assert_array_equal(tplanes[0].numpy(), np.asarray(planes[0]))
    aplanes, ascales = TB.activation_sign_planes(
        tx, 'ls-1', torch.ones(1, 2), dtype=torch.float32)
    jplanes, _ = JB.activation_sign_planes(jx, 'ls-1', vs, jnp.float32)
    np.testing.assert_array_equal(aplanes[0].numpy(), np.asarray(jplanes[0]))
    assert ascales[0].shape == (2,)
    # t = 0, flip = +1 packs plain signs, as the unfolded k = 1 does.
    zeros, ones = torch.zeros(c), torch.ones(c)
    signs = np.asarray(j_pack_signs(j_sign(jx)))
    np.testing.assert_array_equal(
        TB.pack_sign_planes(tx, 1, None, zeros, ones)[0].numpy(), signs)
    np.testing.assert_array_equal(TB.pack_sign_planes(tx, 1)[0].numpy(),
                                  signs)
    with pytest.raises(ValueError, match='scale rows'):
        TB.pack_sign_planes(tx, 2)
    if tdtype == torch.bfloat16:
        naive = pack_signs(torch.from_numpy(flip) * binary_sign(
            tx.float() - torch.from_numpy(thresh)))
        assert not torch.equal(naive, got)


@pytest.mark.parametrize('stride', [1, 2])
@pytest.mark.parametrize('c', [40, 70])
def test_xnor_conv2d_integer_dot_exact(rng, stride, c):
    """Unit scales, no bias: the conv returns the integer dot, which
    must equal JAX's s8 sign conv at every pixel, borders included."""
    x = rng.standard_normal((2, 7, 9, c)).astype(np.float32)
    w = rng.standard_normal((3, 3, c, 6)).astype(np.float32)
    jx, tx = _both(x)
    jw, tw = _both(w)
    want = JB.binary_conv_int8(j_sign(jx).astype(jnp.int8),
                               j_sign(jw).astype(jnp.int8),
                               stride=stride, padding=1)
    got = TB.xnor_conv2d(pack_signs(tx), TB.pack_weights(tw), torch.ones(2),
                         torch.ones(6), None, in_channels=c, stride=stride,
                         padding=1)
    assert want.dtype == jnp.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize('route', ['threshold', 'clamp'])
@pytest.mark.parametrize('tdtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('c', [40, 70])
@pytest.mark.parametrize('stride', [1, 2])
def test_quant_conv2d_infer_matches_jax(rng, route, tdtype, c, stride):
    """The whole packed conv (producer + XNOR conv + epilogue) against
    JAX's int8 branch: exact, since the integer dot is exact and the
    epilogue runs the same float ops in the same order."""
    n, cout = 3, 12
    x = rng.standard_normal((n, 8, 7, c)).astype(np.float32) * 2
    w = rng.standard_normal((3, 3, c, cout)).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    x_vs = rng.uniform(0.1, 0.9, (1, n)).astype(np.float32)
    w_vs = rng.uniform(0.1, 0.9, (1, cout)).astype(np.float32)
    thresh, flip = _fold_inputs(rng, c)
    jx, tx = _both(x, tdtype)
    packed = TB.pack_weights(torch.from_numpy(w))[None]
    common = dict(x_scheme='ls-1', in_channels=c, stride=stride, padding=1)
    jkw = dict(common, x_vs=jnp.asarray(x_vs), w_vs=jnp.asarray(w_vs),
               w_packed=jnp.asarray(packed.numpy()), bias=jnp.asarray(bias),
               out_dtype=JDT[tdtype], compute_dtype=jnp.int8)
    tkw = dict(common, x_vs=torch.from_numpy(x_vs),
               w_vs=torch.from_numpy(w_vs), w_packed=packed,
               bias=torch.from_numpy(bias), out_dtype=tdtype,
               compute_dtype='int8')
    if route == 'threshold':
        fold = (thresh, flip, np.ones((1, c), np.float32))
        jkw.update(zip(('x_thresh', 'x_flip', 'x_va'),
                       map(jnp.asarray, fold)))
        tkw.update(zip(('x_thresh', 'x_flip', 'x_va'),
                       map(torch.from_numpy, fold)))
    else:
        jkw['clamp_fn'] = j_clamp('symmetric', 2.0)
        tkw['clamp_fn'] = get_clamp_fn('symmetric', 2.0)
    want = JB.quant_conv2d_infer(jx, **jkw)
    got = TB.quant_conv2d_infer(tx, **tkw)
    assert got.dtype == tdtype and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize('scheme', ['ls-2', 'ls-T'])
def test_per_batch_least_squares_scales_match_jax(scheme):
    """moving_average_mode 'off': the activation quantizer solves each
    sample's scales with opt_v1 (skip 3, exact), as JAX's eval forward;
    v1 within a few float32 ulps of JAX's (rtol 1e-5)."""
    x = np.random.default_rng(4).standard_normal((3, 4, 4, 8)).astype(
        np.float32) * 1.5
    quant = JActivationQuantizer(scheme)
    jx = jnp.asarray(x)
    state = quant.init(jax.random.key(0), jx, False)
    _, want = quant.apply(state, jx, False, return_scales=True)
    got = ActivationQuantizer(scheme)(torch.from_numpy(x))
    assert got.shape == want.shape == (2 if scheme == 'ls-2' else 1, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_unknown_compute_dtype_raises():
    """A compute dtype that names no route raises."""
    x = torch.zeros(1, 4, 4, 8)
    packed = torch.zeros(1, 3, 3, 1, 4, dtype=torch.int32)
    kw = dict(x_vs=torch.ones(1, 1), w_packed=packed, w_vs=torch.ones(1, 4),
              in_channels=8)
    with pytest.raises(ValueError, match='compute_dtype'):
        TB.quant_conv2d_infer(x, x_scheme='ls-1', compute_dtype='fp8', **kw)


def test_wrappers_reject_other_devices_and_cpu_runs_no_kernel():
    before = _build.launch_counts()
    words = torch.zeros(1, 4, 4, 1, dtype=torch.int32)
    TB.xnor_conv2d(words, torch.zeros(3, 3, 1, 4, dtype=torch.int32),
                   torch.ones(1), torch.ones(4), None, in_channels=8)
    assert _build.launch_counts() == before  # plain twin: no launch
    meta = torch.empty(1, 4, 4, 8, device='meta')
    with pytest.raises(ValueError, match='CPU or CUDA'):
        max_pool_3x3_s2_p1(meta)
    with pytest.raises(ValueError, match='CPU or CUDA'):
        TB.pack_sign_planes(meta, 1, None, torch.zeros(8), torch.ones(8))
    with pytest.raises(ValueError, match='do not hold'):
        TB.xnor_conv2d(words, torch.zeros(3, 3, 2, 4, dtype=torch.int32),
                       torch.ones(1), torch.ones(4), None, in_channels=8)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    import torch.utils.cpp_extension as cpp
    monkeypatch.setattr(cpp, 'CUDA_HOME', None)
    monkeypatch.setenv('PATH', str(tmp_path))
    monkeypatch.setattr(_build, 'BUILD_ROOT', tmp_path / 'build')
    with pytest.raises(RuntimeError, match='nvcc not found'):
        _build.build(['xnor'])
    assert not (tmp_path / 'build').exists()
