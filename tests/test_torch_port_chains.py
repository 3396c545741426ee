"""The port's bf16 serving chains and dense fp32 forwards against JAX.

bf16 chains: the reference is JAX's op-by-op apply, which rounds to bf16
after every op as PyTorch does (under jit XLA fuses ops and skips those
roundings: another bf16 program). Where every sign-plane conv takes the
int8 route, the XNOR and regular ResNet chains are equal to it: the
dots are integers, the epilogues the same float ops, and the stem,
shortcut and head convs at these widths round alike. LeNet-5's fp fc1
and fc2 are bf16 matmuls whose float32 sums run in another order than
XLA's dot, and the bake route's float32 conv sums do too: a sum that
lands on the other side of a bf16 rounding moves its output by one bf16
ulp (2^-8 relative), which can flip a later sign and move its dots by 2.
Those are held to about bf16 resolution of the logits (2e-2).

Dense fp32 forwards (inference_mode 'dense', JAX's fp32 twin of the
bench): every conv is a float32 conv of the quantized tensors; torch and
XLA sum in another order (float32 rounding, ~1e-6 relative).

The models are probes.models.small_config's, batch 2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quant_tpu.nn import export as jexport
from quant_tpu_torch.nn import export as texport
from quant_tpu.nn import QLeNet5 as JQLeNet5
from quant_tpu.nn import QResNet as JQResNet
from quant_tpu_torch.probes.models import build, seed_state
from quant_tpu_torch.probes.models import small_config as model_config
from quant_tpu_torch.serving.engine import InferenceEngine
from quant_tpu_torch.utils.jax_import import (
    from_jax_variables, to_jax_variables,
)

BF16_TOL = dict(rtol=2e-2, atol=2e-2)
FP32_TOL = dict(rtol=1e-4, atol=1e-4)
BATCH = 2


def port_model(family, cfg, **kw):
    return build(family, cfg, device='cpu', **kw)


def jax_model(family, cfg, **kw):
    return (JQLeNet5 if family == 'lenet' else JQResNet)(**{**cfg, **kw})


def _input(family, seed=0):
    shape = (BATCH, 28, 28, 1) if family == 'lenet' else (BATCH, 32, 32, 3)
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jax_logits(model, variables, x):
    return np.asarray(jax.jit(lambda v, a: model.apply(v, a, False))(
        variables, jnp.asarray(x)))


def _seeded(family, cfg, seed=0, **kw):
    gen = torch.Generator().manual_seed(seed)
    model = port_model(family, cfg, generator=gen, **kw)
    seed_state(model, gen)
    return model


def _served(family, x_quant, w_quant, sign_compute):
    """JAX's folded, stripped tree of a seeded small model, the JAX
    serving model in bf16 and the port model that loads the tree."""
    cfg = model_config(family, x_quant, w_quant)
    cfg['sign_compute'] = sign_compute
    variables = to_jax_variables(_seeded(family, cfg))
    x = _input(family)
    packed = jax_model(family, cfg, inference_mode='packed')
    pvars = jax.jit(lambda v, s: jexport.export_packed_variables(
        packed, v, s))(variables, jnp.asarray(x[:1]))
    serve, fvars, folded = jexport.fold_for_serving(packed, pvars)
    svars = jax.tree.map(np.asarray, jexport.strip_for_deployment(fvars))
    want = np.asarray(serve.clone(eval_dtype=jnp.bfloat16).apply(
        svars, jnp.asarray(x), False))
    model = from_jax_variables(
        port_model(family, cfg, bn_fold=folded, eval_dtype='bfloat16'),
        svars)
    return model, x, want


@pytest.mark.parametrize('family,x_quant,w_quant,sign_compute', [
    ('xnor', 'ls-T', 'ls-1', 'auto'),
    ('xnor', 'ls-2', 'ls-1', 'int8'),
    ('xnor', 'gf-3', 'ls-T', 'int8'),
    ('regular', 'ls-1', 'ls-1', 'auto'),
])
def test_bf16_int8_chain_equals_jax_op_by_op(family, x_quant, w_quant,
                                              sign_compute):
    model, x, want = _served(family, x_quant, w_quant, sign_compute)
    got = model(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('family,x_quant,w_quant,sign_compute', [
    ('xnor', 'ls-2', 'ls-1', 'auto'),     # the bake
    ('xnor', 'gf-2', 'ls-1', 'bf16'),
    ('lenet', 'ls-T', 'ls-1', 'auto'),    # int8 route, bf16 fc layers
    ('lenet', 'ls-2', 'ls-1', 'auto'),
])
def test_bf16_chain_matches_jax_op_by_op(family, x_quant, w_quant,
                                         sign_compute):
    model, x, want = _served(family, x_quant, w_quant, sign_compute)
    got = model(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **BF16_TOL)


@pytest.mark.parametrize('family,x_quant,w_quant', [
    ('xnor', 'fp', 'fp'), ('regular', 'fp', 'fp'),
    ('regular_bottleneck', 'fp', 'fp'), ('xnor_bottleneck', 'fp', 'fp'),
    ('lenet', 'fp', 'fp'), ('xnor', 'ls-2', 'ls-1'),
    ('regular', 'gf-2', 'ls-T')])
def test_dense_fp32_forward_matches_jax(family, x_quant, w_quant):
    """inference_mode 'dense': the fp32 twin (fp x fp) and the dense eval
    forward of quantized schemes (cached weight and EMA scales)."""
    cfg = model_config(family, x_quant, w_quant)
    model = _seeded(family, cfg, inference_mode='dense')
    x = _input(family)
    want = _jax_logits(jax_model(family, cfg, inference_mode='dense'),
                       to_jax_variables(model), x)
    got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **FP32_TOL)


def test_dense_bf16_chain_raises_as_jax():
    """A bf16 chain into a dense conv of float32 weights: JAX's conv
    refuses operands of two dtypes, and so does the port's."""
    cfg = model_config('xnor', 'fp', 'fp')
    model = port_model('xnor', cfg, inference_mode='dense',
                       eval_dtype='bfloat16')
    with pytest.raises(TypeError, match='one dtype'):
        model(torch.zeros(1, 32, 32, 3))


def test_engine_serves_a_lenet():
    """InferenceEngine serves any model with an NHWC input: a folded
    LeNet-5's futures equal predict on the same batch."""
    cfg = model_config('lenet', 'ls-2', 'ls-1')
    model = _seeded('lenet', cfg)
    texport.export_packed_variables(model)
    model, folded = texport.fold_for_serving(model)
    assert folded
    images = _input('lenet', seed=3)
    engine = InferenceEngine(model, (28, 28, 1), max_batch=BATCH,
                             device='cpu')
    futures = [engine.submit(img) for img in images]
    engine.start()
    try:
        got = np.stack([f.result(timeout=60) for f in futures])
    finally:
        engine.stop()
    np.testing.assert_allclose(got, engine.predict(images), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got, model(torch.from_numpy(images)).numpy(),
                               rtol=1e-6, atol=1e-6)
