"""Per-batch activation scales (moving_average_mode 'off') and the EMA
calibration pass of the port's models, held against quant_tpu's.

A small XNOR ResNet (probes.models.small_config: width 8, one block a
stage, 32 px) with ls-2 activations and a LeNet-5 (8 and 12 filters, 28
px) with ls-T activations are built and seeded by the port, in mode
'off', and handed to JAX as a variable tree. Their packed forwards solve
every sample's scales with opt_v1 on both sides; calibrate_ema_scales
then blends four seeded batches into EMA scales on both sides, and the
calibrated model is folded and served.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quant_tpu.nn import QLeNet5 as JQLeNet5
from quant_tpu.nn import QResNet as JQResNet
from quant_tpu.nn import export as jexport
from quant_tpu.nn.layers import ActivationQuantizer as JActivationQuantizer
from quant_tpu_torch.nn import export as texport
from quant_tpu_torch.nn.layers import ActivationQuantizer
from quant_tpu_torch.probes.models import build, seed_state, small_config
from quant_tpu_torch.utils.jax_import import to_jax_variables

# fp32 logits: the binary dots are exact on both sides; opt_v1's
# cumsum, the stem, BN and head sum in another order (a few float32 ulps
# relative), which reaches the logits through the scale epilogues.
FP32_TOL = dict(rtol=1e-4, atol=1e-4)
# EMA leaves after four batches: each batch's solved scales within a few
# ulps of JAX's (tests/test_torch_port_optimal.py), blended at momentum
# 0.99, through layers whose inputs carry the same rounding (seen:
# <= 2.4e-7 absolute).
EMA_TOL = dict(rtol=1e-5, atol=1e-6)
# Folded against unfolded serving of one calibrated model (the JAX
# package's fold tests hold the two to 2e-4).
FOLD_TOL = dict(rtol=2e-4, atol=2e-4)
# id: (family, x_quant, w_quant)
CASES = {'xnor-ls2-ls1': ('xnor', 'ls-2', 'ls-1'),
         'lenet-lsT-ls1': ('lenet', 'ls-T', 'ls-1')}


def _shape(family: str, n: int) -> tuple:
    return (n, 28, 28, 1) if family == 'lenet' else (n, 32, 32, 3)


def _jax_model(family: str, cfg: dict, **kw):
    return (JQLeNet5 if family == 'lenet' else JQResNet)(**{**cfg, **kw})


def _tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope='module')
def prepared():
    """Per case, built once: the seeded 'off' port model, its JAX tree,
    the input, the calibration batches, and JAX's calibrated tree."""
    cache = {}

    def get(case: str) -> dict:
        if case not in cache:
            family, xq, wq = CASES[case]
            cfg = dict(small_config(family, xq, wq),
                       moving_average_mode='off')
            gen = torch.Generator().manual_seed(0)
            model = build(family, cfg, device='cpu', generator=gen)
            seed_state(model, gen)
            variables = to_jax_variables(model)
            rng = np.random.default_rng(1)
            batches = [rng.standard_normal(_shape(family, 3)).astype(
                np.float32) for _ in range(4)]
            jm = _jax_model(family, cfg, inference_mode='packed')
            calibrated = jax.jit(
                lambda v, bs: jexport.calibrate_ema_scales(jm, v, bs))(
                    variables, [jnp.asarray(b) for b in batches])
            cache[case] = dict(
                family=family, cfg=cfg, model=model, variables=variables,
                x=np.random.default_rng(0).standard_normal(
                    _shape(family, 2)).astype(np.float32),
                batches=batches, jax_model=jm,
                jax_calibrated=_tree(calibrated))
        return cache[case]
    return get


@pytest.mark.parametrize('case', list(CASES))
def test_per_batch_scales_forward_matches_jax(prepared, case):
    p = prepared(case)
    want = np.asarray(jax.jit(lambda v, a: p['jax_model'].apply(v, a, False))(
        p['variables'], jnp.asarray(p['x'])))
    got = p['model'](torch.from_numpy(p['x'])).numpy()
    np.testing.assert_allclose(got, want, **FP32_TOL)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, np.asarray(tree)


@pytest.mark.parametrize('case', list(CASES))
def test_calibrate_ema_scales_matches_jax(prepared, case):
    """The EMA leaves and ema_count of every activation quantizer; the
    model handed in is left as it was."""
    p = prepared(case)
    twin = texport.calibrate_ema_scales(p['model'], p['batches'])
    got = dict(_leaves(to_jax_variables(twin)['quant_state']))
    want = dict(_leaves(p['jax_calibrated']['quant_state']))
    assert got.keys() == want.keys()
    counts = [k for k in want if k[-1] == 'ema_count']
    assert counts and all(int(want[k]) == 4 for k in counts)
    for key, leaf in want.items():
        if key[-1] == 'ema_count':
            np.testing.assert_array_equal(got[key], leaf, err_msg=key)
        else:
            np.testing.assert_allclose(got[key], leaf, err_msg=key,
                                       **EMA_TOL)
    assert p['model'].moving_average_mode == 'off'
    assert all(not q.calibrate and q.ema is None
               for q in p['model'].modules()
               if isinstance(q, ActivationQuantizer))
    assert all(not q.calibrate for q in twin.modules()
               if isinstance(q, ActivationQuantizer))


@pytest.mark.parametrize('case', list(CASES))
def test_calibrated_model_folds_and_serves(prepared, case):
    """The calibrated twin folds its thresholds and serves stripped,
    against its own unfolded forward and against JAX's calibrated,
    exported, folded and stripped model."""
    p = prepared(case)
    x = torch.from_numpy(p['x'])
    twin = texport.calibrate_ema_scales(p['model'], p['batches'])
    unfolded = twin(x).numpy()
    texport.export_packed_variables(twin)
    model, folded = texport.fold_for_serving(twin)
    assert folded and model.bn_fold
    texport.strip_for_deployment(model)
    got = model(x).numpy()
    np.testing.assert_allclose(got, unfolded, **FOLD_TOL)

    jm = _jax_model(p['family'], p['cfg'], inference_mode='packed',
                    moving_average_mode='eval_only')
    pvars = jax.jit(lambda v, a: jexport.export_packed_variables(jm, v, a))(
        p['jax_calibrated'], jnp.asarray(p['x'][:1]))
    serve, fvars, jfolded = jexport.fold_for_serving(jm, pvars)
    assert jfolded
    svars = jexport.strip_for_deployment(fvars)
    want = np.asarray(jax.jit(lambda v, a: serve.apply(v, a, False))(
        svars, jnp.asarray(p['x'])))
    np.testing.assert_allclose(got, want, **FP32_TOL)


@pytest.mark.parametrize('scheme', ['ls-2', 'ls-T', 'gf-2'])
def test_observer_returns_the_blended_scales(scheme):
    """Two observer forwards of one quantizer: the first batch's mean
    scales are copied, the second blended at momentum 0.9, and each
    forward returns the blended scales over its batch, as JAX's."""
    rng = np.random.default_rng(3)
    xs = [rng.standard_normal((3, 4, 4, 5)).astype(np.float32) * s
          for s in (1.0, 2.0)]
    quant = ActivationQuantizer(scheme, 'eval_only',
                                moving_average_momentum=0.9, calibrate=True)
    jq = JActivationQuantizer(scheme, 'eval_only',
                              moving_average_momentum=0.9, calibrate=True)
    state = jq.init(jax.random.key(0), jnp.asarray(xs[0]), False)
    observe = jax.jit(lambda s, a: jq.apply(s, a, False, return_scales=True,
                                            mutable=['quant_state']))
    for x in xs:
        (_, jvs), state = observe(state, jnp.asarray(x))
        vs = quant(torch.from_numpy(x))
        np.testing.assert_allclose(vs.numpy(), np.asarray(jvs), **EMA_TOL)
        np.testing.assert_allclose(quant.ema.numpy(), np.asarray(
            state['quant_state']['ema']), **EMA_TOL)
    assert int(quant.ema_count) == 2
    assert int(state['quant_state']['ema_count']) == 2


def test_calibration_errors():
    """Observer mode without EMA state raises, as does an empty batch
    iterable (the model's EMA would stay untracked)."""
    x = torch.zeros(2, 4, 4, 8)
    with pytest.raises(ValueError, match='EMA moving_average_mode'):
        ActivationQuantizer('ls-2', 'off', calibrate=True)(x)
    cfg = dict(small_config('lenet', 'ls-2', 'ls-1'),
               moving_average_mode='off')
    model = build('lenet', cfg, device='cpu', calibrate=True)
    with pytest.raises(ValueError, match='EMA moving_average_mode'):
        model(torch.zeros(1, 28, 28, 1))
    with pytest.raises(ValueError, match='empty batch'):
        texport.calibrate_ema_scales(model, iter(()))
