"""Parity of the port's packed xnor QResNet serving forward with JAX's.

A small xnor QResNet (7x7/s2/p3 stem, 3x3/s2/p1 max pool so the pool
kernel's path runs, 8 stem channels, one block per stage, 32x32 input,
10 classes, batch 4) is initialised in JAX with non-trivial BN affines
(negative gammas included) and tracked EMA scales, then exported, folded
and stripped by quant_tpu. The port loads the same tree through
from_jax_variables; it also prepares its own artifact from the unstripped
tree, which must equal JAX's leaf by leaf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quant_tpu.nn import QResNet as JQResNet
from quant_tpu.nn import export as jexport
from quant_tpu_torch.nn import export as texport
from quant_tpu_torch.nn.layers import QuantConv2d
from quant_tpu_torch.nn.resnet import QResNet
from quant_tpu_torch.utils.jax_import import from_jax_variables

LAYER = {'x_quant': 'ls-1', 'w_quant': 'ls-1',
         'clamp': {'kind': 'symmetric', 'alpha': 2.0},
         'double_shortcut': True}
CONFIG = dict(
    block='xnor',
    layer0={'n_in_channels': 8, 'kernel_size': 7, 'stride': 2,
            'padding': 3, 'bias': False,
            'maxpool': {'type': 'maxpool2d', 'kernel_size': 3,
                        'stride': 2, 'padding': 1}},
    layer1=dict(LAYER), layer2=dict(LAYER), layer3=dict(LAYER),
    layer4=dict(LAYER), nonlins=['prelu', 'prelu'], num_blocks=[1, 1, 1, 1],
    output_classes=10, moving_average_mode='eval_only')
BATCH = 4

# fp32 chain: the 16 binary convs, sign planes and pool are exact; the
# stem conv, BN and head sum in another order in XLA and torch (float32
# rounding, ~1e-6 relative), which reaches the logits through the scale
# epilogues and could at worst flip a sign sitting on a threshold.
FP32_TOL = dict(rtol=1e-4, atol=1e-4)
# bf16 chain: the reference is JAX's op-by-op apply, which rounds to
# bf16 after every op as torch does (under jit XLA fuses ops and skips
# intermediate roundings, a different bf16 program). The two may still
# accumulate the bf16 stem and 1x1 shortcut convs in another order before
# rounding; a 1-ulp bf16 difference (2^-8 relative) can flip an
# activation sitting on a threshold and move its dots by 2. So the
# logits are held to about bf16 resolution of their size (~3 here).
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _perturb(variables, rng):
    """Non-trivial BN affines/stats (including NEGATIVE gammas, which
    flip the fold's per-channel sign) and tracked scales (as
    tests/nn/test_xnor_fold.py does)."""
    def params_fn(path, leaf):
        names = [getattr(p, 'key', '') for p in path]
        if 'bn' in names and names[-1] == 'scale':
            mag = rng.uniform(0.3, 1.5, leaf.shape)
            sgn = np.where(rng.random(leaf.shape) < 0.3, -1.0, 1.0)
            return jnp.asarray(mag * sgn, leaf.dtype)
        if 'bn' in names and names[-1] == 'bias':
            return jnp.asarray(rng.uniform(-0.8, 0.8, leaf.shape),
                               leaf.dtype)
        return leaf

    def stats_fn(path, leaf):
        names = [getattr(p, 'key', '') for p in path]
        if names[-1] == 'mean':
            return jnp.asarray(rng.uniform(-0.5, 0.5, leaf.shape),
                               leaf.dtype)
        return jnp.asarray(rng.uniform(0.2, 2.0, leaf.shape), leaf.dtype)

    def quant_fn(path, leaf):
        names = [getattr(p, 'key', '') for p in path]
        if names[-1] == 'ema_count':
            return jnp.ones_like(leaf)
        return jnp.asarray(rng.uniform(0.1, 0.9, leaf.shape), leaf.dtype)

    out = dict(variables)
    out['params'] = jax.tree_util.tree_map_with_path(
        params_fn, variables['params'])
    out['batch_stats'] = jax.tree_util.tree_map_with_path(
        stats_fn, variables['batch_stats'])
    out['quant_state'] = jax.tree_util.tree_map_with_path(
        quant_fn, variables['quant_state'])
    return out


@pytest.fixture(scope='module')
def jax_side():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((BATCH, 32, 32, 3)).astype(np.float32)
    model = JQResNet(**CONFIG)
    # jit only to compile each JAX program once (eager flax dispatch
    # compiles op by op and takes tens of seconds); the math is the same.
    init = jax.jit(lambda k, v: model.init(k, v, True))
    variables = _perturb(init(jax.random.key(0), jnp.asarray(x[:2])), rng)
    packed = model.clone(inference_mode='packed')
    pvars = jax.jit(lambda v, s: jexport.export_packed_variables(
        packed, v, s))(variables, jnp.asarray(x[:1]))
    serve, fvars, folded = jexport.fold_for_serving(packed, pvars)
    assert folded
    svars = jexport.strip_for_deployment(fvars)

    def apply(m, v):
        return jax.jit(lambda t, u: m.apply(t, u, False))(v, jnp.asarray(x))

    logits = {
        'fp32': apply(serve, svars),
        'bf16': serve.clone(eval_dtype=jnp.bfloat16,
                            sign_compute='int8').apply(
                                svars, jnp.asarray(x), False),
        'unfolded': apply(packed, pvars),
    }
    return dict(x=x, variables=_numpy_tree(variables),
                pvars=_numpy_tree(pvars), fvars=_numpy_tree(fvars),
                svars=_numpy_tree(svars),
                logits={k: np.asarray(v) for k, v in logits.items()})


def _port(tree, **kw):
    model = QResNet(**{**CONFIG, **kw}, device='cpu')
    return from_jax_variables(model, tree)


def _logits(model, x):
    return model(torch.from_numpy(x)).numpy()


def test_serving_forward_matches_jax_fp32(jax_side):
    model = _port(jax_side['svars'], bn_fold=True)
    got = _logits(model, jax_side['x'])
    assert got.shape == (BATCH, 10) and got.dtype == np.float32
    np.testing.assert_allclose(got, jax_side['logits']['fp32'], **FP32_TOL)


def test_serving_forward_matches_jax_bf16(jax_side):
    model = _port(jax_side['svars'], bn_fold=True, eval_dtype='bfloat16')
    got = _logits(model, jax_side['x'])
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, jax_side['logits']['bf16'], **BF16_TOL)


def test_unfolded_packed_forward_matches_jax(jax_side):
    model = _port(jax_side['pvars'])
    np.testing.assert_allclose(_logits(model, jax_side['x']),
                               jax_side['logits']['unfolded'], **FP32_TOL)


def test_port_artifact_equals_jax_leaf_by_leaf(jax_side):
    model = _port(jax_side['variables'])
    assert all(c.w_packed is None for c in model.modules()
               if isinstance(c, QuantConv2d))
    texport.export_packed_variables(model)
    texport.fold_xnor_thresholds(model)
    got = jax.tree.map(lambda t: t.numpy(),
                       texport.packed_params_tree(model))
    want = jax_side['fvars']['packed_params']
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(want)):
        assert g.dtype == w.dtype, path
        np.testing.assert_array_equal(g, w, err_msg=str(path))


def test_port_prepared_artifact_serves_like_jax(jax_side):
    model = _port(jax_side['variables'])
    texport.export_packed_variables(model)
    model, folded = texport.fold_for_serving(model)
    assert folded and model.bn_fold
    texport.strip_for_deployment(model)
    assert all(c.kernel is None and c.w_vs is None
               for c in model.modules() if isinstance(c, QuantConv2d))
    np.testing.assert_allclose(_logits(model, jax_side['x']),
                               jax_side['logits']['fp32'], **FP32_TOL)


def test_fold_mismatch_raises_both_ways(jax_side):
    folded = _port(jax_side['svars'])  # folded tree, bn_fold off
    with pytest.raises(ValueError, match='bn_fold=True'):
        folded(torch.from_numpy(jax_side['x']))
    unfolded = _port(jax_side['pvars'], bn_fold=True)
    with pytest.raises(ValueError, match='x_thresh'):
        unfolded(torch.from_numpy(jax_side['x']))


def test_fold_guards_raise_as_jax(jax_side):
    x = jnp.asarray(jax_side['x'][:1])
    packed = JQResNet(**CONFIG).clone(inference_mode='packed')
    export = jax.jit(lambda v, s: jexport.export_packed_variables(
        packed, v, s))

    def both_raise(tree, match):
        with pytest.raises(ValueError, match=match):
            jexport.fold_xnor_thresholds(packed, tree)
        model = _port(tree)
        texport.export_packed_variables(model)
        with pytest.raises(ValueError, match=match):
            texport.fold_xnor_thresholds(model)
        assert texport.fold_for_serving(model) == (model, False)

    zero_gamma = jax.tree.map(np.copy, jax_side['variables'])
    zero_gamma['params']['layer2_block0']['bn1']['bn']['scale'][3] = 0.0
    both_raise(export(zero_gamma, x),
               'zero channel')
    untracked = jax.tree.map(np.copy, jax_side['variables'])
    qs = untracked['quant_state']['layer1_block0']['conv2']['x_quantizer']
    qs['ema_count'] = np.zeros((), np.int32)
    both_raise(export(untracked, x),
               'tracked no batches')


def test_fold_requires_ema_mode_and_packed(jax_side):
    model = _port(jax_side['variables'])
    with pytest.raises(ValueError, match='export_packed_variables'):
        texport.fold_xnor_thresholds(model)
    with pytest.raises(ValueError, match='export_packed_variables'):
        texport.strip_for_deployment(model)
    off = QResNet(**{**CONFIG, 'moving_average_mode': 'off'}, device='cpu')
    texport.export_packed_variables(off)
    with pytest.raises(ValueError, match='EMA'):
        texport.fold_xnor_thresholds(off)
    conv = QuantConv2d(8, 4, 3, padding=1, moving_average_mode='off')
    conv.x_thresh, conv.x_flip = torch.zeros(8), torch.ones(8)
    with pytest.raises(ValueError, match='EMA activation scales'):
        conv(torch.zeros(1, 4, 4, 8), bn_folded=True)


def test_per_batch_least_squares_scales_serve_as_jax(jax_side):
    """moving_average_mode 'off' with ls-2 (layer2) and ls-T (layer3)
    activations: every sample's scales solved with opt_v1 on both sides,
    the packed unfolded forward within FP32_TOL of JAX's."""
    cfg = {**CONFIG, 'layer2': dict(LAYER, x_quant='ls-2'),
           'layer3': dict(LAYER, x_quant='ls-T'),
           'moving_average_mode': 'off'}
    tree = jax.tree.map(np.copy, jax_side['variables'])
    for node in tree['quant_state'].values():
        for conv in node.values():
            conv.pop('x_quantizer')  # no EMA state in mode 'off'
    packed = JQResNet(**cfg).clone(inference_mode='packed')
    want = jax.jit(lambda v, a: packed.apply(v, a, False))(
        tree, jnp.asarray(jax_side['x']))
    model = from_jax_variables(QResNet(**cfg, device='cpu'), tree)
    np.testing.assert_allclose(_logits(model, jax_side['x']),
                               np.asarray(want), **FP32_TOL)


def test_unknown_block_and_route_raise():
    """A block family or a sign_compute route that does not exist
    raises."""
    with pytest.raises(ValueError, match='not supported'):
        QResNet(**{**CONFIG, 'block': 'bogus'}, device='cpu')
    with pytest.raises(ValueError, match='sign_compute'):
        QuantConv2d(8, 4, 3, sign_compute='fp8')


def test_from_jax_variables_checks_leaves(jax_side):
    broken = jax.tree.map(np.copy, jax_side['svars'])
    del broken['batch_stats']['layer3_block0']['bn2']
    with pytest.raises(KeyError, match='layer3_block0/bn2'):
        _port(broken)
    wrong = jax.tree.map(np.copy, jax_side['svars'])
    wrong['params']['fc']['bias'] = np.zeros(11, np.float32)
    with pytest.raises(ValueError, match='fc/bias'):
        _port(wrong)
    with pytest.raises(ValueError, match='config mismatch'):
        _port(jax_side['svars'], moving_average_mode='off')
