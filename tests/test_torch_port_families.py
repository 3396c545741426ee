"""Parity of the port's model families with JAX's serving preparation.

Each case is a small model (probes.models.small_config: width 8, one
block a stage, 32 px, 10 classes, batch 2; LeNet-5 at 28 px with 8 and
12 filters) of one family and scheme pair. The port builds it from a
seed (probes.models.seed_state: negative BN gammas, cached weight
scales, a distinct EMA scale per plane)
and hands its state to JAX as a variable tree (to_jax_variables). Then
both sides export, fold and strip, and must agree: the packed leaves
equal, the fold chosen the same, the fp32 logits within float32
rounding. The int8-route dots are exact on both sides; the stem, BN,
shortcut and head convs sum in another order (~1e-6 relative), which
reaches the logits through the scale epilogues.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quant_tpu.nn import QLeNet5 as JQLeNet5
from quant_tpu.nn import QResNet as JQResNet
from quant_tpu.nn import export as jexport
from quant_tpu_torch.nn import export as texport
from quant_tpu_torch.probes.models import build, seed_state
from quant_tpu_torch.probes.models import small_config as model_config
from quant_tpu_torch.utils.jax_import import (
    from_jax_variables, to_jax_variables,
)

FP32_TOL = dict(rtol=1e-4, atol=1e-4)
# Folded against unfolded serving of one model: the fold moves BN into
# thresholds or the epilogue, which rounds differently in float32 (the
# JAX package's own fold tests hold the two to 2e-4).
FOLD_TOL = dict(rtol=2e-4, atol=2e-4)
BATCH = 2
# id: (family, x_quant, w_quant, the fold fold_for_serving applies).
CASES = {
    'xnor-lsT-ls1': ('xnor', 'ls-T', 'ls-1', 'x_thresh'),
    'xnor-ls2-ls1': ('xnor', 'ls-2', 'ls-1', 'x_thresh'),
    'xnor-gf2-ls1': ('xnor', 'gf-2', 'ls-1', 'x_thresh'),
    'xnor-gf3-lsT': ('xnor', 'gf-3', 'ls-T', 'x_thresh'),
    'xnor-ls1-ls2': ('xnor', 'ls-1', 'ls-2', 'x_thresh'),
    'xnor-fp-ls1': ('xnor', 'fp', 'ls-1', None),
    'regular-ls1-ls1': ('regular', 'ls-1', 'ls-1', 'b_fold'),
    'regular_bottleneck-ls2-ls1': ('regular_bottleneck', 'ls-2', 'ls-1',
                                   'b_fold'),
    'xnor_bottleneck-lsT-ls2': ('xnor_bottleneck', 'ls-T', 'ls-2',
                                'x_thresh'),
    'lenet-ls2-ls1': ('lenet', 'ls-2', 'ls-1', 'x_thresh'),
    'lenet-lsT-ls1': ('lenet', 'ls-T', 'ls-1', 'x_thresh'),
}


def port_model(family: str, cfg: dict, **kw) -> torch.nn.Module:
    return build(family, cfg, device='cpu', **kw)


def jax_model(family: str, cfg: dict, **kw):
    cls = JQLeNet5 if family == 'lenet' else JQResNet
    return cls(**{**cfg, **kw})


def _input(family: str, seed: int = 0) -> np.ndarray:
    shape = (BATCH, 28, 28, 1) if family == 'lenet' else (BATCH, 32, 32, 3)
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _jax_logits(model, variables, x):
    return np.asarray(jax.jit(lambda v, a: model.apply(v, a, False))(
        variables, jnp.asarray(x)))


@pytest.fixture(scope='module')
def prepared():
    """Per case, built once: the seeded port model's tree and JAX's
    exported (pvars), folded (fvars) and stripped (svars) trees with
    their fp32 logits."""
    cache = {}

    def get(case: str) -> dict:
        if case in cache:
            return cache[case]
        family, xq, wq, _ = CASES[case]
        cfg = model_config(family, xq, wq)
        gen = torch.Generator().manual_seed(0)
        model = port_model(family, cfg, generator=gen)
        seed_state(model, gen)
        variables = to_jax_variables(model)
        x = _input(family)
        packed = jax_model(family, cfg, inference_mode='packed')
        pvars = jax.jit(lambda v, s: jexport.export_packed_variables(
            packed, v, s))(variables, jnp.asarray(x[:1]))
        serve, fvars, folded = jexport.fold_for_serving(packed, pvars)
        svars = jexport.strip_for_deployment(fvars)
        cache[case] = dict(
            family=family, cfg=cfg, x=x, variables=variables,
            pvars=_numpy_tree(pvars), fvars=_numpy_tree(fvars),
            svars=_numpy_tree(svars), folded=folded,
            logits=_jax_logits(serve, svars, x),
            unfolded=_jax_logits(packed, pvars, x))
        return cache[case]
    return get


def _forward(model, x):
    return model(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize('case', list(CASES))
def test_port_artifact_equals_jax_leaf_by_leaf(prepared, case):
    """The port's own export and fold_for_serving give JAX's leaves
    (w_packed with a plane axis, w_scales, and x_thresh/x_flip/x_va or
    b_fold, whichever fold the family takes), exactly."""
    p = prepared(case)
    fold_leaf = CASES[case][3]
    model = from_jax_variables(port_model(p['family'], p['cfg']),
                               p['variables'])
    texport.export_packed_variables(model)
    model, folded = texport.fold_for_serving(model)
    assert folded == p['folded'] and model.bn_fold == folded
    got = jax.tree.map(lambda t: t.numpy(),
                       texport.packed_params_tree(model))
    want = p['fvars']['packed_params']
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(want)):
        assert g.dtype == w.dtype, path
        np.testing.assert_array_equal(g, w, err_msg=str(path))
    names = {path[-1].key for path, _ in
             jax.tree_util.tree_leaves_with_path(got)}
    for leaf in ('x_thresh', 'b_fold'):
        assert (leaf in names) == (leaf == fold_leaf), leaf


@pytest.mark.parametrize('case', list(CASES))
def test_serving_forward_matches_jax_fp32(prepared, case):
    """JAX's stripped serving tree loaded into the port (the fold flag as
    fold_for_serving set it) serves JAX's logits."""
    p = prepared(case)
    model = from_jax_variables(
        port_model(p['family'], p['cfg'], bn_fold=p['folded']), p['svars'])
    got = _forward(model, p['x'])
    assert got.shape == (BATCH, 10) and got.dtype == np.float32
    np.testing.assert_allclose(got, p['logits'], **FP32_TOL)
    unfolded = from_jax_variables(port_model(p['family'], p['cfg']),
                                  p['pvars'])
    np.testing.assert_allclose(_forward(unfolded, p['x']), p['unfolded'],
                               **FP32_TOL)
    np.testing.assert_allclose(got, _forward(unfolded, p['x']), **FOLD_TOL)


@pytest.mark.parametrize('case', list(CASES))
def test_packed_weight_bytes_match_jax(prepared, case):
    p = prepared(case)
    for tree, fold in (('fvars', p['folded']), ('svars', p['folded'])):
        model = from_jax_variables(
            port_model(p['family'], p['cfg'], bn_fold=fold), p[tree])
        assert texport.packed_weight_bytes(model) == tuple(
            jexport.packed_weight_bytes(p[tree])), tree


@pytest.mark.parametrize('case,ema', [
    ('xnor-ls2-ls1', (2.5, 0.3)), ('xnor-gf3-lsT', (1.5, 0.8, 0.1)),
    ('lenet-ls2-ls1', (2.5, 0.3))])
def test_threshold_fold_refuses_a_prefix_sum_over_alpha(prepared, case,
                                                        ema):
    """A residual plane leaves the clamp box when an EMA prefix sum
    exceeds alpha (2 for the ResNets): both folds raise, and
    fold_for_serving serves the model unfolded. LeNet's identity clamp
    has no box, so there the fold holds."""
    p = prepared(case)
    tree = jax.tree.map(np.copy, p['pvars'])
    node = (tree['quant_state']['conv2'] if p['family'] == 'lenet'
            else tree['quant_state']['layer2_block0']['conv1'])
    node['x_quantizer']['ema'] = np.asarray(ema, np.float32)
    packed = jax_model(p['family'], p['cfg'], inference_mode='packed')
    model = from_jax_variables(port_model(p['family'], p['cfg']), tree)
    if p['family'] == 'lenet':
        jexport.fold_xnor_thresholds(packed, tree)
        texport.fold_xnor_thresholds(model)
        return
    with pytest.raises(ValueError, match='exceed clamp alpha'):
        jexport.fold_xnor_thresholds(packed, tree)
    with pytest.raises(ValueError, match='exceed clamp alpha'):
        texport.fold_xnor_thresholds(model)
    assert texport.fold_for_serving(model) == (model, False)
    assert all(m.x_thresh is None for m in model.modules()
               if hasattr(m, 'x_thresh'))


def test_fold_for_serving_keeps_jax_order():
    """A regular model takes the epilogue fold; an xnor one, where that
    fold is undefined, the threshold fold; an xnor one without EMA
    scales neither."""
    for family, mode, want in (('regular', 'eval_only', 'b_fold'),
                               ('xnor', 'eval_only', 'x_thresh'),
                               ('xnor', 'off', None)):
        cfg = model_config(family, 'ls-1', 'ls-1')
        cfg['moving_average_mode'] = mode
        gen = torch.Generator().manual_seed(1)
        model = port_model(family, cfg, generator=gen)
        seed_state(model, gen)
        texport.export_packed_variables(model)
        model, folded = texport.fold_for_serving(model)
        assert folded == (want is not None)
        conv = model.layer1_block0.conv1
        assert (conv.b_fold is not None) == (want == 'b_fold')
        assert (conv.x_thresh is not None) == (want == 'x_thresh')


def test_bottleneck_blocks_as_jax():
    """The bottleneck families' widths and the xnor bottleneck's refusal
    of the double shortcut."""
    cfg = model_config('regular_bottleneck', 'ls-1', 'ls-1')
    model = port_model('regular_bottleneck', cfg)
    assert model.layer4_block0.conv3.features == 8 * 8 * 4
    assert model.fc.kernel.shape == (8 * 8 * 4, 10)
    cfg = model_config('xnor_bottleneck', 'ls-1', 'ls-1')
    cfg['layer2'] = dict(cfg['layer2'], double_shortcut=True)
    with pytest.raises(ValueError, match='double_shortcut'):
        port_model('xnor_bottleneck', cfg)


def test_copy_of_a_folded_model_serves_alike(prepared):
    """A deep copy keeps every packed buffer (the smoke run copies the
    CPU model to the card this way)."""
    p = prepared('xnor-lsT-ls1')
    model = from_jax_variables(port_model('xnor', p['cfg'], bn_fold=True),
                               p['svars'])
    np.testing.assert_array_equal(_forward(copy.deepcopy(model), p['x']),
                                  _forward(model, p['x']))
