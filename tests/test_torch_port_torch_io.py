"""The reference-checkpoint maps of the port (utils/torch_import.py,
utils/torch_export.py) held against quant_tpu's and against the
reference's own logits.

tests/data_oracle holds two apple/ml-quant models with warmed quantizer,
EMA and BN buffers: their state dicts, an input and the reference's
logits. Each is imported by both packages' maps, loaded into the port's
model (through utils.jax_import) and into JAX's, built as
tests/nn/test_torch_import.py builds them (chip_smoke.ORACLES, which the
card's oracle phase runs), and run on the same input. Bounds are those
of tests/nn/test_torch_import.py: 1e-3 dense, 5e-2 with equal argmax
packed (the ResNet on JAX's 'auto' route, the bf16 bake, and on
sign_compute='int8', the multi-plane int8 route).
"""

import jax
import numpy as np
import pytest
import torch

from chip_smoke import (
    ORACLE_DENSE_TOL, ORACLE_PACKED_TOL, ORACLES, load_oracle, oracle_model,
)
from quant_tpu.nn import QLeNet5 as JQLeNet5
from quant_tpu.nn import QResNet as JQResNet
from quant_tpu.utils import torch_export as jexport
from quant_tpu.utils import torch_import as jimport
from quant_tpu_torch.nn.lenet import QLeNet5
from quant_tpu_torch.utils import torch_export as texport
from quant_tpu_torch.utils import torch_import as timport
from quant_tpu_torch.utils.jax_import import to_jax_variables

# Bounds of tests/nn/test_torch_import.py:62,78,161.
DENSE_TOL = dict(rtol=ORACLE_DENSE_TOL, atol=ORACLE_DENSE_TOL)
PACKED_TOL = dict(rtol=ORACLE_PACKED_TOL, atol=ORACLE_PACKED_TOL)
# The port against JAX on one route: the binary dots are exact on both
# sides; the dense chains sum the stem, BN and head in another order (a
# few float32 ulps); the bake rounds its float32 conv to bf16 on both
# sides, where one ulp of input moves a bf16 rounding.
SAME_ROUTE_TOL = {('dense', 'auto'): dict(rtol=1e-5, atol=1e-5),
                  ('packed', 'int8'): dict(rtol=1e-5, atol=1e-5),
                  ('packed', 'auto'): dict(rtol=2e-2, atol=2e-2)}
# The BN batch counters, which the tree does not track: exported as 0.
_SYNTH = 'num_batches_tracked'


def _leaves(tree, prefix=''):
    if not isinstance(tree, dict):
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, f'{prefix}/{k}'))
    return out


def _assert_trees_equal(got: dict, want: dict) -> None:
    got, want = _leaves(got), _leaves(want)
    assert set(got) == set(want)
    for path, leaf in want.items():
        assert got[path].dtype == leaf.dtype, path
        np.testing.assert_array_equal(got[path], leaf, err_msg=path)


def _port_model(name: str, **kw) -> torch.nn.Module:
    """The oracle's model in the port (chip_smoke.oracle_model: the
    reference's state dict through the port's maps), on the CPU."""
    return oracle_model(name, 'cpu', **kw)


def _jax_model(name: str, x: np.ndarray, **kw) -> tuple[object, dict]:
    """The oracle's model in JAX, its tree through JAX's maps."""
    spec = ORACLES[name]
    cls = JQResNet if name == 'resnet' else JQLeNet5
    model = cls(**spec['config'], **kw)
    # Jitted: flax's eager init of the ResNet takes ~25 s on the CPU.
    variables = jax.jit(lambda v: model.init(jax.random.key(0), v, True))(
        x[:2])
    sd = load_oracle(name)[0]
    if name == 'resnet':
        imported = jimport.import_resnet_state_dict(
            sd, num_blocks=spec['num_blocks'])
    else:
        imported = jimport.import_lenet_state_dict(
            sd, conv2_filters=spec['conv2_filters'])
    return model, jimport.merge_imported(variables, imported)


def _forward(model: torch.nn.Module, x: np.ndarray) -> np.ndarray:
    with torch.no_grad():
        return model(torch.from_numpy(np.ascontiguousarray(x))).numpy()


@pytest.mark.parametrize('name', list(ORACLES))
def test_imported_tree_equals_jax_leaf_for_leaf(name):
    sd = load_oracle(name)[0]
    spec = ORACLES[name]
    if name == 'resnet':
        got = timport.import_resnet_state_dict(sd, spec['num_blocks'])
        want = jimport.import_resnet_state_dict(sd, spec['num_blocks'])
    else:
        got = timport.import_lenet_state_dict(sd, spec['conv2_filters'])
        want = jimport.import_lenet_state_dict(sd, spec['conv2_filters'])
    _assert_trees_equal(got, want)
    tsd = {k: torch.from_numpy(v) for k, v in sd.items()}
    _assert_trees_equal(timport.state_dict_to_numpy(tsd),
                        jimport.state_dict_to_numpy(tsd))


@pytest.mark.parametrize('name', list(ORACLES))
def test_merged_tree_has_jax_structure_and_the_imported_leaves(name):
    """merge_imported onto the port's variables and JAX's onto flax's
    init: the same paths, dtypes and shapes, and every leaf the state
    dict carries equal; the port's model then holds that tree."""
    model = _port_model(name, inference_mode='dense')
    _, jax_tree = _jax_model(name, load_oracle(name)[1])
    _assert_trees_equal(to_jax_variables(model),
                        jax.tree.map(np.asarray, jax_tree))


def test_merge_imported_refuses_a_shape_mismatch():
    model = QLeNet5(**ORACLES['lenet']['config'], device='cpu')
    imported = timport.import_lenet_state_dict(load_oracle('lenet')[0], 12)
    imported['params']['fc2']['bias'] = np.zeros(11, np.float32)
    with pytest.raises(ValueError, match='shape mismatch'):
        timport.merge_imported(to_jax_variables(model), imported)


@pytest.mark.parametrize('name,mode,sign_compute', [
    ('resnet', 'dense', 'auto'), ('resnet', 'packed', 'auto'),
    ('resnet', 'packed', 'int8'), ('lenet', 'dense', 'auto'),
    ('lenet', 'packed', 'auto')])
def test_oracle_logits(name, mode, sign_compute):
    _, x, ref = load_oracle(name)
    out = _forward(_port_model(name, inference_mode=mode,
                               sign_compute=sign_compute), x)
    np.testing.assert_allclose(out, ref, **(
        DENSE_TOL if mode == 'dense' else PACKED_TOL))
    np.testing.assert_array_equal(out.argmax(-1), ref.argmax(-1))
    jm, jvars = _jax_model(name, x, inference_mode=mode,
                           sign_compute=sign_compute)
    np.testing.assert_allclose(out, np.asarray(jm.apply(jvars, x, False)),
                               **SAME_ROUTE_TOL[mode, sign_compute])


def _assert_round_trip(oracle_sd: dict, exported: dict) -> None:
    assert set(exported) == set(oracle_sd)
    for k, v in exported.items():
        ref = oracle_sd[k]
        assert v.shape == ref.shape, k
        if k.endswith(_SYNTH) and 'moving_avg_module' not in k:
            continue  # BN counter: synthesized, value not recoverable
        np.testing.assert_array_equal(v, ref, err_msg=k)


@pytest.mark.parametrize('name', list(ORACLES))
def test_export_round_trip_and_equal_to_jax(name):
    """export(import(oracle)) from the port's model reproduces the
    reference's state dict, and equals JAX's export of the same tree."""
    tree = to_jax_variables(_port_model(name, inference_mode='dense'))
    spec = ORACLES[name]
    if name == 'resnet':
        got = texport.export_resnet_state_dict(tree, spec['num_blocks'],
                                               momentum=0.99)
        want = jexport.export_resnet_state_dict(tree, spec['num_blocks'],
                                                momentum=0.99)
    else:
        got = texport.export_lenet_state_dict(tree, spec['conv2_filters'],
                                              momentum=0.99)
        want = jexport.export_lenet_state_dict(tree, spec['conv2_filters'],
                                               momentum=0.99)
    _assert_round_trip(load_oracle(name)[0], got)
    _assert_trees_equal(got, want)


def test_export_dispatch_and_guards():
    tree = to_jax_variables(_port_model('lenet'))
    out = texport.export_state_dict('lenet5', tree, {'conv2_filters': 12})
    assert 'conv2.w_approximate.v1' in out
    _assert_trees_equal(out, jexport.export_state_dict(
        'lenet5', tree, {'conv2_filters': 12}))
    with pytest.raises(ValueError, match='bottleneck'):
        texport.export_state_dict('resnet', tree,
                                  {'block': 'xnor_bottleneck',
                                   'num_blocks': [1, 1, 1]})
    with pytest.raises(ValueError, match='not exportable'):
        texport.export_state_dict('vit', tree, {})


def test_export_mode_off_synthesizes_moving_avg_buffers():
    """A moving_average_mode 'off' model tracks no EMA state; the
    reference registers moving_avg_module buffers unconditionally, so
    the export synthesizes them, as JAX's does."""
    model = QLeNet5(conv1_filters=8, conv2_filters=12, x_quant='ls-2',
                    w_quant='ls-1', moving_average_mode='off', device='cpu')
    tree = to_jax_variables(model)
    cfg = {'conv2_filters': 12, 'x_quant': 'ls-2'}
    out = texport.export_state_dict('lenet5', tree, cfg)
    mam = 'conv2.x_approximate.moving_avg_module'
    assert out[f'{mam}.moving_average'].shape == (2,)  # k of ls-2
    assert out[f'{mam}.momentum'].shape == (2,)
    assert int(out[f'{mam}.num_batches_tracked']) == 0
    _assert_trees_equal(out, jexport.export_state_dict('lenet5', tree, cfg))


def test_export_missing_required_leaf_raises():
    tree = to_jax_variables(QLeNet5(**ORACLES['lenet']['config'],
                                    device='cpu'))
    del tree['params']['fc2']['bias']
    with pytest.raises(KeyError, match='fc2/bias'):
        texport.export_lenet_state_dict(tree, conv2_filters=12)


def test_export_stripped_conv_raises():
    tree = to_jax_variables(_port_model('resnet'))
    del tree['params']['layer1_block0']['conv1']['kernel']
    with pytest.raises(KeyError, match='stripped'):
        texport.export_resnet_state_dict(tree, num_blocks=[1, 1, 1])


def test_numpy_to_state_dict_round_trip(tmp_path):
    """The wrapped tensors survive torch.save / torch.load unchanged."""
    sd = load_oracle('lenet')[0]
    tsd = texport.numpy_to_state_dict(sd)
    torch.save(tsd, tmp_path / 'sd.pt')
    back = torch.load(tmp_path / 'sd.pt')
    for k, v in back.items():
        assert isinstance(v, torch.Tensor)
        np.testing.assert_array_equal(v.numpy(), sd[k])
