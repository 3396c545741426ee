"""The port's serving-artifact preparation (serving/prepare.py), its
worker specs and the serve driver, against the JAX package's.

A JAX experiment trained one epoch is handed to the port as a port
experiment (its config.yaml and its tree as a port checkpoint). From
it, the port's prepare_serving_artifact writes the leaves and the
serving.yaml of JAX's artifact (an XNOR ResNet with EMA scales:
threshold-folded, stripped), and, calibrated on the same batches, of a
LeNet-5 trained with per-batch scales; the served float32 logits are
JAX's within 1e-4. The 'experiment' and 'artifact' worker specs serve
on the CPU, the serve driver from a worker process and in process.
"""

import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from quant_tpu.experiment import Experiment as JExperiment
from quant_tpu.serving.prepare import (
    load_serving_artifact as jload, prepare_serving_artifact as jprepare,
)
from quant_tpu.train.task import classification_task as jtask
from quant_tpu.utils.checkpoints import restore_checkpoint as jrestore
from quant_tpu_torch.examples import serve
from quant_tpu_torch.serving import prepare
from quant_tpu_torch.serving.worker import build_engine_from_spec
from quant_tpu_torch.utils.checkpoints import (
    restore_checkpoint, save_checkpoint,
)

FP32_TOL = dict(rtol=1e-4, atol=1e-4)
# JAX's calibration blends each batch's solved scales into the EMA as
# the port's does; the solves' float32 reductions run in another order
# (the observer pass of tests/test_torch_port_calibrate.py), so the
# calibrated thresholds and scales agree to float32 rounding.
CALIBRATED_TOL = dict(rtol=1e-5, atol=1e-6)

QLAYER = {'x_quant': 'ls-1', 'w_quant': 'ls-1',
          'clamp': {'kind': 'symmetric', 'alpha': 2},
          'double_shortcut': True}
MODELS = {
    # The JAX prepare test's XNOR ResNet: EMA scales, threshold fold.
    'xnor': ({'architecture': 'resnet', 'loss': 'cross_entropy',
              'arch_config': {
                  'block': 'xnor', 'moving_average_mode': 'eval_only',
                  'layer0': {'n_in_channels': 4, 'kernel_size': 3,
                             'stride': 1, 'padding': 1, 'bias': False,
                             'maxpool': {'type': 'identity'}},
                  'layer1': dict(QLAYER), 'layer2': dict(QLAYER),
                  'layer3': dict(QLAYER), 'layer4': None,
                  'nonlins': ['prelu', 'prelu'], 'num_blocks': [1, 1, 1],
                  'output_classes': 10}}, (32, 32, 3)),
    # mnist_ls1.yaml's LeNet-5, narrow: per-batch scales ('off').
    'lenet': ({'architecture': 'lenet5', 'loss': 'nll_loss',
               'arch_config': {'moving_average_mode': 'off',
                               'x_quant': 'ls-1', 'w_quant': 'ls-1',
                               'clamp': {'kind': 'identity'},
                               'conv1_filters': 4, 'conv2_filters': 6,
                               'output_classes': 10}}, (28, 28, 1)),
}


def _train(tmp, name):
    model, shape = MODELS[name]
    cfg = {
        'seed': 11, 'environment': {'nchips': 1},
        'data': {'dataset': 'synthetic', 'train_batch_size': 16,
                 'test_batch_size': 16, 'train_size': 32, 'test_size': 16,
                 'image_shape': list(shape)},
        'model': model,
        'optimization': {'epochs': 1,
                         'optimizer': {'algorithm': 'sgd', 'lr': 0.05},
                         'lr_scheduler': {'scheduler': 'step_lr',
                                          'step_size': 1, 'gamma': 1.0}},
        'log': {'level': 'WARNING', 'interval': 100, 'save_model_freq': 1,
                'tensorboard': False,
                'root_experiments_dir': str(tmp / 'experiments')},
        'experiment_name': name,
    }
    JExperiment(jtask, cfg).run()
    jexp = tmp / 'experiments' / name
    # The same experiment for the port: its config.yaml, its tree as a
    # port checkpoint.
    texp = tmp / 'port' / name
    texp.mkdir(parents=True)
    shutil.copy(jexp / 'config.yaml', texp / 'config.yaml')
    tree = jrestore(jexp / 'checkpoints' / 'checkpoint_1')
    save_checkpoint(texp / 'checkpoints', {
        k: tree[k] for k in ('params', 'batch_stats', 'quant_state')}, 1)
    return jexp, texp, shape


@pytest.fixture(scope='module')
def xnor(tmp_path_factory):
    return _train(tmp_path_factory.mktemp('prep'), 'xnor')


def _leaves(tree, prefix=''):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f'{prefix}/{k}'))
        return out
    return {prefix: np.asarray(tree)}


def _images(shape, n=4, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (n,) + shape).astype(np.float32)


def _compare(jout, tout, tol=None):
    jmeta = yaml.safe_load((jout / 'serving.yaml').read_text())
    tmeta = yaml.safe_load((tout / 'serving.yaml').read_text())
    for meta in (jmeta, tmeta):
        meta.pop('source_checkpoint')
    assert tmeta == jmeta and tmeta['bn_fold'] is True
    want = _leaves(jrestore(jout / 'checkpoint_0'))
    got = _leaves(restore_checkpoint(tout / 'checkpoint_0'))
    assert set(got) == set(want)
    # Stripped: no fp32 kernel of a packed conv (a block's binary convs,
    # LeNet's conv2).
    assert not any(re.match(r'/params/(\w+_block\d+/conv\d|conv2)/kernel$',
                            p) for p in got)
    assert any(p.endswith('/w_packed') for p in got)
    for path, w in want.items():
        if tol is None or w.dtype.kind != 'f':
            np.testing.assert_array_equal(got[path], w, err_msg=path)
        else:
            np.testing.assert_allclose(got[path], w, err_msg=path, **tol)


def _served_equal(jout, tout, shape):
    jmodel, jvars, jshape = jload(jout)
    tmodel, tshape = prepare.load_serving_artifact(tout, device='cpu')
    assert tshape == jshape == shape
    x = _images(shape)
    want = np.asarray(jmodel.apply(jvars, jnp.asarray(x), False))
    got = tmodel(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **FP32_TOL)
    return tmodel, got


def test_artifact_equals_jax_s(xnor, tmp_path):
    jexp, texp, shape = xnor
    jout = jprepare(jexp, tmp_path / 'j', input_shape=shape)
    tout = prepare.prepare_serving_artifact(texp, tmp_path / 't',
                                            input_shape=shape, device='cpu')
    _compare(jout, tout)
    _served_equal(jout, tout, shape)


def test_calibrated_artifact_equals_jax_s(tmp_path):
    jexp, texp, shape = _train(tmp_path, 'lenet')
    batches = [np.random.default_rng(i).standard_normal(
        (16,) + shape).astype(np.float32) for i in range(2)]
    jout = jprepare(jexp, tmp_path / 'j', input_shape=shape,
                    calib_batches=[jnp.asarray(b) for b in batches])
    tout = prepare.prepare_serving_artifact(
        texp, tmp_path / 't', input_shape=shape, device='cpu',
        calib_batches=batches)
    assert yaml.safe_load((tout / 'serving.yaml').read_text())['model'][
        'arch_config']['moving_average_mode'] == 'eval_only'
    _compare(jout, tout, CALIBRATED_TOL)
    _served_equal(jout, tout, shape)


def test_worker_specs_serve_on_the_cpu(xnor, tmp_path):
    _, texp, shape = xnor
    out = prepare.main(['--experiment', str(texp), '--out',
                        str(tmp_path / 'a'), '--input-shape',
                        ','.join(map(str, shape)), '--device', 'cpu'])
    model, _ = prepare.load_serving_artifact(out, device='cpu')
    x = _images(shape, n=3, seed=5)
    want = model(torch.from_numpy(x)).numpy()
    for spec in ({'model': 'artifact', 'artifact_dir': str(out)},
                 {'model': 'experiment', 'experiment_dir': str(texp),
                  'input_shape': list(shape)}):
        engine = build_engine_from_spec({**spec, 'device': 'cpu',
                                         'max_batch': 4})
        np.testing.assert_array_equal(engine.predict(x), want)


def test_prepare_calibrates_on_synthetic_batches(xnor, tmp_path):
    _, texp, shape = xnor
    out = prepare.main(['--experiment', str(texp), '--out',
                        str(tmp_path / 'a'), '--input-shape',
                        ','.join(map(str, shape)), '--device', 'cpu',
                        '--calibrate-synthetic', '2'])
    model, _ = prepare.load_serving_artifact(out, device='cpu')
    assert model.bn_fold and model.moving_average_mode == 'eval_only'
    got = model(torch.from_numpy(_images(shape))).numpy()
    assert np.isfinite(got).all()


def test_serve_driver(xnor, tmp_path):
    _, texp, shape = xnor
    out = prepare.prepare_serving_artifact(texp, tmp_path / 'a',
                                           input_shape=shape, device='cpu')
    outs = serve.main(['--workers', '1', '--artifact', str(out),
                       '--device', 'cpu', '--requests', '4'])
    assert len(outs) == 4 and np.isfinite(np.stack(outs)).all()
    outs = serve.main(['--config', str(texp / 'config.yaml'),
                       '--checkpoint',
                       str(texp / 'checkpoints' / 'checkpoint_1'),
                       '--image-size', str(shape[0]), '--device', 'cpu',
                       '--requests', '4'])
    assert len(outs) == 4 and outs[0].shape == (10,)
    assert np.isfinite(np.stack(outs)).all()


def test_the_artifact_has_no_dense_fallback(xnor, tmp_path, monkeypatch):
    """Where the JAX worker serves the dense model after a failed packed
    export, the port's raises."""
    from quant_tpu_torch.nn import export

    def fail(model):
        raise RuntimeError('export failed')

    monkeypatch.setattr(export, 'export_packed_variables', fail)
    with pytest.raises(RuntimeError, match='export failed'):
        build_engine_from_spec({'model': 'experiment', 'device': 'cpu',
                                'experiment_dir': str(xnor[1]),
                                'input_shape': list(xnor[2])})
    assert jax.devices()[0].platform == 'cpu'
