"""The port's InferenceEngine on the CPU, its entry points' device rule,
and the package's import boundary (no JAX, nothing of quant_tpu)."""

import ast
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from quant_tpu_torch.nn import export as texport
from quant_tpu_torch.nn.layers import QuantConv2d
from quant_tpu_torch.nn.resnet import QResNet
from quant_tpu_torch.serving.engine import InferenceEngine

REPO = Path(__file__).resolve().parent.parent
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
    layer4=None, nonlins=['prelu', 'prelu'], num_blocks=[1, 1, 1],
    output_classes=10, moving_average_mode='eval_only')
SHAPE = (32, 32, 3)


def _served_model():
    """Seeded port model with tracked scales, packed, folded, stripped."""
    gen = torch.Generator().manual_seed(0)
    model = QResNet(**CONFIG, device='cpu', generator=gen)
    for m in model.modules():
        if isinstance(m, QuantConv2d):
            m.w_vs = m.kernel.abs().mean(dim=(0, 1, 2))[None]
            m.x_quantizer.ema.fill_(0.5)
            m.x_quantizer.ema_count.fill_(1)
    texport.export_packed_variables(model)
    model, folded = texport.fold_for_serving(model)
    assert folded
    return texport.strip_for_deployment(model)


def test_engine_futures_equal_predict():
    engine = InferenceEngine(_served_model(), SHAPE, max_batch=4,
                             max_wait_ms=20.0, device='cpu')
    engine.warmup()
    images = np.random.default_rng(1).standard_normal(
        (7,) + SHAPE).astype(np.float32)
    futures = [None] * len(images)

    def send(i):
        futures[i] = engine.submit(images[i])
    # Submit concurrently, then start the scheduler: it drains the queue
    # as batches of 4 and 3 (padded to 4), the batch sizes predict()
    # uses, so each sample meets the same kernels both ways.
    threads = [threading.Thread(target=send, args=(i,))
               for i in range(len(images))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    engine.start()
    try:
        got = np.stack([f.result(timeout=30) for f in futures])
    finally:
        engine.stop()
    assert not engine._thread.is_alive()
    want = engine.predict(images)
    # Per-sample arithmetic does not depend on the rest of the batch;
    # float32 rounding of the CPU stem conv is the only slack allowed.
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.isfinite(got).all() and got.shape == (7, 10)
    stats = engine.stats
    assert stats['requests'] == 7 and stats['batches'] == 2
    assert stats['padded'] == 1
    assert stats['latency_ms']['window'] == 7
    with pytest.raises(ValueError, match='expected shape'):
        engine.submit(np.zeros((8, 8, 3), np.float32))
    with pytest.raises(ValueError, match='bucket'):
        engine.warmup([3])


def test_engine_predict_chunks_above_max_batch():
    engine = InferenceEngine(_served_model(), SHAPE, max_batch=2,
                             device='cpu')
    images = np.random.default_rng(2).standard_normal(
        (5,) + SHAPE).astype(np.float32)
    out = engine.predict(images)
    assert out.shape == (5, 10)
    np.testing.assert_allclose(out[4], engine.predict(images[4:])[0],
                               rtol=1e-5, atol=1e-5)


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip('this machine has CUDA; the rule is for machines '
                    'without it')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        QResNet(**CONFIG)
    model = QResNet(**CONFIG, device='cpu')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        InferenceEngine(model, SHAPE)
    with pytest.raises(ValueError, match='unsupported device'):
        InferenceEngine(model, SHAPE, device='meta')


def _imported_roots(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split('.')[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split('.')[0]


def test_port_imports_no_jax_and_nothing_of_quant_tpu():
    files = sorted((REPO / 'quant_tpu_torch').rglob('*.py'))
    files.append(REPO / 'chip_smoke.py')
    assert len(files) > 10
    banned = {'jax', 'jaxlib', 'flax', 'optax', 'orbax', 'quant_tpu'}
    for f in files:
        roots = set(_imported_roots(f))
        assert not roots & banned, (f, roots & banned)
