"""The port's recipe drivers end to end on the CPU (--device cpu), each on
a recipe under examples/ with narrow widths and a few images, its data
written by the test in the dataset's own format: MNIST IDX-gz
(mnist_ls1.yaml), CIFAR-10 pickles (cifar10_ls1.yaml), CIFAR-100
pickles (cifar100_fp.yaml, then cifar100_ls1_kd.yaml distilling from
it) and JPEGs in the ImageNet folder layout (imagenet_fp.yaml). Each
writes config.yaml, the metric CSVs and its checkpoints; one runs as
`python -m`, as users run it.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import yaml

from quant_tpu_torch.examples import cifar10, cifar100, imagenet, mnist
from quant_tpu_torch.utils.checkpoints import restore_checkpoint

NARROW_RESNET = {
    'layer0': {'n_in_channels': 4, 'kernel_size': 3, 'stride': 1,
               'padding': 1, 'bias': False, 'maxpool': {'type': 'identity'}},
    'num_blocks': [1, 1, 1, 1]}


def recipe(tmp_path, path, data, arch=None, **sections):
    """The recipe with 1 epoch, the test's data and experiments root,
    tensorboard off and narrower models; returns the copy's path."""
    cfg = yaml.safe_load(open(path))
    cfg['optimization']['epochs'] = 1
    cfg['log'].update(root_experiments_dir=str(tmp_path / 'exps'),
                      tensorboard=False, level='WARNING')
    cfg['data'].update(data)
    cfg['model']['arch_config'].update(arch or NARROW_RESNET)
    for section, keys in sections.items():
        cfg['model'][section] = keys
    out = tmp_path / os.path.basename(path)
    out.write_text(yaml.safe_dump(cfg))
    return str(out)


def assert_experiment(exp):
    assert (exp / 'config.yaml').exists()
    for name in ('train.csv', 'test.csv'):
        assert (exp / 'metrics' / name).read_text().startswith('Loss,')
    payload = restore_checkpoint(exp / 'checkpoints' / 'checkpoint_1')
    assert payload['epoch'] == 1 and payload['step'] > 0
    assert set(payload) == {'params', 'batch_stats', 'quant_state',
                            'opt_state', 'step', 'epoch'}


def test_mnist_driver_as_a_module(tmp_path):
    import gzip
    import struct

    data = tmp_path / 'mnist'
    data.mkdir()
    rng = np.random.default_rng(0)
    for prefix, n in (('train', 40), ('t10k', 20)):
        for kind, arr, magic in (
                ('images-idx3', rng.integers(0, 256, (n, 28, 28),
                                             dtype=np.uint8), 0x803),
                ('labels-idx1', rng.integers(0, 10, n, dtype=np.uint8),
                 0x801)):
            with gzip.open(data / f'{prefix}-{kind}-ubyte.gz', 'wb') as f:
                f.write(struct.pack('>I', magic))
                f.write(struct.pack('>' + 'I' * arr.ndim, *arr.shape))
                f.write(arr.tobytes())
    cfg = recipe(tmp_path, 'examples/mnist/mnist_ls1.yaml',
                 {'dataset_path': str(data), 'test_batch_size': 8},
                 {'conv1_filters': 4, 'conv2_filters': 6})
    argv = ['--config', cfg, '--experiment-name', 'm', '--device', 'cpu']
    subprocess.run([sys.executable, '-m', 'quant_tpu_torch.examples.mnist',
                    *argv], check=True, timeout=300)
    assert_experiment(tmp_path / 'exps' / 'm')
    train, test = mnist.main(argv + ['--auto-resume'])
    assert len(train) == len(test) == 1
    assert (tmp_path / 'exps' / 'm' / 'checkpoints' / 'checkpoint_2').exists()


def _cifar(tmp_path, files, key):
    data = tmp_path / 'cifar'
    data.mkdir(exist_ok=True)
    rng = np.random.default_rng(1)
    for name, n in files:
        with open(data / name, 'wb') as f:
            pickle.dump({b'data': rng.integers(0, 256, (n, 3072),
                                               dtype=np.uint8),
                         key: list(rng.integers(0, 10, n))}, f)
    return {'dataset_path': str(data), 'train_batch_size': 8,
            'test_batch_size': 8}


def test_cifar10_driver(tmp_path):
    data = _cifar(tmp_path, [(f'data_batch_{i}', 4) for i in range(1, 6)]
                  + [('test_batch', 8)], b'labels')
    cfg = recipe(tmp_path, 'examples/cifar10/cifar10_ls1.yaml', data)
    train, test = cifar10.main(['--config', cfg, '--experiment-name', 'c',
                                '--device', 'cpu'])
    assert len(train) == 1 and np.isfinite(test[0]['Loss'])
    assert_experiment(tmp_path / 'exps' / 'c')


def test_cifar100_kd_pair(tmp_path):
    data = _cifar(tmp_path, [('train', 16), ('test', 8)], b'fine_labels')
    teacher = recipe(tmp_path, 'examples/cifar100/cifar100_fp.yaml', data)
    cifar100.main(['--config', teacher, '--experiment-name', 'teacher',
                   '--device', 'cpu'])
    exp = tmp_path / 'exps' / 'teacher'
    assert_experiment(exp)
    kd = yaml.safe_load(open('examples/cifar100/cifar100_ls1_kd.yaml'))[
        'model']['kd_config']
    kd.update(teacher_config_path=str(exp / 'config.yaml'),
              teacher_checkpoint_path=str(exp / 'checkpoints'
                                          / 'checkpoint_1'))
    student = recipe(tmp_path, 'examples/cifar100/cifar100_ls1_kd.yaml',
                     data, kd_config=kd)
    train, _ = cifar100.main(['--config', student, '--experiment-name',
                              'student', '--device', 'cpu'])
    assert np.isfinite(train[0]['Loss'])
    assert_experiment(tmp_path / 'exps' / 'student')


def test_imagenet_driver_on_jpegs(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(2)
    for split in ('train', 'val'):
        for cname in ('n01', 'n02'):
            (tmp_path / 'imnet' / split / cname).mkdir(parents=True)
            for i in range(2):
                Image.fromarray(rng.integers(0, 256, (240, 260, 3),
                                             dtype=np.uint8)).save(
                    tmp_path / 'imnet' / split / cname / f'{i}.jpg')
    cfg = recipe(tmp_path, 'examples/imagenet/imagenet_fp.yaml',
                 {'dataset_path': str(tmp_path / 'imnet'),
                  'train_batch_size': 2, 'test_batch_size': 2,
                  'workers': 2},
                 dict(NARROW_RESNET, output_classes=2))
    train, test = imagenet.main(['--config', cfg, '--experiment-name', 'i',
                                 '--device', 'cpu'])
    assert len(train) == len(test) == 1
    assert_experiment(tmp_path / 'exps' / 'i')


def test_drivers_default_to_the_card():
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        mnist.main(['--config', 'examples/mnist/mnist_ls1.yaml',
                    '--experiment-name', 'never'])


@pytest.mark.parametrize('n,channels,size', [(4, 8, 16), (4, 8, 8),
                                             (2, 8, 16), (8, 8, 16)])
def test_strided_shortcut_backward_on_the_cpu(n, channels, size):
    """The downsampling shortcut's 1x1 stride-2 conv under autograd on
    the CPU (ops.conv.conv2d): oneDNN's backward of the NHWC view
    crashed the process at the first two shapes, which a narrow recipe
    reaches; the port's gradients equal those of contiguous NCHW
    operands and its forward the plain conv's."""
    import torch
    import torch.nn.functional as F

    from quant_tpu_torch.ops.conv import conv2d

    gen = torch.Generator().manual_seed(n * size)
    x = torch.randn(n, size, size, channels, generator=gen,
                    requires_grad=True)
    w = torch.randn(1, 1, channels, 2 * channels, generator=gen,
                    requires_grad=True)
    y = conv2d(x, w, stride=2)
    g = torch.randn(y.shape, generator=gen)
    y.backward(g)
    x2 = x.detach().permute(0, 3, 1, 2).contiguous().requires_grad_()
    w2 = w.detach().permute(3, 2, 0, 1).contiguous().requires_grad_()
    y2 = F.conv2d(x2, w2, stride=2)
    y2.backward(g.permute(0, 3, 1, 2))
    with torch.no_grad():
        assert torch.equal(y, conv2d(x, w, stride=2))
    assert torch.equal(x.grad, x2.grad.permute(0, 2, 3, 1))
    assert torch.equal(w.grad, w2.grad.permute(2, 3, 1, 0))
