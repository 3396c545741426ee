"""Seeded models for the probes, the smoke run and the tests.

`bench_resnet18` ports the model builder of bench.py:59-77 (the
student of the ImageNet KD recipes, examples/imagenet/imagenet_ls1_kd.yaml);
`imagenet_teacher` their teacher, examples/imagenet/imagenet_fp.yaml;
`resnet50_cifar` the ResNet-50 of
examples/cifar100/cifar100_resnet50_ls2_tpu.yaml and `lenet5` the
LeNet-5 of examples/mnist/*.yaml. `seed_state` gives a built model the
state training leaves (BN affines and statistics, cached weight scales
of the weight quantizer's solve, EMA activation scales, each plane with
a scale of its own), and
`seeded_model` builds, seeds and prepares one for serving with the
port's own export, fold and strip. `seeded_serving_resnet18` is the
bench's headline model, which the smoke run and the batch-sweep probe
serve.
"""

from typing import Any, Callable

import torch

from quant_tpu_torch.device import DeviceLike
from quant_tpu_torch.nn import export
from quant_tpu_torch.nn.layers import BatchNorm, QuantConv2d
from quant_tpu_torch.nn.lenet import QLeNet5
from quant_tpu_torch.nn.resnet import QResNet
from quant_tpu_torch.ops.quantize import solve_scales

# EMA activation scales per plane, as a trained model's fall: distinct,
# so that a swapped plane or scale shows, and with prefix sums (0.9,
# 1.35) inside the clamp's alpha of 2, so that the threshold fold holds.
EMA_SCALES = (0.9, 0.45, 0.2)


def bench_resnet18_config(x_quant: str, w_quant: str,
                          block: str = 'xnor') -> dict[str, Any]:
    """QResNet's arguments for bench_resnet18 (bench.py:59-77)."""
    layer: dict[str, Any] = {'x_quant': x_quant, 'w_quant': w_quant,
                             'clamp': {'kind': 'symmetric', 'alpha': 2.0}}
    if block == 'xnor':
        layer['double_shortcut'] = True
    return dict(
        block=block,
        layer0={'n_in_channels': 64, 'kernel_size': 7, 'stride': 2,
                'padding': 3, 'bias': False,
                'maxpool': {'type': 'maxpool2d', 'kernel_size': 3,
                            'stride': 2, 'padding': 1}},
        layer1=dict(layer), layer2=dict(layer), layer3=dict(layer),
        layer4=dict(layer), nonlins=['prelu', 'prelu'],
        num_blocks=[2, 2, 2, 2], output_classes=1000)


def bench_resnet18(x_quant: str, w_quant: str, block: str = 'xnor',
                   **kwargs: Any) -> QResNet:
    """ResNet-18 at 224 px and 1000 classes with symmetric clamp alpha 2,
    PReLU and, for xnor blocks, the double shortcut (bench.py:59-77)."""
    return QResNet(**bench_resnet18_config(x_quant, w_quant, block),
                   **kwargs)


def imagenet_teacher(x_quant: str = 'fp', w_quant: str = 'fp',
                     **kwargs: Any) -> QResNet:
    """The teacher of the ImageNet KD recipes (imagenet_fp.yaml):
    ResNet-18, regular blocks, identity clamp, ReLU, 224 px, 1000
    classes; fp x fp as written."""
    layer = {'x_quant': x_quant, 'w_quant': w_quant,
             'clamp': {'kind': 'identity'}}
    return QResNet(
        block='regular',
        layer0={'n_in_channels': 64, 'kernel_size': 7, 'stride': 2,
                'padding': 3, 'bias': False,
                'maxpool': {'type': 'maxpool2d', 'kernel_size': 3,
                            'stride': 2, 'padding': 1}},
        layer1=dict(layer), layer2=dict(layer), layer3=dict(layer),
        layer4=dict(layer), nonlins=['relu', 'relu'],
        num_blocks=[2, 2, 2, 2], output_classes=1000, **kwargs)


def resnet50_cifar(x_quant: str, w_quant: str, **kwargs: Any) -> QResNet:
    """The regular_bottleneck ResNet-50 of cifar100_resnet50_ls2_tpu.yaml:
    32 px, 3x3 stem of 64 channels, no pool, blocks [3, 4, 6, 3], ReLU,
    symmetric clamp alpha 2, 100 classes."""
    layer = {'x_quant': x_quant, 'w_quant': w_quant,
             'clamp': {'kind': 'symmetric', 'alpha': 2.0}}
    return QResNet(
        block='regular_bottleneck',
        layer0={'n_in_channels': 64, 'kernel_size': 3, 'stride': 1,
                'padding': 1, 'bias': False, 'maxpool': {'type': 'identity'}},
        layer1=dict(layer), layer2=dict(layer), layer3=dict(layer),
        layer4=dict(layer), nonlins=['relu', 'relu'],
        num_blocks=[3, 4, 6, 3], output_classes=100, **kwargs)


def lenet5(x_quant: str, w_quant: str, **kwargs: Any) -> QLeNet5:
    """The LeNet-5 of examples/mnist: 28 px, 20 and 50 filters, 10
    classes, identity clamp."""
    return QLeNet5(conv1_filters=20, conv2_filters=50, output_classes=10,
                   x_quant=x_quant, w_quant=w_quant,
                   clamp={'kind': 'identity'}, **kwargs)


def small_config(family: str, x_quant: str, w_quant: str) -> dict:
    """A small model of a family, as keyword arguments of the port's and
    the JAX package's constructors: for the ResNets width 8, one block a
    stage, the 7x7/s2 stem with the 3x3/s2 pool, symmetric clamp alpha 2,
    10 classes (32 px in); LeNet-5 ('lenet') with 8 and 12 filters (28
    px in). EMA activation scales (eval_only)."""
    if family == 'lenet':
        return dict(conv1_filters=8, conv2_filters=12, output_classes=10,
                    x_quant=x_quant, w_quant=w_quant,
                    clamp={'kind': 'identity'},
                    moving_average_mode='eval_only')
    layer: dict[str, Any] = {'x_quant': x_quant, 'w_quant': w_quant,
                             'clamp': {'kind': 'symmetric', 'alpha': 2.0}}
    if family == 'xnor':
        layer['double_shortcut'] = True
    return dict(
        block=family,
        layer0={'n_in_channels': 8, 'kernel_size': 7, 'stride': 2,
                'padding': 3, 'bias': False,
                'maxpool': {'type': 'maxpool2d', 'kernel_size': 3,
                            'stride': 2, 'padding': 1}},
        layer1=dict(layer), layer2=dict(layer), layer3=dict(layer),
        layer4=dict(layer), nonlins=['prelu', 'prelu'],
        num_blocks=[1, 1, 1, 1], output_classes=10,
        moving_average_mode='eval_only')


def build(family: str, config: dict, **kwargs: Any) -> torch.nn.Module:
    """QLeNet5 for 'lenet', else a QResNet of that block family."""
    cls = QLeNet5 if family == 'lenet' else QResNet
    return cls(**{**config, **kwargs})


def _weight_scales(conv: QuantConv2d) -> torch.Tensor:
    """Cached weight scales as training leaves them, per out-channel: the
    weight quantizer's own solve (quant_tpu/nn/layers.py:97-120): means
    for ls-1 and gf-k, the least-squares optimum (opt_v1, exact, every
    3rd element) for ls-2 and ls-T."""
    w_oi = torch.movedim(conv.kernel, -1, 0)
    return solve_scales(conv.w_quant, w_oi, skip=3, mode='exact')


@torch.no_grad()
def seed_state(model: torch.nn.Module, gen: torch.Generator) -> None:
    """The state of a trained model, drawn from `gen`: BN affines with
    30% negative gammas and random statistics, cached weight scales
    (_weight_scales) and EMA activation scales EMA_SCALES, jittered by
    up to 10% per conv, with one tracked batch."""
    def uniform(like: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
        return torch.empty_like(like).uniform_(lo, hi, generator=gen)

    for m in model.modules():
        if isinstance(m, BatchNorm):
            if m.weight is not None:
                sign = torch.where(uniform(m.weight, 0, 1) < 0.3, -1.0, 1.0)
                m.weight.copy_(uniform(m.weight, 0.3, 1.5) * sign)
                m.bias.copy_(uniform(m.bias, -0.8, 0.8))
            m.running_mean.copy_(uniform(m.running_mean, -0.5, 0.5))
            m.running_var.copy_(uniform(m.running_var, 0.2, 2.0))
        elif isinstance(m, QuantConv2d):
            if m.w_vs is not None:
                m.w_vs = _weight_scales(m)
            ema = m.x_quantizer.ema
            if ema is not None:
                k = ema.shape[0]
                ema.copy_(torch.tensor(EMA_SCALES[:k])
                          * uniform(ema, 0.9, 1.0))
                m.x_quantizer.ema_count.fill_(1)


def prepare_for_serving(model: torch.nn.Module) -> torch.nn.Module:
    """Export, fold with the family's fold and strip a packed model with
    binary weights, in place (others are returned as they are). A fold
    must apply, except where per-batch scales (moving_average_mode 'off')
    rule out the threshold fold: such a model serves unfolded."""
    convs = [m for m in model.modules() if isinstance(m, QuantConv2d)]
    if not any(c.packed for c in convs):
        return model
    export.export_packed_variables(model)
    folded = export.fold_for_serving(model)[1]
    if not folded and model.moving_average_mode != 'off':
        raise RuntimeError('no fold applied to the seeded model')
    return export.strip_for_deployment(model)


def seeded_model(make: Callable[..., torch.nn.Module], x_quant: str,
                 w_quant: str, device: DeviceLike, seed: int,
                 prepare: bool = True, **kwargs: Any) -> torch.nn.Module:
    """make(x_quant, w_quant, **kwargs) on the CPU from one
    torch.Generator (weights by torch's default init, then seed_state),
    prepared for serving (prepare_for_serving) unless `prepare` is False,
    as a model is before calibrate_ema_scales. Moved to `device`."""
    gen = torch.Generator().manual_seed(seed)
    model = make(x_quant, w_quant, device='cpu', generator=gen, **kwargs)
    seed_state(model, gen)
    if prepare:
        prepare_for_serving(model)
    return model.to(device)


def seeded_serving_resnet18(device: DeviceLike, seed: int,
                            stem_s2d: bool = False, x_quant: str = 'ls-1',
                            w_quant: str = 'ls-1') -> QResNet:
    """Packed, threshold-folded, stripped XNOR ResNet-18 (EMA scales) from
    seeded weights: by default the bench's headline ls-1 model."""
    return seeded_model(bench_resnet18, x_quant, w_quant, device, seed,
                        moving_average_mode='eval_only', stem_s2d=stem_s2d)
