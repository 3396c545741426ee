"""The bench's ResNet-18 for the probes and the smoke run.

`bench_resnet18` ports the model builder of bench.py:59-77;
`seeded_serving_resnet18` builds that model with seeded weights and
prepares it for serving, so the smoke run and the batch-sweep probe
serve one model.
"""

from typing import Any

import torch

from quant_tpu_torch.device import DeviceLike
from quant_tpu_torch.nn import export
from quant_tpu_torch.nn.layers import BatchNorm, QuantConv2d
from quant_tpu_torch.nn.resnet import QResNet
from quant_tpu_torch.ops.quantize import quantizer_ls_1


def bench_resnet18(x_quant: str, w_quant: str, block: str = 'xnor',
                   **kwargs: Any) -> QResNet:
    """ResNet-18 at 224 px and 1000 classes with symmetric clamp alpha 2,
    PReLU and, for xnor blocks, the double shortcut (bench.py:59-77)."""
    layer: dict[str, Any] = {'x_quant': x_quant, 'w_quant': w_quant,
                             'clamp': {'kind': 'symmetric', 'alpha': 2.0}}
    if block == 'xnor':
        layer['double_shortcut'] = True
    return QResNet(
        block=block,
        layer0={'n_in_channels': 64, 'kernel_size': 7, 'stride': 2,
                'padding': 3, 'bias': False,
                'maxpool': {'type': 'maxpool2d', 'kernel_size': 3,
                            'stride': 2, 'padding': 1}},
        layer1=dict(layer), layer2=dict(layer), layer3=dict(layer),
        layer4=dict(layer), nonlins=['prelu', 'prelu'],
        num_blocks=[2, 2, 2, 2], output_classes=1000, **kwargs)


def seeded_serving_resnet18(device: DeviceLike, seed: int,
                            stem_s2d: bool = False) -> QResNet:
    """Packed, folded, stripped ls-1 XNOR ResNet-18 from seeded weights.

    Built on the CPU from one torch.Generator: weights by torch's default
    init, BN affines with 30% negative gammas, cached weight scales as
    training leaves them (per-out-channel mean |w|) and EMA activation
    scales as the JAX bench fills them (0.5, one tracked batch); then
    exported, threshold-folded and stripped, and moved to `device`.
    """
    gen = torch.Generator().manual_seed(seed)
    model = bench_resnet18('ls-1', 'ls-1', moving_average_mode='eval_only',
                           stem_s2d=stem_s2d, device='cpu', generator=gen)

    def uniform(like: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
        return torch.empty_like(like).uniform_(lo, hi, generator=gen)

    for m in model.modules():
        if isinstance(m, BatchNorm):
            sign = torch.where(uniform(m.weight, 0, 1) < 0.3, -1.0, 1.0)
            m.weight.copy_(uniform(m.weight, 0.3, 1.5) * sign)
            m.bias.copy_(uniform(m.bias, -0.8, 0.8))
            m.running_mean.copy_(uniform(m.running_mean, -0.5, 0.5))
            m.running_var.copy_(uniform(m.running_var, 0.2, 2.0))
        elif isinstance(m, QuantConv2d):
            m.w_vs = quantizer_ls_1(torch.movedim(m.kernel, -1, 0))[0]
            m.x_quantizer.ema.fill_(0.5)
            m.x_quantizer.ema_count.fill_(1)
    export.export_packed_variables(model)
    model, folded = export.fold_for_serving(model)
    if not folded:
        raise RuntimeError('threshold fold did not apply')
    export.strip_for_deployment(model)
    return model.to(device)
