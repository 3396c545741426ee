"""QResNet with XNOR-ordering basic blocks, packed serving form (port of
quant_tpu/nn/resnet.py:39-53, 119-188, 351-453).

Module names match the JAX variable tree (conv1, bn1, layer{s}_block{b},
fc; inside a block bn1, conv1, nonlin1, bn2, conv2, nonlin2, shortcut).
The other block families are queued for Slice B.
"""

from typing import Any, Iterator, Optional, Sequence

import torch
from torch import nn

from quant_tpu_torch.device import DeviceLike, resolve_device
from quant_tpu_torch.nn.layers import (
    BatchNorm, Conv, Dense, DtypeLike, PReLU, QuantConv2d, as_dtype,
)
from quant_tpu_torch.ops.conv import global_avg_pool, max_pool2d
from quant_tpu_torch.ops.pool import max_pool_3x3_s2_p1, pool_fusable


def _nonlin(name: str) -> nn.Module:
    if name == 'relu':
        return nn.ReLU()
    if name == 'prelu':
        return PReLU(negative_slope_init=0.25)
    if name == 'identity':
        return nn.Identity()
    raise ValueError(f'Non-linearity {name} is not supported.')


class _Shortcut(nn.Module):
    """Full-precision 1x1 conv + BN downsample, identity when the block
    keeps its width and resolution."""

    def __init__(self, in_planes: int, planes: int, stride: int,
                 use_bias: bool,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.identity = stride == 1 and in_planes == planes
        if not self.identity:
            self.conv = Conv(in_planes, planes, 1, stride=stride,
                             use_bias=use_bias, generator=generator)
            self.norm = BatchNorm(planes)

    def forward(self, x: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        if self.identity:
            return x
        return self.norm(self.conv(x, dtype), dtype)


class XnorBasicBlock(nn.Module):
    """BN -> quant-conv -> nonlin block (XNOR-Net ordering), optional
    Bi-Real double shortcut. With bn_fold the BNs are skipped: their
    affine lives in the convs' thresholds."""

    def __init__(self, in_planes: int, planes: int, x_quant: str,
                 w_quant: str, nonlins: Sequence[str], stride: int = 1,
                 double_shortcut: bool = False,
                 clamp: Optional[dict[str, Any]] = None,
                 moving_average_mode: str = 'off',
                 sign_compute: str = 'auto',
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if len(nonlins) != 2:
            raise ValueError('There should be 2 non-linearities.')
        self.double_shortcut = double_shortcut
        qconv = dict(x_quant=x_quant, w_quant=w_quant, clamp=clamp,
                     moving_average_mode=moving_average_mode,
                     sign_compute=sign_compute, use_bias=True, padding=1,
                     generator=generator)
        self.bn1 = BatchNorm(in_planes)
        self.conv1 = QuantConv2d(in_planes, planes, 3, stride=stride, **qconv)
        self.nonlin1 = _nonlin(nonlins[0])
        self.bn2 = BatchNorm(planes)
        self.conv2 = QuantConv2d(planes, planes, 3, stride=1, **qconv)
        self.nonlin2 = _nonlin(nonlins[1])
        self.shortcut = _Shortcut(in_planes, planes, stride, use_bias=True,
                                  generator=generator)

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None,
                bn_fold: bool = False) -> torch.Tensor:
        out1 = x if bn_fold else self.bn1(x, dtype)
        out1 = self.nonlin1(self.conv1(out1, dtype, bn_fold))
        if self.double_shortcut:
            out1 = out1 + self.shortcut(x, dtype)
        out2 = out1 if bn_fold else self.bn2(out1, dtype)
        out2 = self.conv2(out2, dtype, bn_fold)
        if self.double_shortcut:
            return self.nonlin2(out2) + out1
        return self.nonlin2(out2 + self.shortcut(x, dtype))


class QResNet(nn.Module):
    """ResNet with per-stage quantization config, packed serving form.

    Arguments mirror the JAX QResNet (layer0 configures the fp stem,
    layer1..layer4 carry {x_quant, w_quant, clamp, double_shortcut}).
    `eval_dtype` (e.g. torch.bfloat16) is the feature-map chain's dtype
    and `bn_fold` serves threshold-folded convs; both are plain
    attributes that may be changed between forwards. `stem_s2d` runs the
    stem conv in its exact space-to-depth form (`conv1.s2d`; JAX
    resnet.py:386,409), with the same parameters. Parameters start
    from torch's default init drawn from `generator`, or come from a JAX
    tree via utils.jax_import.from_jax_variables.

    Builds on `device` ('cuda' by default; raises if CUDA is missing).
    """

    def __init__(self, block: str, layer0: dict[str, Any],
                 layer1: dict[str, Any], layer2: dict[str, Any],
                 layer3: dict[str, Any], layer4: Optional[dict[str, Any]],
                 nonlins: Sequence[str], num_blocks: Sequence[int],
                 output_classes: int, moving_average_mode: str = 'off',
                 inference_mode: str = 'packed',
                 eval_dtype: DtypeLike = None, sign_compute: str = 'auto',
                 bn_fold: bool = False, stem_s2d: bool = False,
                 in_channels: int = 3, device: DeviceLike = 'cuda',
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        if block != 'xnor':
            raise NotImplementedError(
                f'block {block!r}: only the xnor basic block is ported; '
                'the other families are queued for Slice B.')
        if inference_mode != 'packed':
            raise NotImplementedError(
                f'inference_mode {inference_mode!r}: only the packed '
                'serving path is ported; the dense QAT path is Slice C.')
        self.block = block
        self.moving_average_mode = moving_average_mode
        self.eval_dtype = as_dtype(eval_dtype)
        self.bn_fold = bn_fold
        self.maxpool = dict(layer0['maxpool'])
        if self.maxpool['type'] not in ('maxpool2d', 'identity'):
            raise ValueError(
                f"maxpool type {self.maxpool['type']} is not supported.")
        width = layer0['n_in_channels']
        self.conv1 = Conv(in_channels, width, layer0['kernel_size'],
                          stride=layer0['stride'], padding=layer0['padding'],
                          use_bias=layer0['bias'], s2d=stem_s2d,
                          generator=generator)
        self.bn1 = BatchNorm(width)

        stages = [(layer1, width, 1), (layer2, 2 * width, 2),
                  (layer3, 4 * width, 2)]
        if layer4 is not None:
            stages.append((layer4, 8 * width, 2))
        self.block_names: list[str] = []
        in_planes = width
        for s, (cfg, planes, first_stride) in enumerate(stages):
            cfg = dict(cfg)
            kwargs = dict(x_quant=cfg.pop('x_quant'),
                          w_quant=cfg.pop('w_quant'),
                          clamp=cfg.pop('clamp', None), nonlins=nonlins,
                          moving_average_mode=moving_average_mode,
                          sign_compute=sign_compute, generator=generator,
                          **cfg)
            for b in range(num_blocks[s]):
                name = f'layer{s + 1}_block{b}'
                self.add_module(name, XnorBasicBlock(
                    in_planes, planes, stride=first_stride if b == 0 else 1,
                    **kwargs))
                self.block_names.append(name)
                in_planes = planes
        self.fc = Dense(in_planes, output_classes, generator=generator)
        self.to(dev)

    def blocks(self) -> Iterator[tuple[str, XnorBasicBlock]]:
        for name in self.block_names:
            yield name, getattr(self, name)

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC images -> float32 logits."""
        dt = self.eval_dtype
        if dt is not None:
            x = x.to(dt)
        x = torch.relu(self.bn1(self.conv1(x, dt), dt))
        mp = self.maxpool
        if mp['type'] == 'maxpool2d':
            if pool_fusable(tuple(x.shape), mp['kernel_size'], mp['stride'],
                            mp['padding']):
                x = max_pool_3x3_s2_p1(x.contiguous())
            else:
                x = max_pool2d(x, kernel_size=mp['kernel_size'],
                               stride=mp['stride'], padding=mp['padding'])
        for _, blk in self.blocks():
            x = blk(x, dt, self.bn_fold)
        logits = self.fc(global_avg_pool(x), dt)
        return logits.to(torch.float32)
