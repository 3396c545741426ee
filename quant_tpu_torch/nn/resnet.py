"""QResNet and its four block families (port of quant_tpu/nn/resnet.py):
the regular (conv->BN) and XNOR (BN->conv) orderings, each as basic and
bottleneck blocks, in eval and train form.

Module names match the JAX variable tree (conv1, bn1, layer{s}_block{b},
fc; inside a block bn1, conv1, nonlin1, ..., conv3, bn3, nonlin3,
shortcut). With `bn_fold` the blocks skip the BNs that an export fold
put into their convs: the epilogue's (`b_fold`, regular families) or
the thresholds (`x_thresh`, XNOR families).

Models are built in eval mode; `model.train()` runs the train forward
(nn.layers: batch statistics, solved and cached scales, the dense QAT
convs), with the chain in `train_dtype` and, with `remat`, each block
recomputed in the backward pass.
"""

from typing import Any, Iterator, Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from quant_tpu_torch.device import DeviceLike, resolve_device
from quant_tpu_torch.nn.layers import (
    BatchNorm, Conv, Dense, DtypeLike, PReLU, QuantConv2d, as_dtype,
    state_unchanged,
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
        self.eval()

    def forward(self, x: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        if self.identity:
            return x
        return self.norm(self.conv(x, dtype), dtype)


class _Block(nn.Module):
    """What the four block families share: the quantized-conv settings
    and the rule for when the fold applies (packed convs with binary
    weights; the XNOR families also need binary activations)."""

    xnor = False

    def __init__(self, x_quant: str, w_quant: str, nonlins: Sequence[str],
                 clamp: Optional[dict[str, Any]], moving_average_mode: str,
                 solver_mode: str, calibrate: bool, inference_mode: str,
                 pass_fusion: bool, sign_compute: str, use_bias: bool,
                 generator: Optional[torch.Generator],
                 moving_average_momentum: float = 0.99):
        super().__init__()
        if len(nonlins) != 2:
            raise ValueError('There should be 2 non-linearities.')
        self.x_quant, self.w_quant = x_quant, w_quant
        self.inference_mode = inference_mode
        self.qconv = dict(x_quant=x_quant, w_quant=w_quant, clamp=clamp,
                          moving_average_mode=moving_average_mode,
                          moving_average_momentum=moving_average_momentum,
                          solver_mode=solver_mode, calibrate=calibrate,
                          inference_mode=inference_mode,
                          pass_fusion=pass_fusion, sign_compute=sign_compute,
                          use_bias=use_bias, generator=generator)
        self.eval()

    def _fold(self, bn_fold: bool) -> bool:
        return (bn_fold and not self.training
                and self.inference_mode == 'packed'
                and self.w_quant != 'fp'
                and not (self.xnor and self.x_quant == 'fp'))

    def fold_pairs(self) -> list[tuple[str, QuantConv2d, BatchNorm]]:
        """(name, conv, the BN folded into it): convN and bnN, the BN
        after its conv (regular) or before it (XNOR)."""
        return [(f'conv{n}', getattr(self, f'conv{n}'),
                 getattr(self, f'bn{n}'))
                for n in '123' if hasattr(self, f'conv{n}')]


class RegularBasicBlock(_Block):
    """conv -> BN -> nonlin basic block, bias-free quantized 3x3 convs,
    fp 1x1+BN downsample shortcut (resnet.py:56-116)."""

    def __init__(self, in_planes: int, planes: int, x_quant: str,
                 w_quant: str, nonlins: Sequence[str], stride: int = 1,
                 clamp: Optional[dict[str, Any]] = None,
                 moving_average_mode: str = 'off',
                 solver_mode: str = 'exact', calibrate: bool = False,
                 inference_mode: str = 'packed', pass_fusion: bool = True,
                 sign_compute: str = 'auto',
                 generator: Optional[torch.Generator] = None,
                 moving_average_momentum: float = 0.99):
        super().__init__(x_quant, w_quant, nonlins, clamp,
                         moving_average_mode, solver_mode, calibrate,
                         inference_mode, pass_fusion, sign_compute, False, generator,
                         moving_average_momentum=moving_average_momentum)
        self.conv1 = QuantConv2d(in_planes, planes, 3, stride=stride,
                                 padding=1, **self.qconv)
        self.bn1 = BatchNorm(planes)
        self.nonlin1 = _nonlin(nonlins[0])
        self.conv2 = QuantConv2d(planes, planes, 3, padding=1, **self.qconv)
        self.bn2 = BatchNorm(planes)
        self.nonlin2 = _nonlin(nonlins[1])
        self.shortcut = _Shortcut(in_planes, planes, stride, use_bias=False,
                                  generator=generator)

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None,
                bn_fold: bool = False) -> torch.Tensor:
        fold = self._fold(bn_fold)
        out = self.conv1(x, dtype, fold)
        if not fold:
            out = self.bn1(out, dtype)
        out = self.conv2(self.nonlin1(out), dtype, fold)
        if not fold:
            out = self.bn2(out, dtype)
        return self.nonlin2(out + self.shortcut(x, dtype))


class XnorBasicBlock(_Block):
    """BN -> quant-conv -> nonlin block (XNOR-Net ordering), optional
    Bi-Real double shortcut (resnet.py:119-188)."""

    xnor = True

    def __init__(self, in_planes: int, planes: int, x_quant: str,
                 w_quant: str, nonlins: Sequence[str], stride: int = 1,
                 double_shortcut: bool = False,
                 clamp: Optional[dict[str, Any]] = None,
                 moving_average_mode: str = 'off',
                 solver_mode: str = 'exact', calibrate: bool = False,
                 inference_mode: str = 'packed', pass_fusion: bool = True,
                 sign_compute: str = 'auto',
                 generator: Optional[torch.Generator] = None,
                 moving_average_momentum: float = 0.99):
        super().__init__(x_quant, w_quant, nonlins, clamp,
                         moving_average_mode, solver_mode, calibrate,
                         inference_mode, pass_fusion, sign_compute, True, generator,
                         moving_average_momentum=moving_average_momentum)
        self.double_shortcut = double_shortcut
        self.bn1 = BatchNorm(in_planes)
        self.conv1 = QuantConv2d(in_planes, planes, 3, stride=stride,
                                 padding=1, **self.qconv)
        self.nonlin1 = _nonlin(nonlins[0])
        self.bn2 = BatchNorm(planes)
        self.conv2 = QuantConv2d(planes, planes, 3, padding=1, **self.qconv)
        self.nonlin2 = _nonlin(nonlins[1])
        self.shortcut = _Shortcut(in_planes, planes, stride, use_bias=True,
                                  generator=generator)

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None,
                bn_fold: bool = False) -> torch.Tensor:
        fold = self._fold(bn_fold)
        out1 = x if fold else self.bn1(x, dtype)
        out1 = self.nonlin1(self.conv1(out1, dtype, fold))
        if self.double_shortcut:
            out1 = out1 + self.shortcut(x, dtype)
        out2 = out1 if fold else self.bn2(out1, dtype)
        out2 = self.conv2(out2, dtype, fold)
        if self.double_shortcut:
            return self.nonlin2(out2) + out1
        return self.nonlin2(out2 + self.shortcut(x, dtype))


class RegularBottleneckBlock(_Block):
    """1x1-reduce -> 3x3 -> 1x1-expand bottleneck (ResNet-50 family),
    conv -> BN -> nonlin, bias-free convs (resnet.py:191-263). nonlins[0]
    follows bn1 and bn2, nonlins[1] the residual sum."""

    expansion = 4

    def __init__(self, in_planes: int, planes: int, x_quant: str,
                 w_quant: str, nonlins: Sequence[str], stride: int = 1,
                 clamp: Optional[dict[str, Any]] = None,
                 moving_average_mode: str = 'off',
                 solver_mode: str = 'exact', calibrate: bool = False,
                 inference_mode: str = 'packed', pass_fusion: bool = True,
                 sign_compute: str = 'auto',
                 generator: Optional[torch.Generator] = None,
                 moving_average_momentum: float = 0.99):
        super().__init__(x_quant, w_quant, nonlins, clamp,
                         moving_average_mode, solver_mode, calibrate,
                         inference_mode, pass_fusion, sign_compute, False, generator,
                         moving_average_momentum=moving_average_momentum)
        out_planes = planes * self.expansion
        self.conv1 = QuantConv2d(in_planes, planes, 1, **self.qconv)
        self.bn1 = BatchNorm(planes)
        self.nonlin1 = _nonlin(nonlins[0])
        self.conv2 = QuantConv2d(planes, planes, 3, stride=stride,
                                 padding=1, **self.qconv)
        self.bn2 = BatchNorm(planes)
        self.nonlin2 = _nonlin(nonlins[0])
        self.conv3 = QuantConv2d(planes, out_planes, 1, **self.qconv)
        self.bn3 = BatchNorm(out_planes)
        self.nonlin3 = _nonlin(nonlins[1])
        self.shortcut = _Shortcut(in_planes, out_planes, stride,
                                  use_bias=False, generator=generator)

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None,
                bn_fold: bool = False) -> torch.Tensor:
        fold = self._fold(bn_fold)
        out = x
        for conv, bn, nonlin in ((self.conv1, self.bn1, self.nonlin1),
                                 (self.conv2, self.bn2, self.nonlin2),
                                 (self.conv3, self.bn3, None)):
            out = conv(out, dtype, fold)
            if not fold:
                out = bn(out, dtype)
            if nonlin is not None:
                out = nonlin(out)
        return self.nonlin3(out + self.shortcut(x, dtype))


class XnorBottleneckBlock(_Block):
    """Bottleneck with XNOR-Net ordering: BN -> quant-conv -> nonlin per
    sub-conv, biased convs, one fp shortcut around the block
    (resnet.py:266-340). double_shortcut raises: the 1x1 convs change
    the channel count."""

    xnor = True
    expansion = 4

    def __init__(self, in_planes: int, planes: int, x_quant: str,
                 w_quant: str, nonlins: Sequence[str], stride: int = 1,
                 double_shortcut: bool = False,
                 clamp: Optional[dict[str, Any]] = None,
                 moving_average_mode: str = 'off',
                 solver_mode: str = 'exact', calibrate: bool = False,
                 inference_mode: str = 'packed', pass_fusion: bool = True,
                 sign_compute: str = 'auto',
                 generator: Optional[torch.Generator] = None,
                 moving_average_momentum: float = 0.99):
        if double_shortcut:
            raise ValueError(
                'double_shortcut is only defined for basic blocks '
                '(channel counts change inside a bottleneck).')
        super().__init__(x_quant, w_quant, nonlins, clamp,
                         moving_average_mode, solver_mode, calibrate,
                         inference_mode, pass_fusion, sign_compute, True, generator,
                         moving_average_momentum=moving_average_momentum)
        out_planes = planes * self.expansion
        self.bn1 = BatchNorm(in_planes)
        self.conv1 = QuantConv2d(in_planes, planes, 1, **self.qconv)
        self.nonlin1 = _nonlin(nonlins[0])
        self.bn2 = BatchNorm(planes)
        self.conv2 = QuantConv2d(planes, planes, 3, stride=stride,
                                 padding=1, **self.qconv)
        self.nonlin2 = _nonlin(nonlins[0])
        self.bn3 = BatchNorm(planes)
        self.conv3 = QuantConv2d(planes, out_planes, 1, **self.qconv)
        self.nonlin3 = _nonlin(nonlins[1])
        self.shortcut = _Shortcut(in_planes, out_planes, stride,
                                  use_bias=True, generator=generator)

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None,
                bn_fold: bool = False) -> torch.Tensor:
        fold = self._fold(bn_fold)
        out = x
        for bn, conv, nonlin in ((self.bn1, self.conv1, self.nonlin1),
                                 (self.bn2, self.conv2, self.nonlin2),
                                 (self.bn3, self.conv3, None)):
            if not fold:
                out = bn(out, dtype)
            out = conv(out, dtype, fold)
            if nonlin is not None:
                out = nonlin(out)
        return self.nonlin3(out + self.shortcut(x, dtype))


def remat_block(block: nn.Module, x: torch.Tensor,
                dtype: Optional[torch.dtype]) -> torch.Tensor:
    """block(x, dtype) under torch.utils.checkpoint, JAX's nn.remat: the
    backward pass recomputes the block's activations instead of keeping
    them. The recomputation starts from the state the forward saw and
    leaves the state the forward wrote (BN statistics, w_vs, EMA are
    written once, and 'train_and_eval' re-blends from the same EMA)."""
    before = [(b, b.clone()) for b in block.buffers()]
    ran = []

    def run(inp: torch.Tensor) -> torch.Tensor:
        if not ran:
            ran.append(True)
            return block(inp, dtype)
        with state_unchanged(block):
            with torch.no_grad():
                for b, value in before:
                    b.copy_(value)
            return block(inp, dtype)

    return checkpoint(run, x, use_reentrant=False)


BLOCKS = {
    'regular': RegularBasicBlock,
    'xnor': XnorBasicBlock,
    'regular_bottleneck': RegularBottleneckBlock,
    'xnor_bottleneck': XnorBottleneckBlock,
}


class QResNet(nn.Module):
    """ResNet with per-stage quantization config.

    Arguments mirror the JAX QResNet (layer0 configures the fp stem,
    layer1..layer4 carry {x_quant, w_quant, clamp, double_shortcut?}),
    `block` is one of BLOCKS (with num_blocks [3, 4, 6, 3],
    'regular_bottleneck' is ResNet-50). `inference_mode` 'packed' serves
    the binary convs packed, 'dense' runs every conv as a float32 conv of
    the quantized tensors (the fp32 twin: schemes 'fp'). `solver_mode` is
    the opt_v1 mode of the activation solves under moving_average_mode
    'off'; `calibrate` builds the activation quantizers in observer mode
    (nn.export.calibrate_ema_scales). `eval_dtype` (e.g.
    torch.bfloat16) is the feature-map chain's dtype and `bn_fold` serves
    convs that an export fold prepared; both are plain attributes that
    may be changed between forwards. `stem_s2d` runs the stem conv
    in its exact space-to-depth form (`conv1.s2d`; JAX resnet.py:386,409),
    with the same parameters. Parameters start from torch's default init
    drawn from `generator`, or come from a JAX tree via
    utils.jax_import.from_jax_variables.

    Built in eval mode. After `train()` a forward is JAX's train=True
    apply: every conv dense (inference_mode and bn_fold do not apply),
    the chain in `train_dtype` (e.g. torch.bfloat16: stem, BNs' outputs,
    nonlins, shortcuts, quantized operands, head; the solves and BN
    reductions stay float32, the logits are float32), the stem pool
    differentiable (ops.conv.max_pool2d; the pool kernel, which has no
    backward, serves where no gradient is recorded), and with `remat`
    each block under torch.utils.checkpoint (`remat_block`). State
    (BN statistics, w_vs, EMA) is written once a forward.

    Builds on `device` ('cuda' by default; raises if CUDA is missing).
    """

    def __init__(self, block: str, layer0: dict[str, Any],
                 layer1: dict[str, Any], layer2: dict[str, Any],
                 layer3: dict[str, Any], layer4: Optional[dict[str, Any]],
                 nonlins: Sequence[str], num_blocks: Sequence[int],
                 output_classes: int, moving_average_mode: str = 'off',
                 moving_average_momentum: float = 0.99,
                 solver_mode: str = 'exact', calibrate: bool = False,
                 inference_mode: str = 'packed',
                 eval_dtype: DtypeLike = None, pass_fusion: bool = True,
                 sign_compute: str = 'auto', bn_fold: bool = False,
                 stem_s2d: bool = False, in_channels: int = 3,
                 train_dtype: DtypeLike = None, remat: bool = False,
                 device: DeviceLike = 'cuda',
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        if block not in BLOCKS:
            raise ValueError(f'Block {block} is not supported.')
        block_cls = BLOCKS[block]
        self.block = block
        self.moving_average_mode = moving_average_mode
        self.eval_dtype = as_dtype(eval_dtype)
        self.train_dtype = as_dtype(train_dtype)
        self.remat = remat
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
        expansion = getattr(block_cls, 'expansion', 1)
        self.block_names: list[str] = []
        in_planes = width
        for s, (cfg, planes, first_stride) in enumerate(stages):
            cfg = dict(cfg)
            kwargs = dict(x_quant=cfg.pop('x_quant'),
                          w_quant=cfg.pop('w_quant'),
                          clamp=cfg.pop('clamp', None), nonlins=nonlins,
                          moving_average_mode=moving_average_mode,
                          moving_average_momentum=moving_average_momentum,
                          solver_mode=solver_mode, calibrate=calibrate,
                          inference_mode=inference_mode,
                          pass_fusion=pass_fusion, sign_compute=sign_compute,
                          generator=generator, **cfg)
            for b in range(num_blocks[s]):
                name = f'layer{s + 1}_block{b}'
                self.add_module(name, block_cls(
                    in_planes, planes, stride=first_stride if b == 0 else 1,
                    **kwargs))
                self.block_names.append(name)
                in_planes = planes * expansion
        self.fc = Dense(in_planes, output_classes, generator=generator)
        self.to(dev)
        self.eval()

    def blocks(self) -> Iterator[tuple[str, _Block]]:
        for name in self.block_names:
            yield name, getattr(self, name)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC images -> float32 logits (eval under torch.no_grad)."""
        if self.training:
            return self._forward(x, self.train_dtype, False)
        with torch.no_grad():
            return self._forward(x, self.eval_dtype, self.bn_fold)

    def _forward(self, x: torch.Tensor, dt: Optional[torch.dtype],
                 bn_fold: bool) -> torch.Tensor:
        if dt is not None:
            x = x.to(dt)
        x = torch.relu(self.bn1(self.conv1(x, dt), dt))
        mp = self.maxpool
        grad = torch.is_grad_enabled()
        if mp['type'] == 'maxpool2d':
            if pool_fusable(tuple(x.shape), mp['kernel_size'], mp['stride'],
                            mp['padding']) and not (grad and x.requires_grad):
                x = max_pool_3x3_s2_p1(x.contiguous())
            else:
                x = max_pool2d(x, kernel_size=mp['kernel_size'],
                               stride=mp['stride'], padding=mp['padding'])
        remat = self.remat and self.training and grad
        for _, blk in self.blocks():
            x = remat_block(blk, x, dt) if remat else blk(x, dt, bn_fold)
        logits = self.fc(global_avg_pool(x), dt)
        return logits.to(torch.float32)
