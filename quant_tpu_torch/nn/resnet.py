"""QResNet and its four block families (port of quant_tpu/nn/resnet.py):
the regular (conv->BN) and XNOR (BN->conv) orderings, each as basic and
bottleneck blocks, in eval and train form.

Module names match the JAX variable tree (conv1, bn1, layer{s}_block{b},
fc; inside a block bn1, conv1, nonlin1, ..., conv3, bn3, nonlin3,
shortcut). With `bn_fold` the blocks skip the BNs that an export fold
put into their convs: the epilogue's (`b_fold`, regular families) or
the thresholds (`x_thresh`, XNOR families).

A served block hands the pointwise ops after each binary conv (its
nonlinearity, the residual add with the shortcut's BN, the nonlinearity
after it) to the conv's kernel as its tail (`_Block._conv`,
ops.binary_infer.Tail) where the conv and the ops allow it; everywhere
else the same ops run eagerly after the conv.

Models are built in eval mode; `model.train()` runs the train forward
(nn.layers: batch statistics, solved and cached scales, the dense QAT
convs), with the chain in `train_dtype` and, with `remat`, each block
recomputed in the backward pass.
"""

import contextlib
from typing import Any, Iterator, Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from quant_tpu_torch.device import DeviceLike, resolve_device
from quant_tpu_torch.nn.layers import (
    BatchNorm, Conv, Dense, DtypeLike, PReLU, QuantConv2d, as_dtype,
    state_unchanged,
)
from quant_tpu_torch.ops import binary_infer as BI
from quant_tpu_torch.ops.conv import max_pool2d
from quant_tpu_torch.ops.pool import max_pool_3x3_s2_p1, pool_fusable
from quant_tpu_torch.parallel import global_stats, spatial
from quant_tpu_torch.utils.profiling import span


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
    keeps its width and resolution. A downsample runs in a span of kind
    'shortcut' named `span_name` (QResNet names it by its module path)."""

    span_name = 'shortcut'

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
        with span(self.span_name, 'shortcut'):
            return self.norm(self.conv(x, dtype), dtype)

    def takes_tail(self) -> bool:
        """Whether a tail can apply this shortcut's BN: identity, or an
        unsharded, unbanded downsample."""
        return self.identity or (self.conv.tp is None
                                 and self.conv.space is None
                                 and self.norm.tp is None)

    def for_tail(self, x: torch.Tensor, dtype: Optional[torch.dtype]
                 ) -> tuple[torch.Tensor, Optional[tuple]]:
        """(r, bn) of a block's tail (ops.binary_infer.Tail): x and None
        for the identity, else the downsample conv's output and its BN's
        eval (mean, mul, bias), in the shortcut's span."""
        if self.identity:
            return x, None
        with span(self.span_name, 'shortcut'):
            return self.conv(x, dtype), self.norm.eval_affine()


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

    def tail_engages(self, conv: QuantConv2d, fold: bool,
                     dtype: Optional[torch.dtype],
                     acts: Sequence[Optional[nn.Module]],
                     residual: Optional[torch.Tensor],
                     shortcut: Optional[_Shortcut]) -> bool:
        """Whether `conv` applies the tail in its kernel (_conv): the
        block serves folded, the conv takes a tail, the nonlinearities
        are PReLU or identity, the residual has the conv's output dtype
        and the shortcut's BN can go into the tail."""
        return (fold and conv.takes_tail()
                and all(a is None or isinstance(a, (PReLU, nn.Identity))
                        for a in acts)
                and (residual is None
                     or (residual.dtype == (dtype or torch.float32)
                         and (shortcut is None or shortcut.takes_tail()))))

    def _conv(self, conv: QuantConv2d, x: torch.Tensor,
              dtype: Optional[torch.dtype], fold: bool,
              bn: Optional[BatchNorm] = None,
              act_a: Optional[nn.Module] = None,
              residual: Optional[torch.Tensor] = None,
              shortcut: Optional[_Shortcut] = None,
              act_b: Optional[nn.Module] = None) -> torch.Tensor:
        """conv(x), then bn where the block is not folded (the regular
        families' BN after the conv), then the tail, each part where
        given: act_a, + r, act_b, with r = shortcut(residual), or the
        residual itself where no shortcut is given. Where tail_engages
        holds the conv's kernel applies the tail (the shortcut's conv
        runs first, its BN goes into the tail); otherwise the eager ops
        run it after the conv, the shortcut last."""
        acts = (act_a, act_b)
        if self.tail_engages(conv, fold, dtype, acts, residual, shortcut):
            bn_vecs = None
            if residual is not None and shortcut is not None:
                residual, bn_vecs = shortcut.for_tail(residual, dtype)
            slope_a, slope_b = (a.negative_slope if isinstance(a, PReLU)
                                else None for a in acts)
            return conv(x, dtype, fold, tail=BI.Tail(
                slope_a, residual, bn_vecs, slope_b))
        y = conv(x, dtype, fold)
        if bn is not None and not fold:
            y = bn(y, dtype)
        if act_a is not None:
            y = act_a(y)
        if residual is not None:
            y = y + (residual if shortcut is None
                     else shortcut(residual, dtype))
        return y if act_b is None else act_b(y)

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
        out = self._conv(self.conv1, x, dtype, fold, self.bn1, self.nonlin1)
        return self._conv(self.conv2, out, dtype, fold, self.bn2,
                          residual=x, shortcut=self.shortcut,
                          act_b=self.nonlin2)


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
        double = self.double_shortcut
        out1 = x if fold else self.bn1(x, dtype)
        out1 = self._conv(self.conv1, out1, dtype, fold, act_a=self.nonlin1,
                          residual=x if double else None,
                          shortcut=self.shortcut)
        out2 = out1 if fold else self.bn2(out1, dtype)
        if double:
            return self._conv(self.conv2, out2, dtype, fold,
                              act_a=self.nonlin2, residual=out1)
        return self._conv(self.conv2, out2, dtype, fold, residual=x,
                          shortcut=self.shortcut, act_b=self.nonlin2)


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
                                 (self.conv2, self.bn2, self.nonlin2)):
            out = self._conv(conv, out, dtype, fold, bn, nonlin)
        return self._conv(self.conv3, out, dtype, fold, self.bn3,
                          residual=x, shortcut=self.shortcut,
                          act_b=self.nonlin3)


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
                                 (self.bn2, self.conv2, self.nonlin2)):
            if not fold:
                out = bn(out, dtype)
            out = self._conv(conv, out, dtype, fold, act_a=nonlin)
        if not fold:
            out = self.bn3(out, dtype)
        return self._conv(self.conv3, out, dtype, fold, residual=x,
                          shortcut=self.shortcut, act_b=self.nonlin3)


def remat_block(block: nn.Module, x: torch.Tensor,
                dtype: Optional[torch.dtype],
                name: str = 'block') -> torch.Tensor:
    """block(x, dtype) under torch.utils.checkpoint, JAX's nn.remat: the
    backward pass recomputes the block's activations instead of keeping
    them. The recomputation starts from the state the forward saw and
    leaves the state the forward wrote (BN statistics, w_vs, EMA are
    written once, and 'train_and_eval' re-blends from the same EMA).
    The recomputation also runs under the contexts the forward ran
    under, whenever the backward runs: its statistics reduce over the
    same 'data' group (parallel.global_stats), and in a banded forward it
    runs on the same bands (parallel.spatial.recompute: halos, statistics
    and solves over 'space'). Every rank recomputes the same blocks in
    the same order, so the collectives line up; in a banded model each
    block is recomputed whole (no early stop), so every rank re-issues
    all of its collectives whatever tensors autograd saved. The forward
    and the recomputation each run in a span of kind 'block' named
    `name` (utils.profiling), the recomputation on the thread that runs
    the backward."""
    before = [(b, b.clone()) for b in block.buffers()]
    group = global_stats.current()
    space = global_stats.current_space()
    banded = space is not None and space.banded
    ran = []

    def run(inp: torch.Tensor) -> torch.Tensor:
        with span(name, 'block'):
            if not ran:
                ran.append(True)
                return block(inp, dtype)
            with state_unchanged(block), global_stats.over(group):
                with spatial.recompute(space, banded):
                    with torch.no_grad():
                        for b, value in before:
                            b.copy_(value)
                    return block(inp, dtype)

    whole = (contextlib.nullcontext() if space is None
             else set_checkpoint_early_stop(False))
    with whole:
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

    Banded (`space`, parallel.spatial.band_model), a forward takes this
    rank's row band of the images: the stem, its pool and every block
    whose convs band at their heights run on bands, the map is gathered
    before the first block that does not, and the global average pool
    reduces over the group. In eval and train mode alike: a train
    forward's batch statistics and solves are the whole images', and
    its gradients flow back through the gathers, halos and average pool
    (parallel.spatial), with `remat` too (each block recomputed on its
    bands, `remat_block`).

    A forward runs in spans (utils.profiling): 'forward' (kind 'model'),
    inside it 'stem' (the input cast, conv, BN, ReLU and pool), one
    span of kind 'block' a block under its module name, and 'head'
    (global pool, fc, the cast to float32 logits); each quantized conv
    and downsample shortcut opens its own, named by its module path.

    Builds on `device` ('cuda' by default; raises if CUDA is missing).
    """

    space: Optional[spatial.SpatialParallel] = None

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
        for path, m in self.named_modules():
            if isinstance(m, (QuantConv2d, _Shortcut)):
                m.span_name = path
        self.to(dev)
        self.eval()

    def blocks(self) -> Iterator[tuple[str, _Block]]:
        for name in self.block_names:
            yield name, getattr(self, name)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC images -> float32 logits (eval under torch.no_grad)."""
        with span('forward', 'model'):
            if self.training:
                return self._forward(x, self.train_dtype, False)
            with torch.no_grad():
                return self._forward(x, self.eval_dtype, self.bn_fold)

    def _forward(self, x: torch.Tensor, dt: Optional[torch.dtype],
                 bn_fold: bool) -> torch.Tensor:
        with spatial.forward(self.space):
            return self._layers(x, dt, bn_fold)

    def _pool(self, x: torch.Tensor) -> torch.Tensor:
        """The stem pool, of x or of its row band."""
        mp = self.maxpool
        k, s, p = mp['kernel_size'], mp['stride'], mp['padding']
        x, band = spatial.conv_band(self.space, x, k, s, p)
        pad_top = 1
        if band is not None:
            x, pad_top = band.extend(x), band.pad_top
        if pool_fusable(tuple(x.shape), k, s, p, pad_top) and not (
                torch.is_grad_enabled() and x.requires_grad):
            if band is None:
                return max_pool_3x3_s2_p1(x.contiguous())
            return max_pool_3x3_s2_p1(x.contiguous(), pad_top)
        if band is not None:
            return spatial.max_pool_rows(x, band, k, s, p)
        return max_pool2d(x, kernel_size=k, stride=s, padding=p)

    def _layers(self, x: torch.Tensor, dt: Optional[torch.dtype],
                bn_fold: bool) -> torch.Tensor:
        with span('stem', 'stem'):
            if dt is not None:
                x = x.to(dt)
            x = torch.relu(self.bn1(self.conv1(x, dt), dt))
            if self.maxpool['type'] == 'maxpool2d':
                x = self._pool(x)
        remat = self.remat and self.training and torch.is_grad_enabled()
        for name, blk in self.blocks():
            x = spatial.block_input(self.space, blk, x)
            if remat:
                x = remat_block(blk, x, dt, name)
            else:
                with span(name, 'block'):
                    x = blk(x, dt, bn_fold)
        with span('head', 'head'):
            logits = self.fc(spatial.global_avg_pool(self.space, x), dt)
            return logits.to(torch.float32)
