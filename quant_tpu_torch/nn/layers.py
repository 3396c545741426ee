"""Eval-form layers of the packed serving path (port of
quant_tpu/nn/layers.py:124-330 and the packed branch of QuantConv2d,
:400-542).

Modules keep the JAX layouts (HWIO kernels, (in, out) dense kernels,
NHWC activations) and the JAX tree's leaf names where PyTorch has no
idiom of its own, so `utils.jax_import.from_jax_variables` maps one
exported variable tree onto them. Everything here is inference only:
the dense QAT path and training are queued for Slice C.
"""

import math
from typing import Any, Callable, Optional, Sequence, Union

import torch
from torch import nn

from quant_tpu_torch.ops import binary_infer as BI
from quant_tpu_torch.ops.conv import _pair, conv2d, stem_conv_s2d
from quant_tpu_torch.ops.quantize import get_clamp_fn, quantizer_ls_1

IntOr2 = Union[int, Sequence[int]]
DtypeLike = Union[None, str, torch.dtype]

_EMA_MODES = ('eval_only', 'train_and_eval')


def as_dtype(dtype: DtypeLike) -> Optional[torch.dtype]:
    """None, a torch dtype, or its name ('bfloat16') -> torch dtype."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype))


def _uniform(shape: Sequence[int], fan_in: int,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    # torch nn.Conv2d / nn.Linear default init: U(-1/sqrt(fan_in), +...).
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    t = torch.empty(tuple(shape), dtype=torch.float32)
    return t.uniform_(-bound, bound, generator=generator)


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _require_ls1(scheme: str, what: str) -> None:
    if scheme != 'ls-1':
        raise NotImplementedError(
            f'{what} {scheme!r}: only ls-1 is ported; fp and the '
            'multi-plane schemes are queued for Slice B.')


class PReLU(nn.Module):
    """PReLU with one shared slope; the slope is cast to x's dtype."""

    def __init__(self, negative_slope_init: float = 0.25):
        super().__init__()
        self.negative_slope = _frozen(
            torch.tensor(negative_slope_init, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.negative_slope.to(x.dtype) * x)


class Conv(nn.Module):
    """Full-precision NHWC conv (HWIO kernel); `dtype` downcasts x, kernel
    and bias for the computation. With `s2d` a 7x7/s2/p3 conv on even H
    and W runs as its exact space-to-depth form (same parameters)."""

    def __init__(self, in_channels: int, features: int,
                 kernel_size: IntOr2, stride: IntOr2 = 1,
                 padding: IntOr2 = 0, use_bias: bool = True,
                 s2d: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kh, kw = _pair(kernel_size)
        fan_in = in_channels * kh * kw
        self.stride, self.padding, self.s2d = stride, padding, s2d
        self.kernel = _frozen(_uniform((kh, kw, in_channels, features),
                                       fan_in, generator))
        self.bias = (_frozen(_uniform((features,), fan_in, generator))
                     if use_bias else None)

    def forward(self, x: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        kernel, bias = self.kernel, self.bias
        if dtype is not None:
            x, kernel = x.to(dtype), kernel.to(dtype)
            bias = bias.to(dtype) if bias is not None else None
        if (self.s2d and kernel.shape[:2] == (7, 7)
                and _pair(self.stride) == (2, 2)
                and _pair(self.padding) == (3, 3)
                and x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0):
            return stem_conv_s2d(x, kernel, bias=bias)
        return conv2d(x, kernel, stride=self.stride, padding=self.padding,
                      bias=bias)


class Dense(nn.Module):
    """Fully-connected layer with an (in, out) kernel."""

    def __init__(self, in_features: int, features: int,
                 use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel = _frozen(_uniform((in_features, features), in_features,
                                       generator))
        self.bias = (_frozen(_uniform((features,), in_features, generator))
                     if use_bias else None)

    def forward(self, x: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        kernel = self.kernel
        if dtype is not None:
            x, kernel = x.to(dtype), kernel.to(dtype)
        y = x @ kernel
        if self.bias is not None:
            y = y + (self.bias.to(dtype) if dtype is not None else self.bias)
        return y


class BatchNorm(nn.Module):
    """Eval BatchNorm as flax computes it: (x - mean) * (rsqrt(var + eps)
    * weight) + bias in float32, rounded once to `dtype`.

    eps 1e-5 as the JAX BatchNorm; its training-time running-stat update
    (torch momentum convention) is Slice C.
    """

    def __init__(self, num_features: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        ones = torch.ones(num_features, dtype=torch.float32)
        zeros = torch.zeros(num_features, dtype=torch.float32)
        self.weight = _frozen(ones.clone())
        self.bias = _frozen(zeros.clone())
        self.register_buffer('running_mean', zeros.clone())
        self.register_buffer('running_var', ones.clone())

    def forward(self, x: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        mul = torch.rsqrt(self.running_var + self.epsilon) * self.weight
        y = (x.to(torch.float32) - self.running_mean) * mul + self.bias
        return y.to(dtype or torch.promote_types(x.dtype, torch.float32))


class ActivationQuantizer(nn.Module):
    """Per-sample activation scales in eval: the EMA broadcast over the
    batch when an EMA mode tracks one, else the batch's own ls-1 solve.
    Only the scales are returned; the packed conv re-derives the signs.
    """

    def __init__(self, scheme: str, moving_average_mode: str = 'off'):
        super().__init__()
        if moving_average_mode not in ('off',) + _EMA_MODES:
            raise ValueError(
                f'Invalid moving average mode {moving_average_mode}.')
        _require_ls1(scheme, 'activation scheme')
        self.scheme = scheme
        self.moving_average_mode = moving_average_mode
        use_ema = moving_average_mode != 'off'
        self.register_buffer(
            'ema', torch.zeros(1, dtype=torch.float32) if use_ema else None)
        self.register_buffer(
            'ema_count',
            torch.zeros((), dtype=torch.int32) if use_ema else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(k, N) scales for x (N leading)."""
        if self.ema is not None:
            return self.ema[:, None].expand(self.ema.shape[0], x.shape[0])
        return quantizer_ls_1(x)[0]


class QuantConv2d(nn.Module):
    """Packed-serving quantized conv: conv(w_quant(w), x_quant(clamp(x))).

    Weights come from the exported `w_packed` / `w_scales` buffers, or,
    before export, from the fp kernel and its cached scales `w_vs`. A
    stripped conv has no kernel and no `w_vs`. With `x_thresh`/`x_flip`
    (from nn.export.fold_xnor_thresholds) x is the raw pre-BN block input
    and the signs come from per-channel threshold compares.
    """

    def __init__(self, in_channels: int, features: int,
                 kernel_size: IntOr2, *, x_quant: str = 'ls-1',
                 w_quant: str = 'ls-1',
                 clamp: Optional[dict[str, Any]] = None,
                 stride: IntOr2 = 1, padding: IntOr2 = 0,
                 use_bias: bool = True, moving_average_mode: str = 'off',
                 sign_compute: str = 'auto',
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _require_ls1(x_quant, 'activation scheme')
        _require_ls1(w_quant, 'weight scheme')
        # 'auto' picks int8 when both sides have one effective plane
        # (layers.py:509-522), which ls-1 x ls-1 always has.
        if sign_compute == 'bf16':
            raise NotImplementedError(
                "sign_compute='bf16' is queued for Slice B; ls-1 x ls-1 "
                "runs the int8 route ('auto').")
        if sign_compute not in ('auto', 'int8'):
            raise ValueError(f'invalid sign_compute {sign_compute!r}')
        kh, kw = _pair(kernel_size)
        fan_in = in_channels * kh * kw
        self.in_channels, self.features = in_channels, features
        self.x_quant, self.w_quant = x_quant, w_quant
        self.clamp = dict(clamp) if clamp else {'kind': 'identity'}
        self.stride, self.padding = stride, padding
        self.moving_average_mode = moving_average_mode
        self.kernel = _frozen(_uniform((kh, kw, in_channels, features),
                                       fan_in, generator))
        self.bias = (_frozen(_uniform((features,), fan_in, generator))
                     if use_bias else None)
        self.register_buffer('w_vs',
                             torch.zeros(1, features, dtype=torch.float32))
        self.x_quantizer = ActivationQuantizer(x_quant, moving_average_mode)
        for name in ('w_packed', 'w_scales', 'x_thresh', 'x_flip', 'x_va'):
            self.register_buffer(name, None)

    def clamp_fn(self) -> Callable:
        return get_clamp_fn(**self.clamp)

    def pack(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(w_packed (1,kh,kw,Wd,O), w_scales (1,O)) from the fp kernel
        and its cached scales."""
        if self.kernel is None or self.w_vs is None:
            raise ValueError('stripped conv has no kernel to pack')
        w_oi = torch.movedim(self.kernel, -1, 0)
        planes = BI.weight_sign_planes(w_oi, self.w_quant, self.w_vs)
        w_packed = torch.stack([BI.pack_weights(torch.movedim(p, 0, -1))
                                for p in planes])
        return w_packed, self.w_vs.clone()

    def export_packed(self) -> None:
        """Persist the packed weights in the w_packed/w_scales buffers."""
        self.w_packed, self.w_scales = self.pack()

    def forward(self, x: torch.Tensor,
                out_dtype: Optional[torch.dtype] = None,
                bn_folded: bool = False) -> torch.Tensor:
        has_thresh = self.x_thresh is not None
        if bn_folded and not has_thresh:
            raise ValueError(
                'bn_fold serving requested but packed_params carry no '
                'x_thresh — run nn.export.fold_xnor_thresholds on the '
                'exported model first.')
        if has_thresh and not bn_folded:
            raise ValueError(
                'packed_params are BN-folded but the model was not built '
                'with bn_fold=True — applying them through the unfolded '
                'model would run BN twice.')
        if has_thresh and self.moving_average_mode == 'off':
            raise ValueError(
                'threshold-folded serving needs EMA activation scales '
                "(moving_average_mode != 'off'): per-batch eval scales "
                'require the BN output values the folded path never '
                'computes.')
        thresh_kw = {}
        if has_thresh:
            # Folded: signs come from thresholds on the raw x and the EMA
            # scales need no values, so clamp(x) is never computed.
            thresh_kw = dict(x_thresh=self.x_thresh, x_flip=self.x_flip,
                             x_va=self.x_va)
        else:
            x = self.clamp_fn()(x)
        x_vs = self.x_quantizer(x)
        if self.w_packed is not None:
            w_packed, w_scales = self.w_packed, self.w_scales
        else:
            w_packed, w_scales = self.pack()
        return BI.quant_conv2d_infer(
            x,
            x_scheme=self.x_quant, x_vs=x_vs, w_packed=w_packed,
            w_vs=w_scales, in_channels=self.in_channels, bias=self.bias,
            stride=self.stride, padding=self.padding,
            out_dtype=out_dtype or torch.float32, compute_dtype='int8',
            **thresh_kw)
