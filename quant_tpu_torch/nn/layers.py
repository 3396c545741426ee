"""Layers of the port in eval and train form (port of
quant_tpu/nn/layers.py:87-564).

Modules keep the JAX layouts (HWIO kernels, (in, out) dense kernels,
NHWC activations) and the JAX tree's leaf names where PyTorch has no
idiom of its own, so `utils.jax_import.from_jax_variables` maps one
variable tree onto them. Parameters are trainable (`requires_grad`);
state (BN statistics, cached weight scales `w_vs`, EMA activation
scales) lives in buffers.

Every module here is built in eval mode, and so is every model, so a
module serves as built; `model.train()` switches to the train forms,
JAX's `train=True`:

- QuantConv2d runs the dense QAT conv whatever `inference_mode` says,
  solves its weight scales on every forward and caches them in `w_vs`
  (eval reads the cache), and casts the quantized operands, bias and
  output to the chain's `train_dtype` when one is set (the solves stay
  float32);
- ActivationQuantizer solves each batch's scales and, in an EMA mode,
  blends their batch mean into `ema` (with 'train_and_eval' it then
  quantizes with the blended scales);
- BatchNorm normalizes with the batch's statistics as flax computes them
  and updates its running statistics.

Values reach the gradient through the straight-through `binarize` and
the clamps' JAX gradients. Train forwards write state in place, so
`state_unchanged` can keep a module's state as it was (a frozen
teacher in train mode, the recomputation of a rematerialized block).

A quantized conv's forward runs in a span of kind 'qconv' named
`span_name`, each solve of scales (an activation quantizer's, a train
forward's weight solve) in one of kind 'solve' (utils.profiling).
"""

import math
from contextlib import contextmanager
from typing import Any, Callable, Iterator, Optional, Sequence, Union

import torch
from torch import nn

from quant_tpu_torch.ops import binary_infer as BI
from quant_tpu_torch.ops.conv import _pair, conv2d, stem_conv_s2d
from quant_tpu_torch.parallel import global_stats, spatial
from quant_tpu_torch.parallel.sharding import (
    TensorParallel, gather_channels, reduce_input_grad,
)
from quant_tpu_torch.ops.quantize import (
    get_clamp_fn, quantize_with_scheme, scheme_num_scales, solve_scales,
    validate_scheme,
)
from quant_tpu_torch.utils.profiling import span

IntOr2 = Union[int, Sequence[int]]
DtypeLike = Union[None, str, torch.dtype]

_EMA_MODES = ('eval_only', 'train_and_eval')


def as_dtype(dtype: DtypeLike) -> Optional[torch.dtype]:
    """None, a torch dtype, or its name ('bfloat16') -> torch dtype."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype))


Init = Callable[..., torch.Tensor]


def _uniform_init(fan_in: Callable[[tuple[int, ...]], int],
                  dtype: torch.dtype) -> Init:
    def init(shape: Sequence[int],
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        shape = tuple(shape)
        n = fan_in(shape)
        bound = 1.0 / math.sqrt(n) if n > 0 else 0.0
        t = torch.empty(shape, dtype=dtype)
        return t.uniform_(-bound, bound, generator=generator)
    return init


def torch_conv_kernel_init(dtype: torch.dtype = torch.float32) -> Init:
    """torch nn.Conv2d / nn.Linear default kernel init: an initializer
    `init(shape, generator=None)` drawing U(-1/sqrt(fan_in),
    +1/sqrt(fan_in)), fan_in the product of every axis but the last
    (an HWIO kernel's (Cin // groups) * kh * kw, a dense kernel's in)."""
    return _uniform_init(lambda shape: math.prod(shape[:-1]), dtype)


def torch_bias_init(fan_in: int, dtype: torch.dtype = torch.float32
                    ) -> Init:
    """torch Conv2d / Linear default bias init: an initializer
    `init(shape, generator=None)` drawing U(-1/sqrt(fan_in),
    +1/sqrt(fan_in)) (0 where fan_in is 0)."""
    return _uniform_init(lambda shape: fan_in, dtype)


def _gathered(module: nn.Module, y: torch.Tensor) -> torch.Tensor:
    """y, a sharded module's slice of the output channels, gathered over
    its 'model' group (parallel.sharding.shard_model); y as it is for a
    module that is not sharded."""
    return y if module.tp is None else gather_channels(y, module.tp)


def _sharded_input(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """x, the whole input of a sharded module, with its gradient summed
    over the 'model' group (each rank's backward gives its slice's part);
    x as it is for a module that is not sharded."""
    return x if module.tp is None else reduce_input_grad(x, module.tp)


@contextmanager
def state_unchanged(module: nn.Module) -> Iterator[None]:
    """Run the body and put every buffer of `module` back as it was: the
    train forwards' state writes (BN statistics, w_vs, EMA) are undone,
    as JAX throws away the state a non-mutable apply returns."""
    saved = [(b, b.clone()) for b in module.buffers()]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, value in saved:
                b.copy_(value)


class PReLU(nn.Module):
    """PReLU with one shared slope; the slope is cast to x's dtype. At
    x = 0 the gradient is 1, as jnp.where's (F.prelu's is the slope)."""

    def __init__(self, negative_slope_init: float = 0.25):
        super().__init__()
        self.negative_slope = nn.Parameter(
            torch.tensor(negative_slope_init, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return BI.prelu(x, self.negative_slope)


class Conv(nn.Module):
    """Full-precision NHWC conv (HWIO kernel); `dtype` downcasts x, kernel
    and bias for the computation. The kernel is (kh, kw, Cin // groups,
    features). With `s2d` a 7x7/s2/p3 ungrouped conv on even H and W runs
    as its exact space-to-depth form (same parameters).
    Sharded (`tp`), it holds its slice of the out-channels and gathers
    its output, as Dense and QuantConv2d do. Banded (`space`,
    parallel.spatial.band_model), it convolves its row band and the halo
    rows its neighbours send."""

    tp: Optional[TensorParallel] = None
    space: Optional[spatial.SpatialParallel] = None

    def __init__(self, in_channels: int, features: int,
                 kernel_size: IntOr2, stride: IntOr2 = 1,
                 padding: IntOr2 = 0, use_bias: bool = True,
                 groups: int = 1, s2d: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kh, kw = _pair(kernel_size)
        fan_in = in_channels // groups * kh * kw
        self.kernel_size = (kh, kw)
        self.stride, self.padding, self.s2d = stride, padding, s2d
        self.groups = groups
        self.kernel = nn.Parameter(torch_conv_kernel_init()(
            (kh, kw, in_channels // groups, features), generator))
        self.bias = (nn.Parameter(torch_bias_init(fan_in)(
            (features,), generator)) if use_bias else None)

    def forward(self, x: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        x, band = spatial.conv_band(self.space, x, self.kernel_size,
                                    self.stride, self.padding)
        kernel, bias = self.kernel, self.bias
        x = _sharded_input(self, x)
        if dtype is not None:
            x, kernel = x.to(dtype), kernel.to(dtype)
            bias = bias.to(dtype) if bias is not None else None
        if band is not None:
            return spatial.conv_rows(x, kernel, band, self.stride,
                                     self.padding, bias)
        if (self.s2d and kernel.shape[:2] == (7, 7)
                and _pair(self.stride) == (2, 2)
                and _pair(self.padding) == (3, 3) and self.groups == 1
                and x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0):
            return _gathered(self, stem_conv_s2d(x, kernel, bias=bias))
        return _gathered(self, conv2d(x, kernel, stride=self.stride,
                                      padding=self.padding,
                                      groups=self.groups, bias=bias))


class Dense(nn.Module):
    """Fully-connected layer with an (in, out) kernel."""

    tp: Optional[TensorParallel] = None

    def __init__(self, in_features: int, features: int,
                 use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel = nn.Parameter(torch_conv_kernel_init()(
            (in_features, features), generator))
        self.bias = (nn.Parameter(torch_bias_init(in_features)(
            (features,), generator)) if use_bias else None)

    def forward(self, x: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        kernel = self.kernel
        x = _sharded_input(self, x)
        if dtype is not None:
            x, kernel = x.to(dtype), kernel.to(dtype)
        y = x @ kernel
        if self.bias is not None:
            y = y + (self.bias.to(dtype) if dtype is not None else self.bias)
        return _gathered(self, y)


class BatchNorm(nn.Module):
    """BatchNorm as flax computes it, with torch's conventions (momentum
    is the new statistics' weight, 0.1 by default; eps 1e-5). Affine-free
    (`affine=False`, LeNet-5's) has no weight and no bias.

    Eval: (x - mean) * (rsqrt(var + eps) * weight) + bias in float32 on
    the running statistics, rounded once to `dtype`. Train (flax 0.12
    normalization.py:60-142): the batch's mean and fast variance
    max(0, E[x^2] - E[x]^2) over N, H, W, reduced in at least float32
    whatever x's dtype, normalize the same way, and the running
    statistics become (1 - momentum) * old + momentum * batch (the biased
    batch variance, where F.batch_norm would update with the unbiased one);
    the output is `dtype`, else x's dtype promoted with the affine's.
    Under a data-parallel train step (parallel.global_stats.over) the
    batch's statistics are the global batch's, over every rank's rows;
    in a banded forward (parallel.spatial) they are the whole images',
    over the 'space' group's bands too, until the map is gathered.
    Sharded (`tp`), it holds its slice of the bias (JAX's rules shard a
    `bias` leaf) and gathers it; all else is whole.
    """

    tp: Optional[TensorParallel] = None

    def __init__(self, num_features: int, epsilon: float = 1e-5,
                 affine: bool = True, momentum: float = 0.1):
        super().__init__()
        self.epsilon = epsilon
        self.momentum = momentum  # flax's is 1 - momentum
        ones = torch.ones(num_features, dtype=torch.float32)
        zeros = torch.zeros(num_features, dtype=torch.float32)
        self.weight = nn.Parameter(ones.clone()) if affine else None
        self.bias = nn.Parameter(zeros.clone()) if affine else None
        self.register_buffer('running_mean', zeros.clone())
        self.register_buffer('running_var', ones.clone())
        self.eval()

    def scale(self, eps: float) -> torch.Tensor:
        """The eval affine's a = gamma / sqrt(var + eps), as the export
        folds compute it (gamma = 1 when affine-free)."""
        g = (self.weight if self.weight is not None
             else torch.ones_like(self.running_var))
        # torch's float32 sqrt on the CPU can land an ulp off the
        # correctly rounded root that XLA takes (seen at var ~ 1.23); a
        # float64 root rounded once to float32 is the correctly rounded
        # one.
        var = self.running_var + eps
        return g / torch.sqrt(var.double()).to(var.dtype)

    def _affine(self, mean: torch.Tensor, var: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor,
                           Optional[torch.Tensor]]:
        """(mean, mul, bias) of the normalization (x - mean) * mul +
        bias, mul = rsqrt(var + eps) * weight."""
        mul = torch.rsqrt(var + self.epsilon)
        if self.weight is not None:
            mul = mul * self.weight
        bias = None if self.bias is None else _gathered(self, self.bias)
        return mean, mul, bias

    def eval_affine(self) -> tuple[torch.Tensor, torch.Tensor,
                                   Optional[torch.Tensor]]:
        """The eval forward's (mean, mul, bias), float32 (O,) vectors: a
        block's tail applies its shortcut's BN with them
        (ops.binary_infer.Tail)."""
        return self._affine(self.running_mean, self.running_var)

    def _normalize(self, x: torch.Tensor, mean: torch.Tensor,
                   var: torch.Tensor) -> torch.Tensor:
        return BI.bn_affine(x, *self._affine(mean, var))

    def forward(self, x: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        if self.training:
            return self._train(x, dtype)
        y = self._normalize(x, self.running_mean, self.running_var)
        return y.to(dtype or self._out_dtype(x))

    def _train(self, x: torch.Tensor,
               dtype: Optional[torch.dtype]) -> torch.Tensor:
        xs = x.to(torch.promote_types(x.dtype, torch.float32))
        axes = tuple(range(x.ndim - 1))
        mean, mean2 = global_stats.batch_means([xs, xs * xs], axes)
        var = torch.maximum(mean2 - mean * mean, torch.zeros_like(mean))
        keep = 1.0 - self.momentum  # flax's momentum
        with torch.no_grad():
            self.running_mean.copy_(keep * self.running_mean
                                    + (1 - keep) * mean)
            self.running_var.copy_(keep * self.running_var
                                   + (1 - keep) * var)
        y = self._normalize(x, mean, var)
        return y.to(dtype or self._out_dtype(x))

    def _out_dtype(self, x: torch.Tensor) -> torch.dtype:
        # flax's canonicalize_dtype of x and the affine's parameters:
        # x's dtype promoted with the affine's, x's own when affine-free.
        if self.weight is None:
            return x.dtype
        return torch.promote_types(x.dtype, self.weight.dtype)


def quantize_weights(scheme: str, w_oi: torch.Tensor,
                     vs: Optional[torch.Tensor], train: bool, skip: int = 3,
                     mode: str = 'exact'
                     ) -> tuple[Optional[torch.Tensor], torch.Tensor]:
    """w_oi (its leading axis the out-channels) quantized by `scheme` with
    JAX's weight-scale cache (quant_tpu/nn/layers.py:97-120): in train
    mode the scales are solved (ls-2 and ls-T by opt_v1 over every
    `skip`-th element, `mode`) and written into `vs`; otherwise `vs` is
    read as it stands. (the scales used, w_q); fp has neither scales nor
    cache: (None, w_oi)."""
    if scheme == 'fp':
        return None, w_oi
    if not train:
        return vs, quantize_with_scheme(scheme, w_oi, vs, skip, mode)[1]
    with span('solve.w', 'solve'):
        solved, w_q = quantize_with_scheme(scheme, w_oi, None, skip, mode)
        with torch.no_grad():
            vs.copy_(solved)
    return solved, w_q


class WeightQuantizer(nn.Module):
    """Per-out-channel weight quantizer with a cache of its scales
    (quant_tpu/nn/layers.py:85-120): `vs` is the (k, size) buffer, JAX's
    quant_state vs, kept by quantize_weights. fp has no scales and no
    buffer. QuantConv2d keeps the same cache under its own name, `w_vs`,
    so the variable trees stay JAX's."""

    def __init__(self, scheme: str, size: int, skip: int = 3,
                 solver_mode: str = 'exact'):
        super().__init__()
        validate_scheme(scheme)
        self.scheme, self.size = scheme, size
        self.skip, self.solver_mode = skip, solver_mode
        self.register_buffer(
            'vs', torch.zeros(scheme_num_scales(scheme), size,
                              dtype=torch.float32)
            if scheme != 'fp' else None)

    def forward(self, w_oi: torch.Tensor, train: bool,
                return_scales: bool = False) -> Any:
        """w_oi quantized (its leading axis the out-channels); with
        return_scales, (w_q, the (k, size) scales used)."""
        vs, w_q = quantize_weights(self.scheme, w_oi, self.vs, train,
                                   self.skip, self.solver_mode)
        return (w_q, vs) if return_scales else w_q


class ActivationQuantizer(nn.Module):
    """Per-sample activation scales (quant_tpu/nn/layers.py:123-218).
    fp has no scales and no state.

    Eval: the EMA broadcast over the batch when an EMA mode tracks one,
    else the batch's own solve (ls-2 and ls-T by opt_v1 over every
    `skip`-th element, `solver_mode`). With `calibrate` (the observer
    pass of nn.export.calibrate_ema_scales) each forward also solves the
    batch's scales and blends their batch mean into `ema`, then returns
    the blended scales, so later layers see what EMA serving will feed
    them.

    Train: the batch's own solve. An EMA mode blends its batch mean into
    `ema` ('eval_only'), and 'train_and_eval' returns the blended scales
    instead. A blend copies the first batch's scales and later takes
    momentum*old + (1-momentum)*new; `ema_count` counts the batches.
    Under a data-parallel train step (parallel.global_stats.over) the
    batch mean is over every rank's rows; each sample's scales stay its
    own. Given a `space` whose forward is banded (parallel.spatial), x is
    this rank's band of each sample and the solve reads the whole sample
    (spatial.solve_band), so every 'space' rank holds the same scales;
    their batch mean is taken over the 'data' group alone.
    """

    def __init__(self, scheme: str, moving_average_mode: str = 'off',
                 moving_average_momentum: float = 0.99, skip: int = 3,
                 solver_mode: str = 'exact', calibrate: bool = False):
        super().__init__()
        validate_scheme(scheme)
        if moving_average_mode not in ('off',) + _EMA_MODES:
            raise ValueError(
                f'Invalid moving average mode {moving_average_mode}.')
        self.scheme = scheme
        self.moving_average_mode = moving_average_mode
        self.moving_average_momentum = moving_average_momentum
        self.skip, self.solver_mode = skip, solver_mode
        self.calibrate = calibrate
        use_ema = moving_average_mode != 'off' and scheme != 'fp'
        k = scheme_num_scales(scheme)
        self.register_buffer(
            'ema', torch.zeros(k, dtype=torch.float32) if use_ema else None)
        self.register_buffer(
            'ema_count',
            torch.zeros((), dtype=torch.int32) if use_ema else None)
        self.eval()

    def solve(self, x: torch.Tensor,
              space: Optional[spatial.SpatialParallel] = None
              ) -> Optional[torch.Tensor]:
        """The (k, N) scales this batch solves to (None for fp); of the
        whole samples where x is a band of a banded forward over
        `space`."""
        with span('solve.x', 'solve'):
            if space is not None and space.banded:
                return spatial.solve_band(space, self.scheme, x, self.skip,
                                          self.solver_mode)
            return solve_scales(self.scheme, x, self.skip, self.solver_mode)

    def _track(self, batch_vs: torch.Tensor) -> torch.Tensor:
        """Blend the batch mean of batch_vs into the EMA; the blend."""
        new, = global_stats.batch_means([batch_vs], (1,),
                                        differentiable=False, pixels=False)
        m = self.moving_average_momentum
        blended = torch.where(self.ema_count > 0,
                              m * self.ema + (1.0 - m) * new, new)
        with torch.no_grad():
            self.ema.copy_(blended)
            self.ema_count.add_(1)
        return blended

    def forward(self, x: torch.Tensor,
                space: Optional[spatial.SpatialParallel] = None
                ) -> Optional[torch.Tensor]:
        """(k, N) scales for x (N leading); None for fp. `space`: x is a
        band (solve)."""
        if self.scheme == 'fp':
            return None
        k, n = scheme_num_scales(self.scheme), x.shape[0]
        if self.training:
            batch_vs = self.solve(x, space)
            if self.ema is None:
                return batch_vs
            blended = self._track(batch_vs)
            if self.moving_average_mode == 'train_and_eval':
                return blended[:, None].expand(k, n)
            return batch_vs
        if self.calibrate:
            if self.ema is None:
                raise ValueError(
                    "calibrate=True needs an EMA moving_average_mode "
                    "('eval_only'/'train_and_eval') so there is EMA "
                    'state to calibrate.')
            self._track(self.solve(x))
        if self.ema is not None:
            return self.ema[:, None].expand(k, n)
        return self.solve(x)

    def quantize(self, x: torch.Tensor,
                 space: Optional[spatial.SpatialParallel] = None
                 ) -> torch.Tensor:
        """x_q = sum_i v_i * b_i with this batch's scales (x for fp),
        differentiable through the straight-through binarize; the whole
        samples' scales where x is a band (`space`, solve)."""
        return quantize_with_scheme(self.scheme, x, self(x, space))[1]


class QuantConv2d(nn.Module):
    """Quantized conv: conv(w_quant(w), x_quant(clamp(x))) + bias.

    The kernel is (kh, kw, in_channels // groups, features). Eval:
    inference_mode 'packed' (with a binary w_quant and one group; a
    grouped conv serves the dense path, as in JAX) serves the packed
    conv of ops.binary_infer: weights from the exported `w_packed` /
    `w_scales` buffers or, before export, from the fp kernel and its
    cached scales `w_vs` ((k, O), the JAX tree's quant_state
    w_quantizer/vs). A stripped conv has no kernel and no `w_vs`. With
    `x_thresh`/`x_flip`/`x_va` (nn.export.fold_xnor_thresholds) x is the
    raw pre-BN input and the signs come from per-channel threshold
    compares; with `b_fold` (nn.export.fold_bn_into_packed) the following
    BN lives in `w_scales` and `b_fold`. fp activations take
    fp_activation_conv_infer. `sign_compute` picks the sign-plane route:
    'int8' (the kernels, exact), 'bf16' (the bake when `pass_fusion`,
    else the pass loop) or 'auto', JAX's rule: int8 when both sides have
    one effective plane (ls-1, ls-T), bf16 otherwise.

    inference_mode 'dense' (and an fp w_quant) runs the conv of the
    quantized tensors in float32, as JAX's eval forward does.

    Train (layers.py:544-564), whatever inference_mode says: the weight
    scales are solved (`solver_mode`, every 3rd element) and cached in
    `w_vs`, the activations quantized with the train form of the
    activation quantizer, and both quantized tensors convolved. The
    forward's `out_dtype` is the chain's train_dtype: when set, the
    quantized operands and the bias are cast to it and the conv's output
    stays in it; else the conv runs in float32.

    `solver_mode` and `calibrate` reach the activation quantizer; its
    solves take every 3rd element of a row, as JAX's quantizers.

    Sharded (`tp`, parallel.sharding.shard_model), the conv holds its
    slice of the out-channels (kernel, bias, w_vs, w_packed, w_scales),
    takes the matching slice of b_fold into its epilogue (b_fold is
    replicated, as JAX leaves it), computes its slice of the output from
    the whole input (the activation scales and the fold's thresholds are
    per input channel: whole) and gathers it. The weight solves of train
    mode then run on the slice: they reduce over (kh, kw, I) alone.

    Served on the int8 route, unsharded and unbanded (`takes_tail`), a
    conv takes its block's tail (ops.binary_infer.Tail: PReLU, residual
    add with the shortcut's BN, PReLU), which its kernel applies before
    it stores the output.

    Banded (`space`, parallel.spatial.band_model), a packed conv runs on
    its row band: the int8 route exchanges the halo rows of its packed
    sign words, the other routes those of x, and each conv pads only the
    image's own edges; a per-batch solve reads the whole sample, gathered
    over 'space'. A dense eval conv runs on the gathered map and keeps
    its band. The train form quantizes its band with the whole samples'
    scales, exchanges the halo rows of the quantized operand (whose
    backward returns their gradient to their owner) and runs the dense
    conv with zero edges, as JAX's dense conv pads its quantized operand.
    """

    tp: Optional[TensorParallel] = None
    space: Optional[spatial.SpatialParallel] = None
    span_name = 'qconv'

    def __init__(self, in_channels: int, features: int,
                 kernel_size: IntOr2, *, x_quant: str = 'ls-1',
                 w_quant: str = 'ls-1',
                 clamp: Optional[dict[str, Any]] = None,
                 stride: IntOr2 = 1, padding: IntOr2 = 0,
                 use_bias: bool = True, groups: int = 1,
                 moving_average_mode: str = 'off',
                 moving_average_momentum: float = 0.99,
                 solver_mode: str = 'exact', calibrate: bool = False,
                 inference_mode: str = 'packed', pass_fusion: bool = True,
                 sign_compute: str = 'auto',
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        validate_scheme(x_quant)
        validate_scheme(w_quant)
        if sign_compute not in ('auto', 'int8', 'bf16'):
            raise ValueError(f'invalid sign_compute {sign_compute!r}')
        if inference_mode not in ('packed', 'dense'):
            raise ValueError(f'invalid inference_mode {inference_mode!r}')
        kh, kw = _pair(kernel_size)
        fan_in = in_channels // groups * kh * kw
        self.kernel_size = (kh, kw)
        self.in_channels, self.features = in_channels, features
        self.groups = groups
        self.x_quant, self.w_quant = x_quant, w_quant
        self.clamp = dict(clamp) if clamp else {'kind': 'identity'}
        self.stride, self.padding = stride, padding
        self.moving_average_mode = moving_average_mode
        self.inference_mode = inference_mode
        self.pass_fusion, self.sign_compute = pass_fusion, sign_compute
        self.solver_mode = solver_mode
        self.kernel = nn.Parameter(torch_conv_kernel_init()(
            (kh, kw, in_channels // groups, features), generator))
        self.bias = (nn.Parameter(torch_bias_init(fan_in)(
            (features,), generator)) if use_bias else None)
        k_w = scheme_num_scales(w_quant)
        self.register_buffer(
            'w_vs', torch.zeros(k_w, features, dtype=torch.float32)
            if w_quant != 'fp' else None)
        self.x_quantizer = ActivationQuantizer(
            x_quant, moving_average_mode, moving_average_momentum,
            solver_mode=solver_mode, calibrate=calibrate)
        for name in ('w_packed', 'w_scales', 'x_thresh', 'x_flip', 'x_va',
                     'b_fold'):
            self.register_buffer(name, None)
        self.eval()

    def clamp_fn(self) -> Callable:
        return get_clamp_fn(**self.clamp)

    @property
    def packable(self) -> bool:
        """Whether the packed path can serve this conv: binary weights,
        one group (JAX's grouped conv serves dense)."""
        return self.w_quant != 'fp' and self.groups == 1

    @property
    def packed(self) -> bool:
        """Whether this conv serves the packed path."""
        return self.inference_mode == 'packed' and self.packable

    def _w_oi(self) -> torch.Tensor:
        if self.kernel is None or (self.w_quant != 'fp'
                                   and self.w_vs is None):
            raise ValueError(
                'stripped conv has no kernel to quantize' + (
                    f' (groups={self.groups}: a grouped conv serves the '
                    'dense path, which needs the kernel)'
                    if self.groups != 1 else ''))
        return torch.movedim(self.kernel, -1, 0)

    def pack(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(w_packed (k,kh,kw,Wd,O), w_scales (k,O)) from the fp kernel
        and its cached scales."""
        planes = BI.weight_sign_planes(self._w_oi(), self.w_quant, self.w_vs)
        w_packed = torch.stack([BI.pack_weights(torch.movedim(p, 0, -1))
                                for p in planes])
        scales = BI.weight_scales_for_planes(self.w_quant, self.w_vs)
        return w_packed, scales.clone()

    def export_packed(self) -> None:
        """Persist the packed weights in the w_packed/w_scales buffers."""
        self.w_packed, self.w_scales = self.pack()

    def _dense(self, x: torch.Tensor) -> torch.Tensor:
        x_q = self.x_quantizer.quantize(self.clamp_fn()(x))
        w_q = torch.movedim(quantize_weights(
            self.w_quant, self._w_oi(), self.w_vs, False,
            mode=self.solver_mode)[1], 0, -1)
        if x_q.dtype != w_q.dtype:
            raise TypeError(
                'the dense conv takes operands of one dtype (as '
                f'lax.conv_general_dilated), got {x_q.dtype} and '
                f'{w_q.dtype}')
        return conv2d(x_q, w_q, stride=self.stride, padding=self.padding,
                      groups=self.groups, bias=self.bias).to(torch.float32)

    def _train(self, x: torch.Tensor, dtype: Optional[torch.dtype],
               band: Optional[BI.RowBand] = None) -> torch.Tensor:
        w_oi = quantize_weights(self.w_quant, self._w_oi(), self.w_vs, True,
                                mode=self.solver_mode)[1]
        x_q = self.x_quantizer.quantize(
            self.clamp_fn()(x), self.space if band is not None else None)
        w_q, bias = torch.movedim(w_oi, 0, -1), self.bias
        if dtype is not None:
            x_q, w_q = x_q.to(dtype), w_q.to(dtype)
            bias = bias.to(dtype) if bias is not None else None
        if band is not None:
            y = spatial.conv_rows(x_q, w_q, band, self.stride, self.padding,
                                  bias)
        else:
            y = conv2d(x_q, w_q, stride=self.stride, padding=self.padding,
                       groups=self.groups, bias=bias)
        return y if dtype is not None else y.to(torch.float32)

    def _sign_compute(self) -> str:
        if self.sign_compute != 'auto':
            return self.sign_compute
        def one_plane(scheme: str) -> bool:  # one effective plane
            return scheme == 'ls-T' or BI.sign_planes(scheme) == 1
        one_pass = one_plane(self.x_quant) and one_plane(self.w_quant)
        return 'int8' if one_pass else 'bf16'

    def takes_tail(self) -> bool:
        """Whether this conv's eval forward can apply a block's tail
        (ops.binary_infer.Tail) in its kernel's epilogue: it serves packed
        through the int8 route with binary activations, unsharded and
        unbanded."""
        return (not self.training and self.packed and self.x_quant != 'fp'
                and self._sign_compute() == 'int8' and self.tp is None
                and self.space is None)

    def forward(self, x: torch.Tensor,
                out_dtype: Optional[torch.dtype] = None,
                bn_folded: bool = False,
                tail: Optional[BI.Tail] = None) -> torch.Tensor:
        """The conv of x; with `tail` (where takes_tail holds), the
        conv's output with the tail applied."""
        with span(self.span_name, 'qconv'):
            if tail is not None:
                if not self.takes_tail():
                    raise ValueError(f'{self.span_name} takes no tail')
                return self._forward(x, out_dtype, bn_folded, tail=tail)
            x, band = spatial.conv_band(self.space, x, self.kernel_size,
                                        self.stride, self.padding)
            if band is not None:
                return self._forward(x, out_dtype, bn_folded, band)
            return _gathered(self, self._forward(_sharded_input(self, x),
                                                 out_dtype, bn_folded))

    def _b_fold(self) -> torch.Tensor:
        """b_fold, or this rank's slice of it when sharded."""
        if self.tp is None:
            return self.b_fold
        return self.b_fold.chunk(self.tp.size)[self.tp.index]

    def _forward(self, x: torch.Tensor, out_dtype: Optional[torch.dtype],
                 bn_folded: bool, band: Optional[BI.RowBand] = None,
                 tail: Optional[BI.Tail] = None) -> torch.Tensor:
        if self.training:
            return self._train(x, out_dtype, band)
        if not self.packed:
            if band is None:
                return self._dense(x)
            whole = self._dense(spatial.gather_rows(x, self.space))
            return spatial.output_band(self.space, whole)
        has_fold = self.b_fold is not None
        has_thresh = self.x_thresh is not None
        if bn_folded and not (has_fold or has_thresh):
            raise ValueError(
                'bn_fold serving requested but packed_params carry no '
                'b_fold/x_thresh — run nn.export.fold_bn_into_packed '
                '(conv->BN families) or fold_xnor_thresholds (BN->conv '
                'families) on the exported model first.')
        if (has_fold or has_thresh) and not bn_folded:
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
        q = self.x_quantizer
        solves = q.ema is None or q.calibrate  # reads x's values
        x_vs = q(spatial.solve_input(self.space, x) if band is not None
                 and solves else x)
        if self.w_packed is not None:
            w_packed, w_scales = self.w_packed, self.w_scales
        else:
            w_packed, w_scales = self.pack()
        common = dict(w_packed=w_packed, w_vs=w_scales,
                      in_channels=self.in_channels,
                      bias=self._b_fold() if has_fold else self.bias,
                      stride=self.stride, padding=self.padding,
                      out_dtype=out_dtype or torch.float32,
                      fused=self.pass_fusion, band=band)
        if self.x_quant == 'fp':
            if has_thresh:
                raise ValueError(
                    'threshold folding is undefined for fp activations '
                    '(they consume BN output values).')
            return BI.fp_activation_conv_infer(x, **common)
        return BI.quant_conv2d_infer(
            x, x_scheme=self.x_quant, x_vs=x_vs,
            w_planes_share_scale=self.w_quant == 'ls-T',
            compute_dtype='int8' if self._sign_compute() == 'int8' else None,
            tail=tail, **common, **thresh_kw)
