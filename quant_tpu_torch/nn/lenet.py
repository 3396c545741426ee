"""QLeNet5 in eval and train form (port of quant_tpu/nn/lenet.py).

fp conv1 (5x5) -> relu -> BN(affine-free, eps 1e-4) -> 2x2 max pool ->
BN -> quantized conv2 (5x5) -> relu -> 2x2 max pool -> NHWC flatten ->
fp fc1 -> relu -> fp fc2 -> log_softmax. Module names match the JAX
tree (conv1, bn_conv1, bn_conv2, conv2, fc1, fc2). The 2x2 pools stay
PyTorch ops: JAX runs them with reduce_window, outside any Pallas
kernel. With `bn_fold`, bn_conv2 lives in conv2's thresholds
(nn.export.fold_xnor_thresholds). Built in eval mode; after
`train()` the forward is JAX's train=True apply (BN on batch
statistics, the dense QAT conv2, the chain in `train_dtype`), whose
log-probabilities feed the MNIST recipes' nll_loss. Banded
(parallel.spatial.band_model), conv1 (VALID, not shape-preserving)
gathers the images' bands and the forward, train or eval, runs whole on
every rank.
"""

from typing import Any, Optional

import torch
from torch import nn

from quant_tpu_torch.device import DeviceLike, resolve_device
from quant_tpu_torch.nn.layers import (
    BatchNorm, Conv, Dense, DtypeLike, QuantConv2d, as_dtype,
)
from quant_tpu_torch.ops.conv import max_pool2d
from quant_tpu_torch.parallel import spatial

_BN_EPS = 1e-4


class QLeNet5(nn.Module):
    """LeNet-5 with a quantized second conv; `solver_mode` and `calibrate`
    reach its activation quantizer and `eval_dtype` and `bn_fold` are
    plain attributes, as on QResNet. Builds on `device` ('cuda' by
    default; raises if CUDA is missing)."""

    space: Optional[spatial.SpatialParallel] = None

    def __init__(self, conv1_filters: int = 20, conv2_filters: int = 50,
                 output_classes: int = 10, x_quant: str = 'fp',
                 w_quant: str = 'fp',
                 clamp: Optional[dict[str, Any]] = None,
                 moving_average_mode: str = 'off',
                 moving_average_momentum: float = 0.99,
                 solver_mode: str = 'exact', calibrate: bool = False,
                 inference_mode: str = 'packed',
                 eval_dtype: DtypeLike = None, pass_fusion: bool = True,
                 sign_compute: str = 'auto', bn_fold: bool = False,
                 in_channels: int = 1, train_dtype: DtypeLike = None,
                 device: DeviceLike = 'cuda',
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.x_quant, self.w_quant = x_quant, w_quant
        self.moving_average_mode = moving_average_mode
        self.inference_mode = inference_mode
        self.eval_dtype = as_dtype(eval_dtype)
        self.train_dtype = as_dtype(train_dtype)
        self.bn_fold = bn_fold
        self.conv1 = Conv(in_channels, conv1_filters, 5, generator=generator)
        self.bn_conv1 = BatchNorm(conv1_filters, _BN_EPS, affine=False)
        self.bn_conv2 = BatchNorm(conv1_filters, _BN_EPS, affine=False)
        self.conv2 = QuantConv2d(
            conv1_filters, conv2_filters, 5, x_quant=x_quant,
            w_quant=w_quant, clamp=clamp,
            moving_average_mode=moving_average_mode,
            moving_average_momentum=moving_average_momentum,
            solver_mode=solver_mode, calibrate=calibrate,
            inference_mode=inference_mode, pass_fusion=pass_fusion,
            sign_compute=sign_compute, generator=generator)
        # 28 px in: conv1 24, pool 12, conv2 8, pool 4.
        self.fc1 = Dense(16 * conv2_filters, conv2_filters * output_classes,
                         generator=generator)
        self.fc2 = Dense(conv2_filters * output_classes, output_classes,
                         generator=generator)
        self.to(dev)
        self.eval()

    def fold_pairs(self) -> list[tuple[str, QuantConv2d, BatchNorm]]:
        """The (name, conv, BN before it) the threshold fold takes."""
        return [('conv2', self.conv2, self.bn_conv2)]

    def _fold(self) -> bool:
        return (self.bn_fold and self.inference_mode == 'packed'
                and self.w_quant != 'fp' and self.x_quant != 'fp')

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC images (N, 28, 28, 1) -> float32 log-probabilities (eval
        under torch.no_grad)."""
        if self.training:
            return self._forward(x, self.train_dtype, False)
        with torch.no_grad():
            return self._forward(x, self.eval_dtype, self._fold())

    def _forward(self, x: torch.Tensor, dt: Optional[torch.dtype],
                 fold: bool) -> torch.Tensor:
        with spatial.forward(self.space):
            return self._layers(x, dt, fold)

    def _layers(self, x: torch.Tensor, dt: Optional[torch.dtype],
                fold: bool) -> torch.Tensor:
        if dt is not None:
            x = x.to(dt)
        x = self.bn_conv1(torch.relu(self.conv1(x, dt)))
        x = max_pool2d(x, kernel_size=2, stride=2)
        if not fold:
            x = self.bn_conv2(x)
        x = torch.relu(self.conv2(x, dt, fold))
        x = max_pool2d(x, kernel_size=2, stride=2)
        x = x.reshape(x.shape[0], -1)  # NHWC order, as JAX flattens
        x = torch.relu(self.fc1(x, dt))
        x = self.fc2(x, dt)
        return torch.log_softmax(x.to(torch.float32), dim=-1)
