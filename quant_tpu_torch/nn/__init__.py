"""Modules of the port: the layers in eval and train form, the QResNet
families, QLeNet5 and the serving preparation (export, calibrate, fold,
strip).

The package exports the JAX package's names (quant_tpu/nn/__init__.py),
name for name. MODEL_REGISTRY maps a config's model.architecture to its
class, as the JAX package's does.
"""

from quant_tpu_torch.nn.layers import (
    ActivationQuantizer,
    BatchNorm,
    Conv,
    Dense,
    QuantConv2d,
    WeightQuantizer,
    scheme_num_scales,
    validate_scheme,
)
from quant_tpu_torch.nn.lenet import QLeNet5
from quant_tpu_torch.nn.resnet import (
    QResNet,
    RegularBasicBlock,
    RegularBottleneckBlock,
    XnorBasicBlock,
    XnorBottleneckBlock,
)

MODEL_REGISTRY = {
    'lenet5': QLeNet5,
    'resnet': QResNet,
}

__all__ = [
    'ActivationQuantizer', 'BatchNorm', 'Conv', 'Dense', 'QuantConv2d',
    'WeightQuantizer', 'scheme_num_scales', 'validate_scheme',
    'QLeNet5', 'QResNet', 'RegularBasicBlock', 'RegularBottleneckBlock',
    'XnorBasicBlock', 'XnorBottleneckBlock',
    'MODEL_REGISTRY',
]
