"""Modules of the port: eval-form layers, the QResNet families, QLeNet5
and the serving preparation (export, calibrate, fold, strip).

MODEL_REGISTRY maps a config's model.architecture to its class, as the
JAX package's does.
"""

from quant_tpu_torch.nn.lenet import QLeNet5
from quant_tpu_torch.nn.resnet import QResNet

MODEL_REGISTRY = {
    'lenet5': QLeNet5,
    'resnet': QResNet,
}

__all__ = ['MODEL_REGISTRY', 'QLeNet5', 'QResNet']
