"""Utilities of the port: logging, checkpoints, profiling, the reference
checkpoint maps and interchange with the JAX package's variable trees.

The package exports the JAX package's names (quant_tpu/utils/
__init__.py), name for name.
"""

from quant_tpu_torch.utils.logging_utils import init_logging

__all__ = ['init_logging']
