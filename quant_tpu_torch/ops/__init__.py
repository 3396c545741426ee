"""Tensor functions of the port: signs, packing, quantizers, convs and the
kernel wrappers (`pool`, `binary_gemm`, `binary_infer`).

The package exports the JAX package's quantization functions
(quant_tpu/ops/__init__.py), name for name; `ops.pool` stays out, as
there. Importing a module here builds nothing: each kernel is compiled
at its first launch on a CUDA tensor.
"""

from quant_tpu_torch.ops.ste import binarize, binary_sign
from quant_tpu_torch.ops.optimal import opt_v1
from quant_tpu_torch.ops.quantize import (
    clamp_identity,
    clamp_symmetric,
    quantizer_fp,
    quantizer_ls_1,
    quantizer_ls_2,
    quantizer_ls_ternary,
    quantizer_gf,
)

__all__ = [
    'binarize', 'binary_sign', 'opt_v1',
    'clamp_identity', 'clamp_symmetric', 'quantizer_fp',
    'quantizer_ls_1', 'quantizer_ls_2', 'quantizer_ls_ternary', 'quantizer_gf',
]
