"""PyTorch/CUDA port of quant_tpu for NVIDIA Hopper (H100).

The JAX package `quant_tpu` is the reference; this package mirrors its
module names and public layouts (NHWC activations, HWIO weights, packed
sign words as (kh, kw, ceil(I/32), O) int32) so that one exported
variable tree serves from both. It imports torch, numpy and PyYAML (and
PIL for the ImageNet decode, tensorboardX where present), never JAX.

Ported so far: every serving forward of the JAX package (the QResNet
families and QLeNet5, every quantization scheme, EMA or per-batch
least-squares scales through `ops.optimal.opt_v1`), the serving
preparation with EMA calibration (`nn.export`), the serving stack
(`serving.engine` InferenceEngine and ServingFrontend, `serving.rpc`,
`serving.worker`), quantization-aware training (`train`), the
experiment entry point that runs the recipes under examples/ (`config`,
`data`, `train.task`, `utils.checkpoints`, `experiment`, `platform`,
the drivers in `examples`), the serving artifact (`serving.prepare`),
data and tensor parallelism over processes (`parallel`: a sharded
model's explicit out-channel gathers, the ring-overlapped binary GEMM,
the TP engine) and the chip probes (`probes.probe_r2`,
`probes.probe_r3`). Their
hand-written CUDA kernels live in `csrc/` and are built with nvcc at
first use (`_build.py`); each wrapper runs its plain PyTorch twin only
for CPU tensors.

A caller of the JAX package switches its imports from `quant_tpu` to
`quant_tpu_torch` at the package level: every public name of every
`quant_tpu` module, every package's `__all__` and every parameter of
its functions and classes exist here too (tests/test_torch_port_api.py
holds them to an AST walk of `quant_tpu/`). The parameters the port
does not take are JAX's own machinery (Pallas, XLA donation and
accumulation types, flax variable trees, which live in the
`nn.Module`s here; a layer's dtypes are set on the model or by the
forward's `out_dtype`): that test's `JAX_ONLY` table lists each with
its reason.
"""

from typing import Callable, Dict

__version__ = '0.1.0'

# The JAX package's aliases (quant_tpu/__init__.py:33-34): per-batch
# hook callables of the train and eval loops, and the metric dict the
# task driver produces.
Hook = Callable[..., None]
MetricDict = Dict[str, float]
