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
the drivers in `examples`), the serving artifact (`serving.prepare`)
and the chip probes (`probes.probe_r2`, `probes.probe_r3`). Their
hand-written CUDA kernels live in `csrc/` and are built with nvcc at
first use (`_build.py`); each wrapper runs its plain PyTorch twin only
for CPU tensors.
"""

__version__ = '0.1.0'
