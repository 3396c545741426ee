"""Tensor functions of the port: signs, packing, quantizers, convs and the
kernel wrappers (`pool`, `binary_gemm`, `binary_infer`).

Importing a module here builds nothing: each kernel is compiled at its
first launch on a CUDA tensor.
"""
