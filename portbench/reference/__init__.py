"""The plain reference of the benchmark's configurations.

Plain PyTorch, float32, from the published definitions (Pouransari et
al., CVPR-W 2020; apple/ml-quant's recipes): the serving forward of an
XNOR ResNet and the KD train step of its recipe. It imports nothing of
the program under test (`quant_tpu_torch`) and nothing of JAX, and it
works out again whatever the program derives from the seeded state:
signs, scales, thresholds. It runs NCHW, as PyTorch's own convs do.
"""
