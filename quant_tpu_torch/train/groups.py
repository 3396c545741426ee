"""Parameter groups: quantized and full-precision (port of
quant_tpu/train/groups.py).

A parameter is 'quantized' iff it is the kernel of a QuantConv2d whose
weights are quantized (w_quant != 'fp'); every other parameter (biases,
BN affines, fp convs, stem, head, PReLU slopes) is 'fp'. The labels feed
`optim.make_optimizer`'s `param_groups`.
"""

from torch import nn

from quant_tpu_torch.nn.layers import QuantConv2d


def quantized_param_labels(model: nn.Module) -> dict[str, str]:
    """{parameter name: 'quantized' or 'fp'} over model.named_parameters."""
    quantized = {f'{name}.kernel' if name else 'kernel'
                 for name, m in model.named_modules()
                 if isinstance(m, QuantConv2d) and m.w_quant != 'fp'}
    return {name: 'quantized' if name in quantized else 'fp'
            for name, _ in model.named_parameters()}
