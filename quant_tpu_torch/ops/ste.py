"""Sign function with sign(0) = +1 (port of quant_tpu/ops/ste.py).

`torch.sign(0)` is 0, so the port never uses it for sign planes.
"""

import torch


def binary_sign(x: torch.Tensor) -> torch.Tensor:
    """Return -1 where x < 0 and +1 where x >= 0, in x's dtype."""
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return torch.where(x < 0, -one, one)
