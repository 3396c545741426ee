"""CIFAR-100 experiment with ResNet (port of examples/cifar100/cifar100.py).

Usage:
    python -m quant_tpu_torch.examples.cifar100 \
        --config examples/cifar100/cifar100_ls1_kd.yaml \
        --experiment-name my-run [--device cpu]
"""

from typing import Callable, Optional, Sequence

from quant_tpu_torch.data import CIFAR100DataLoader
from quant_tpu_torch.examples import run_recipe


def main(argv: Optional[Sequence[str]] = None,
         get_hooks: Optional[Callable] = None) -> tuple[list, list]:
    return run_recipe('CIFAR-100 experiment with ResNet', CIFAR100DataLoader, argv,
                      get_hooks)


if __name__ == '__main__':
    main()
