"""CIFAR-10 experiment with ResNet (port of examples/cifar10/cifar10.py).

Usage:
    python -m quant_tpu_torch.examples.cifar10 \
        --config examples/cifar10/cifar10_ls1.yaml \
        --experiment-name my-run [--device cpu]
"""

from typing import Callable, Optional, Sequence

from quant_tpu_torch.data import CIFAR10DataLoader
from quant_tpu_torch.examples import run_recipe


def main(argv: Optional[Sequence[str]] = None,
         get_hooks: Optional[Callable] = None) -> tuple[list, list]:
    return run_recipe('CIFAR-10 experiment with ResNet', CIFAR10DataLoader, argv,
                      get_hooks)


if __name__ == '__main__':
    main()
