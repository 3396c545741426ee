"""MNIST experiment with LeNet-5 (port of examples/mnist/mnist.py).

Usage:
    python -m quant_tpu_torch.examples.mnist \
        --config examples/mnist/mnist_ls1.yaml \
        --experiment-name my-run [--device cpu]
"""

from typing import Callable, Optional, Sequence

from quant_tpu_torch.data import MNISTDataLoader
from quant_tpu_torch.examples import run_recipe


def main(argv: Optional[Sequence[str]] = None,
         get_hooks: Optional[Callable] = None) -> tuple[list, list]:
    return run_recipe('MNIST experiment with LeNet-5', MNISTDataLoader, argv,
                      get_hooks)


if __name__ == '__main__':
    main()
