"""ImageNet experiment with ResNet (port of examples/imagenet/imagenet.py).

Usage:
    python -m quant_tpu_torch.examples.imagenet \
        --config examples/imagenet/imagenet_ls1_kd.yaml \
        --experiment-name my-run [--device cpu]
"""

from typing import Callable, Optional, Sequence

from quant_tpu_torch.data import ImageNetDataLoader
from quant_tpu_torch.examples import run_recipe


def main(argv: Optional[Sequence[str]] = None,
         get_hooks: Optional[Callable] = None) -> tuple[list, list]:
    return run_recipe('ImageNet experiment with ResNet', ImageNetDataLoader, argv,
                      get_hooks)


if __name__ == '__main__':
    main()
