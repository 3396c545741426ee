"""The recipe drivers of the port (port of examples/*/*.py): run one
recipe YAML from examples/ end to end, e.g.

    python -m quant_tpu_torch.examples.mnist \\
        --config examples/mnist/mnist_ls1.yaml --experiment-name my-run

on the card, or with `--device cpu` on the CPU. Every driver takes the
flags of config.get_base_argument_parser. The loader is the one the
config's `data.dataset` names (the driver's own dataset when the config
names none), so a recipe can run on `synthetic` data as written
otherwise.
"""

from typing import Callable, Optional, Sequence, Type

from quant_tpu_torch.config import get_base_argument_parser, parse_config
from quant_tpu_torch.data import QuantDataLoader
from quant_tpu_torch.experiment import Experiment
from quant_tpu_torch.platform import LocalComputePlatform
from quant_tpu_torch.train.task import classification_task
from quant_tpu_torch.utils.visualization import get_tensorboard_hooks


def run_recipe(description: str, loader_cls: Type[QuantDataLoader],
               argv: Optional[Sequence[str]] = None,
               get_hooks: Optional[Callable] = None) -> tuple[list, list]:
    """Parse argv, run the experiment on the local platform and return
    its (train, test) epoch metrics. get_hooks defaults to the
    TensorBoard hooks."""
    parser = get_base_argument_parser(description)
    config = parse_config(parser.parse_args(argv))
    if config.get('data', {}).get('dataset'):
        loader_cls = None
    experiment = Experiment(classification_task, config, loader_cls,
                            get_hooks or get_tensorboard_hooks)
    return LocalComputePlatform().run(experiment)
