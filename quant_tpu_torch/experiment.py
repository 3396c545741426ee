"""Experiment: config snapshot, task run, per-epoch metric CSVs (port of
quant_tpu/experiment.py).

Writes the resolved config.yaml into the experiment directory, runs the
task, and writes per-epoch train and test metrics to
metrics/{train,test}.csv with the csv module: the columns and values of
the JAX package's `pandas.DataFrame(rows).to_csv(index=False)` for the
task's rows (one key set, float values as Python writes them).
Experiment dir layout: checkpoints/ config.yaml metrics/ tensorboard/.
"""

import csv
import logging
from pathlib import Path
from typing import Callable, Optional, Type

import yaml

from quant_tpu_torch.data import QuantDataLoader

logger = logging.getLogger(__name__)

# CLI flags of one invocation, left out of the config.yaml snapshot: a
# later resume reloads that file, and e.g. an eval-only visit must not
# freeze the experiment in skip_training mode, nor a CPU run pin it to
# the CPU.
TRANSIENT_KEYS = ('skip_training', 'restore_experiment',
                  'init_from_checkpoint', 'device')


def _write_csv(rows: list[dict], path: Path) -> None:
    with open(path, 'w', newline='') as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]),
                                lineterminator='\n')
        writer.writeheader()
        writer.writerows(rows)


def log_metrics_to_experiments_dir(train_metrics: list[dict],
                                   test_metrics: list[dict],
                                   experiment_dir: Path) -> None:
    metrics_dir = Path(experiment_dir) / 'metrics'
    metrics_dir.mkdir(parents=True, exist_ok=True)
    if train_metrics:
        _write_csv(train_metrics, metrics_dir / 'train.csv')
    if test_metrics:
        _write_csv(test_metrics, metrics_dir / 'test.csv')


class Experiment:
    """One configured run of a task function."""

    def __init__(self, task_fn: Callable, config: dict,
                 data_loader_cls: Optional[Type[QuantDataLoader]] = None,
                 get_hooks: Optional[Callable] = None,
                 root_experiments_dir: Optional[Path] = None):
        self.task_fn = task_fn
        self.config = config
        self.data_loader_cls = data_loader_cls
        self.get_hooks = get_hooks
        self.root_experiments_dir = Path(
            root_experiments_dir
            if root_experiments_dir is not None
            else config['log'].get('root_experiments_dir', 'experiments/'))

    @property
    def experiment_dir(self) -> Path:
        return self.root_experiments_dir / self.config['experiment_name']

    def run(self) -> tuple[list[dict], list[dict]]:
        exp_dir = self.experiment_dir
        exp_dir.mkdir(parents=True, exist_ok=True)
        snapshot = {k: v for k, v in self.config.items()
                    if k not in TRANSIENT_KEYS}
        with open(exp_dir / 'config.yaml', 'w') as f:
            yaml.safe_dump(snapshot, f)

        restore = self.config.get('restore_experiment')
        train_metrics, test_metrics = self.task_fn(
            self.config,
            self.root_experiments_dir,
            self.data_loader_cls,
            self.get_hooks,
            Path(restore) if restore else None,
        )
        log_metrics_to_experiments_dir(train_metrics, test_metrics, exp_dir)
        return train_metrics, test_metrics

