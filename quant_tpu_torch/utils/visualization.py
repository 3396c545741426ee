"""TensorBoard metric hooks (port of quant_tpu/utils/visualization.py).

Uses tensorboardX when available (gated import — the framework has no hard
dependency on it). Train metrics log every `log_interval` global steps;
test metrics log once per epoch; the lr is logged alongside.
"""

import logging
from pathlib import Path
from typing import Optional

logger = logging.getLogger(__name__)


class Visualizer:
    def __init__(self, log_dir: Path, metrics: Optional[dict] = None,
                 every_n_steps: bool = True):
        self.metrics = metrics
        self.every_n_steps = every_n_steps
        try:
            from tensorboardX import SummaryWriter
            self.writer = SummaryWriter(str(log_dir))
        except ImportError:  # pragma: no cover
            logger.warning('tensorboardX unavailable; TB logging disabled')
            self.writer = None

    def hook(self, epoch: int, global_step: int,
             values_dict: Optional[dict] = None,
             log_interval: Optional[int] = None,
             metrics: Optional[dict] = None, **_: object) -> None:
        """Log metric accumulators + scalar values.

        metrics: call-time {'train'/'test': MetricAccumulator} from the
        epoch drivers (the LIVE accumulators — reference
        visualization.py:45-77 logs the metric dicts the loops update);
        falls back to the construction-time dict. Accumulators are
        computed only after the interval gate, so the device readback
        happens once per log_interval, not per batch.
        """
        if self.writer is None:
            return
        if self.every_n_steps and log_interval \
                and global_step % log_interval != 0:
            return
        step = global_step if self.every_n_steps else epoch
        for name, acc in (metrics or self.metrics or {}).items():
            for k, v in acc.compute().items():
                self.writer.add_scalar(f'{name}/{k}', v, step)
        for k, v in (values_dict or {}).items():
            if v is not None:
                self.writer.add_scalar(k, v, step)

    # A Visualizer IS a hook: the epoch drivers call it like any other
    # hook, and the task driver close()s hooks that support it so the
    # event files are flushed even for short runs.
    __call__ = hook

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()


def get_tensorboard_hooks(config: dict, experiment_root: Path,
                          train_metrics: Optional[dict] = None,
                          test_metrics: Optional[dict] = None,
                          ) -> tuple[list, list]:
    """Build (train_hooks, test_hooks) from config (reference
    visualization.py:89-116). Returns empty hooks when tensorboard is
    disabled in the config. The returned hooks are the Visualizer
    objects themselves (callable, with .close())."""
    log_cfg = config.get('log', {})
    if not log_cfg.get('tensorboard'):
        return [], []
    tb_dir = Path(experiment_root) / config['experiment_name'] / 'tensorboard'
    train_vis = Visualizer(tb_dir / 'train', train_metrics,
                           every_n_steps=True)
    test_vis = Visualizer(tb_dir / 'test', test_metrics,
                          every_n_steps=False)
    return [train_vis], [test_vis]
