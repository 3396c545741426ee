"""Compute platforms (port of quant_tpu/platform.py, `LocalComputePlatform`).

`ComputePlatform` is the run-environment abstraction; the local platform
optionally spawns a TensorBoard server subprocess (port from the
TENSORBOARD_PORT env var) for the duration of the experiment and stops
it after. The JAX package's `PodComputePlatform` (cooperating processes
under jax.distributed) waits for Slice E of ROADMAP.md.
"""

import logging
import os
import shutil
import subprocess
from abc import ABC, abstractmethod

from quant_tpu_torch.experiment import Experiment

logger = logging.getLogger(__name__)


class ComputePlatform(ABC):
    """Abstract platform an experiment runs on."""

    @abstractmethod
    def run(self, experiment: Experiment) -> tuple[list, list]:
        """Run the experiment, returning (train, test) epoch metrics."""


class LocalComputePlatform(ComputePlatform):
    def __init__(self, start_tensorboard: bool = True):
        self.start_tensorboard = start_tensorboard

    def run(self, experiment: Experiment) -> tuple[list, list]:
        tb_proc = None
        config = experiment.config
        wants_tb = (self.start_tensorboard
                    and config.get('log', {}).get('tensorboard'))
        if wants_tb and shutil.which('tensorboard'):
            port = os.environ.get('TENSORBOARD_PORT', '6006')
            logdir = experiment.experiment_dir / 'tensorboard'
            logdir.mkdir(parents=True, exist_ok=True)
            tb_proc = subprocess.Popen(
                ['tensorboard', '--logdir', str(logdir), '--port', port],
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
            logger.info('TensorBoard serving %s on port %s', logdir, port)
        elif wants_tb:
            logger.info('tensorboard binary not found; metrics are still '
                        'written as event files and CSVs')
        try:
            return experiment.run()
        finally:
            if tb_proc is not None:
                tb_proc.terminate()
                tb_proc.wait()
