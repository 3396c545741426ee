"""Compute platforms (port of quant_tpu/platform.py).

`ComputePlatform` is the run-environment abstraction; the local platform
optionally spawns a TensorBoard server subprocess (port from the
TENSORBOARD_PORT env var) for the duration of the experiment and stops
it after. `PodComputePlatform` runs the experiment as cooperating
processes on this machine, one rank of a torch.distributed process
group each (quant_tpu_torch/pod_worker.py).
"""

import json
import logging
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from abc import ABC, abstractmethod
from pathlib import Path
from typing import Callable, Optional

from quant_tpu_torch.experiment import Experiment

logger = logging.getLogger(__name__)


class ComputePlatform(ABC):
    """Abstract platform an experiment runs on."""

    @abstractmethod
    def run(self, experiment: Experiment) -> tuple[list, list]:
        """Run the experiment, returning (train, test) epoch metrics."""


class LocalComputePlatform(ComputePlatform):
    """Run the experiment in this process. `root_experiments_dir` is
    kept for the caller, as JAX's platform keeps it (the experiment's
    own directory comes from its config)."""

    def __init__(self, root_experiments_dir: Optional[Path] = None,
                 start_tensorboard: bool = True):
        self.root = root_experiments_dir
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


class PodComputePlatform(ComputePlatform):
    """Run the experiment as n_processes cooperating processes on this
    machine, a simulated pod.

    Each worker (quant_tpu_torch/pod_worker.py) joins one process group
    over a free local port before anything else, then runs
    `classification_task`, which sees a world above 1 and shards the
    datasets over the ranks (train.task). Rank 0 writes the experiment's
    files, its checkpoints and the metrics this call returns. The
    backend is NCCL for CUDA and gloo for the CPU, or the one `env`
    names under parallel.multihost.BACKEND_ENV (gloo takes several ranks
    on one card, which NCCL refuses). `env` shapes the workers'
    environment (pod_worker.DETERMINISTIC_ENV: cuDNN's deterministic
    algorithms); the config's `device` their device.

    The workers share one deadline, `timeout` seconds; the first worker
    to fail kills the rest (a dead rank strands its peers inside
    collectives). `on_spawn`, when set, is called with the workers'
    Popen handles right after they start (tests preempt one that way).
    After a run, `rank_metrics` holds each rank's (train, test) metrics,
    rank 0's first (the ones `run` returns).
    """

    def __init__(self, n_processes: int, port: Optional[int] = None,
                 env: Optional[dict] = None, timeout: float = 600.0):
        self.n_processes = n_processes
        self.port = port  # None: a free ephemeral port each run
        self.env = env or {}
        self.timeout = timeout
        self.on_spawn: Optional[Callable[[list], None]] = None
        self.rank_metrics: list[tuple[list, list]] = []

    def run(self, experiment: Experiment) -> tuple[list, list]:
        # The workers run classification_task from the serialized config;
        # a custom task_fn, loader or hooks cannot cross the process
        # boundary: refuse rather than run the defaults.
        from quant_tpu_torch.train.task import classification_task
        if (experiment.task_fn is not classification_task
                or experiment.data_loader_cls is not None
                or experiment.get_hooks is not None):
            raise ValueError(
                'PodComputePlatform runs classification_task resolved '
                'from the config; custom task_fn / data_loader_cls / '
                'get_hooks are not forwarded to the workers.')

        port = self.port
        if port is None:
            with socket.socket() as s:
                s.bind(('127.0.0.1', 0))
                port = s.getsockname()[1]

        exp_dir = experiment.experiment_dir
        exp_dir.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory() as td:
            cfg_path = Path(td) / 'config.json'
            out_path = Path(td) / 'metrics.json'
            cfg = dict(experiment.config)
            cfg['log'] = dict(cfg.get('log', {}))
            cfg['log']['root_experiments_dir'] = str(
                experiment.root_experiments_dir)
            with open(cfg_path, 'w') as f:
                json.dump(cfg, f)
            env = dict(os.environ, **{k: str(v)
                                      for k, v in self.env.items()})
            procs = [
                subprocess.Popen(
                    [sys.executable, '-m', 'quant_tpu_torch.pod_worker',
                     str(cfg_path), str(pid), str(self.n_processes),
                     str(port), str(out_path)],
                    env=env, cwd=str(Path(__file__).resolve().parents[1]))
                for pid in range(self.n_processes)
            ]
            if callable(self.on_spawn):
                self.on_spawn(procs)
            try:
                deadline = time.monotonic() + self.timeout
                while True:
                    rcs = [p.poll() for p in procs]
                    failed = [(i, rc) for i, rc in enumerate(rcs)
                              if rc not in (None, 0)]
                    if failed:
                        raise RuntimeError(
                            f'pod worker(s) failed: {failed} '
                            f'(all exit codes: {rcs})')
                    if all(rc == 0 for rc in rcs):
                        break
                    if time.monotonic() > deadline:
                        raise RuntimeError(
                            f'pod workers did not finish within '
                            f'{self.timeout}s (exit codes: {rcs})')
                    time.sleep(0.2)
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                for p in procs:
                    p.wait()
            payloads = [json.loads(Path(p).read_text()) for p in [
                out_path] + [f'{out_path}.{r}'
                             for r in range(1, self.n_processes)]]
        self.rank_metrics = [(p['train'], p['test']) for p in payloads]
        return self.rank_metrics[0]
