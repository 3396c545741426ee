"""One process of a PodComputePlatform run (port of quant_tpu/pod_worker.py).

Run as:
    python -m quant_tpu_torch.pod_worker <config.json> <rank> <nprocs> \\
        <port> <out>

Joins the process group of the platform's local coordinator
(127.0.0.1:<port>) before any collective, on the backend
parallel.multihost.default_backend names for the config's device, then
runs the experiment as a single process would: `classification_task`
sees a world above 1 and shards the datasets over the ranks. Rank 0
writes the experiment's files (config snapshot, metric CSVs,
checkpoints); the other ranks run the bare task on the same state. Each
rank writes the metrics it computed as JSON, rank 0 at <out> and rank r
at <out>.<r>.

With DETERMINISTIC_ENV set to 1 in its environment the worker runs
cuDNN's deterministic algorithms (the counterpart of XLA's
--xla_gpu_deterministic_ops that a JAX pod's env can carry): two runs of
one config then train alike, which a comparison between runs needs
(cuDNN's default backward algorithms sum in a run-dependent order, and
a binary net's sign flips carry that far).
"""

import json
import os
import sys
from pathlib import Path

import torch
import torch.distributed as dist

from quant_tpu_torch.device import resolve_device
from quant_tpu_torch.experiment import Experiment
from quant_tpu_torch.parallel.multihost import initialize
from quant_tpu_torch.train.task import classification_task

DETERMINISTIC_ENV = 'QUANT_TPU_TORCH_DETERMINISTIC'


def main() -> None:
    cfg_path, pid, nprocs, port, out = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
        sys.argv[5])
    with open(cfg_path) as f:
        config = json.load(f)
    if os.environ.get(DETERMINISTIC_ENV) == '1':
        torch.backends.cudnn.deterministic = True
    initialize(f'127.0.0.1:{port}', nprocs, pid,
               device=resolve_device(config.get('device', 'cuda')))
    try:
        if pid == 0:
            train_m, test_m = Experiment(classification_task, config).run()
        else:
            # Experiment.run's task call without its file writes;
            # forwarding restore_experiment matters: a resumed pod in
            # which only rank 0 restored would train divergent replicas.
            root = Path(config['log'].get('root_experiments_dir',
                                          'experiments/'))
            restore = config.get('restore_experiment')
            train_m, test_m = classification_task(
                config, root,
                restore_experiment=Path(restore) if restore else None)
    finally:
        dist.destroy_process_group()
    with open(out if pid == 0 else f'{out}.{pid}', 'w') as f:
        json.dump({'train': train_m, 'test': test_m}, f)


if __name__ == '__main__':
    main()
