"""The port's PodComputePlatform (quant_tpu_torch/platform.py,
quant_tpu_torch/pod_worker.py): a 2-process pod on the CPU over gloo,
the five cases of tests/train/test_pod_platform.py. The user-facing
platform launches the workers, rank 0 writes the artifacts, and the run
returns its metrics; eval covers an odd test set as one process does;
SIGTERM to one worker stops the gang at one step with one interrupt
checkpoint, from which every rank resumes; a failing worker kills the
gang."""

import signal
import threading
import time

import numpy as np
import pytest

from quant_tpu_torch.experiment import Experiment
from quant_tpu_torch.parallel.multihost import BACKEND_ENV
from quant_tpu_torch.platform import PodComputePlatform
from quant_tpu_torch.train.task import classification_task
from quant_tpu_torch.utils.checkpoints import (
    get_path_to_checkpoint, restore_checkpoint,
)

# Every pod here: two ranks on the CPU (gloo), one shared deadline, one
# thread a rank (the ranks of these small models would only contend for
# the cores).
POD_TIMEOUT = 120
POD_ENV = {'OMP_NUM_THREADS': '1'}


def pod_config(tmp_path, name: str, **over) -> dict:
    cfg = {
        'seed': 0,
        'experiment_name': name,
        'device': 'cpu',
        'environment': {'platform': 'pod', 'nchips': 0},
        'data': {'dataset': 'synthetic', 'train_batch_size': 16,
                 'test_batch_size': 16, 'train_size': 64, 'test_size': 32,
                 'image_shape': [28, 28, 1], 'seed': 3},
        'model': {'architecture': 'lenet5', 'loss': 'nll_loss',
                  'arch_config': {'conv1_filters': 4, 'conv2_filters': 4,
                                  'x_quant': 'ls-1', 'w_quant': 'ls-1',
                                  'clamp': {'kind': 'identity'},
                                  'output_classes': 10}},
        'optimization': {'epochs': 1,
                         'optimizer': {'algorithm': 'sgd', 'lr': 0.1},
                         'lr_scheduler': {'scheduler': 'step_lr',
                                          'step_size': 1, 'gamma': 1.0}},
        'log': {'level': 'WARNING', 'interval': 100,
                'save_model_freq': 1, 'tensorboard': False,
                'root_experiments_dir': str(tmp_path / 'experiments')},
    }
    cfg.update(over)
    return cfg


def pod(**kw) -> PodComputePlatform:
    return PodComputePlatform(n_processes=2, timeout=POD_TIMEOUT,
                              env={**POD_ENV, **kw})


# nchips 0 (as many cards as processes), and nchips equal to the world:
# the published recipes' form (e.g. nchips 8 on a pod of 8).
@pytest.mark.parametrize('nchips', [0, 2])
def test_pod_platform_two_processes(tmp_path, nchips):
    platform = pod()
    train_m, test_m = platform.run(Experiment(
        classification_task, pod_config(
            tmp_path, 'podrun',
            environment={'platform': 'pod', 'nchips': nchips})))
    assert len(train_m) == 1 and len(test_m) == 1
    assert np.isfinite(train_m[0]['Loss'])
    # Every rank reports the global batch's metrics.
    assert platform.rank_metrics == [(train_m, test_m)] * 2
    exp_dir = tmp_path / 'experiments' / 'podrun'
    assert (exp_dir / 'config.yaml').exists()
    assert (exp_dir / 'metrics' / 'train.csv').exists()
    # Rank 0 alone wrote the checkpoint, once.
    assert sorted(p.name for p in (exp_dir / 'checkpoints').iterdir()) == [
        'checkpoint_1']


def test_pod_platform_rejects_unforwardable_experiment(tmp_path):
    cfg = {'log': {'root_experiments_dir': str(tmp_path)},
           'experiment_name': 'x'}
    exp = Experiment(classification_task, cfg,
                     get_hooks=lambda c, d: ([], []))
    with pytest.raises(ValueError, match='not forwarded'):
        PodComputePlatform(n_processes=2).run(exp)


def test_pod_eval_covers_full_odd_test_set(tmp_path):
    """A 2-process eval equals the single-process eval on an odd-sized
    test set (33 examples): the padded shards and masked metrics cover
    every example."""
    def cfg(**over):
        c = pod_config(tmp_path, 'evalbase', seed=5)
        c['data'] = dict(c['data'], test_size=33, seed=9)
        c.update(over)
        return c

    Experiment(classification_task, cfg()).run()
    exp_dir = tmp_path / 'experiments' / 'evalbase'
    _, single = Experiment(classification_task, cfg(
        experiment_name='eval1', skip_training=True,
        restore_experiment=str(exp_dir))).run()
    _, pod_m = pod().run(
        Experiment(classification_task, cfg(
            experiment_name='eval2', skip_training=True,
            restore_experiment=str(exp_dir))))
    assert single and pod_m
    for k in single[0]:
        np.testing.assert_allclose(pod_m[0][k], single[0][k], rtol=1e-5,
                                   err_msg=k)


def test_pod_preemption_consensus_checkpoints_cleanly(tmp_path):
    """SIGTERM to ONE worker mid-run: the stop is a consensus
    (parallel.multihost.collective_any), so both workers leave the batch
    loop at the same step (else a rank waits in the next step's
    collectives and the run times out), rank 0 writes the interrupt
    checkpoint, and both exit 0. Every rank then resumes from it."""
    epochs = 400
    cfg = pod_config(tmp_path, 'podpre')
    cfg['data'] = dict(cfg['data'], train_size=512)
    cfg['optimization'] = dict(cfg['optimization'], epochs=epochs)
    exp_dir = tmp_path / 'experiments' / 'podpre'

    def preempt_one(procs):
        def fire():
            # checkpoint_2 exists once both ranks finished epoch 2 in
            # lockstep, so both guards hold SIGTERM by then.
            deadline = time.monotonic() + POD_TIMEOUT / 2
            while (not (exp_dir / 'checkpoints' / 'checkpoint_2').exists()
                   and time.monotonic() < deadline):
                time.sleep(0.05)
            procs[1].send_signal(signal.SIGTERM)
        threading.Thread(target=fire, daemon=True).start()

    platform = pod()
    platform.on_spawn = preempt_one
    platform.run(Experiment(classification_task, cfg))  # must not raise

    payload = restore_checkpoint(get_path_to_checkpoint(exp_dir))
    interrupt_epoch = int(np.asarray(payload['epoch']))
    assert 2 <= interrupt_epoch < epochs - 1, \
        'run completed without interruption: the signal came too late'

    # Resume on every rank: `epochs` MORE epochs (reference semantics,
    # tasks.py:196) to a clean finish with a final checkpoint.
    resume = dict(cfg, restore_experiment=str(exp_dir))
    resume['optimization'] = dict(cfg['optimization'], epochs=2)
    train_m, test_m = pod().run(Experiment(classification_task, resume))
    assert len(train_m) == 2 and len(test_m) == 2
    assert all(np.isfinite(m['Loss']) for m in train_m)
    final = restore_checkpoint(get_path_to_checkpoint(exp_dir))
    assert int(np.asarray(final['epoch'])) == interrupt_epoch + 2


def test_pod_platform_kills_gang_on_worker_failure(tmp_path):
    # Workers that die at once (no such backend) fail the run promptly
    # with their exit codes, not at the timeout, and leave no peer
    # running.
    platform = pod(**{BACKEND_ENV: 'no_such_backend'})
    procs_seen = []
    platform.on_spawn = procs_seen.extend
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match='failed'):
        platform.run(Experiment(classification_task,
                                pod_config(tmp_path, 'podfail')))
    assert time.monotonic() - t0 < POD_TIMEOUT / 2
    assert len(procs_seen) == 2
    for p in procs_seen:
        assert p.poll() is not None  # nobody left running
