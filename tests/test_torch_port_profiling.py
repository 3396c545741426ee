"""The port's profiling utilities (quant_tpu_torch/utils/profiling.py):
the trace context's robustness and StepTimer's cadence, mirroring
tests/utils/test_profiling.py, and the same logs as JAX's StepTimer."""

import logging
from unittest import mock

import torch

from quant_tpu.utils.profiling import StepTimer as JStepTimer
from quant_tpu_torch.utils import profiling
from quant_tpu_torch.utils.profiling import StepTimer, trace

LOGGER = 'quant_tpu_torch.utils.profiling'


def test_trace_context_is_robust(tmp_path):
    # On the CPU the profiler starts; either way the context must not
    # raise and must stop cleanly, leaving its trace behind.
    with trace(tmp_path / 'prof'):
        x = torch.arange(10).sum().item()
    assert x == 45
    assert (tmp_path / 'prof' / 'trace.json').exists()


def test_trace_failure_to_start_only_warns(tmp_path, caplog):
    with mock.patch('torch.profiler.profile',
                    side_effect=RuntimeError('no profiler here')), \
            caplog.at_level(logging.WARNING, logger=LOGGER):
        with trace(tmp_path / 'prof'):
            x = sum(range(10))
    assert x == 45
    assert 'failed to start' in caplog.records[0].getMessage()


def test_step_timer_logs_on_cadence(caplog):
    synced = []
    t = StepTimer(batch_size=32, log_every=2,
                  sync_fn=lambda: synced.append(1))
    with caplog.at_level(logging.INFO, logger=LOGGER):
        t(epoch=0, global_step=0)   # arms the timer
        t(epoch=0, global_step=1)   # below cadence
        assert not caplog.records
        t(epoch=0, global_step=2)   # hits cadence
    assert len(caplog.records) == 1
    msg = caplog.records[0].getMessage()
    assert 'steps/s' in msg and 'images/s' in msg
    assert synced == [1]


def test_step_timer_without_batch_size(caplog):
    t = StepTimer(log_every=1)
    with caplog.at_level(logging.INFO, logger=LOGGER):
        t(epoch=0, global_step=0)
        t(epoch=0, global_step=1)
    assert len(caplog.records) == 1
    assert 'images/s' not in caplog.records[0].getMessage()


def test_step_timer_reports_as_jax_does(caplog):
    """The same steps give JAX's message up to the measured rates, and
    the default sync touches the card only where CUDA is in use."""
    assert StepTimer().sync_fn is profiling._sync_card
    with mock.patch('torch.cuda.synchronize') as sync:
        profiling._sync_card()
    assert sync.called == (torch.cuda.is_available()
                           and torch.cuda.is_initialized())
    logs = []
    for cls, name in ((StepTimer, LOGGER),
                      (JStepTimer, 'quant_tpu.utils.profiling')):
        caplog.clear()
        t = cls(batch_size=8, log_every=3, sync_fn=None)
        with caplog.at_level(logging.INFO, logger=name):
            for step in range(7):
                t(epoch=1, global_step=step)
        logs.append([(r.args[1:], r.msg) for r in caplog.records])
    assert logs[0] == logs[1] and len(logs[0]) == 2
