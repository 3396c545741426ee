"""Profiling and step timing (port of quant_tpu/utils/profiling.py).

* `trace(log_dir)`: a context manager around `torch.profiler` (CPU and,
  where there is a card, CUDA activity) that writes a Chrome trace to
  log_dir on exit. A profiler that cannot start or stop only logs a
  warning; the traced code runs either way.
* `StepTimer`: a wall-clock step timer usable as a train-loop hook; it
  synchronizes the card before each report (so queued kernels do not
  hide device time) and reports steps/sec and images/sec.
"""

import contextlib
import logging
import time
from pathlib import Path
from typing import Callable, Iterator, Optional

import torch

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def trace(log_dir: 'str | Path') -> Iterator[None]:
    prof = None
    try:
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.__enter__()
    except Exception as e:  # noqa: BLE001 - platform dependent
        logger.warning('torch.profiler failed to start (%s); profiling '
                       'disabled for this run', e)
        prof = None
    try:
        yield
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                out = Path(log_dir)
                out.mkdir(parents=True, exist_ok=True)
                prof.export_chrome_trace(str(out / 'trace.json'))
            except Exception as e:  # noqa: BLE001
                logger.warning('torch.profiler failed to stop: %s', e)


def _sync_card() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StepTimer:
    """Accumulates step wall times; call as a hook(epoch, global_step, ...).

    sync_fn runs before each report; the default synchronizes the card
    when CUDA is in use (nothing on the CPU)."""

    def __init__(self, batch_size: Optional[int] = None,
                 log_every: int = 50,
                 sync_fn: Optional[Callable[[], None]] = _sync_card
                 ) -> None:
        self.batch_size = batch_size
        self.log_every = log_every
        self.sync_fn = sync_fn
        self._t0: Optional[float] = None
        self._last_step = 0

    def __call__(self, epoch: int, global_step: int, **_: object) -> None:
        now = time.perf_counter()
        if self._t0 is None:
            self._t0 = now
            self._last_step = global_step
            return
        if (global_step - self._last_step) >= self.log_every:
            if self.sync_fn is not None:
                self.sync_fn()
                now = time.perf_counter()
            steps = global_step - self._last_step
            sps = steps / (now - self._t0)
            msg = f'{sps:.2f} steps/s'
            if self.batch_size:
                msg += f' ({sps * self.batch_size:.1f} images/s)'
            logger.info('StepTimer: %s (epoch %d, step %d)',
                        msg, epoch, global_step)
            self._t0 = now
            self._last_step = global_step
