"""Preemption-aware training shutdown (port of quant_tpu/train/preemption.py).

A `PreemptionGuard` turns SIGTERM into a cooperative stop flag: the
train loop polls it at batch boundaries and `classification_task`
writes an interrupt checkpoint before it stops, so the standard restore
path (or --auto-resume) resumes with at most one partial epoch run
again. The interrupt checkpoint's payload carries `epoch = interrupted
- 1` (restore runs the interrupted epoch again) while its file name
takes the interrupted epoch, so repeated preemptions in one epoch
overwrite one slot and `get_path_to_checkpoint`'s max-epoch pick still
finds it.

Several processes (a torch.distributed world above 1): the stop is a
consensus. Each call of the guard joins `parallel.multihost.
collective_any` over the local flags until one is set, then latches, so
every process leaves the batch loop at the same call and none is left
inside a step's collectives. torch.distributed has no counterpart of
jax.distributed's preemption sync service: the signal handler is the
only source of the flag.
"""

import logging
import signal
import threading
from types import FrameType
from typing import Iterable, Optional

from quant_tpu_torch.parallel.multihost import collective_any, world_size

logger = logging.getLogger(__name__)


class PreemptionGuard:
    """Cooperative shutdown flag driven by preemption notices.

    Usable as a zero-argument callable (the `stop` hook of
    `train_epoch`); the first True latches. In a run of several
    processes every process must call it at the same loop points: the
    return value is a consensus. `restore()` reinstates the
    previous signal handlers. Off the main thread (where CPython forbids
    signal.signal) the guard is an inert flag that tests and embedding
    hosts can still `trigger()`.
    """

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,)):
        self._event = threading.Event()
        self._previous: dict[int, object] = {}
        self._latched = False  # the consensus (several processes)
        for sig in signals:
            try:
                self._previous[sig] = signal.signal(sig, self._handle)
            except ValueError:  # not the main thread
                logger.info('PreemptionGuard inert: not on main thread')
                break

    def _handle(self, signum: int, frame: Optional[FrameType]) -> None:
        logger.warning('Received signal %d: finishing current batch, '
                       'then checkpointing and stopping.', signum)
        self._event.set()

    def trigger(self) -> None:
        """Set the flag programmatically (tests, embedding hosts)."""
        self._event.set()

    @property
    def requested(self) -> bool:
        """The latched stop decision; with several processes it turns
        true only through `__call__`, at the same call on every one."""
        if world_size() > 1:
            return self._latched
        return self._event.is_set()

    def __call__(self) -> bool:
        if world_size() > 1:
            # A process whose own flag is set must still join the
            # collective its peers join, until the decision latches.
            if not self._latched and collective_any(self._event.is_set()):
                self._latched = True
            return self._latched
        return self._event.is_set()

    def restore(self) -> None:
        """Reinstate the signal handlers that were active before."""
        for sig, prev in self._previous.items():
            signal.signal(sig, prev)
        self._previous.clear()

    def __enter__(self) -> 'PreemptionGuard':
        return self

    def __exit__(self, *exc: object) -> None:
        self.restore()
