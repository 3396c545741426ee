"""Preemption-aware training shutdown (port of quant_tpu/train/preemption.py,
its single-process branch).

A `PreemptionGuard` turns SIGTERM into a cooperative stop flag: the
train loop polls it at batch boundaries and `classification_task`
writes an interrupt checkpoint before it stops, so the standard restore
path (or --auto-resume) resumes with at most one partial epoch run
again. The interrupt checkpoint's payload carries `epoch = interrupted
- 1` (restore runs the interrupted epoch again) while its file name
takes the interrupted epoch, so repeated preemptions in one epoch
overwrite one slot and `get_path_to_checkpoint`'s max-epoch pick still
finds it.

The JAX package's multi-process branch (jax.distributed's preemption
sync, a consensus across hosts) waits for Slice E of ROADMAP.md.
"""

import logging
import signal
import threading
from types import FrameType
from typing import Iterable, Optional

logger = logging.getLogger(__name__)


class PreemptionGuard:
    """Cooperative shutdown flag driven by preemption notices.

    Usable as a zero-argument callable (the `stop` hook of
    `train_epoch`); the first True latches. `restore()` reinstates the
    previous signal handlers. Off the main thread (where CPython forbids
    signal.signal) the guard is an inert flag that tests and embedding
    hosts can still `trigger()`.
    """

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,)):
        self._event = threading.Event()
        self._previous: dict[int, object] = {}
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
        """The latched stop decision."""
        return self._event.is_set()

    def __call__(self) -> bool:
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
