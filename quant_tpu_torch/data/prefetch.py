"""Host-side pipeline helpers: background prefetch of loader batches (port
of quant_tpu/data/prefetch.py).

Batches are produced by a background thread into a bounded queue, so
host decode and augmentation overlap the card's work, and per-image
decode fans out over a thread pool (PIL decode and file IO release the
GIL).
"""

import queue
import threading
from typing import Iterable, Iterator


class PrefetchIterable:
    """Wrap a batched iterable; a producer thread keeps `depth` batches
    ready. Iterating twice restarts the inner iterable (fresh epoch)."""

    _SENTINEL = object()

    def __init__(self, inner: Iterable, depth: int = 2):
        self.inner = inner
        self.depth = depth

    @property
    def num_examples(self) -> object:
        return getattr(self.inner, 'num_examples', None)

    def __len__(self) -> int:
        return len(self.inner)  # type: ignore[arg-type]

    def set_epoch(self, epoch: int) -> None:
        self.inner.set_epoch(epoch)  # type: ignore[attr-defined]

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        err: list[BaseException] = []

        def produce():
            try:
                for item in self.inner:
                    q.put(item)
            except BaseException as e:  # propagate to the consumer
                err.append(e)
            finally:
                q.put(self._SENTINEL)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is self._SENTINEL:
                if err:
                    raise err[0]
                return
            yield item
