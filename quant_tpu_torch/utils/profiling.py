"""Profiling and step timing (port of quant_tpu/utils/profiling.py), and
the program's own spans.

* `trace(log_dir)`: a context manager around `torch.profiler` (CPU and,
  where there is a card, CUDA activity) that writes a Chrome trace to
  log_dir on exit, with the program's spans (below) on their host
  threads above the profiler's events. A profiler that cannot start or
  stop only logs a warning; the traced code runs either way.
* `StepTimer`: a wall-clock step timer usable as a train-loop hook; it
  synchronizes the card before each report (so queued kernels do not
  hide device time) and reports steps/sec and images/sec.
* `span(name, kind)` and `recording()`: the program marks where its
  work happens (a model's forward and its stem, blocks, quantized convs,
  shortcuts, solves and head; a train step and its phases) with
  `with span(name, kind):`. Nothing is recorded unless a `recording()`
  context is open: `span` then returns one shared no-op context after a
  single check of a module global, and names are built once, when the
  model is. While recording, each span keeps its name, kind, start and
  end in `time.time_ns()` (the clock `torch.profiler` converts its
  events to), the native id of its thread, its parent and its unit (the
  root span that opened the forward or step it belongs to), in a
  bounded buffer that counts what it drops; each span entered counts
  one for its (kind, name). A span opened on a thread with no span of
  its own open (autograd's device thread, running the backward and
  remat's recomputation) takes as parent the innermost span open on the
  thread that opened the unit. The Recorder that `recording()` yields
  holds what it recorded, and stays readable once it closes.
"""

import contextlib
import itertools
import json
import logging
import os
import threading
import time
from pathlib import Path
from typing import Callable, Iterator, NamedTuple, Optional

import torch

logger = logging.getLogger(__name__)

SPAN_LIMIT = 500_000


class SpanRecord(NamedTuple):
    """One closed span. Times are `time.time_ns()`; parent 0: a root."""
    id: int
    parent: int
    unit: int
    name: str
    kind: str
    thread: int
    start_ns: int
    end_ns: int


class _Off:
    """The shared no-op that `span` returns while nothing records."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc: object) -> None:
        return None


_OFF = _Off()


class _Span:
    __slots__ = ('rec', 'name', 'kind', 'id', 'parent', 'unit', 'thread',
                 'start')

    def __init__(self, rec: 'Recorder', name: str, kind: str):
        self.rec, self.name, self.kind = rec, name, kind

    def __enter__(self) -> None:
        self.rec._open(self)

    def __exit__(self, *exc: object) -> None:
        self.rec._close(self)


class _Thread(threading.local):
    """A thread's open spans and its native id, read once (the id is a
    system call, which costs microseconds on some hosts)."""

    def __init__(self) -> None:
        self.stack: list[_Span] = []
        self.id = threading.get_native_id()


_record = tuple.__new__   # a SpanRecord without its Python-level __new__


class Recorder:
    """What one `recording()` keeps: `records` (closed spans, at most
    SPAN_LIMIT as it stood when the recording opened), `dropped` (closed
    spans past the limit), `counts` (spans entered by (kind, name)) and
    `units` (root spans entered)."""

    def __init__(self) -> None:
        self.limit = SPAN_LIMIT
        self.records: list[SpanRecord] = []
        self.dropped = 0
        self.counts: dict[tuple[str, str], int] = {}
        self.units = 0
        self._ids = itertools.count(1)
        self._thread = _Thread()
        self._opener: list[_Span] = []   # the open unit's thread's stack
        self._lock = threading.Lock()

    def _open(self, s: _Span) -> None:
        thread = self._thread
        stack = thread.stack
        s.thread = thread.id
        with self._lock:
            s.id = next(self._ids)
            top = stack[-1] if stack else (
                self._opener[-1] if self._opener else None)
            if top is None:
                s.parent, s.unit = 0, s.id
                self._opener = stack
                self.units += 1
            else:
                s.parent, s.unit = top.id, top.unit
            key = (s.kind, s.name)
            self.counts[key] = self.counts.get(key, 0) + 1
            stack.append(s)
        s.start = time.time_ns()

    def _close(self, s: _Span) -> None:
        end = time.time_ns()
        stack = self._thread.stack
        with self._lock:
            if stack and stack[-1] is s:
                stack.pop()
            else:
                stack.remove(s)
            if len(self.records) < self.limit:
                self.records.append(_record(SpanRecord, (
                    s.id, s.parent, s.unit, s.name, s.kind, s.thread,
                    s.start, end)))
            else:
                self.dropped += 1


_active: Optional[Recorder] = None


def span(name: str, kind: str) -> 'contextlib.AbstractContextManager[None]':
    """A context that records one span of `kind` named `name` while a
    recording is open; the shared no-op otherwise."""
    if _active is None:
        return _OFF
    return _Span(_active, name, kind)


@contextlib.contextmanager
def recording() -> Iterator[Recorder]:
    """Record every span opened inside, on any thread; yields the
    Recorder, which stays readable after the context closes. Inside an
    open recording, that one goes on recording."""
    global _active
    if _active is not None:
        yield _active
        return
    rec = Recorder()
    _active = rec
    try:
        yield rec
    finally:
        _active = None


def _write_spans(path: Path, records: list[SpanRecord]) -> None:
    """Add `records` to the Chrome trace at `path` as complete events on
    their threads, on the trace's own clock (its baseTimeNanoseconds)."""
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get('baseTimeNanoseconds', 0))
    pid = os.getpid()
    doc.setdefault('traceEvents', []).extend(
        {'ph': 'X', 'cat': 'span', 'name': r.name, 'pid': pid,
         'tid': r.thread, 'ts': (r.start_ns - base) / 1e3,
         'dur': (r.end_ns - r.start_ns) / 1e3,
         'args': {'kind': r.kind, 'id': r.id, 'parent': r.parent,
                  'unit': r.unit}}
        for r in records)
    with open(path, 'w') as f:
        json.dump(doc, f)


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
    with recording() as rec:
        first = len(rec.records)
        try:
            yield
        finally:
            if prof is not None:
                try:
                    prof.__exit__(None, None, None)
                    out = Path(log_dir)
                    out.mkdir(parents=True, exist_ok=True)
                    prof.export_chrome_trace(str(out / 'trace.json'))
                    _write_spans(out / 'trace.json', rec.records[first:])
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
