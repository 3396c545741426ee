"""What every traffic driver shares: the run's settings, the measured
window, and what a driver hands back to `run.py`.

A window dispatches units (forwards or steps) back to back until the
host's clock passes its seconds, then synchronizes: every unit it
dispatched has completed when it ends, and its length runs to that
synchronize. Nothing is built or compiled inside it: the drivers warm
every shape first.
"""

import gc
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from portbench import devtrace as tracing


@dataclass
class Run:
    """One run of one cell."""
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float               # perf_counter at the process's start
    limits: dict = field(default_factory=dict)


@dataclass
class Check:
    """One number the comparison with the reference reads, and its limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit   # False for NaN


@dataclass
class Outcome:
    kind: str                       # 'serve' or 'train'
    e2e: dict[str, float]
    attempted: int
    failed: int
    checks: list[Check]
    units: int                      # forwards or steps in the window
    batch: int
    memory_peak_bytes: int
    launches: dict[str, int]
    trace: Optional[tracing.Trace] = None

    @property
    def correct(self) -> bool:
        return (self.failed == 0 and bool(self.checks)
                and all(c.ok for c in self.checks))


def synchronize(device: torch.device) -> None:
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def window(unit: Callable[[int], None], seconds: float,
           device: torch.device) -> tuple[int, float]:
    """Dispatch unit(i) for i = 0, 1, ... until `seconds` have passed on
    the host's clock, then synchronize; (units, window seconds). Python's
    cyclic garbage collector waits until the window has closed."""
    gc.collect()
    gc.disable()
    try:
        start = time.perf_counter()
        n = 0
        while True:
            unit(n)
            n += 1
            if time.perf_counter() - start >= seconds:
                break
        synchronize(device)
        return n, time.perf_counter() - start
    finally:
        gc.enable()


def measured(run: Run, unit: Callable[[int], None]
             ) -> tuple[int, float, Optional[tracing.Trace]]:
    """The run's window: plain, or under the profiler for at most the
    traffic's `trace_seconds` with --trace 1. (units, seconds, trace)."""
    if not run.trace:
        n, secs = window(unit, run.seconds, run.device)
        return n, secs, None
    seconds = min(run.seconds, float(run.traffic['trace_seconds']))
    return tracing.traced(lambda: window(unit, seconds, run.device))


def memory_peak_bytes(device: torch.device) -> int:
    if device.type != 'cuda':
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def free(device: torch.device) -> None:
    """Return the program's freed memory before the reference runs."""
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.empty_cache()


class reference_precision:
    """float32 at full precision (TF32 off) inside, as the reference is
    defined; the flags as they were on exit."""

    def __enter__(self) -> None:
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc) -> None:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved
