"""The device trace of a measured window, read from `torch.profiler`.

The window runs under the profiler with CUDA activity alone: the device's
operations (kernels, copies, sets) and the host's calls into the CUDA
runtime. Recording every PyTorch operator on the host too (CPU activity)
slows a host-bound loop by more than half and would read its own cost as
idle device time. The profiler starts just before the window, so the
window is placed on the trace's clock from its first event, for the
window's length on the host's clock. From the trace: every device
operation clipped to the window, the union of their intervals (the
seconds the device was busy), the device operations that took most
time, and the idle gaps between them, each named by the runtime call the
host was in at the gap's middle ('host: between CUDA calls' where it was
in none: Python and PyTorch's own work), the longest gaps summed by that
name.
"""

from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

TOP = 10
LABELLED_GAPS = 2000
NAME_CHARS = 160
IDLE_HOST = 'host: between CUDA calls'


@dataclass
class Kernel:
    name: str
    start: float    # seconds on the profiler's clock
    end: float

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclass
class Trace:
    kernels: list[Kernel]
    window_s: float
    busy_s: float
    breakdown: dict = field(default_factory=dict)


def _union(kernels: list[Kernel]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for k in sorted(kernels, key=lambda k: k.start):
        if merged and k.start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], k.end)
        else:
            merged.append([k.start, k.end])
    return [(a, b) for a, b in merged]


def _label_gaps(gaps: list[tuple[float, float]], host: list
                ) -> list[tuple[str, float]]:
    """(innermost host call at the gap's middle, gap seconds) for each
    gap; 'host: between CUDA calls' where none ran."""
    if not host:
        return [(IDLE_HOST, b - a) for a, b in gaps]
    host.sort(key=lambda e: e[1])
    names = [h[0] for h in host]
    starts = np.array([h[1] for h in host])
    ends = np.array([h[2] for h in host])
    out = []
    for a, b in gaps:
        mid = 0.5 * (a + b)
        i = int(np.searchsorted(starts, mid, side='right'))
        live = np.nonzero(ends[:i] >= mid)[0]
        out.append((names[live[-1]] if live.size else IDLE_HOST, b - a))
    return out


def read(prof: 'torch.profiler.profile', window_s: float) -> Trace:
    """The Trace of a window of `window_s` seconds (host clock) that
    started as the profiler did."""
    cuda = torch.autograd.DeviceType.CUDA
    kernels, host = [], []
    for e in prof.events():
        start, end = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.device_type == cuda:
            # A span recorded on the host shows on the device's timeline
            # too, as an annotation over its kernels: no device operation.
            if not getattr(e, 'is_user_annotation', False):
                kernels.append(Kernel(e.name, start, end))
        else:
            host.append((e.name, start, end))
    events = kernels + [Kernel(*h) for h in host]
    if not events:
        raise RuntimeError('the profiler recorded nothing')
    lo = min(k.start for k in events)
    hi = lo + window_s
    kernels = [Kernel(k.name, max(k.start, lo), min(k.end, hi))
               for k in kernels if k.end > lo and k.start < hi]
    busy = _union(kernels)
    busy_s = sum(b - a for a, b in busy)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:LABELLED_GAPS]
    by_op: dict[str, float] = {}
    for k in kernels:
        by_op[k.name] = by_op.get(k.name, 0.0) + k.seconds
    idle: dict[str, float] = {}
    for name, s in _label_gaps(gaps, host):
        idle[name] = idle.get(name, 0.0) + s
    top = lambda d: [[n[:NAME_CHARS], s] for n, s in
                     sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return Trace(kernels, hi - lo, busy_s,
                 {'device_ops': top(by_op), 'idle_gaps': top(idle)})


def traced(window: Callable[[], tuple[int, float]]
           ) -> tuple[int, float, Trace]:
    """Run window() (it returns the units it completed, its last one
    synchronized, and its seconds) under the profiler; (units, seconds,
    its Trace). On a machine without CUDA the host's operators are
    traced instead, and no device operation shows."""
    from torch.profiler import ProfilerActivity, profile
    activity = (ProfilerActivity.CUDA if torch.cuda.is_available()
                else ProfilerActivity.CPU)
    with profile(activities=[activity]) as prof:
        units, seconds = window()
    return units, seconds, read(prof, seconds)
