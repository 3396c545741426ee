"""A probe of the program's span recorder on the card; the benchmark does
not run it.

    python3 portbench/span_probe.py --workload <cell> --seconds 3 \\
        --runs 3 [--clock]

With --clock, first the recorder's cost a span in a bare loop and its
primitives' (us), then the shared clock: a span opened around a long
kernel (torch.cuda._sleep) and closed after torch.cuda.synchronize()
must end no earlier than the kernel does in the profiler's trace, and
soon after; each repeat prints the span's end less the kernel's end and
the kernel's launch call's start less the span's start, in us, and the
native thread ids of the launch calls beside the span's. Then the cost
of recording: windows of --seconds of the cell's program (built as
spans.py builds it, warmed for the driver's set-up units) under
torch.profiler with CUDA activity, as a
`--trace 1` run's, with the recorder off and on in turn (off, on, on,
off, ...), --runs of each; units/s of each window and the medians.
Last, one pass of spans.py, which prints its three lines. One JSON line
a reading.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Optional  # noqa: E402

from portbench import run as bench_run  # noqa: E402

SLEEP_CYCLES = 100_000_000   # about 50 ms at the H100's clock
REPEATS = 5


def emit(**record) -> None:
    print(json.dumps(record), flush=True)


def clock_check(profiling) -> None:
    """Besides the span, time.time_ns() read just before and after the
    launch and the synchronize: the runtime calls' events must lie
    inside those stamps where the clocks agree."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(REPEATS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with profiling.recording() as rec:
                with profiling.span('clock', 'probe'):
                    t0 = time.time_ns()
                    torch.cuda._sleep(SLEEP_CYCLES)
                    t1 = time.time_ns()
                    torch.cuda.synchronize()
                    t2 = time.time_ns()
        s = rec.records[0]
        events = prof.profiler.kineto_results.events()
        kernels = [e for e in events if e.device_type() == cuda
                   and not e.is_user_annotation()]
        k = max(kernels, key=lambda e: e.duration_ns())
        host = [e for e in events if e.device_type() != cuda]
        launch = next(e for e in host
                      if e.correlation_id() == k.correlation_id())
        sync = next(e for e in host if 'Synchronize' in e.name())
        end = lambda e: e.start_ns() + e.duration_ns()
        us = lambda a, b: (a - b) / 1e3
        emit(probe='clock', kernel=k.name(),
             kernel_us=k.duration_ns() / 1e3,
             span_end_after_kernel_end_us=us(s.end_ns, end(k)),
             launch_after_span_start_us=us(launch.start_ns(), s.start_ns),
             launch_start_after_stamp_us=us(launch.start_ns(), t0),
             stamp_after_launch_end_us=us(t1, end(launch)),
             sync=sync.name(),
             sync_start_after_stamp_us=us(sync.start_ns(), t1),
             stamp_after_sync_end_us=us(t2, end(sync)),
             sync_end_after_kernel_end_us=us(end(sync), end(k)),
             span_end_after_stamp_us=us(s.end_ns, t2),
             launch_thread=launch.start_thread_id(), span_thread=s.thread,
             span_end_after_kernel_end_us_bare_sync=_bare(profiling))


def _bare(profiling) -> Optional[float]:
    """As above, the span closed after the bare synchronize that
    torch.cuda.synchronize() wraps (no device guard around it): the
    span's end less the kernel's, in us; None where the profiler
    recorded no kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with profiling.recording() as rec:
            with profiling.span('clock', 'probe'):
                torch.cuda._sleep(SLEEP_CYCLES)
                torch._C._cuda_synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == cuda and not e.is_user_annotation()]
    if not kernels:
        return None
    k = max(kernels, key=lambda e: e.duration_ns())
    return (rec.records[0].end_ns - k.start_ns() - k.duration_ns()) / 1e3


def micro(profiling) -> None:
    """The recorder's cost a span in a bare loop, off and on, with and
    without the profiler, and its primitives' cost a call (us)."""
    import threading

    import torch
    from torch.profiler import ProfilerActivity, profile
    n = 20_000

    def per(fn) -> float:
        t = time.perf_counter()
        fn()
        return (time.perf_counter() - t) / n * 1e6

    def loop() -> None:
        for _ in range(n):
            with profiling.span('a', 'b'):
                pass

    def on() -> None:
        with profiling.recording():
            loop()

    lock = threading.Lock()

    def locked() -> None:
        for _ in range(n):
            with lock:
                pass

    out = {'off': per(loop), 'on': per(on),
           'time_ns': per(lambda: [time.time_ns() for _ in range(n)]),
           'get_native_id': per(
               lambda: [threading.get_native_id() for _ in range(n)]),
           'lock': per(locked)}
    with profile(activities=[ProfilerActivity.CUDA]):
        out['off_profiled'] = per(loop)
        out['on_profiled'] = per(on)
        x = torch.zeros(1, device='cuda')
        out['launch_profiled'] = per(lambda: [x.add_(1) for _ in range(n)])
        with profiling.recording():
            out['launch_in_span_profiled'] = per(
                lambda: [_launch_in_span(profiling, x) for _ in range(n)])
    torch.cuda.synchronize()
    emit(probe='micro_us', **out)


def _launch_in_span(profiling, x) -> None:
    with profiling.span('a', 'b'):
        x.add_(1)


def cost(ctx, seconds: float, runs: int, profiling) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench import harness, spans
    dev = torch.device('cuda')
    unit, release = spans.program_unit(ctx, dev)
    for i in range(spans.warm_units(ctx)):
        unit(i)
    harness.synchronize(dev)
    order = [on for k in range(runs) for on in
             ((False, True) if k % 2 == 0 else (True, False))]
    rates: dict[bool, list[float]] = {False: [], True: []}
    for on in order:
        gc.collect()
        with profile(activities=[ProfilerActivity.CUDA]):
            with (profiling.recording() if on
                  else contextlib.nullcontext()):
                n, secs = harness.window(unit, seconds, dev)
        rates[on].append(n / secs)
        emit(probe='cost', recording=on, units=n, seconds=secs,
             units_per_s=n / secs)
    off, on_ = (statistics.median(rates[False]),
                statistics.median(rates[True]))
    emit(probe='cost_median', off_units_per_s=off, on_units_per_s=on_,
         on_less_off=(on_ - off) / off,
         ms_a_unit_on_less_off=1e3 / on_ - 1e3 / off)
    release()
    harness.free(dev)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seconds', type=float, default=3.0)
    ap.add_argument('--runs', type=int, default=3)
    ap.add_argument('--clock', action='store_true')
    args = ap.parse_args()
    bench_run._environment()
    import torch
    if not torch.cuda.is_available():
        print('span_probe: no CUDA device', file=sys.stderr)
        return 2
    from portbench import spans
    profiling = spans.program_profiling()
    if profiling is None:
        print('span_probe: the program records no spans', file=sys.stderr)
        return 2
    bench = bench_run.spec()
    w = bench_run.cell(bench, args.workload)
    traffic = bench_run.traffic(w['traffic'])
    kind = 'serve' if traffic['driver'] == 'serve_closed_loop' else 'train'
    ctx = SimpleNamespace(config=bench_run.config(bench, w['config']),
                          traffic=traffic,
                          outcome=SimpleNamespace(kind=kind, units=0,
                                                  batch=traffic['batch']))
    emit(probe='card', card=bench_run.card(), workload=w['name'])
    t = time.perf_counter()
    if args.clock:
        micro(profiling)
        clock_check(profiling)
    cost(ctx, args.seconds, args.runs, profiling)
    spans.measure(ctx)
    emit(probe='done', seconds=time.perf_counter() - t)
    return 0


if __name__ == '__main__':
    sys.exit(main())
