"""What probe_r2 and probe_r3 share: the registry, `record`, the timing
loop and the command line.

Each probe is a function `name(device='cuda', ...)` that measures one
thing and calls `record` once per result. `record` prints one JSON line
and, when the command line gave `--out PATH`, appends it there; nothing
is written to a fixed path.
"""

import argparse
import contextlib
import json
import time
from typing import Any, Callable, Iterator, Optional

import torch
import torch.nn.functional as F

from quant_tpu_torch.device import resolve_device

Probe = Callable[..., None]

# Rows recorded by this process, in order (read by chip_smoke.py).
RECORDS: list[dict[str, Any]] = []
_out_path: Optional[str] = None


def registrar(table: dict[str, Probe]) -> Callable[[Probe], Probe]:
    """A decorator that enters a probe in `table` under its name."""
    def probe(fn: Probe) -> Probe:
        table[fn.__name__] = fn
        return fn
    return probe


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'


def record(name: str, dev: torch.device, **kv: Any) -> dict[str, Any]:
    """Print one result as a JSON line (and append it to --out)."""
    row = {'probe': name, 'device': device_name(dev), **kv}
    RECORDS.append(row)
    line = json.dumps(row)
    if _out_path:
        with open(_out_path, 'a') as f:
            f.write(line + '\n')
    print(line, flush=True)
    return row


def timed_loop(step: Callable[[Any], Any], carry: Any, dev: torch.device,
               inner: int, outer: int = 4) -> tuple[float, Any]:
    """Seconds per rep of `carry = step(carry)`, and the last carry.

    As the JAX probes time: `inner` chained reps warm up (the JAX step's
    compile and first run), then `outer * inner` chained reps are timed
    (CUDA events on the card, the host clock on the CPU).
    """
    for _ in range(inner):
        carry = step(carry)
    reps = outer * inner
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            carry = step(carry)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / reps, carry
    t0 = time.perf_counter()
    for _ in range(reps):
        carry = step(carry)
    return (time.perf_counter() - t0) / reps, carry


def _timed(fn: Callable[[], Any], iters: int, head_start_ms: float
           ) -> tuple[float, bool]:
    """(mean ms a call of `fn` on the current CUDA stream, whether the
    stream was still in its head start when the host had queued the
    last call)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if head_start_ms > 0:
        torch.cuda._sleep(int(head_start_ms * 2e6))  # cycles, <= 2 GHz
    start.record()
    for _ in range(iters):
        fn()
    lead_held = not start.query()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, lead_held


def card_ms(fn: Callable[[], Any], iters: int,
            head_start_ms: float = 20.0) -> float:
    """Mean milliseconds per call of `fn` on the current CUDA stream.

    After two warm-up calls the stream first sleeps for `head_start_ms`
    (before the start event), so the host queues the calls meanwhile and
    the events time the card's work alone, not the host's launch time,
    as long as the queueing takes less than the sleep. head_start_ms=0
    times the calls back to back, host included."""
    return _timed(fn, iters, head_start_ms)[0]


def card_alone_ms(fn: Callable[[], Any], iters: int,
                  back_to_back_ms: float) -> tuple[Optional[float], int]:
    """(card_ms of `fn`, the calls it averages) behind a head start sized
    from the back-to-back time (1.5x that of the calls, plus 20 ms),
    read only where the stream was still in its head start when the
    host had queued the last call, so that the card never waited for
    the host. A launch queue that fills up stalls the host before that
    (eager forwards of hundreds of launches each): then fewer calls are
    timed, halving `iters` down to one. (None, 0) where even one call
    outlasts the head start: the card time alone was not measured."""
    n = iters
    while n >= 1:
        ms, lead_held = _timed(fn, n, 1.5 * back_to_back_ms * n + 20.0)
        if lead_held:
            return ms, n
        n //= 2
    return None, 0


@contextlib.contextmanager
def tf32(enabled: bool, cudnn: Optional[bool] = None) -> Iterator[None]:
    """Set TF32 for float32 matmuls and cuDNN convs (`cudnn`, when given,
    for the convs alone); restore on exit."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled if cudnn is None else cudnn
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _gen(dev: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


def randn(shape: tuple[int, ...], dev: torch.device,
          dtype: torch.dtype = torch.float32, seed: int = 0) -> torch.Tensor:
    """Standard normal values made on `dev` from `seed`, cast to dtype."""
    return torch.randn(shape, generator=_gen(dev, seed),
                       device=dev).to(dtype)


def randint(lo: int, hi: int, shape: tuple[int, ...], dev: torch.device,
            dtype: torch.dtype, seed: int = 0) -> torch.Tensor:
    """Integers in [lo, hi) made on `dev` from `seed`."""
    return torch.randint(lo, hi, shape, generator=_gen(dev, seed),
                         device=dev).to(dtype)


def pm1(shape: tuple[int, ...], dev: torch.device, dtype: torch.dtype,
        seed: int = 0) -> torch.Tensor:
    """Random ±1 values (the JAX probes' sign(normal))."""
    return (randint(0, 2, shape, dev, torch.int32, seed) * 2 - 1).to(dtype)


def nchw(x: torch.Tensor) -> torch.Tensor:
    """The NCHW view of an NHWC tensor (channels_last memory)."""
    return x.permute(0, 3, 1, 2)


def oihw(w: torch.Tensor) -> torch.Tensor:
    """An HWIO kernel as a channels_last OIHW tensor."""
    return w.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)


def col_major(w: torch.Tensor) -> torch.Tensor:
    """The same (K, N) matrix stored column-major: the layout in which
    torch._int_mm reaches cuBLASLt's int8 tensor-core kernels (probe_r2's
    matmul_int8 records both layouts)."""
    return w.t().contiguous().t()


def im2col3x3(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B*H*W, 9*C) patches of a 3x3 stride-1 'same'
    conv, taps in (dy, dx) order with C fastest (rows of an HWIO kernel
    reshaped to (9*C, Cout))."""
    b, h, w, c = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    cols = [xp[:, dy:dy + h, dx:dx + w, :]
            for dy in range(3) for dx in range(3)]
    return torch.cat(cols, dim=-1).reshape(b * h * w, 9 * c)


def main(table: dict[str, Probe], doc: str,
         argv: Optional[list[str]] = None) -> int:
    """`<probe>` runs one probe, `--all` every probe in turn, `--list`
    (or nothing) prints the names. A probe that raises is recorded with
    its error and the exit code is 1."""
    global _out_path
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument('probe', nargs='?', choices=sorted(table))
    ap.add_argument('--list', action='store_true',
                    help='print every probe name')
    ap.add_argument('--all', action='store_true',
                    help='run every probe in turn, in this process')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument('--out', default=None,
                    help='also append each result line to this file')
    args = ap.parse_args(argv)
    if args.list or (args.probe is None and not args.all):
        print('\n'.join(table))
        return 0
    dev = resolve_device(args.device)
    _out_path = args.out
    failed = 0
    for name in table if args.all else [args.probe]:
        t0 = time.perf_counter()
        try:
            table[name](device=dev)
        except Exception as e:  # noqa: BLE001 — record the failure
            record(name, dev, error=f'{type(e).__name__}: {e}'[:300],
                   wall_s=time.perf_counter() - t0)
            failed += 1
    return 1 if failed else 0
