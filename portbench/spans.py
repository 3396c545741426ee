"""Device time put down to the program's spans, for the `span_ms.*`
readers.

The program records spans where its work happens
(`quant_tpu_torch.utils.profiling`: a forward's stem, blocks, quantized
convs, shortcuts, solves and head; a train step's phases) while a
recording is open. The measured window runs with the recorder off and
its trace (devtrace.read) keeps no launch correlation, so the readers
read a pass of their own, run once the window's trace has been read,
and not the window: the cell's program built as its driver builds it,
on the traffic's pool of batches (from `SEED`, which sets values and no
shape), warmed for as many units as the driver's set-up and the window
ran together (`warm_units`), so that the measured units come where the
window ended, then `UNITS` units dispatched back to back and
synchronized under `torch.profiler` with CUDA activity (as devtrace)
and the recorder on.

Each device operation (kernel, copy, set) is put down to the innermost
span open when its launch call began: the runtime call and the
operation share the profiler's correlation id, and the spans its clock
(`time.time_ns()`, on which the profiler places its events). The spans
of one unit nest across threads (autograd's thread takes the innermost
span of the thread that opened the unit as parent), and in the cells'
programs one thread launches at a time, so the innermost span open is
the launching thread's, or the unit opener's where that thread had none
open. A unit is a root span: a served forward or a train step.

The pass prints three lines before the result: spans entered a unit by
kind beside the port kernels' launches a unit; device ms a unit under
the units' roots and under each role (`ROLES`), with the operations no
span launched; and the pass's longest idle gaps, each named by the
phase and innermost span the host was in at the gap's middle, then by
the runtime call (devtrace's labels), e.g.
'train.backward/layer3_block1 · host: between CUDA calls', beside its
synchronizing and copying runtime calls a unit, named alike.
"""

import gc
import importlib
import json
import time
from dataclasses import dataclass, field
from typing import Any, Callable, NamedTuple, Optional

import torch

from portbench import devtrace, harness, port, state

SEED = 2 ** 31 + 19
UNITS = {'serve': 16, 'train': 4}
SETUP = {'serve': 'warmup_units', 'train': 'checked_steps'}
TOP = 10
BACKWARD = 'train.backward'
PHASES = ('train.forward', 'train.teacher', BACKWARD, 'train.optimizer')
SYNCS = ('Synchronize', 'Memcpy')


class Op(NamedTuple):
    """A device operation on the profiler's clock (ns since the epoch);
    `launch_ns` is its launch call's start, None where none was
    found."""
    name: str
    start_ns: int
    end_ns: int
    launch_ns: Optional[int]


class Span(NamedTuple):
    """What attribution reads of a span (the recorder's SpanRecord has
    these fields and more)."""
    id: int
    parent: int
    name: str
    kind: str
    start_ns: int
    end_ns: int


def _in(kind: str) -> Callable[[list[Span]], bool]:
    return lambda chain: any(s.kind == kind for s in chain)


def _named(name: str) -> Callable[[list[Span]], bool]:
    return lambda chain: any(s.name == name for s in chain)


def _block_self(chain: list[Span]) -> bool:
    kinds = {s.kind for s in chain}
    return 'block' in kinds and 'qconv' not in kinds


def _remat(chain: list[Span]) -> bool:
    """A block recomputed in the backward pass: a block span under
    'train.backward'."""
    names = [s.name for s in chain]
    return BACKWARD in names and any(
        s.kind == 'block' for s in chain[names.index(BACKWARD):])


# role -> which chains of spans (root first) it takes.
ROLES: dict[str, Callable[[list[Span]], bool]] = {
    'qconv': _in('qconv'),
    'block_self': _block_self,
    'stem_head': lambda c: any(s.kind in ('stem', 'head') for s in c),
    'solve': _in('solve'),
    'remat': _remat,
    **{p: _named(p) for p in PHASES},
}


@dataclass
class Reading:
    """A pass's numbers, each a unit: `ms` device ms by role, 'unit'
    under the roots, 'unattributed' launched outside every span (empty
    where no device operation showed); `counts` spans entered by kind;
    `launches` the port kernels'; `gaps` the longest idle gaps; `syncs`
    the synchronizing and copying runtime calls by span."""
    units: int
    ms: dict[str, float] = field(default_factory=dict)
    counts: dict[str, float] = field(default_factory=dict)
    launches: dict[str, float] = field(default_factory=dict)
    gaps: list = field(default_factory=list)
    syncs: dict[str, float] = field(default_factory=dict)


def innermost(spans: list[Span], times: list[int]) -> list[Optional[Span]]:
    """For each of `times` (sorted or not), the deepest span open then
    (start <= t < end), None where none was."""
    depth: dict[int, int] = {}
    byid = {s.id: s for s in spans}

    def depth_of(s: Span) -> int:
        if s.id not in depth:
            parent = byid.get(s.parent)
            depth[s.id] = 0 if parent is None else depth_of(parent) + 1
        return depth[s.id]

    events = ([(s.end_ns, 0, i) for i, s in enumerate(spans)]
              + [(s.start_ns, 1, i) for i, s in enumerate(spans)]
              + [(t, 2, j) for j, t in enumerate(times)])
    events.sort()
    open_: dict[int, Span] = {}
    out: list[Optional[Span]] = [None] * len(times)
    for _, what, i in events:
        if what == 0:
            open_.pop(i, None)
        elif what == 1:
            open_[i] = spans[i]
        elif open_:
            out[i] = max(open_.values(), key=depth_of)
    return out


def chains(spans: list[Span], inner: list[Optional[Span]]
           ) -> list[list[Span]]:
    """The chain of each innermost span, its root first ([] for None)."""
    byid = {s.id: s for s in spans}
    memo: dict[int, list[Span]] = {}

    def chain(s: Span) -> list[Span]:
        if s.id not in memo:
            parent = byid.get(s.parent)
            memo[s.id] = (chain(parent) if parent is not None else []) + [s]
        return memo[s.id]

    return [chain(s) if s is not None else [] for s in inner]


def device_ms(ops: list[Op], spans: list[Span], units: int
              ) -> dict[str, float]:
    """Device ms a unit by role, 'unit' (every operation a span
    launched) and 'unattributed'; {} without operations or units."""
    if not ops or units <= 0:
        return {}
    inner = innermost(spans, [o.launch_ns if o.launch_ns is not None
                              else -1 for o in ops])
    ns = {role: 0 for role in ('unit', 'unattributed', *ROLES)}
    for op, chain in zip(ops, chains(spans, inner)):
        d = op.end_ns - op.start_ns
        if not chain:
            ns['unattributed'] += d
            continue
        ns['unit'] += d
        for role, takes in ROLES.items():
            if takes(chain):
                ns[role] += d
    return {role: v / 1e6 / units for role, v in ns.items()}


def span_prefix(chain: list[Span]) -> str:
    """'phase/innermost' of a chain, the innermost alone outside a
    phase, '' for no span."""
    if not chain:
        return ''
    phases = [s.name for s in chain if s.kind == 'phase']
    last = chain[-1].name
    return last if not phases or phases[-1] == last else (
        f'{phases[-1]}/{last}')


def idle_gaps(ops: list[Op], host: list[tuple[str, int, int]],
              spans: list[Span]) -> list[list]:
    """The pass's longest idle gaps between device operations (as many
    as devtrace labels), summed by label (span prefix, then devtrace's
    host-call label), longest first."""
    if not ops:
        return []
    t0 = min(o.start_ns for o in ops)
    sec = lambda t: (t - t0) * 1e-9
    kernels = [devtrace.Kernel(o.name, sec(o.start_ns), sec(o.end_ns))
               for o in ops]
    busy = devtrace._union(kernels)
    gaps = sorted(((busy[i][1], busy[i + 1][0])
                   for i in range(len(busy) - 1)
                   if busy[i + 1][0] > busy[i][1]),
                  key=lambda g: g[0] - g[1])[:devtrace.LABELLED_GAPS]
    labels = devtrace._label_gaps(
        gaps, [(n, sec(a), sec(b)) for n, a, b in host])
    mids = [t0 + int(0.5e9 * (a + b)) for a, b in gaps]
    prefixes = [span_prefix(c) for c in
                chains(spans, innermost(spans, mids))]
    total: dict[str, float] = {}
    for prefix, (label, s) in zip(prefixes, labels):
        key = f'{prefix} · {label}' if prefix else label
        total[key] = total.get(key, 0.0) + s
    return [[k, v] for k, v in
            sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]


def host_calls(host: list[tuple[str, int, int]], spans: list[Span],
               units: int) -> dict[str, float]:
    """Synchronizing and copying runtime calls (`SYNCS`) a unit, by the
    span the host was in when each began ('phase/innermost', as the
    gaps)."""
    calls = [h for h in host if any(n in h[0] for n in SYNCS)]
    prefixes = [span_prefix(c) for c in
                chains(spans, innermost(spans, [h[1] for h in calls]))]
    out: dict[str, float] = {}
    for (name, _, _), prefix in zip(calls, prefixes):
        key = f'{prefix} · {name}' if prefix else name
        out[key] = out.get(key, 0.0) + 1.0 / max(units, 1)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def profiled_ops(prof: Any) -> tuple[list[Op], list[tuple[str, int, int]]]:
    """(device operations with their launch calls' starts, host calls)
    of a finished torch.profiler session, on its clock."""
    cuda = torch.autograd.DeviceType.CUDA
    device, host, launch = [], [], {}
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                device.append((e.name(), start, end, e.correlation_id()))
        else:
            host.append((e.name(), start, end))
            corr = e.correlation_id()
            if corr and (corr not in launch or start < launch[corr]):
                launch[corr] = start
    ops = [Op(n, a, b, launch.get(c)) for n, a, b, c in device]
    return ops, host


def _spans(records: list) -> list[Span]:
    return [Span(r.id, r.parent, r.name, r.kind, r.start_ns, r.end_ns)
            for r in records]


def warm_units(ctx: Any) -> int:
    """Units the pass runs before it measures: the driver's set-up units
    (`SETUP`: warm-up forwards, checked steps) and the window's, so a
    train state is as many steps old as at the window's end, and what
    the program does once after some calls has been done."""
    return int(ctx.traffic[SETUP[ctx.outcome.kind]]) + int(ctx.outcome.units)


def program_unit(ctx: Any, dev: torch.device
                  ) -> tuple[Callable[[int], None], Callable[[], None]]:
    """(unit(i), release) of the cell's program, built as its driver
    builds it, from SEED, on the traffic's pool of batches. It follows
    drivers/serve_closed_loop.py and drivers/train_kd.py: a change to
    how a driver builds or steps the program is made here too, until
    the window's trace keeps launch correlation and the pass goes."""
    cfg, o = ctx.config, ctx.outcome
    gen = state.generator(SEED, dev)
    pool = int(ctx.traffic['pool_batches'])
    size, ch = cfg['image_size'], cfg['in_channels']
    held: dict[str, Any] = {}
    if o.kind == 'serve':
        weights = state.serve_state(cfg, gen, dev)
        held['images'] = state.images(gen, dev, pool, o.batch, size, ch)
        held['forward'] = port.serve_forward(
            port.serving_model(cfg, weights, dev))

        def unit(i: int) -> None:
            held['forward'](held['images'][i % pool])
    else:
        student, teacher = state.train_states(cfg, gen, dev)
        held['images'] = state.images(gen, dev, pool, o.batch, size, ch)
        held['labels'] = state.labels(gen, dev, pool, o.batch,
                                      cfg['output_classes'])
        held['state'], held['step'], _ = port.train_step(
            cfg, student, teacher, dev)
        held['metric'] = port.init_metric_state()

        def unit(i: int) -> None:
            held['step'](held['images'][i % pool],
                         held['labels'][i % pool], held['metric'])
    return unit, held.clear


def program_profiling() -> Optional[Any]:
    """The program's span recorder, None where the program has none."""
    try:
        mod = importlib.import_module('quant_tpu_torch.utils.profiling')
    except ImportError:
        return None
    return mod if hasattr(mod, 'recording') else None


def measure(ctx: Any) -> Optional[Reading]:
    """The pass of ctx's cell (module docstring); None where the program
    records no spans."""
    profiling = program_profiling()
    if profiling is None or ctx.outcome.kind not in UNITS:
        return None
    from torch.profiler import ProfilerActivity, profile
    dev = torch.device('cuda' if torch.cuda.is_available() else 'cpu')
    activity = (ProfilerActivity.CUDA if dev.type == 'cuda'
                else ProfilerActivity.CPU)
    n, warm = UNITS[ctx.outcome.kind], warm_units(ctx)
    t0 = time.perf_counter()
    unit, release = program_unit(ctx, dev)
    try:
        for i in range(warm):
            unit(i)
        harness.synchronize(dev)
        gc.collect()
        before = port.launch_counts()
        with profile(activities=[activity]) as prof:
            with profiling.recording() as rec:
                for i in range(n):
                    unit(warm + i)
                harness.synchronize(dev)
        after = port.launch_counts()
    finally:
        release()
        harness.free(dev)
    units = rec.units
    ops, host = profiled_ops(prof)
    spans = _spans(rec.records)
    by_kind: dict[str, float] = {}
    for (k, _), c in sorted(rec.counts.items()):
        by_kind[k] = by_kind.get(k, 0) + c / max(units, 1)
    reading = Reading(
        units, device_ms(ops, spans, units), by_kind,
        {k: (v - before.get(k, 0)) / max(units, 1)
         for k, v in after.items()},
        idle_gaps(ops, host, spans), host_calls(host, spans, units))
    print(f'spans a unit: {json.dumps(reading.counts)}; port kernels a '
          f'unit: {json.dumps(reading.launches)}; units {units} after '
          f'{warm}, spans dropped {rec.dropped}; pass '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    print(f'span device ms a unit: {json.dumps(reading.ms)}', flush=True)
    print(f'span idle gaps: {json.dumps(reading.gaps)}; syncs and '
          f'copies a unit: {json.dumps(reading.syncs)}', flush=True)
    return reading


_last: list = []


def reading(ctx: Any) -> Optional[Reading]:
    """measure(ctx), once for each run's outcome."""
    if not _last or _last[0] is not ctx.outcome:
        _last[:] = [ctx.outcome, measure(ctx)]
    return _last[1]


def train_chain(ctx: Any) -> Optional[str]:
    """'f32' or 'bf16': the chain a training cell's student trains in
    (the suffix of its metrics); None for a serving cell."""
    if ctx.outcome.kind != 'train':
        return None
    return {'float32': 'f32', 'bfloat16': 'bf16'}.get(
        ctx.config['train']['train_dtype'])


def read_role(ctx: Any, kind: str, role: str,
              chain: Optional[str] = None) -> Optional[float]:
    """Device ms a unit under `role` in a cell of `kind` ('serve' or
    'train', of the train `chain`); None in any other cell, or where the
    pass saw no device operation."""
    if ctx.outcome.kind != kind or (chain is not None
                                    and train_chain(ctx) != chain):
        return None
    r = reading(ctx)
    return None if r is None else r.ms.get(role)
