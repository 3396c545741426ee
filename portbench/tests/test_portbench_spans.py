"""spans.py on made-up traces: device operations put down to the span
open at their launch, roles, gap labels, the correlation of launch and
operation; the span_ms readers read nothing outside their kind of cell
and leave the window's trace as it was; and a traced CPU rehearsal
prints the span counts line."""

import copy
from types import SimpleNamespace

import pytest

from conftest import run_small_cell
from portbench import devtrace, run as bench_run, spans
from portbench.harness import Outcome
from portbench.spans import Op, Span

BENCH = bench_run.spec()
SPAN_METRICS = [m['name'] for m in BENCH['per_layer']
                if m['name'].startswith('span_ms.')]

# One KD step (unit 1) on the main thread; its backward runs on another
# thread, which recomputes a block (id 6) with a solve inside (id 7).
STEP = [Span(1, 0, 'train.step', 'step', 0, 100),
        Span(2, 1, 'train.forward', 'phase', 1, 30),
        Span(3, 2, 'layer1_block0', 'block', 2, 20),
        Span(4, 3, 'layer1_block0.conv1', 'qconv', 3, 10),
        Span(5, 1, 'train.backward', 'phase', 40, 90),
        Span(6, 5, 'layer1_block0', 'block', 50, 70),
        Span(7, 6, 'solve.x', 'solve', 52, 60),
        Span(8, 1, 'train.optimizer', 'phase', 91, 99)]


def _op(launch, start, dur):
    return Op('k', start, start + dur, launch)


OPS = [_op(5, 200, 10),      # forward, in a qconv
       _op(25, 210, 20),     # forward, outside its block
       _op(45, 230, 40),     # backward, no block open
       _op(55, 270, 80),     # recomputed block, in a solve
       _op(65, 350, 160),    # recomputed block
       _op(95, 510, 320),    # optimizer
       _op(120, 830, 640),   # launched outside every span
       _op(None, 1470, 1)]   # no launch call found


def test_operations_go_to_the_span_open_at_their_launch():
    ms = spans.device_ms(OPS, STEP, units=1)
    ns = {k: round(v * 1e6) for k, v in ms.items()}
    assert ns['train.forward'] == 30 and ns['qconv'] == 10
    assert ns['block_self'] == 80 + 160
    assert ns['train.backward'] == 40 + 80 + 160
    assert ns['remat'] == 80 + 160 and ns['solve'] == 80
    assert ns['train.optimizer'] == 320 and ns['train.teacher'] == 0
    assert ns['unit'] == 30 + 280 + 320 and ns['unattributed'] == 641
    assert ns['unit'] + ns['unattributed'] == sum(
        o.end_ns - o.start_ns for o in OPS)
    assert ns['unit'] == sum(ns[p] for p in spans.PHASES)
    two = spans.device_ms(OPS, STEP, units=2)
    assert two['unit'] == pytest.approx(ms['unit'] / 2)
    assert spans.device_ms([], STEP, 1) == {}


def test_innermost_is_the_deepest_open_span():
    inner = spans.innermost(STEP, [55, 45, 150, 0, 100])
    assert [s.id if s else None for s in inner] == [7, 5, None, 1, None]
    assert spans.span_prefix(spans.chains(STEP, inner)[0]) == (
        'train.backward/solve.x')
    assert spans.span_prefix(spans.chains(STEP, inner)[1]) == (
        'train.backward')
    assert spans.span_prefix([]) == ''
    forward = [Span(1, 0, 'forward', 'model', 0, 10),
               Span(2, 1, 'layer2_block0', 'block', 1, 9)]
    assert spans.span_prefix(forward) == 'layer2_block0'


def test_idle_gaps_are_prefixed_by_the_span_the_host_was_in():
    ops = [Op('a', 0, 10, 0), Op('b', 50, 60, 0), Op('c', 150, 160, 0),
           Op('d', 400, 410, 0)]
    host = [('cudaStreamSynchronize', 60, 140)]
    step = [Span(1, 0, 'train.step', 'step', 0, 250),
            Span(2, 1, 'train.backward', 'phase', 0, 120),
            Span(3, 2, 'layer3_block1', 'block', 20, 40)]
    gaps = spans.idle_gaps(ops, host, step)
    assert gaps == [
        [f'{devtrace.IDLE_HOST}', pytest.approx(240e-9)],
        ['train.backward · cudaStreamSynchronize', pytest.approx(90e-9)],
        ['train.backward/layer3_block1 · ' + devtrace.IDLE_HOST,
         pytest.approx(40e-9)]]
    assert spans.idle_gaps([], host, step) == []
    calls = host + [('cudaMemcpyAsync', 30, 31), ('cudaLaunchKernel', 30, 31),
                    ('cudaMemcpyAsync', 500, 501)]
    assert spans.host_calls(calls, step, units=2) == {
        'train.backward · cudaStreamSynchronize': 0.5,
        'train.backward/layer3_block1 · cudaMemcpyAsync': 0.5,
        'cudaMemcpyAsync': 0.5}


class _Event:
    def __init__(self, name, device, start, dur, corr, annotation=False):
        self._v = (name, device, start, dur, corr, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


def test_an_operation_is_linked_to_its_launch_by_correlation():
    import torch
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = [_Event('cudaLaunchKernel', cpu, 100, 5, 7),
              _Event('kernel', cuda, 150, 30, 7),
              _Event('cudaMemcpyAsync', cpu, 200, 5, 8),
              _Event('Memcpy DtoH', cuda, 210, 4, 8),
              _Event('annotation', cuda, 0, 500, 0, annotation=True),
              _Event('orphan', cuda, 300, 2, 99),
              _Event('Activity Buffer Request', cpu, 50, 1, 0)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    ops, host = spans.profiled_ops(prof)
    assert ops == [Op('kernel', 150, 180, 100), Op('Memcpy DtoH', 210, 214,
                                                   200),
                   Op('orphan', 300, 302, None)]
    assert [h[0] for h in host] == ['cudaLaunchKernel', 'cudaMemcpyAsync',
                                    'Activity Buffer Request']


def _ctx(kind, config):
    o = Outcome(kind=kind, e2e={}, attempted=1, failed=0, checks=[],
                units=4, batch=4, memory_peak_bytes=0, launches={},
                trace=devtrace.Trace([devtrace.Kernel('k', 0.0, 0.5)], 1.0,
                                     0.5, {'device_ops': [['k', 0.5]]}))
    return bench_run.Context(bench_run.config(BENCH, config), {}, o)


def test_each_reader_reads_only_its_kind_of_cell(monkeypatch):
    roles = {'qconv', 'block_self', 'stem_head', 'solve', 'remat',
             *spans.PHASES, 'unit'}
    fake = spans.Reading(1, {r: 1.0 + i for i, r in
                                  enumerate(sorted(roles))})
    monkeypatch.setattr(spans, 'reading', lambda ctx: fake)
    cells = {'serve': _ctx('serve', 'r18_xnor_ls1'),
             'f32': _ctx('train', 'r18_xnor_ls1'),
             'bf16': _ctx('train', 'r18_xnor_ls2_ls1')}
    assert len(SPAN_METRICS) == 13
    for m in SPAN_METRICS:
        parts = m.split('.')
        kind = 'serve' if parts[1] == 'serve' else parts[-1]
        for name, ctx in cells.items():
            got = bench_run.reader(m).read(ctx)
            if name == kind:
                role = parts[2] if kind == 'serve' or parts[2] in (
                    'solve', 'remat') else f'train.{parts[2]}'
                assert got == fake.ms[role], m
            else:
                assert got is None, (m, name)
    monkeypatch.setattr(spans, 'reading', lambda ctx: spans.Reading(1))
    assert all(bench_run.reader(m).read(cells['serve']) is None
               for m in SPAN_METRICS)


def test_the_span_metrics_list_the_cells_they_read():
    for m in BENCH['per_layer']:
        if m['name'] in SPAN_METRICS:
            assert m['source'] == 'device_trace' and m['unit'] == 'ms'
            kind = m['name'].split('.')[1]
            for cell in m['workloads']:
                w = bench_run.cell(BENCH, cell)
                assert ('serve' in w['traffic']) == (kind == 'serve')


def test_a_program_without_spans_reads_nothing(monkeypatch):
    monkeypatch.setattr(spans, 'program_profiling', lambda: None)
    ctx = _ctx('serve', 'r18_xnor_ls1')
    assert spans.measure(ctx) is None
    assert all(bench_run.reader(m).read(ctx) is None for m in SPAN_METRICS)


@pytest.mark.parametrize('cell', ['r18_xnor_ls1.serve_b256',
                                  'r18_xnor_ls2_ls1.train_kd_tpu_b256'])
def test_a_traced_rehearsal_prints_the_counts_and_keeps_the_trace(
        cell, capsys, monkeypatch):
    """The span readers run their pass after every other reader, print
    the counts line, and leave the window's trace and the other readers'
    numbers as they were; on the CPU no device operation shows, so they
    read nothing."""
    seen = {}
    measure = spans.measure

    def spy(ctx):
        seen['trace'] = copy.deepcopy(ctx.trace)
        seen['reading'] = measure(ctx)
        return seen['reading']

    monkeypatch.setattr(spans, 'measure', spy)
    line, outcome = run_small_cell(cell, trace=True)
    out = capsys.readouterr().out
    assert outcome.trace == seen['trace']
    assert not set(line['metrics']) & set(SPAN_METRICS)
    counts = next(x for x in out.splitlines()
                  if x.startswith('spans a unit: '))
    r = seen['reading']
    assert r.ms == {} and r.units == spans.UNITS[outcome.kind]
    tr = bench_run.traffic(bench_run.cell(BENCH, cell)['traffic'])
    warm = int(tr[spans.SETUP[outcome.kind]]) + outcome.units
    assert f'units {r.units} after {warm},' in counts
    if outcome.kind == 'serve':
        assert r.counts == {'block': 4, 'head': 1, 'model': 1, 'qconv': 8,
                            'shortcut': 3, 'stem': 1}
    else:
        assert r.counts['qconv'] == 24 and r.counts['phase'] == 4
    assert 'port kernels a unit' in counts
