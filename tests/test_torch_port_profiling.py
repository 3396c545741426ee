"""The port's profiling utilities (quant_tpu_torch/utils/profiling.py):
the trace context's robustness and StepTimer's cadence, mirroring
tests/utils/test_profiling.py, and the same logs as JAX's StepTimer;
the program's spans: nesting across threads, the off path, the bounded
buffer, the clock shared with torch.profiler, the spans of a QResNet
forward and of a KD step with remat, which change no number."""

import contextlib
import logging
import threading
from unittest import mock

import torch

from quant_tpu.utils.profiling import StepTimer as JStepTimer
from quant_tpu_torch.utils import profiling
from quant_tpu_torch.utils.profiling import StepTimer, trace

LOGGER = 'quant_tpu_torch.utils.profiling'


def test_trace_context_is_robust(tmp_path):
    # On the CPU the profiler starts; either way the context must not
    # raise and must stop cleanly, leaving its trace behind.
    with trace(tmp_path / 'prof'):
        x = torch.arange(10).sum().item()
    assert x == 45
    assert (tmp_path / 'prof' / 'trace.json').exists()


def test_trace_failure_to_start_only_warns(tmp_path, caplog):
    with mock.patch('torch.profiler.profile',
                    side_effect=RuntimeError('no profiler here')), \
            caplog.at_level(logging.WARNING, logger=LOGGER):
        with trace(tmp_path / 'prof'):
            x = sum(range(10))
    assert x == 45
    assert 'failed to start' in caplog.records[0].getMessage()


def test_step_timer_logs_on_cadence(caplog):
    synced = []
    t = StepTimer(batch_size=32, log_every=2,
                  sync_fn=lambda: synced.append(1))
    with caplog.at_level(logging.INFO, logger=LOGGER):
        t(epoch=0, global_step=0)   # arms the timer
        t(epoch=0, global_step=1)   # below cadence
        assert not caplog.records
        t(epoch=0, global_step=2)   # hits cadence
    assert len(caplog.records) == 1
    msg = caplog.records[0].getMessage()
    assert 'steps/s' in msg and 'images/s' in msg
    assert synced == [1]


def test_step_timer_without_batch_size(caplog):
    t = StepTimer(log_every=1)
    with caplog.at_level(logging.INFO, logger=LOGGER):
        t(epoch=0, global_step=0)
        t(epoch=0, global_step=1)
    assert len(caplog.records) == 1
    assert 'images/s' not in caplog.records[0].getMessage()


def test_step_timer_reports_as_jax_does(caplog):
    """The same steps give JAX's message up to the measured rates, and
    the default sync touches the card only where CUDA is in use."""
    assert StepTimer().sync_fn is profiling._sync_card
    with mock.patch('torch.cuda.synchronize') as sync:
        profiling._sync_card()
    assert sync.called == (torch.cuda.is_available()
                           and torch.cuda.is_initialized())
    logs = []
    for cls, name in ((StepTimer, LOGGER),
                      (JStepTimer, 'quant_tpu.utils.profiling')):
        caplog.clear()
        t = cls(batch_size=8, log_every=3, sync_fn=None)
        with caplog.at_level(logging.INFO, logger=name):
            for step in range(7):
                t(epoch=1, global_step=step)
        logs.append([(r.args[1:], r.msg) for r in caplog.records])
    assert logs[0] == logs[1] and len(logs[0]) == 2


# --- the program's spans (span, recording) ----------------------------

def _chain(records, r) -> str:
    byid = {s.id: s for s in records}
    names = []
    while r is not None:
        names.append(r.name)
        r = byid.get(r.parent)
    return '/'.join(reversed(names))


def test_spans_nest_with_parents_units_and_counts():
    span = profiling.span
    with profiling.recording() as rec:
        for _ in range(2):
            with span('step', 'step'):
                with span('a', 'phase'):
                    with span('x', 'solve'):
                        pass
                    with span('x', 'solve'):
                        pass
    assert len(rec.records) == 8
    by = {(r.unit, r.name): r for r in rec.records}
    roots = [r for r in rec.records if r.parent == 0]
    assert [r.name for r in roots] == ['step', 'step'] and rec.units == 2
    for root in roots:
        assert root.unit == root.id
        a = by[(root.unit, 'a')]
        assert a.parent == root.id
        xs = [r for r in rec.records if r.unit == root.unit
              and r.name == 'x']
        assert [x.parent for x in xs] == [a.id, a.id]
        assert root.start_ns <= a.start_ns <= xs[0].start_ns
        assert xs[1].end_ns <= a.end_ns <= root.end_ns
    assert rec.counts == {('step', 'step'): 2, ('phase', 'a'): 2,
                          ('solve', 'x'): 4}
    assert {r.thread for r in rec.records} == {threading.get_native_id()}
    assert rec.dropped == 0


def test_a_span_on_another_thread_takes_the_units_innermost():
    span = profiling.span
    seen = []

    def worker():
        with span('recompute', 'block'):
            with span('conv', 'qconv'):
                seen.append(threading.get_native_id())

    with profiling.recording() as rec:
        with span('step', 'step'):
            with span('train.backward', 'phase'):
                t = threading.Thread(target=worker)
                t.start()
                t.join(timeout=30)
                assert not t.is_alive()
        worker()   # a thread with nothing open, no unit open: a new unit
    by = {}
    for r in rec.records:
        by.setdefault(r.name, []).append(r)
    step, back = by['step'][0], by['train.backward'][0]
    inner, alone = by['recompute']
    assert inner.parent == back.id and inner.unit == step.id
    assert inner.thread == seen[0] != step.thread == alone.thread
    assert by['conv'][0].parent == inner.id
    assert alone.parent == 0 and alone.unit == alone.id
    assert by['conv'][1].unit == alone.id and rec.units == 2


def test_threads_that_record_at_once_lose_no_span():
    """Eight threads, switching as often as the interpreter allows,
    under one unit: every span is counted and kept, and each thread's
    spans nest under the unit's root or their own."""
    import sys
    threads, each = 8, 200
    span = profiling.span

    def worker():
        for _ in range(each):
            with span('outer', 'block'):
                with span('inner', 'solve'):
                    pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.recording() as rec:
            with span('step', 'step'):
                pool = [threading.Thread(target=worker)
                        for _ in range(threads)]
                for t in pool:
                    t.start()
                for t in pool:
                    t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in pool)
    n = threads * each
    assert rec.counts == {('step', 'step'): 1, ('block', 'outer'): n,
                          ('solve', 'inner'): n}
    assert len(rec.records) == 2 * n + 1 and rec.units == 1
    root = next(r for r in rec.records if r.name == 'step')
    by = {r.id: r for r in rec.records}
    for r in rec.records:
        if r.name == 'outer':
            assert r.parent == root.id and r.unit == root.id
        elif r.name == 'inner':
            assert by[r.parent].name == 'outer'
            assert by[r.parent].thread == r.thread
    assert len({r.id for r in rec.records}) == 2 * n + 1


def test_nothing_records_outside_a_recording():
    with profiling.recording() as rec:
        with profiling.span('kept', 'k'):
            pass
    off = profiling.span('dropped', 'k')
    assert off is profiling.span('other', 'j') is profiling._OFF
    with off:
        with profiling.span('nested', 'k'):
            pass
    assert [r.name for r in rec.records] == ['kept']
    assert rec.counts == {('k', 'kept'): 1} and rec.units == 1
    with profiling.recording() as fresh:
        pass
    assert fresh is not rec and fresh.records == [] and fresh.counts == {}


def test_the_buffer_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling, 'SPAN_LIMIT', 2)
    with profiling.recording() as rec:
        for _ in range(5):
            with profiling.span('s', 'k'):
                pass
    assert len(rec.records) == 2 and rec.dropped == 3
    assert rec.counts == {('k', 's'): 5} and rec.units == 5


def test_a_span_brackets_the_profilers_event_of_its_op():
    """The profiler places its events on time.time_ns()'s clock: its raw
    events and trace_start_ns plus an event's offset alike."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.recording() as rec:
            with profiling.span('mm', 'op'):
                torch.mm(x, x)
    s = rec.records[0]
    raw = [e for e in prof.profiler.kineto_results.events()
           if e.name() == 'aten::mm']
    assert len(raw) == 1
    start, end = raw[0].start_ns(), raw[0].start_ns() + raw[0].duration_ns()
    assert s.start_ns <= start < end <= s.end_ns
    base = prof.profiler.kineto_results.trace_start_ns()
    ev = next(e for e in prof.events() if e.name == 'aten::mm')
    offset = base + int(ev.time_range.start * 1e3)
    assert s.start_ns <= offset <= s.end_ns


def test_trace_writes_the_spans_into_its_chrome_trace(tmp_path):
    import json
    with trace(tmp_path / 'prof'):
        with profiling.span('work', 'probe'):
            torch.mm(torch.randn(64, 64), torch.randn(64, 64))
    doc = json.loads((tmp_path / 'prof' / 'trace.json').read_text())
    mine = [e for e in doc['traceEvents'] if e.get('cat') == 'span']
    assert [(e['name'], e['args']['kind']) for e in mine] == [
        ('work', 'probe')]
    mm = next(e for e in doc['traceEvents'] if e.get('name') == 'aten::mm')
    assert mine[0]['tid'] == threading.get_native_id() == mm['tid']
    assert mine[0]['ts'] <= mm['ts'] and (
        mm['ts'] + mm['dur'] <= mine[0]['ts'] + mine[0]['dur'] + 1)


# A small XNOR ResNet with the flagship's train recipe (ls-2 activations
# by lloyd, bf16 chain, remat) and an fp KD teacher, at a CPU test's size.
_L0 = {'n_in_channels': 8, 'kernel_size': 7, 'stride': 2, 'padding': 3,
       'bias': False, 'maxpool': {'type': 'maxpool2d', 'kernel_size': 3,
                                  'stride': 2, 'padding': 1}}
_Q = {'x_quant': 'ls-2', 'w_quant': 'ls-1', 'double_shortcut': True,
      'clamp': {'kind': 'symmetric', 'alpha': 2.0}}
_FP = {'x_quant': 'fp', 'w_quant': 'fp', 'clamp': {'kind': 'identity'}}
_ARCH = dict(block='xnor', layer0=_L0, layer1=_Q, layer2=_Q, layer3=_Q,
             layer4=_Q, nonlins=['prelu', 'prelu'], num_blocks=[1, 1, 1, 1],
             output_classes=10)
_BLOCKS = ['layer1_block0', 'layer2_block0', 'layer3_block0',
           'layer4_block0']


def _kinds(counts) -> dict:
    out: dict = {}
    for (kind, _), n in counts.items():
        out[kind] = out.get(kind, 0) + n
    return out


def test_a_forward_opens_its_spans_and_gives_the_same_logits():
    from quant_tpu_torch.nn.resnet import QResNet
    gen = torch.Generator().manual_seed(3)
    model = QResNet(**_ARCH, moving_average_mode='eval_only',
                    device='cpu', generator=gen)
    x = torch.randn(2, 32, 32, 3, generator=gen)
    plain = model(x)
    with profiling.recording() as rec:
        recorded = model(x)
    assert torch.equal(plain, recorded)
    assert _kinds(rec.counts) == {'model': 1, 'stem': 1, 'block': 4,
                                  'head': 1, 'qconv': 8, 'shortcut': 3}
    chains = [_chain(rec.records, r) for r in rec.records]
    assert 'forward/layer2_block0/layer2_block0.conv1' in chains
    assert 'forward/layer3_block0/layer3_block0.shortcut' in chains
    roots = [r for r in rec.records if r.parent == 0]
    assert [r.name for r in roots] == ['forward'] and rec.units == 1
    order = [r.name for r in sorted(rec.records, key=lambda r: r.start_ns)
             if r.kind in ('stem', 'block', 'head')]
    assert order == ['stem', *_BLOCKS, 'head']


def _kd_step(gen_seed: int):
    import functools

    from quant_tpu_torch import train as T
    from quant_tpu_torch.nn.resnet import QResNet
    from quant_tpu_torch.train.kd import kd_criterion, make_teacher_apply
    gen = torch.Generator().manual_seed(gen_seed)
    student = QResNet(**_ARCH, inference_mode='dense', solver_mode='lloyd',
                      train_dtype='bfloat16', remat=True, device='cpu',
                      generator=gen)
    teacher = QResNet(**{**_ARCH, 'block': 'regular', 'layer1': _FP,
                         'layer2': _FP, 'layer3': _FP, 'layer4': _FP,
                         'nonlins': ['relu', 'relu']},
                      inference_mode='dense', device='cpu', generator=gen)
    spec, _ = T.make_optimizer(
        {'optimizer': {'algorithm': 'adam', 'lr': 2e-4, 'weight_decay': 0},
         'lr_scheduler': {'scheduler': 'linear_lr', 'min_lr': 2e-7}}, 2, 10)
    state = T.TrainState.create(student, spec)
    marks: list = []
    step = T.make_train_step(
        functools.partial(kd_criterion, temperature=1.0),
        make_teacher_apply(teacher, train_mode=True), phase_hook=marks.append)
    x = torch.randn(4, 32, 32, 3, generator=gen)
    y = torch.randint(0, 10, (4,), generator=gen)
    return state, step, marks, x, y


def test_a_kd_step_opens_its_phases_at_the_hooks_marks():
    from quant_tpu_torch.train.metrics import init_metric_state
    runs = []
    for record in (False, True):
        state, step, marks, x, y = _kd_step(5)
        with (profiling.recording() if record
              else contextlib.nullcontext()) as rec:
            _, _, loss = step(state, x, y, init_metric_state())
        runs.append((loss, [p.detach().clone()
                            for p in state.model.parameters()], marks, rec))
    (loss0, params0, marks0, _), (loss1, params1, marks1, rec) = runs
    assert torch.equal(loss0, loss1)
    assert all(torch.equal(a, b) for a, b in zip(params0, params1))
    assert marks0 == marks1 == ['forward', 'teacher', 'backward',
                                'optimizer', 'end']
    phases = sorted((r for r in rec.records if r.kind == 'phase'),
                    key=lambda r: r.start_ns)
    assert [p.name for p in phases] == [
        'train.forward', 'train.teacher', 'train.backward',
        'train.optimizer']
    assert all(a.end_ns <= b.start_ns for a, b in zip(phases, phases[1:]))
    # student 8 + teacher 8 quantized convs, and 8 recomputed; each of
    # the student's solves its weights and its activations, twice.
    assert _kinds(rec.counts) == {
        'step': 1, 'phase': 4, 'model': 2, 'stem': 2, 'head': 2,
        'block': 12, 'qconv': 24, 'shortcut': 9, 'solve': 32}
    assert rec.units == 1
    chains = {_chain(rec.records, r) for r in rec.records}
    assert {f'train.step/train.backward/{b}' for b in _BLOCKS} <= chains
    assert ('train.step/train.backward/layer4_block0/'
            'layer4_block0.conv2/solve.x') in chains
    assert ('train.step/train.teacher/forward/layer1_block0/'
            'layer1_block0.conv1') in chains
    assert not any(c.startswith('train.step/train.teacher') and 'solve' in c
                   for c in chains)
