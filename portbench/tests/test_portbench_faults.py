"""The comparison catches a broken timed path. Each case drives a run of
a cell on the CPU at a test's size (everything but the look for a card)
with one fault planted in the program underneath, and sees `correct`
come out false, where the same run without the fault comes out true:

- serving: an answer altered where it is produced (one image's logits
  permuted); half of the batch left out (its logits copied from the
  other half);
- training: a step that returns its state unchanged; half of the batch
  left out, the loss's mean taken over the rest.

Every cell runs on one card, so no exchange between cards can be left
out. The chains run in float32 here, where the sound run reads the
reference to rounding; on the card the limits are set from the bf16
chains' readings (PERF.md)."""

import pytest
import torch

from conftest import float32_chain, run_small_cell
from portbench import port, run as bench_run

BENCH = bench_run.spec()
SERVE = [w['name'] for w in BENCH['workloads'] if 'serve' in w['traffic']]
TRAIN = [w['name'] for w in BENCH['workloads'] if 'train' in w['traffic']]


def _run(cell: str) -> bool:
    line, _ = run_small_cell(cell, config_edit=float32_chain)
    return line['correct']


def _serve_fault(monkeypatch, fault: str) -> None:
    sound = port.serve_forward

    def broken(model):
        forward = sound(model)

        def run(x):
            if fault == 'half_batch':
                out = forward(x[:x.shape[0] // 2])
                return torch.cat([out, out])
            out = forward(x).clone()
            out[0] = out[0].roll(1)
            return out
        return run
    monkeypatch.setattr(port, 'serve_forward', broken)


def _train_fault(monkeypatch, fault: str) -> None:
    if fault == 'half_batch':
        sound_kd = port.T.kd_criterion

        def half(student, teacher, target, **kw):
            n = student.shape[0] // 2
            return sound_kd(student[:n], teacher[:n], target[:n], **kw)
        monkeypatch.setattr(port.T, 'kd_criterion', half)
        return
    sound = port.train_step

    def broken(*args, **kwargs):
        state, step, seen = sound(*args, **kwargs)

        def run(data, target, metric):
            before = [p.detach().clone() for p in state.model.parameters()]
            loss = step(data, target, metric)
            with torch.no_grad():
                for p, b in zip(state.model.parameters(), before):
                    p.copy_(b)
            return loss
        return state, run, seen
    monkeypatch.setattr(port, 'train_step', broken)


@pytest.mark.parametrize('cell', SERVE + TRAIN)
def test_sound_run_is_correct(cell):
    assert _run(cell)


@pytest.mark.parametrize('cell', SERVE)
@pytest.mark.parametrize('fault', ['answer_altered', 'half_batch'])
def test_serving_fault_is_caught(cell, fault, monkeypatch):
    _serve_fault(monkeypatch, fault)
    assert not _run(cell)


@pytest.mark.parametrize('cell', TRAIN)
@pytest.mark.parametrize('fault', ['state_unchanged', 'half_batch'])
def test_training_fault_is_caught(cell, fault, monkeypatch):
    _train_fault(monkeypatch, fault)
    assert not _run(cell)
