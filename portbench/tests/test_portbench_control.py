"""The control of the comparison comes out as not correct: the reference,
put in the program's place and computed one precision below the
configuration's (control.py: float8 below a bf16 chain, TF32 below a
float32 one), fails a limit of the cell that the program's own reading
keeps, judged by harness.Check as a run judges it; in a training cell
the half-batch fault fails one too. On the CPU at a test's size; with
the `card` marker, on the card at the cell's own size over three seeds
(the readings the limits were set from are in PERF.md)."""

import pytest
import torch

from conftest import small
from portbench import control, run as bench_run

BENCH = bench_run.spec()
CELLS = [w['name'] for w in BENCH['workloads']]


def _seed(cell: str, seed: int, device: torch.device, config_edit=None
          ) -> tuple[dict, dict]:
    w = bench_run.cell(BENCH, cell)
    cfg = bench_run.config(BENCH, w['config'])
    traffic = bench_run.traffic(w['traffic'])
    if config_edit is not None:
        cfg = config_edit(cfg)
        traffic = dict(traffic, batch=4, pool_batches=4)
    fn = (control.serve_seed if traffic['driver'] == 'serve_closed_loop'
          else control.train_seed)
    limits = bench_run.limits(cell)
    return fn(cfg, traffic, seed, device, limits), limits


def _check(out: dict, seed: int) -> None:
    assert out['correct']['program'], (seed, out['program'])
    assert not out['correct']['control'], (seed, out['control'])
    if 'half_batch' in out['correct']:
        assert not out['correct']['half_batch'], (seed, out['half_batch'])


@pytest.mark.parametrize('cell', CELLS)
def test_control_fails_where_the_program_passes_cpu(cell):
    seed = 2 ** 31 + 17
    out, limits = _seed(cell, seed, torch.device('cpu'),
                        lambda c: small(c, width=16, size=64))
    _check(out, seed)


@pytest.mark.card
@pytest.mark.parametrize('cell', CELLS)
def test_control_fails_where_the_program_passes_on_the_card(cell, card):
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        out, _ = _seed(cell, seed, card)
        _check(out, seed)
