"""Tests of the benchmark. Run them from the repo's root:

    python -m pytest portbench/tests -q

Tests marked `card` run on a CUDA card and skip elsewhere; the decision is
made inside the `card` fixture, never while a module is imported.
"""

import copy
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line('markers',
                            'card: needs a CUDA card (skips without one)')


@pytest.fixture
def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


BOTTLENECK = 'bottleneck_r50'


def bench_config(name: str) -> dict:
    """A configuration of BENCHMARK.json by name, or BOTTLENECK: the
    ImageNet ResNet-50 as a test's own configuration, r18_xnor_ls2_ls1's
    keys with XNOR bottleneck blocks [3, 4, 6, 3] (no double shortcut,
    which a bottleneck does not define) and a regular bottleneck
    teacher."""
    from portbench import run as bench_run
    bench = bench_run.spec()
    if name != BOTTLENECK:
        return bench_run.config(bench, name)
    c = copy.deepcopy(bench_run.config(bench, 'r18_xnor_ls2_ls1'))
    c['name'], c['block'], c['num_blocks'] = name, 'xnor_bottleneck', [
        3, 4, 6, 3]
    del c['double_shortcut']
    c['train']['teacher']['block'] = 'regular_bottleneck'
    return c


def small(config: dict, width: int = 8, size: int = 32,
          classes: int = 10) -> dict:
    """A configuration cut to a CPU test's size: one block a stage."""
    c = copy.deepcopy(config)
    c['image_size'], c['output_classes'] = size, classes
    c['layer0']['n_in_channels'] = width
    c['num_blocks'] = [1, 1, 1, 1]
    return c


def float32_chain(config: dict) -> dict:
    """The configuration with its serving and train chains in float32."""
    c = copy.deepcopy(config)
    c['serve']['eval_dtype'] = 'float32'
    c['train']['train_dtype'] = 'float32'
    c['train']['teacher']['dtype'] = 'float32'
    return c


def run_small_cell(cell: str, seed: int = 2 ** 31 + 5, trace: bool = False,
                   seconds: float = 0.2, config_edit=None):
    """One run of `cell` through its driver on the CPU at a test's size
    (the cell's limits, the check after the window); (line, outcome):
    the result line as run.py prints it, without the card check."""
    import time

    from portbench import harness, run as bench_run
    bench = bench_run.spec()
    w = bench_run.cell(bench, cell)
    cfg = small(bench_run.config(bench, w['config']))
    if config_edit is not None:
        cfg = config_edit(cfg)
    tr = dict(bench_run.traffic(w['traffic']), batch=4, pool_batches=4)
    r = harness.Run(config=cfg, traffic=tr, seed=seed,
                    seconds=seconds, trace=trace, device=torch.device('cpu'),
                    t0=time.perf_counter(), limits=bench_run.limits(cell))
    outcome = bench_run.driver(tr['driver']).run(r)
    line = bench_run.result(bench, w, outcome, trace,
                            {'platform': 'cpu', 'kind': 'cpu', 'count': 1,
                             'memory_peak_bytes': 0}, cfg, tr)
    return line, outcome
