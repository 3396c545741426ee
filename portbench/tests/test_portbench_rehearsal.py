"""A rehearsal of the benchmark on the CPU: each cell through its traffic
driver and the harness's own functions at a test's size, each per-layer
metric's reader on a trace made up here, and run.py's refusal to run
without a card."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import run_small_cell
from portbench import counts, devtrace, run as bench_run
from portbench.harness import Outcome

ROOT = Path(__file__).resolve().parents[2]
BENCH = bench_run.spec()
CELLS = [w['name'] for w in BENCH['workloads']]


@pytest.mark.parametrize('cell', CELLS)
@pytest.mark.parametrize('trace', [False, True])
def test_cell_runs_through_its_driver(cell, trace):
    line, outcome = run_small_cell(cell, trace=trace)
    assert list(line) == (['correct', 'attempted', 'failed', 'metrics',
                           'device'] + (['breakdown'] if trace else [])
                          + ['check'])
    assert outcome.units > 0 and line['attempted'] > 0
    assert all(set(v) == {'value', 'limit'} for v in line['check'].values())
    json.dumps(line)
    w = bench_run.cell(BENCH, cell)
    if trace:
        # No device operation shows on the CPU: the device's readers
        # read nothing, and the breakdown names the host's gaps.
        assert line['device']['busy_s'] == 0
        assert line['breakdown']['device_ops'] == []
        assert {m for m in line['metrics']} <= {
            m['name'] for m in BENCH['per_layer']
            if bench_run.applies(m, cell)}
    else:
        want = {m['name'] for m in BENCH['end_to_end']
                if bench_run.applies(m, cell)}
        assert set(line['metrics']) == want
        assert all(v['value'] > 0 for v in line['metrics'].values())
    assert w['chips'] == 1


def _trace(kernels, window_s=1.0):
    ks = [devtrace.Kernel(n, a, b) for n, a, b in kernels]
    busy = sum(b - a for a, b in devtrace._union(ks))
    return devtrace.Trace(ks, window_s, busy, {})


def _ctx(kind: str, config: str, kernels, units=10, batch=128):
    o = Outcome(kind=kind, e2e={}, attempted=1, failed=0, checks=[],
                units=units, batch=batch, memory_peak_bytes=0, launches={},
                trace=_trace(kernels))
    cfg = bench_run.config(BENCH, config)
    return bench_run.Context(cfg, {}, o)


KERNELS = [('xnor_conv2d_kernel', 0.00, 0.10),
           ('pack_sign_planes_wide_kernel', 0.10, 0.15),
           ('cutlass_tensorop_bf16_fprop', 0.20, 0.30),
           ('vectorized_elementwise_kernel', 0.30, 0.40),
           ('reduce_kernel', 0.35, 0.45),
           ('max_pool_3x3_s2_p1_kernel', 0.50, 0.52)]


def test_serve_readers_read_the_trace():
    ctx = _ctx('serve', 'r18_xnor_ls1', KERNELS)
    read = lambda m: bench_run.reader(m).read(ctx)
    cfg = ctx.config
    assert read('mfu.serve') == pytest.approx(
        100 * 10 * 128 * counts.serve_peak_s(cfg) / 1.0)
    assert read('roofline.binary_conv') == pytest.approx(
        100 * 10 * counts.binary_conv_bound_s(cfg, 128) / 0.15)
    assert read('op_ms.conv.serve') == pytest.approx(1e3 * 0.10 / 10)
    assert read('op_ms.pointwise.serve') == pytest.approx(1e3 * 0.20 / 10)
    # busy: [0, 0.15] + [0.2, 0.45] + [0.5, 0.52] = 0.42 of 1 s
    assert read('idle_share.serve') == pytest.approx(58.0)
    for m in ('mfu.train.f32', 'op_ms.conv.train.f32',
              'op_ms.pointwise.train.bf16', 'idle_share.train.bf16'):
        assert read(m) is None


def test_readers_read_nothing_from_an_empty_trace():
    for kind, config in (('serve', 'r18_xnor_ls2_ls1'),
                         ('train', 'r18_xnor_ls1')):
        ctx = _ctx(kind, config, [])
        for m in ('roofline.binary_conv', 'op_ms.conv.serve',
                  'op_ms.pointwise.serve', 'idle_share.serve',
                  'op_ms.conv.train.f32', 'op_ms.pointwise.train.f32',
                  'idle_share.train.f32', 'op_ms.conv.train.bf16',
                  'op_ms.pointwise.train.bf16', 'idle_share.train.bf16'):
            assert bench_run.reader(m).read(ctx) is None


def test_train_readers_read_the_trace():
    ctx = _ctx('train', 'r18_xnor_ls1', KERNELS, units=4, batch=256)
    read = lambda m: bench_run.reader(m).read(ctx)
    assert read('mfu.train.f32') == pytest.approx(
        100 * 4 * 256 * counts.train_peak_s(ctx.config))
    assert read('op_ms.pointwise.train.f32') == pytest.approx(1e3 * 0.2 / 4)
    bf16 = _ctx('train', 'r18_xnor_ls2_ls1', KERNELS, units=4, batch=256)
    assert bench_run.reader('mfu.train.bf16').read(bf16) == pytest.approx(
        100 * 4 * 256 * counts.train_peak_s(bf16.config))
    assert bench_run.reader('idle_share.train.bf16').read(bf16) == (
        pytest.approx(58.0))
    assert read('mfu.serve') is None and read('roofline.binary_conv') is None


def test_idle_gaps_are_named_by_the_host_call():
    gaps = devtrace._label_gaps([(1.0, 2.0), (5.0, 5.5)],
                                [('cudaLaunchKernel', 1.2, 1.8),
                                 ('cudaStreamSynchronize', 0.5, 3.0)])
    assert gaps == [('cudaLaunchKernel', 1.0),
                    (devtrace.IDLE_HOST, 0.5)]


def _run_py(cwd: Path) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, 'portbench/run.py', '--workload', CELLS[0],
         '--seed', str(2 ** 31 + 3), '--seconds', '1', '--trace', '0'],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_run_refuses_without_a_card():
    out = _run_py(ROOT)
    assert out.returncode == 2 and out.stdout.strip() == ''
    assert 'no CUDA device' in out.stderr


def test_run_fails_with_the_benchmark_alone(tmp_path):
    """A directory with BENCHMARK.json and portbench/ alone prints no
    result and exits with another code than 0."""
    shutil.copy(ROOT / 'BENCHMARK.json', tmp_path)
    shutil.copytree(ROOT / 'portbench', tmp_path / 'portbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    out = _run_py(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ''
