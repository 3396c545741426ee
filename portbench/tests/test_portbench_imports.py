"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program. Each case runs in a fresh
interpreter and compares the top-level name of every loaded module (the
part before the first dot) whole: `quant_tpu_torch` is the program,
`quant_tpu` the JAX package."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import run as bench_run

ROOT = Path(__file__).resolve().parents[2]
JAX = {'jax', 'jaxlib', 'flax', 'quant_tpu'}
CELLS = [w['name'] for w in bench_run.spec()['workloads']]


def _loaded(code: str) -> set[str]:
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={'PATH': '/usr/bin:/bin', 'JAX_PLATFORMS': 'cpu',
                              'HOME': str(ROOT / 'build'),
                              'OMP_NUM_THREADS': '2'})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


_TOP = ("import json, sys; print(json.dumps(sorted({m.split('.')[0] "
        "for m in sys.modules})))")


@pytest.mark.parametrize('cell', CELLS)
def test_a_run_loads_no_jax(cell):
    """A whole run of the cell at a test's size on the CPU, traced, with
    every per-layer metric's reader loaded."""
    code = ('import sys; sys.path[:0] = ["portbench/tests", "."]\n'
            'import torch; torch.set_num_threads(2)\n'
            'from conftest import run_small_cell\n'
            f'run_small_cell({cell!r}, trace=True, seconds=0.1)\n' + _TOP)
    loaded = _loaded(code)
    assert 'quant_tpu_torch' in loaded
    assert not loaded & JAX


def test_reference_loads_neither_program_nor_jax():
    code = ('import sys; sys.path.insert(0, ".")\n'
            'import torch, json\n'
            'from portbench.reference import resnet as ref\n'
            'from portbench.tests.conftest import small\n'
            'cfg = small(json.load(open("portbench/configs/'
            'r18_xnor_ls2_ls1.json")))\n'
            'cfg["train"]["train_dtype"] = "float32"\n'
            'x = torch.randn(2, 32, 32, 3)\n'
            'from portbench import state\n'
            'g = torch.Generator().manual_seed(1)\n'
            's = state.serve_state(cfg, g, torch.device("cpu"))\n'
            'ref.serve_logits(cfg, s, x)\n'
            'st, te = state.train_states(cfg, g, torch.device("cpu"))\n'
            'ref.train_steps(cfg, st, te, [x])\n' + _TOP)
    loaded = _loaded(code)
    assert not loaded & (JAX | {'quant_tpu_torch'})


def test_reference_sources_import_no_program():
    """No source of the reference names the program or JAX in an import."""
    import ast
    for path in (ROOT / 'portbench' / 'reference').glob('*.py'):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split('.')[0] not in JAX | {'quant_tpu_torch'}, (
                    path, n)
