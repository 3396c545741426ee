"""The benchmark's ImageNet XNOR ResNet-50 (ls-2 activations x ls-1
weights, bottleneck blocks), read from its committed configuration
`portbench/configs/r50_xnor_ls2_ls1.json`, on the CPU.

Its depth stays [3, 4, 6, 3]; width (8 stem planes) and image (32 px, 10
classes) are cut to a test's size. The program's kernels run their plain
twins here. Checked: the configuration is the cell's and
r18_xnor_ls2_ls1's recipe on bottleneck blocks; the served logits with
the chain in float32 equal the plain reference's to the order of sums
(1e-5 of their spread); one served forward enters the spans of 16
bottleneck blocks, 48 binary convs and 4 projection shortcuts; the work
counts of the full-size configuration walk 48 binary convs, 32 of them
1x1; and the cell runs through its serving driver with `correct` true.
A basic-block file (`block: xnor`) would give ResNet-34's 32 binary
convs, none of them 1x1, and fail every count.
"""

import copy
import json
import time
from collections import Counter
from pathlib import Path

import pytest
import torch

from portbench import counts, harness, judge, port, state
from portbench import run as bench_run
from portbench.reference import resnet as reference
from quant_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parent.parent
CONFIG_FILE = 'portbench/configs/r50_xnor_ls2_ls1.json'
CELL = 'r50_xnor_ls2_ls1.serve_b256'
SIBLING = 'r18_xnor_ls2_ls1'
CPU = torch.device('cpu')
SEED = 2 ** 31 + 23


@pytest.fixture(scope='module')
def config() -> dict:
    return json.loads((ROOT / CONFIG_FILE).read_text())


def small(config: dict, chain: str = 'bfloat16') -> dict:
    """The configuration at a test's width and image size, its depth and
    block kept, served in `chain`."""
    c = copy.deepcopy(config)
    c['image_size'], c['output_classes'] = 32, 10
    c['layer0']['n_in_channels'] = 8
    c['serve']['eval_dtype'] = chain
    return c


def test_configuration_is_the_cells_and_the_siblings_recipe(config):
    """BENCHMARK.json runs this file in the cell, one chip, serve_b256
    traffic; the file is r18_xnor_ls2_ls1's model and recipe with the
    bottleneck's block, depth and teacher, and no double shortcut."""
    bench = bench_run.spec()
    entry = next(c for c in bench['configs'] if c['name'] == config['name'])
    assert entry['file'] == CONFIG_FILE
    assert entry['reduced'] == config['reduced'] == ['train']
    w = bench_run.cell(bench, CELL)
    assert (w['config'], w['traffic'], w['chips']) == (
        config['name'], 'serve_b256', 1)
    sibling = bench_run.config(bench, SIBLING)
    assert sibling['double_shortcut'] and 'double_shortcut' not in config
    changed = {'name', 'source', 'paper', 'block', 'num_blocks',
               'double_shortcut', 'train', 'cut', 'departures', 'assumed'}
    for key in set(sibling) | set(config):
        if key not in changed:
            assert config[key] == sibling[key], key
    assert (config['block'], config['num_blocks']) == (
        'xnor_bottleneck', [3, 4, 6, 3])
    teacher = dict(sibling['train']['teacher'], block='regular_bottleneck')
    assert config['train'] == dict(sibling['train'], teacher=teacher)


def test_served_logits_match_reference(config):
    cfg = small(config, chain='float32')
    gen = state.generator(SEED, CPU)
    weights = state.serve_state(cfg, gen, CPU)
    x = state.images(gen, CPU, 1, 4, cfg['image_size'], 3)[0]
    model = port.serving_model(cfg, weights, CPU)
    assert model.bn_fold   # the program folded its thresholds
    got = port.serve_forward(model)(x)
    want = reference.serve_logits(cfg, weights, x)
    assert float(judge.logit_errors(got, want).max()) < 1e-5


@pytest.fixture(scope='module')
def span_counts(config) -> Counter:
    """Spans entered in one served forward, by kind."""
    cfg = small(config)
    gen = state.generator(SEED + 1, CPU)
    weights = state.serve_state(cfg, gen, CPU)
    x = state.images(gen, CPU, 1, 2, cfg['image_size'], 3)[0]
    forward = port.serve_forward(port.serving_model(cfg, weights, CPU))
    with profiling.recording() as rec:
        forward(x)
    kinds: Counter = Counter()
    for (kind, _), n in rec.counts.items():
        kinds[kind] += n
    return kinds


@pytest.mark.parametrize('kind,n', [('model', 1), ('stem', 1), ('head', 1),
                                    ('block', 16), ('qconv', 48),
                                    ('shortcut', 4), ('solve', 0)])
def test_a_served_forward_enters_its_spans(span_counts, kind, n):
    assert span_counts[kind] == n


@pytest.mark.parametrize('what,n', [
    ('binary', 48), ('binary_1x1', 32), ('binary_3x3', 16),
    ('binary_strided_3x3', 3), ('shortcut', 4), ('stem', 1), ('fc', 1)])
def test_layers_of_the_full_size_configuration(config, what, n):
    layers = counts.layers(config)
    binary = [la for la in layers if la.kind == 'binary']
    got = {'binary': len(binary),
           'binary_1x1': sum(la.k == 1 for la in binary),
           'binary_3x3': sum(la.k == 3 for la in binary),
           'binary_strided_3x3': sum(la.k == 3 and la.stride == 2
                                     for la in binary),
           'shortcut': sum(la.kind == 'shortcut' for la in layers),
           'stem': sum(la.kind == 'stem' for la in layers),
           'fc': sum(la.kind == 'fc' for la in layers)}
    assert got[what] == n


def test_full_size_widths(config):
    """Published widths: 64-512 planes, 4x out of each bottleneck, the fc
    over 2,048 features; the 1x1 convs' GEMM depths run 2-64 words."""
    layers = counts.layers(config)
    binary = [la for la in layers if la.kind == 'binary']
    assert sorted({la.c_out for la in binary}) == [64, 128, 256, 512, 1024,
                                                   2048]
    assert layers[-1].c_in == 2048 and layers[-1].c_out == 1000
    words = {-(-la.c_in // 32) for la in binary if la.k == 1}
    assert min(words) == 2 and max(words) == 64
    assert binary[-1].h_out == 7


def test_cell_runs_through_its_driver(config):
    """The serving driver at a test's size on the CPU: the cell's limits,
    its traffic's other parameters, the check after the window; the
    result line carries the end-to-end metrics that apply to the cell."""
    bench = bench_run.spec()
    w = bench_run.cell(bench, CELL)
    cfg = small(config)
    tr = dict(bench_run.traffic(w['traffic']), batch=4, pool_batches=2)
    r = harness.Run(config=cfg, traffic=tr, seed=SEED + 2, seconds=0.2,
                    trace=False, device=CPU, t0=time.perf_counter(),
                    limits=bench_run.limits(CELL))
    outcome = bench_run.driver(tr['driver']).run(r)
    line = bench_run.result(bench, w, outcome, False,
                            {'platform': 'cpu', 'kind': 'cpu', 'count': 1,
                             'memory_peak_bytes': 0}, cfg, tr)
    # A loaded host may fit one forward into the window: its batch alone
    # is then checked.
    assert line['correct'] and line['failed'] == 0
    assert outcome.units > 0 and line['attempted'] >= 4
    assert set(line['metrics']) == {'serve_img_per_s', 'setup_s'}
    assert all(v['value'] > 0 for v in line['metrics'].values())
    assert line['check']['logit_err']['value'] < (
        line['check']['logit_err']['limit'])
