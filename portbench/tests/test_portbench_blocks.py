"""The harness's walks of a configuration's `block`: the seeded state
(`state.leaves`), the work counts (`counts.layers` and the peaks) and the
plain reference (`reference.resnet.Net`).

The two ResNet-18 configurations are held to frozen copies
(`frozen_r18.json`) of what the harness gave for them before it learnt
the bottleneck block: every leaf's name, shape, kind and fan-in (the
student with and without EMA scales, the teacher), every layer's fields,
the serving and training peaks, the binary convs' bound at batch 256,
and a SHA-256 of the serve state drawn on the CPU from the file's seed.
`draw` takes one generator call a kind in spec order, so equal specs
draw equal bits, and the cells' runs see the very same work and state.

The bottleneck ResNet-50's states load strictly into the program's
QResNet, student and teacher, at the published widths; and every module
refuses a block it does not walk rather than walk it as a basic one.
"""

import copy
import dataclasses
import hashlib
import json
from pathlib import Path

import pytest
import torch

from conftest import BOTTLENECK, bench_config
from portbench import counts, port, state
from portbench.reference import resnet as reference
from quant_tpu_torch.nn.resnet import QResNet

FROZEN = json.loads(Path(__file__).with_name('frozen_r18.json').read_text())
R18 = sorted(FROZEN['configs'])
CPU = torch.device('cpu')


def _plain(leaves: list) -> list:
    return [[list(v) if isinstance(v, tuple) else v for v in leaf]
            for leaf in leaves]


def _teacher(cfg: dict) -> dict:
    return {**cfg, **cfg['train']['teacher']}


def digest(sd: dict[str, torch.Tensor]) -> str:
    """SHA-256 over each leaf's name, dtype, shape and bytes, in order."""
    h = hashlib.sha256()
    for name, t in sd.items():
        h.update(name.encode())
        h.update(str(t.dtype).encode())
        h.update(repr(tuple(t.shape)).encode())
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize('name', R18)
@pytest.mark.parametrize('form', ('student', 'student_ema', 'teacher'))
def test_leaves_are_frozen(name, form):
    cfg = bench_config(name)
    got = {'student': lambda: state.leaves(cfg),
           'student_ema': lambda: state.leaves(cfg, ema=True),
           'teacher': lambda: state.leaves(_teacher(cfg), teacher=True)}
    assert _plain(got[form]()) == FROZEN['configs'][name]['leaves'][form]


@pytest.mark.parametrize('name', R18)
def test_layers_and_work_are_frozen(name):
    cfg, want = bench_config(name), FROZEN['configs'][name]
    assert [list(dataclasses.astuple(layer))
            for layer in counts.layers(cfg)] == want['layers']
    assert counts.serve_peak_s(cfg) == want['serve_peak_s']
    assert counts.binary_conv_bound_s(
        cfg, FROZEN['batch']) == want['binary_conv_bound_s']
    assert counts.train_peak_s(cfg) == want['train_peak_s']


@pytest.mark.parametrize('name', R18)
def test_serve_state_digest_is_frozen(name):
    cfg = bench_config(name)
    drawn = state.serve_state(cfg, state.generator(FROZEN['seed'], CPU), CPU)
    assert digest(drawn) == FROZEN['configs'][name]['serve_state_sha256']


@pytest.mark.parametrize('name', ('r18_xnor_ls2_ls1', BOTTLENECK))
def test_states_load_strictly(name):
    """Student (train form, and served with EMA scales) and teacher, at
    the published widths: the names and shapes are QResNet's."""
    cfg = bench_config(name)
    gen = state.generator(3, CPU)
    student, teacher = state.train_states(cfg, gen, CPU)
    served = state.serve_state(cfg, gen, CPU)
    t = cfg['train']['teacher']
    for arch, mode, weights in (
            (port._student(cfg), 'off', student),
            (port._student(cfg), 'eval_only', served),
            (port._arch(cfg, t['block'], t['x_quant'], t['w_quant'],
                        t['clamp'], t['nonlins'], False), 'off', teacher)):
        model = QResNet(**arch, moving_average_mode=mode,
                        inference_mode='dense', device=CPU)
        model.load_state_dict(weights, strict=True)
        want = {n: tuple(v.shape) for n, v in model.state_dict().items()}
        assert {n: tuple(v.shape) for n, v in weights.items()} == want


@pytest.mark.parametrize('block', ('basic', 'xnor_double', 'bottleneck'))
def test_unknown_block_raises_everywhere(block):
    """A block none of the walks knows raises ValueError naming it in
    counts, state and the reference; a teacher's family as a student's
    (and the other way round) raises in state and the reference."""
    cfg = copy.deepcopy(bench_config('r18_xnor_ls1'))
    cfg['block'] = block
    with pytest.raises(ValueError, match=repr(block)):
        counts.layers(cfg)
    for teacher in (False, True):
        with pytest.raises(ValueError, match=repr(block)):
            state.leaves(cfg, teacher=teacher)
        with pytest.raises(ValueError, match=repr(block)):
            reference.Net(cfg, {}, train=False, teacher=teacher)
    for family, teacher in (('regular', False), ('regular_bottleneck', False),
                            ('xnor', True), ('xnor_bottleneck', True)):
        cfg['block'] = family
        with pytest.raises(ValueError, match=repr(family)):
            state.leaves(cfg, teacher=teacher)
        with pytest.raises(ValueError, match=repr(family)):
            reference.Net(cfg, {}, train=False, teacher=teacher)
