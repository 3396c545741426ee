"""The plain reference against the program, at a small width and size on
the CPU, for both configurations and for a bottleneck ResNet-50 of the
ls-2 x ls-1 recipe: the served logits and the first KD steps, both
chains in float32 (the program's kernels run their plain twins here).
Float32 against float32 differs by the order of sums alone: logits
within 1e-5 of their spread, losses within 1e-5, the first gradients
within 1e-4 of the largest."""

import pytest
import torch

from conftest import BOTTLENECK, bench_config, float32_chain, small
from portbench import judge, port, state
from portbench.drivers import train_kd
from portbench.reference import resnet as reference

CONFIGS = ('r18_xnor_ls1', 'r18_xnor_ls2_ls1', BOTTLENECK)
CPU = torch.device('cpu')


def _config(name: str) -> dict:
    return float32_chain(small(bench_config(name)))


@pytest.mark.parametrize('name', CONFIGS)
def test_served_logits_match_reference(name):
    cfg = _config(name)
    gen = state.generator(2 ** 31 + 11, CPU)
    weights = state.serve_state(cfg, gen, CPU)
    x = state.images(gen, CPU, 1, 4, cfg['image_size'], 3)[0]
    model = port.serving_model(cfg, weights, CPU)
    assert model.bn_fold   # the program folded its thresholds
    got = port.serve_forward(model)(x)
    want = reference.serve_logits(cfg, weights, x)
    assert float(judge.logit_errors(got, want).max()) < 1e-5


@pytest.mark.parametrize('name', CONFIGS)
def test_train_steps_match_reference(name):
    cfg = _config(name)
    gen = state.generator(7, CPU)
    student, teacher = state.train_states(cfg, gen, CPU)
    xs = state.images(gen, CPU, 2, 4, cfg['image_size'], 3)
    ys = state.labels(gen, CPU, 2, 4, cfg['output_classes'])
    train_state, step, seen = port.train_step(cfg, student, teacher, CPU)
    metric = port.init_metric_state()
    losses = [float(step(xs[0], ys[0], metric))]
    logits = [seen['student'], seen['teacher']]
    grads = {n: m / 0.1 for n, m in train_kd.moments(train_state)[0].items()}
    losses.append(float(step(xs[1], ys[1], metric)))
    ref = reference.train_steps(cfg, student, teacher, [xs[0], xs[1]])
    for got, want in zip(losses, ref['losses']):
        assert abs(got - want) <= 1e-5 * abs(want)
    for got, want in zip(logits, (ref['logits'][0], ref['t_logits'][0])):
        assert float(judge.logit_errors(got, want).max()) < 1e-5
    top = max(float(g.abs().max()) for g in ref['grads'].values())
    assert set(grads) == set(ref['grads'])
    for n, g in grads.items():
        assert float((g - ref['grads'][n]).abs().max()) <= 1e-4 * top, n


@pytest.mark.parametrize('name', CONFIGS)
def test_reference_follows_a_snapshot(name):
    """The reference started from the program's state, Adam's moments
    and step count part-way through training takes the program's next
    step: the loss, the logits and each parameter after it."""
    cfg = _config(name)
    gen = state.generator(8, CPU)
    student, teacher = state.train_states(cfg, gen, CPU)
    xs = state.images(gen, CPU, 3, 4, cfg['image_size'], 3)
    ys = state.labels(gen, CPU, 3, 4, cfg['output_classes'])
    train_state, step, seen = port.train_step(cfg, student, teacher, CPU)
    metric = port.init_metric_state()
    for i in range(2):
        step(xs[i], ys[i], metric)
    start = train_kd.snapshot(train_state)
    assert start['step'] == 2
    loss = float(step(xs[2], ys[2], metric))
    ref = reference.train_steps(cfg, start['state'], teacher, [xs[2]],
                                adam=start['adam'],
                                first_step=start['step'])
    assert abs(loss - ref['losses'][0]) <= 1e-5 * abs(ref['losses'][0])
    assert float(judge.logit_errors(seen['student'],
                                    ref['logits'][0]).max()) < 1e-5
    # Adam moves an element whose gradient is nought to rounding by up
    # to lr either way, so the leaves are held by their median.
    errs = torch.tensor([
        float((p.detach() - ref['params'][n]).norm()
              / (ref['params'][n] - start['state'][n]).norm())
        for n, p in train_state.model.named_parameters()])
    assert float(errs.median()) < 1e-3, errs


def test_reference_lloyd_solves_two_means():
    """lloyd_v1 on rows of two clusters lands between them, at the
    midpoint of the clusters' means."""
    a = torch.cat([torch.full((1, 30), 0.2), torch.full((1, 10), 1.0)], 1)
    v1 = reference.lloyd_v1(a)
    assert torch.allclose(v1, torch.tensor([0.6]))
