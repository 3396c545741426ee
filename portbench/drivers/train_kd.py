"""The recipe's KD train step, one stream: steps of `batch` images, each on
the next of `pool_batches` distinct batches (images and labels) drawn on
the device from the seed.

Set-up builds one train state and one step, and drives them through the
first `checked_steps` steps, each on another batch; those steps warm
every shape. The same state and step then run the window. Once it has
closed, the state, Adam's moments and the step count are copied out,
and the same step runs `after_steps` more steps. The reference follows
both stretches (judge.py): the first from the seeded state, the second
from the copy; each step's loss and the student's and teacher's logits,
each stretch's first gradient as Adam holds it, and each parameter's
change over the stretch. Traffic parameters: batch, pool_batches,
checked_steps, after_steps, trace_seconds. End-to-end: train_img_per_s,
batch x the steps completed in the window over its seconds; setup_s,
from the process's start to the window's.
"""

import time
from typing import Callable

import torch

from portbench import harness, judge, port, state
from portbench.reference import resnet as reference


def _named(train_state) -> list[tuple[str, torch.nn.Parameter, float]]:
    """(name, parameter, Adam's beta1) of each trained leaf."""
    opt = train_state.optimizer
    beta1 = {id(p): g['betas'][0] for g in opt.param_groups
             for p in g['params']}
    return [(n, p, beta1[id(p)])
            for n, p in train_state.model.named_parameters()]


def moments(train_state) -> tuple[dict, dict]:
    """Adam's (exp_avg, exp_avg_sq) by name, zeros before the first step."""
    opt = train_state.optimizer
    m, v = {}, {}
    for n, p, _ in _named(train_state):
        s = opt.state.get(p, {})
        m[n] = s['exp_avg'].detach().clone() if s else torch.zeros_like(p)
        v[n] = s['exp_avg_sq'].detach().clone() if s else torch.zeros_like(p)
    return m, v


def snapshot(train_state) -> dict:
    """The train state as it stands, for the reference to start from:
    {'state': every leaf by name, 'adam': (m, v), 'step': steps taken}."""
    return {'state': {n: t.detach().clone() for n, t in
                      train_state.model.state_dict().items()},
            'adam': moments(train_state), 'step': int(train_state.step)}


def program_stretch(train_state, step: Callable, seen: dict,
                    images: torch.Tensor, labels: torch.Tensor,
                    batches: list[int], metric: dict) -> dict:
    """Steps of the program on the pool's `batches`, read as judge.py's
    stretch: losses, logits, the first gradient's and the change's norms
    by name."""
    named = _named(train_state)
    before = {n: p.detach().clone() for n, p, _ in named}
    m_before = moments(train_state)[0]
    out: dict = {'losses': [], 'logits': [], 't_logits': []}
    for i, b in enumerate(batches):
        out['losses'].append(step(images[b], labels[b], metric))
        out['logits'].append(seen['student'])
        out['t_logits'].append(seen['teacher'])
        if i == 0:
            m_after = moments(train_state)[0]
            out['grads'] = judge.norms(
                {n: (m_after[n] - beta1 * m_before[n]) / (1.0 - beta1)
                 for n, _, beta1 in named})
            del m_after
    out['losses'] = torch.stack(out['losses']).tolist()
    out['deltas'] = judge.norms({n: p.detach() - before[n]
                                 for n, p, _ in named})
    return out


def reference_stretch(cfg: dict, start: dict, teacher: dict,
                      images: torch.Tensor, batches: list[int],
                      **kwargs) -> dict:
    """The reference's steps from `start` (a snapshot, or the seeded
    state at step 0), read as judge.py's stretch."""
    ref = reference.train_steps(
        cfg, start['state'], teacher, [images[b] for b in batches],
        adam=start.get('adam'), first_step=start.get('step', 0), **kwargs)
    return {'losses': ref['losses'], 'logits': ref['logits'],
            't_logits': ref['t_logits'], 'grads': judge.norms(ref['grads']),
            'deltas': judge.norms({k: v - start['state'][k]
                                   for k, v in ref['params'].items()})}


def run(r: harness.Run) -> harness.Outcome:
    cfg, tr, dev = r.config, r.traffic, r.device
    batch, pool = int(tr['batch']), int(tr['pool_batches'])
    checked, after = int(tr['checked_steps']), int(tr['after_steps'])
    if checked > pool:
        raise ValueError('each checked step takes a batch of its own')
    gen = state.generator(r.seed, dev)
    student, teacher = state.train_states(cfg, gen, dev)
    images = state.images(gen, dev, pool, batch, cfg['image_size'],
                          cfg['in_channels'])
    labels = state.labels(gen, dev, pool, batch, cfg['output_classes'])
    train_state, step, seen = port.train_step(cfg, student, teacher, dev)
    metric = port.init_metric_state()
    program = {'setup': program_stretch(train_state, step, seen, images,
                                        labels, list(range(checked)),
                                        metric)}
    harness.synchronize(dev)
    setup_s = time.perf_counter() - r.t0

    window_losses: list[torch.Tensor] = []

    def unit(i: int) -> None:
        b = (checked + i) % pool
        window_losses.append(step(images[b], labels[b], metric))

    launches_before = port.launch_counts()
    n, secs, trace = harness.measured(r, unit)
    launches = {k: (v - launches_before.get(k, 0)) // n
                for k, v in port.launch_counts().items()}
    peak = harness.memory_peak_bytes(dev)
    failed = int((~torch.stack(window_losses).isfinite()).sum())
    start = snapshot(train_state)
    after_batches = [(checked + n + j) % pool for j in range(after)]
    program['after'] = program_stretch(train_state, step, seen, images,
                                       labels, after_batches, metric)
    del train_state, step, seen, window_losses
    harness.free(dev)

    with harness.reference_precision():
        ref = {'setup': reference_stretch(cfg, {'state': student}, teacher,
                                          images, list(range(checked))),
               'after': reference_stretch(cfg, start, teacher, images,
                                          after_batches)}
    readings = judge.train_readings(program, ref)
    return harness.Outcome(
        kind='train',
        e2e={'train_img_per_s': n * batch / secs, 'setup_s': setup_s},
        attempted=n, failed=failed,
        checks=[harness.Check(name, readings[name], limit)
                for name, limit in r.limits.items()],
        units=n, batch=batch, memory_peak_bytes=peak, launches=launches,
        trace=trace)
