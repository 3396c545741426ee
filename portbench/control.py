"""The readings that the comparison's limits are set from, at a cell's own
sizes, on the card.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3
                                 [--out PATH] [--window-steps N]

For each seed, one JSON line:

- `program`: the numbers `run.py` compares, read from the program as a
  run reads them (serving: one forward of each batch of the pool;
  training: the checked steps, N untimed steps in the window's place,
  then the step after it), against the plain reference, with
  every number judge.py gives beside those the limits name;
- `control`: the reference put in the program's place, computed in the
  nearest precision below the configuration's, against the reference:
  for a bf16 chain float8, each value the chain holds rounded to e4m3
  under a per-tensor scale and each gradient to e5m2; for a float32
  chain that runs with TF32 off, TF32: TF32 on in the convs and matmuls,
  and each value the chain holds, which the convs and matmuls take as
  operands, and each gradient rounded to TF32's 10-bit mantissa;
- `correct`: the verdict of the cell's limits on `program`, `control`
  and (training) `half_batch`, by harness.Check as a run decides it;
- `fp32` (a bf16 chain): the program against the reference with its
  chain in float32, for the record;
- `again` (training): the reference run twice, its own spread;
- `half_batch` (training): the reference with each loss's mean taken
  over half of the batch, a fault the comparison has to catch;
- `leaves`, `delta_leaves`, `quietest` (training): the leaves that read
  the largest gaps of the first gradient's norm and of the change's,
  and the smallest first gradients in the reference.

The benchmark's own runs never run this.
"""

import argparse
import json
import sys
from pathlib import Path
from typing import Callable, Optional

import torch

from portbench import harness, judge, port, run as bench_run, state
from portbench.drivers import train_kd
from portbench.reference import resnet as reference

E4M3_MAX, E5M2_MAX = 448.0, 57344.0


def _scaled(t: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """t rounded to `dtype` under a per-tensor scale that maps its largest
    magnitude to the dtype's largest value."""
    amax = t.detach().abs().amax().float().clamp_min(1e-30)
    scale = top / amax
    return ((t.float() * scale).to(dtype).float() / scale).to(t.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _scaled(t, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _scaled(g, torch.float8_e5m2, E5M2_MAX)


def fp8(t: torch.Tensor) -> torch.Tensor:
    """The chain rounded to float8 (e4m3), its gradient to e5m2."""
    return _Fp8.apply(t)


def _tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest even at TF32's 10 mantissa bits."""
    bits = t.float().contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32).to(t.dtype)


class _Tf32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _tf32_round(t)

    @staticmethod
    def backward(ctx, g):
        return _tf32_round(g)


def tf32_values(t: torch.Tensor) -> torch.Tensor:
    """The chain's values and their gradients rounded to TF32."""
    return _Tf32.apply(t)


class tf32:
    """TF32 on for float32 matmuls and convs inside."""

    def __enter__(self) -> None:
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True

    def __exit__(self, *exc) -> None:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def _lower(config: dict, train: bool) -> tuple[str, Callable, type]:
    """(name, rounding, precision context) of the control: the precision
    below the one the configuration states."""
    dtype = (config['train']['train_dtype'] if train
             else config['serve']['eval_dtype'])
    if dtype == 'float32':
        return 'tf32', tf32_values, tf32
    if dtype in ('bfloat16', 'float16'):
        return 'fp8', fp8, harness.reference_precision
    raise ValueError(f'no control below {dtype}')


def serve_seed(cfg: dict, traffic: dict, seed: int, dev: torch.device,
               limits: Optional[dict] = None) -> dict:
    batch, pool = int(traffic['batch']), int(traffic['pool_batches'])
    gen = state.generator(seed, dev)
    weights = state.serve_state(cfg, gen, dev)
    images = state.images(gen, dev, pool, batch, cfg['image_size'],
                          cfg['in_channels'])
    model = port.serving_model(cfg, weights, dev)
    forward = port.serve_forward(model)
    got = [forward(images[b]) for b in range(pool)]
    del model, forward
    harness.free(dev)
    name, rnd, ctx = _lower(cfg, train=False)
    errs: dict[str, list] = {'program': [], 'control': [], 'fp32': []}
    top1: dict[str, float] = {k: 0.0 for k in errs}
    for b in range(pool):
        with harness.reference_precision():
            want = reference.serve_logits(cfg, weights, images[b])
            fp32 = reference.serve_logits(cfg, weights, images[b],
                                          rnd=reference.identity)
        with ctx():
            low = reference.serve_logits(cfg, weights, images[b], rnd=rnd)
        outs = {'program': got[b], 'control': low}
        for k, out in outs.items():
            errs[k].append(judge.logit_errors(out, want))
            top1[k] += float((out.argmax(1) != want.argmax(1)).float().mean()
                             / pool)
        errs['fp32'].append(judge.logit_errors(got[b], fp32))
    out = {}
    for k, e in errs.items():
        e = torch.cat(e).double()
        q = torch.quantile(e, torch.tensor([0.5, 0.9, 0.99], dtype=e.dtype,
                                           device=e.device)).tolist()
        out[k] = {'logit_err': float(e.max()), 'median': q[0], 'p90': q[1],
                  'p99': q[2], 'mean': float(e.mean()), 'top1_moved': top1[k]}
    out['control']['name'] = name
    if limits:
        out['correct'] = {k: verdict(out[k], limits)
                          for k in ('program', 'control')}
    return out


def verdict(reading: dict, limits: dict) -> bool:
    """`correct` as a run decides it: every limited number within its
    limit (harness.Check)."""
    return all(harness.Check(k, reading[k], v).ok for k, v in limits.items())


def _worst(program: dict, ref: dict, key: str) -> list:
    """The five leaves with the largest gaps of the setup stretch's
    `key` ('grads' or 'deltas'): [gap, name, program norm, reference
    norm]."""
    p, r = program['setup'][key], ref['setup'][key]
    med = float(torch.tensor(list(r.values())).median())
    rows = sorted(((abs(p[n] - r[n]) / max(r[n], med), n, p[n], r[n])
                   for n in r), reverse=True)
    return [list(row) for row in rows[:5]]


def _quietest(ref: dict) -> list:
    """The six leaves with the smallest first gradient in the reference,
    as a share of the median leaf's: [share, name]."""
    g = ref['setup']['grads']
    med = float(torch.tensor(list(g.values())).median())
    return [[g[n] / med, n] for n in sorted(g, key=g.get)[:6]]


def train_seed(cfg: dict, traffic: dict, seed: int, dev: torch.device,
               limits: Optional[dict] = None, window_steps: int = 4) -> dict:
    """A run's check at the cell's sizes, with `window_steps` untimed
    steps in the window's place, and the control's, the faults' and the
    reference's own readings beside the program's."""
    batch, pool = int(traffic['batch']), int(traffic['pool_batches'])
    checked, after = int(traffic['checked_steps']), int(traffic['after_steps'])
    gen = state.generator(seed, dev)
    student, teacher = state.train_states(cfg, gen, dev)
    images = state.images(gen, dev, pool, batch, cfg['image_size'],
                          cfg['in_channels'])
    labels = state.labels(gen, dev, pool, batch, cfg['output_classes'])
    train_state, step, seen = port.train_step(cfg, student, teacher, dev)
    metric = port.init_metric_state()
    setup_b = list(range(checked))
    program = {'setup': train_kd.program_stretch(
        train_state, step, seen, images, labels, setup_b, metric)}
    for i in range(window_steps):
        b = (checked + i) % pool
        step(images[b], labels[b], metric)
    start = train_kd.snapshot(train_state)
    after_b = [(checked + window_steps + j) % pool for j in range(after)]
    program['after'] = train_kd.program_stretch(
        train_state, step, seen, images, labels, after_b, metric)
    del train_state, step, seen
    harness.free(dev)

    def side(**kwargs) -> dict:
        return {'setup': train_kd.reference_stretch(
                    cfg, {'state': student}, teacher, images, setup_b,
                    **kwargs),
                'after': train_kd.reference_stretch(
                    cfg, start, teacher, images, after_b, **kwargs)}

    with harness.reference_precision():
        ref, again, half = side(), side(), side(half_batch=True)
    name, rnd, ctx = _lower(cfg, train=True)
    with ctx():
        low = side(rnd=rnd)
    out = {'program': judge.train_readings(program, ref),
           'control': {'name': name, **judge.train_readings(low, ref)},
           'half_batch': judge.train_readings(half, ref),
           'again': judge.train_readings(again, ref)}
    if cfg['train']['train_dtype'] != 'float32':
        with harness.reference_precision():
            f32 = side(rnd=reference.identity)
        out['fp32'] = judge.train_readings(program, f32)
    if limits:
        out['correct'] = {k: verdict(out[k], limits)
                          for k in ('program', 'control', 'half_batch')}
    out.update(program_losses=program['setup']['losses']
               + program['after']['losses'],
               reference_losses=ref['setup']['losses']
               + ref['after']['losses'],
               leaves=_worst(program, ref, 'grads'),
               delta_leaves=_worst(program, ref, 'deltas'),
               quietest=_quietest(ref))
    return out


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True,
                    help='comma-separated seeds')
    ap.add_argument('--out', default=None)
    ap.add_argument('--window-steps', type=int, default=4,
                    help="training: untimed steps in the window's place, "
                         'as many as a window holds to read as a run does')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('portbench.control: no CUDA device', file=sys.stderr)
        return 2
    bench = bench_run.spec()
    w = bench_run.cell(bench, args.workload)
    cfg, traffic = (bench_run.config(bench, w['config']),
                    bench_run.traffic(w['traffic']))
    dev = torch.device('cuda')
    limits = bench_run.limits(w['name'])
    for seed in (int(s) for s in args.seeds.split(',')):
        if traffic['driver'] == 'serve_closed_loop':
            out = serve_seed(cfg, traffic, seed, dev, limits)
        else:
            out = train_seed(cfg, traffic, seed, dev, limits,
                             args.window_steps)
        line = json.dumps({'cell': w['name'], 'seed': seed,
                           'window_steps': args.window_steps, **out})
        print(line, flush=True)
        if args.out:
            with open(Path(args.out), 'a') as f:
                f.write(line + '\n')
        harness.free(dev)
    return 0


if __name__ == '__main__':
    sys.exit(main())
