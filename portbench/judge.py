"""The comparison that decides `correct`: the numbers read from the
program's output against the plain reference's.

`logit_err`: for each image, the distance between the program's logits
and the reference's, over the spread of the reference's own logits:
||p - r|| / ||r - mean(r)||; the worst image. Serving reads it of every
checked forward in the window.

Training compares stretches of consecutive steps: the first steps from
the seeded state, and a step of the same train step after the window,
which the reference replays from the program's state, Adam's moments
and step count as the window left them (a stretch's `start`). Over
every stretch:
- `loss_gap`: the worst step's |L_program - L_reference| / |L_reference|;
- `logit_err`: the worst image of the student's train-mode logits at
  the stretch's first step, the forward from a state both sides share
  (after an update, Adam's first steps move every element of a leaf by
  about lr whatever its gradient, so elements whose gradient is nought
  to rounding move either way and flip binary weights: the reference
  reads 0.13-0.16 against itself there); `teacher_logit_err`: the worst
  image of every step's teacher logits (frozen, so its state is always
  shared);
- `grad_gap`: by the worst leaf, the gap between the norms of the
  stretch's first gradient (as Adam holds it after the step:
  (m - beta1 m_before) / (1 - beta1)), | ||g_p|| - ||g_r|| |, over the
  larger of ||g_r|| and the median leaf's ||g_r||; `grad_gap_median`,
  `grad_gap_p90` the median and 90th-percentile leaf's gap;
- `delta_gap`, `delta_gap_median`, `delta_gap_p90`: the same for the
  norm of each parameter's change over the stretch. Leaves whose first
  gradient in the reference is under a thousandth of the median leaf's
  are left out: their gradient is nought to rounding, and Adam moves
  them by round-off alone.
Each number is the worst stretch's; `setup.<number>` and
`after.<number>` give each stretch's own.

A cell's limits file (portbench/limits/<cell>.json) names the numbers
that its runs compare; PERF.md says why those and not the others.
"""

import torch

QUIET_LEAF = 1e-3
STRETCHES = ('setup', 'after')


def logit_errors(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Per-image error of logits `got` (..., B, C) against `want` (B, C)
    or (..., B, C)."""
    want = want.float()
    centred = want - want.mean(-1, keepdim=True)
    return ((got.float() - want).norm(dim=-1)
            / centred.norm(dim=-1).clamp_min(1e-30))


def worst_logit_error(got: list[torch.Tensor], want: list[torch.Tensor]
                      ) -> float:
    """The worst image's logit error over steps; NaN reads infinite."""
    err = logit_errors(torch.stack(got), torch.stack(want))
    return float(torch.where(err.isfinite(), err, torch.inf).max())


def leaf_gaps(program: torch.Tensor, reference: torch.Tensor
              ) -> torch.Tensor:
    """Each leaf's | ||p|| - ||r|| | over max(||r||, median ||r||)."""
    floor = torch.maximum(reference, reference.median())
    return (program - reference).abs() / floor.clamp_min(1e-30)


def _gaps(program: dict[str, float], reference: dict[str, float],
          names: list[str], prefix: str) -> dict[str, float]:
    p = torch.tensor([program[n] for n in names], dtype=torch.float64)
    r = torch.tensor([reference[n] for n in names], dtype=torch.float64)
    gaps = leaf_gaps(p, r)
    gaps = torch.where(gaps.isfinite(), gaps, torch.inf)
    return {prefix: float(gaps.max()),
            prefix + '_median': float(gaps.median()),
            prefix + '_p90': float(torch.quantile(gaps, 0.9))}


def stretch_readings(program: dict, reference: dict, moved: list[str]
                     ) -> dict[str, float]:
    """The numbers of one stretch. Each side is {'losses': [float],
    'logits', 't_logits': [tensor a step], 'grads', 'deltas': {name:
    norm}}; `moved` names the leaves the change is read of."""
    odd = set(program['grads']) ^ set(reference['grads'])
    if odd:
        raise ValueError('the program and the reference hold other leaves: '
                         f'{sorted(odd)[:4]}')
    loss = max(abs(p - r) / abs(r) if p == p else float('inf')
               for p, r in zip(program['losses'], reference['losses']))
    return {'loss_gap': loss,
            'logit_err': worst_logit_error(program['logits'][:1],
                                           reference['logits'][:1]),
            'teacher_logit_err': worst_logit_error(program['t_logits'],
                                                   reference['t_logits']),
            **_gaps(program['grads'], reference['grads'],
                    sorted(reference['grads']), 'grad_gap'),
            **_gaps(program['deltas'], reference['deltas'], moved,
                    'delta_gap')}


def moved_leaves(grads: dict[str, float]) -> list[str]:
    """The leaves whose first gradient in the reference is at least a
    thousandth of the median leaf's."""
    med = float(torch.tensor(list(grads.values()),
                             dtype=torch.float64).median())
    return sorted(n for n, g in grads.items() if g >= QUIET_LEAF * med)


def train_readings(program: dict[str, dict], reference: dict[str, dict]
                   ) -> dict[str, float]:
    """Every number of the module docstring, from each side's stretches
    by name ('setup', 'after'); the leaves are chosen by the reference's
    first gradient of the first stretch."""
    moved = moved_leaves(reference[STRETCHES[0]]['grads'])
    out: dict[str, float] = {}
    for name in STRETCHES:
        if name not in reference:
            continue
        for k, v in stretch_readings(program[name], reference[name],
                                     moved).items():
            out[f'{name}.{k}'] = v
            out[k] = max(out.get(k, 0.0), v)
    out['quiet_leaves'] = len(reference[STRETCHES[0]]['grads']) - len(moved)
    return out


def norms(tensors: dict[str, torch.Tensor]) -> dict[str, float]:
    """Each tensor's float64 norm, read in one copy to the host."""
    names = list(tensors)
    stacked = torch.stack([tensors[n].detach().double().norm()
                           for n in names]).cpu()
    return dict(zip(names, stacked.tolist()))
