"""Optimizers and per-step learning-rate schedules (port of
quant_tpu/train/optim.py).

The reference's optimizers with torch's defaults (sgd with momentum and
nesterov, adam betas (0.9, 0.999) eps 1e-8, adadelta rho 0.9 eps 1e-6)
are torch.optim's own classes, whose L2 weight decay is added to the
gradient before the moments, as optax's add_decayed_weights ahead of the
transform. Schedules are stepped per batch: the learning rate of the
update that a step makes is schedule(step), with step 0 at the first
update (optax's count), and epoch-denominated settings (step_lr
step_size, multi_step_lr milestones) are rescaled by steps_per_epoch.
linear_lr keeps the reference's formula lr0 - step / total * (lr0 +
min_lr), floored at min_lr, with total = max((epochs - 1) *
steps_per_epoch, 1). lambda_lr evaluates a Python expression from the
config and needs lr_scheduler.allow_eval: true.
"""

import copy
import logging
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

logger = logging.getLogger(__name__)

Schedule = Callable[[int], float]


def make_lr_schedule(config: dict, epochs: int,
                     steps_per_epoch: int) -> Schedule:
    """A step-indexed schedule from a reference-schema lr_scheduler
    config (with the optimizer's `lr`)."""
    config = copy.deepcopy(config)
    kind = config.pop('scheduler')
    lr0 = float(config.pop('lr'))

    if kind == 'linear_lr':
        min_lr = float(config['min_lr'])
        total_steps = max((epochs - 1) * steps_per_epoch, 1)
        return lambda step: max(lr0 - step / total_steps * (lr0 + min_lr),
                                min_lr)

    if kind == 'step_lr':
        step_size = int(config['step_size']) * steps_per_epoch
        gamma = float(config['gamma'])
        return lambda step: lr0 * gamma ** (step // step_size)

    if kind == 'multi_step_lr':
        gamma = float(config['gamma'])
        milestones = sorted(int(m) * steps_per_epoch
                            for m in config['milestones'])
        return lambda step: lr0 * gamma ** sum(step >= m for m in milestones)

    if kind == 'lambda_lr':
        if not config.get('allow_eval', False):
            raise ValueError(
                "lambda_lr evaluates the 'lr_lambda' string as Python "
                'code; set lr_scheduler.allow_eval: true to accept that '
                'for configs you trust.')
        logger.warning('lambda_lr: eval()ing lr_lambda from the config.')
        fn = eval(config['lr_lambda'])  # noqa: S307 (reference behavior)
        return lambda step: lr0 * fn(step)

    raise ValueError(f'LR scheduler {kind} is not supported.')


_ALGORITHMS = ('sgd', 'adam', 'adadelta')


@dataclass
class OptimizerSpec:
    """What make_optimizer builds before the parameters are known, the
    counterpart of an optax transform: `init(model)` makes the
    torch.optim optimizer (as tx.init(params)), `set_lr` sets each
    group's learning rate for a step."""

    algorithm: str
    hparams: dict
    schedule: Schedule
    weight_decay: float = 0.0
    groups: Optional[dict[str, tuple[float, float]]] = None
    param_labels: Optional[dict[str, str]] = None

    def init(self, model: torch.nn.Module) -> torch.optim.Optimizer:
        named = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
        if self.groups is None:
            groups = [dict(params=[p for _, p in named], lr_scale=1.0,
                           weight_decay=self.weight_decay, label='all')]
        else:
            labels = self.param_labels or {}
            missing = [n for n, _ in named if n not in labels]
            if missing:
                raise ValueError(f'no param label for {missing[:3]}')
            groups = []
            for label, (scale, wd) in self.groups.items():
                params = [p for n, p in named if labels[n] == label]
                if params:
                    groups.append(dict(params=params, lr_scale=scale,
                                       weight_decay=wd, label=label))
        lr = self.schedule(0)
        if self.algorithm == 'sgd':
            momentum = float(self.hparams.get('momentum', 0.0))
            nesterov = bool(self.hparams.get('nesterov', False))
            return torch.optim.SGD(groups, lr=lr, momentum=momentum,
                                   nesterov=nesterov and momentum > 0)
        if self.algorithm == 'adam':
            betas = self.hparams.get('betas', (0.9, 0.999))
            return torch.optim.Adam(
                groups, lr=lr, betas=(float(betas[0]), float(betas[1])),
                eps=float(self.hparams.get('eps', 1e-8)))
        return torch.optim.Adadelta(
            groups, lr=lr, rho=float(self.hparams.get('rho', 0.9)),
            eps=float(self.hparams.get('eps', 1e-6)))

    def set_lr(self, optimizer: torch.optim.Optimizer, step: int) -> None:
        """Each group's lr for the update at `step`: the schedule's,
        times the group's lr_scale."""
        lr = self.schedule(step)
        for group in optimizer.param_groups:
            group['lr'] = lr * group['lr_scale']


def make_optimizer(config: dict, epochs: int, steps_per_epoch: int,
                   param_labels: Optional[dict[str, str]] = None
                   ) -> tuple[OptimizerSpec, Schedule]:
    """(optimizer spec, lr schedule) from the merged {optimizer: ...,
    lr_scheduler: ...} config; the optimizer's lr seeds the schedule.

    `optimizer.param_groups` ({quantized: {lr_scale, weight_decay}, fp:
    ...}) gives each group of train.groups.quantized_param_labels (pass
    them as `param_labels`) a multiple of the schedule and its own
    weight decay (default the global one).
    """
    opt_cfg = copy.deepcopy(config['optimizer'])
    algorithm = opt_cfg.pop('algorithm')
    if algorithm not in _ALGORITHMS:
        raise ValueError(f'Optimizer {algorithm} is not supported.')
    lr0 = float(opt_cfg.pop('lr', 1.0))
    weight_decay = float(opt_cfg.pop('weight_decay', 0.0))
    groups_cfg = opt_cfg.pop('param_groups', None)

    sched_cfg: dict[str, Any] = dict(copy.deepcopy(config.get(
        'lr_scheduler', {'scheduler': 'step_lr', 'step_size': 10 ** 9,
                         'gamma': 1.0})))
    sched_cfg['lr'] = lr0
    schedule = make_lr_schedule(sched_cfg, epochs, steps_per_epoch)

    groups = None
    if groups_cfg:
        if param_labels is None:
            raise ValueError(
                'optimizer.param_groups requires param labels — build '
                'them with quant_tpu_torch.train.groups.'
                'quantized_param_labels.')
        groups = {}
        for label in ('fp', 'quantized'):
            g = dict(groups_cfg.get(label, {}))
            scale = float(g.pop('lr_scale', 1.0))
            wd = float(g.pop('weight_decay', weight_decay))
            if g:
                raise ValueError(
                    f'Unknown param_groups.{label} keys: {sorted(g)} '
                    '(supported: lr_scale, weight_decay)')
            groups[label] = (scale, wd)
    spec = OptimizerSpec(algorithm, opt_cfg, schedule, weight_decay,
                         groups, param_labels)
    return spec, schedule
