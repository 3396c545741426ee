"""Training: losses, KD, metrics, optimizers and schedules, the train
state and the train and eval steps (port of quant_tpu/train)."""

from quant_tpu_torch.train.losses import get_loss_fn
from quant_tpu_torch.train.kd import kd_criterion
from quant_tpu_torch.train.metrics import MetricAccumulator
from quant_tpu_torch.train.optim import make_lr_schedule, make_optimizer
from quant_tpu_torch.train.state import TrainState
from quant_tpu_torch.train.engine import (
    make_train_step, make_eval_step, train_epoch, evaluate,
)

__all__ = [
    'get_loss_fn', 'kd_criterion', 'MetricAccumulator',
    'make_lr_schedule', 'make_optimizer', 'TrainState',
    'make_train_step', 'make_eval_step', 'train_epoch', 'evaluate',
]
