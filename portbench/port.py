"""The system under test: the PyTorch and CUDA port, `quant_tpu_torch`,
built from a configuration file and handed the harness's seeded state.

Serving: the QResNet with EMA activation scales, loaded, then prepared by
the program's own export, threshold fold and strip (`nn.export`), served
in the configuration's eval dtype. Training: the student's train form
and the frozen teacher, the recipe's optimizer (`train.make_optimizer`)
and its KD step (`train.make_train_step` with `train.kd`), as
`train/task.classification_task` builds them.
"""

import functools
from typing import Any, Callable

import torch

from quant_tpu_torch import _build
from quant_tpu_torch import train as T
from quant_tpu_torch.device import full_precision
from quant_tpu_torch.nn import export
from quant_tpu_torch.nn.resnet import QResNet
from quant_tpu_torch.train.kd import make_teacher_apply
from quant_tpu_torch.train.metrics import init_metric_state


def _arch(config: dict, block: str, x_quant: str, w_quant: str,
          clamp: dict, nonlins: list, double_shortcut: bool) -> dict:
    layer: dict[str, Any] = {'x_quant': x_quant, 'w_quant': w_quant,
                             'clamp': dict(clamp)}
    if double_shortcut:
        layer['double_shortcut'] = True
    return dict(block=block, layer0=config['layer0'],
                layer1=dict(layer), layer2=dict(layer), layer3=dict(layer),
                layer4=dict(layer), nonlins=list(nonlins),
                num_blocks=config['num_blocks'],
                output_classes=config['output_classes'],
                in_channels=config['in_channels'],
                moving_average_momentum=config['moving_average_momentum'])


def _chain(dtype: str) -> Any:
    """A train chain's dtype as the recipes set it: float32 is the
    default chain (no train_dtype key), anything else is named."""
    return None if dtype == 'float32' else dtype


def _student(config: dict) -> dict:
    return _arch(config, config['block'], config['x_quant'],
                 config['w_quant'], config['clamp'], config['nonlins'],
                 config.get('double_shortcut', False))


def serving_model(config: dict, state: dict, device: torch.device
                  ) -> torch.nn.Module:
    """The served model of `config` on `device`, loaded from `state` and
    prepared by the program (export, fold, strip)."""
    serve = config['serve']
    model = QResNet(**_student(config),
                    moving_average_mode=serve['moving_average_mode'],
                    sign_compute=serve['sign_compute'], device=device)
    model.load_state_dict(state, strict=True)
    export.export_packed_variables(model)
    if not export.fold_for_serving(model)[1]:
        raise RuntimeError('the program applied no fold to the served model')
    export.strip_for_deployment(model)
    model.eval_dtype = getattr(torch, serve['eval_dtype'])
    return model


def serve_forward(model: torch.nn.Module) -> Callable:
    """The served forward, as the engine calls it."""
    def forward(x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode(), full_precision():
            return model(x)
    return forward


def train_step(config: dict, student_state: dict, teacher_state: dict,
               device: torch.device) -> tuple[Any, Callable, dict]:
    """(the train state, the KD step, what the step's criterion last saw)
    of `config`'s train form: the last dict holds the student's and the
    teacher's logits of the newest step, detached, as 'student' and
    'teacher'."""
    train = config['train']
    student = QResNet(**_student(config),
                      moving_average_mode=train['moving_average_mode'],
                      inference_mode='dense', solver_mode=train['solver_mode'],
                      train_dtype=_chain(train['train_dtype']),
                      remat=train['remat'],
                      device=device)
    student.load_state_dict(student_state, strict=True)
    t = train['teacher']
    teacher = QResNet(**_arch(config, t['block'], t['x_quant'], t['w_quant'],
                              t['clamp'], t['nonlins'], False),
                      moving_average_mode='off', inference_mode='dense',
                      train_dtype=_chain(t['dtype']),
                      eval_dtype=_chain(t['dtype']),
                      device=device)
    teacher.load_state_dict(teacher_state, strict=True)
    spec, _ = T.make_optimizer(train['optimization'], train['epochs'],
                               train['steps_per_epoch'])
    state = T.TrainState.create(student, spec)
    kd = train['kd']
    criterion = functools.partial(
        T.kd_criterion, temperature=kd['temperature'],
        teacher_correction=kd['teacher_correction'])
    seen: dict[str, torch.Tensor] = {}

    def observed(output: torch.Tensor, teacher_output: torch.Tensor,
                 target: torch.Tensor) -> torch.Tensor:
        seen['student'] = output.detach()
        seen['teacher'] = teacher_output.detach()
        return criterion(output, teacher_output, target)

    step = T.make_train_step(
        observed, make_teacher_apply(teacher, train_mode=kd['train_mode']))

    def run(data: torch.Tensor, target: torch.Tensor,
            metric: dict) -> torch.Tensor:
        with full_precision():
            _, _, loss = step(state, data, target, metric)
        return loss
    return state, run, seen


def launch_counts() -> dict[str, int]:
    return _build.launch_counts()
