"""Classification task driver (port of quant_tpu/train/task.py).

Wires config -> data -> (teacher + KD) -> model -> optimizer and
schedule -> restore -> the epoch loop of train and evaluate -> periodic,
final and interrupt checkpoints, as the JAX task does, on one card
(`config['device']`, 'cuda' unless the caller asks for 'cpu').

Where the port differs from the JAX task:

- `build_model` gives a config without inference_mode JAX's default,
  'dense'.
- `init_model_variables` builds the model with its parameters drawn
  from a torch.Generator seeded by the config's seed; it is not flax's
  init, so a run that must start from JAX's variables takes them through
  init_from_checkpoint (a port checkpoint of the JAX tree).
- The model's state lives in the module, so `_restore_into` loads a
  payload into the model and returns it; the optimizer is built over the
  restored parameters, then takes the payload's optimizer state.
- A train loader with `set_epoch` is set to the run's first epoch, so a
  restored run shuffles and augments as the uninterrupted run would
  have (the JAX task's loaders start again from their first pass).
"""

import logging
from pathlib import Path
from typing import Any, Callable, Optional, Type

import numpy as np
import torch
import yaml

from quant_tpu_torch.config.parser import check_single_card
from quant_tpu_torch.data import DATASET_REGISTRY, QuantDataLoader
from quant_tpu_torch.device import DeviceLike, resolve_device
from quant_tpu_torch.nn.lenet import QLeNet5
from quant_tpu_torch.nn.resnet import QResNet
from quant_tpu_torch.train.engine import (
    evaluate, make_eval_step, make_train_step, train_epoch,
)
from quant_tpu_torch.train.kd import kd_criterion, make_teacher_apply
from quant_tpu_torch.train.losses import get_loss_fn
from quant_tpu_torch.train.optim import make_optimizer
from quant_tpu_torch.train.preemption import PreemptionGuard
from quant_tpu_torch.train.state import TrainState
from quant_tpu_torch.utils.checkpoints import (
    get_path_to_checkpoint, restore_checkpoint, save_checkpoint,
)
from quant_tpu_torch.utils.jax_import import (
    from_jax_variables, to_jax_variables,
)
from quant_tpu_torch.utils.logging_utils import init_logging

logger = logging.getLogger(__name__)

MODEL_REGISTRY = {
    'lenet5': QLeNet5,
    'resnet': QResNet,
}

MODEL_COLLECTIONS = ('params', 'batch_stats', 'quant_state')


def build_model(architecture: str, arch_config: dict,
                device: DeviceLike = 'cuda',
                generator: Optional[torch.Generator] = None
                ) -> torch.nn.Module:
    """Instantiate a model from the registry on `device` (reference
    initialization.py:97-131), its parameters drawn from `generator`.

    A config that names no inference_mode gets JAX's default, 'dense'
    (the port's constructors default to 'packed', the serving form), so
    the task's eval forward is JAX's; serving.prepare packs."""
    try:
        model_cls = MODEL_REGISTRY[architecture]
    except KeyError:
        raise ValueError(f'Model architecture {architecture} is not found.')
    arch_config = {'inference_mode': 'dense', **arch_config}
    return model_cls(**arch_config, device=device, generator=generator)


def init_model_variables(architecture: str, arch_config: dict,
                         seed: Optional[int],
                         device: DeviceLike = 'cuda') -> torch.nn.Module:
    """build_model with the parameters drawn on the CPU from one
    torch.Generator seeded by `seed` (0 when None), then moved to
    `device`: the same seed gives the same model on every device."""
    gen = torch.Generator().manual_seed(0 if seed is None else int(seed))
    model = build_model(architecture, arch_config, 'cpu', gen)
    return model.to(resolve_device(device))


def _paths(tree: Any, prefix: str = '') -> dict[str, Any]:
    """{'a/b/leaf': leaf} over a nested dict."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out: dict[str, Any] = {}
    for key, value in tree.items():
        out.update(_paths(value, f'{prefix}/{key}' if prefix else str(key)))
    return out


def _unflatten(paths: dict[str, Any]) -> dict:
    tree: dict = {}
    for path, leaf in paths.items():
        node = tree
        *parents, last = path.split('/')
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


def _restore_into(model: torch.nn.Module, ckpt_payload: dict,
                  strict_keys: bool = True) -> torch.nn.Module:
    """Load a payload's model collections into `model` in place and
    return it.

    strict_keys: each collection's leaves must be the model's, by path
    (ValueError otherwise; a leaf of another shape raises too). Else
    (reference checkpoints.py:86-89) leaves merge by path: a model leaf
    the payload lacks, or holds at another shape, keeps its value.
    """
    fresh = to_jax_variables(model)
    merged = dict(fresh)
    for col in MODEL_COLLECTIONS:
        if col not in ckpt_payload or col not in fresh:
            continue
        want, got = _paths(fresh[col]), _paths(ckpt_payload[col])
        if set(want) == set(got):
            merged[col] = _unflatten({p: np.asarray(got[p]) for p in want})
        elif strict_keys:
            raise ValueError(
                f'{col}: the checkpoint does not match the model: missing '
                f'{sorted(set(want) - set(got))[:5]}, unexpected '
                f'{sorted(set(got) - set(want))[:5]}')
        else:
            def pick(path: str, old: np.ndarray) -> np.ndarray:
                new = got.get(path)
                if new is not None and tuple(new.shape) == old.shape:
                    return np.asarray(new).astype(old.dtype)
                return old
            merged[col] = _unflatten({p: pick(p, old)
                                      for p, old in want.items()})
            logger.warning('Non-strict restore: structure mismatch in %s; '
                           'merged by path, fresh values kept where '
                           'missing', col)
    return from_jax_variables(model, merged)


def get_teacher_apply(kd_config: dict, seed: Optional[int],
                      device: DeviceLike = 'cuda'
                      ) -> tuple[Callable, Callable]:
    """Load a frozen teacher and build the KD loss (reference
    tasks.py:33-82).

    The teacher's own experiment config.yaml defines its architecture,
    its checkpoint restores the weights; `teacher_dtype` is its
    eval_dtype and train_dtype, `train_mode` keeps its BN on the batch's
    statistics (train.kd.make_teacher_apply: nothing it computes reaches
    its state) and `freeze_teacher` reaches the KD criterion.
    """
    with open(kd_config['teacher_config_path']) as f:
        teacher_model_config = yaml.safe_load(f)['model']

    arch_config = dict(teacher_model_config.get('arch_config', {}))
    teacher_dtype = kd_config.get('teacher_dtype')
    if teacher_dtype is not None:
        arch_config['eval_dtype'] = teacher_dtype
        arch_config['train_dtype'] = teacher_dtype
    teacher = init_model_variables(teacher_model_config['architecture'],
                                   arch_config, seed, device)
    payload = restore_checkpoint(Path(kd_config['teacher_checkpoint_path']))
    _restore_into(teacher, payload, kd_config.get('strict_keys', True))
    train_mode = bool(kd_config.get('train_mode', False))
    freeze = bool(kd_config.get('freeze_teacher', True))
    teacher_apply = make_teacher_apply(teacher, train_mode)

    crit = dict(kd_config.get('criterion_config', {}))

    def kd_loss(output, teacher_output, target):
        return kd_criterion(output, teacher_output, target,
                            freeze_teacher=freeze, **crit)

    return teacher_apply, kd_loss


def _load_optimizer_state(state: TrainState, payload: dict) -> None:
    """The payload's optimizer state and step into `state`, the
    hyperparameters staying the config's; a state of another optimizer
    is refused with a warning and the optimizer starts fresh."""
    saved = payload['opt_state']
    fresh_groups = [{k: v for k, v in g.items() if k != 'params'}
                    for g in state.optimizer.param_groups]
    if [set(g) - {'params'} for g in saved.get('param_groups', [])] != [
            set(g) for g in fresh_groups]:
        logger.warning('Optimizer state in checkpoint does not match the '
                       'current optimizer; starting fresh.')
        return
    try:
        state.optimizer.load_state_dict(saved)
    except ValueError as e:
        logger.warning('Optimizer state in checkpoint does not match the '
                       'current optimizer (%s); starting fresh.', e)
        return
    for group, fresh in zip(state.optimizer.param_groups, fresh_groups):
        group.update(fresh)
    state.step = int(payload.get('step', 0))


def classification_task(
        config: dict,
        experiment_root_directory: Path,
        data_loader_cls: Optional[Type[QuantDataLoader]] = None,
        get_hooks: Optional[Callable] = None,
        restore_experiment: Optional[Path] = None,
) -> tuple[list[dict], list[dict]]:
    """Run a classification experiment; returns per-epoch metric lists."""
    data_config = dict(config['data'])
    model_config = config['model']
    optimization_config = config['optimization']
    log_config = config['log']

    init_logging(log_config.get('level', 'INFO'))
    check_single_card(config)
    device = resolve_device(config.get('device', 'cuda'))

    if data_loader_cls is None:
        data_loader_cls = DATASET_REGISTRY[data_config.pop('dataset')]
    else:
        data_config.pop('dataset', None)
    data_config.pop('download', None)
    data_loader = data_loader_cls(**data_config)
    skip_training = bool(config.get('skip_training'))
    train_loader = None if skip_training else data_loader.get_train_loader()
    test_loader = data_loader.get_test_loader()

    epochs = int(optimization_config['epochs'])
    seed = config.get('seed')

    model = init_model_variables(model_config['architecture'],
                                 model_config.get('arch_config', {}), seed,
                                 device)

    teacher_apply, kd_loss = None, None
    if 'kd_config' in model_config:
        teacher_apply, kd_loss = get_teacher_apply(
            model_config['kd_config'], seed, device)

    eval_loss_fn = get_loss_fn(model_config['loss'])
    train_loss_fn = kd_loss if kd_loss is not None else eval_loss_fn

    start_epoch = 1
    strict = model_config.get('strict_keys', True)
    payload = None
    if restore_experiment is not None:
        payload = restore_checkpoint(
            get_path_to_checkpoint(restore_experiment))
        _restore_into(model, payload, strict)
        start_epoch = int(payload.get('epoch', 0)) + 1
    elif config.get('init_from_checkpoint'):
        _restore_into(model, restore_checkpoint(
            Path(config['init_from_checkpoint'])), strict)

    if skip_training:
        state = TrainState(model=model, optimizer=None, tx=None)
    else:
        param_labels = None
        if optimization_config.get('optimizer', {}).get('param_groups'):
            from quant_tpu_torch.train.groups import quantized_param_labels
            param_labels = quantized_param_labels(model)
        tx, lr_schedule = make_optimizer(
            optimization_config, epochs, len(train_loader),
            param_labels=param_labels)
        state = TrainState.create(model, tx)
        if payload is not None and 'opt_state' in payload:
            _load_optimizer_state(state, payload)
        if hasattr(train_loader, 'set_epoch'):
            train_loader.set_epoch(start_epoch - 1)

    train_hooks, test_hooks = ([], [])
    if get_hooks is not None:
        train_hooks, test_hooks = get_hooks(
            config, Path(experiment_root_directory))

    def _close_hooks() -> None:
        # Flush/close hooks that buffer (TensorBoard writers); without
        # this, short runs end before the periodic flush and the event
        # files stay empty.
        for hook in (*train_hooks, *test_hooks):
            close = getattr(hook, 'close', None)
            if callable(close):
                close()

    train_step = make_train_step(train_loss_fn, teacher_apply)
    eval_step = make_eval_step(eval_loss_fn)

    train_epoch_metrics: list[dict] = []
    test_epoch_metrics: list[dict] = []

    exp_dir = Path(experiment_root_directory) / config['experiment_name']

    try:
        if skip_training:
            test_epoch_metrics.append(
                evaluate(eval_step, state, test_loader, epoch=1,
                         hooks=test_hooks))
        else:
            save_freq = int(log_config.get('save_model_freq', epochs))

            def _payload(epoch: int) -> dict:
                tree = to_jax_variables(state.model)
                return {**{col: tree.get(col, {})
                           for col in MODEL_COLLECTIONS},
                        'opt_state': state.optimizer.state_dict(),
                        'step': state.step,
                        'epoch': epoch}

            # SIGTERM -> finish the batch, write an interrupt checkpoint,
            # stop. The `with` restores the signal handlers even when an
            # epoch raises.
            with PreemptionGuard() as guard:
                # Reference semantics: a restored run trains `epochs` MORE
                # epochs (tasks.py:196: range(start_epoch, start+epochs)).
                final_epoch = start_epoch + epochs - 1
                for epoch in range(start_epoch, start_epoch + epochs):
                    state, m_train = train_epoch(
                        train_step, state, train_loader, epoch,
                        log_interval=int(log_config.get('interval', 10)),
                        hooks=train_hooks, lr_schedule=lr_schedule,
                        steps_per_epoch=len(train_loader), stop=guard)
                    if guard.requested:
                        # Payload epoch-1: restore runs the interrupted
                        # epoch again (its params are partly advanced;
                        # QAT tolerates the re-run). File tag = this
                        # epoch, so repeated preemptions overwrite one
                        # slot.
                        save_checkpoint(exp_dir / 'checkpoints',
                                        _payload(epoch - 1), epoch)
                        logger.warning('Interrupt checkpoint written; '
                                       'resume with --restore-experiment.')
                        break
                    m_test = evaluate(eval_step, state, test_loader,
                                      epoch=epoch, hooks=test_hooks,
                                      stop=guard)
                    if guard.requested:
                        # Interrupted during eval: this epoch's training
                        # completed, so the payload resumes after it.
                        save_checkpoint(exp_dir / 'checkpoints',
                                        _payload(epoch), epoch)
                        logger.warning('Interrupt checkpoint written; '
                                       'resume with --restore-experiment.')
                        break
                    train_epoch_metrics.append(m_train)
                    test_epoch_metrics.append(m_test)

                    # Always checkpoint the last epoch of this run (for a
                    # resumed run: start_epoch+epochs-1, not `epochs`).
                    if epoch % save_freq == 0 or epoch == final_epoch:
                        save_checkpoint(exp_dir / 'checkpoints',
                                        _payload(epoch), epoch)

    finally:
        _close_hooks()

    data_loader.cleanup()
    return train_epoch_metrics, test_epoch_metrics
