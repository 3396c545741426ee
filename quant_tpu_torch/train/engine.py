"""Train and eval steps and the epoch drivers (port of
quant_tpu/train/engine.py).

A train step does what the reference's per-batch loop does: the model's
train forward (BN statistics, quantizer state), the frozen teacher's
forward for KD, the loss, the backward pass, the optimizer's update at
the schedule's learning rate for this step, and the metric update on
the device. The host loops feed batches (any iterable of (images,
labels), numpy or torch, moved to the model's device) and fire hooks.

Data parallel (`mesh=`, one process a rank, parallel.make_mesh): JAX's
step is one program over the global batch sharded on 'data'; here each
rank steps on its own rows, and the step makes them one logical batch:
train-mode statistics over every rank's rows (parallel.global_stats),
gradients averaged across the 'data' group by one all-reduce (equal to
the global batch's gradient for equal local batches), and the metric
increments summed across it, so each rank reports the global batch's
loss and accuracy. A 'data' axis of one rank dispatches no collective.
JAX's `donate` has no counterpart.

Tensor parallel (a mesh with a 'model' axis, the model sharded by
parallel.sharding.shard_model): the ranks of one 'model' group step on
the same rows; the model's forward gathers its sharded outputs and the
gathers' backward leaves each rank its own slice's gradient. So
gradients are averaged over the 'data' group only: a sharded leaf's
gradient is its own slice's, neither summed nor averaged across the
'model' ranks, and a replicated leaf's is the same on each of them.
Statistics and metrics reduce over 'data' alike, so the ranks of one
'model' group hold equal metrics.

Spatial parallel (a mesh with a 'space' axis, the model banded by
parallel.spatial.band_model): the ranks of one 'space' group step on
the same images, each on its row band (parallel.local_band; the loaders
of parallel.multihost cut it), as JAX's step on a batch placed by
`spatial_sharding` (GSPMD partitions it forward and backward). The
banded forward reduces its statistics over 'space' while it runs on
bands; the logits, the loss and the metrics are the whole images' on
every rank. After the backward, the gradients of the modules that ran
on bands (each rank holds its band's share) are summed over 'space'
(parallel.spatial.sum_banded_grads), those of the whole section are
left as they are (every rank holds the whole gradient), then all are
averaged over 'data'. The ranks' parameters stay equal. A model with
`remat` recomputes its blocks inside the backward on the bands they ran
on (nn.resnet.remat_block); the record of the modules that ran on bands
is the forward's, which the recomputation repeats and never resets.
"""

import inspect
import logging
from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from quant_tpu_torch.parallel import data_group, global_stats, spatial
from quant_tpu_torch.parallel.mesh import all_reduce_flat, axis_size
from quant_tpu_torch.train.metrics import (
    MetricAccumulator, init_metric_state, update_metric_state,
    update_metric_state_masked,
)
from quant_tpu_torch.train.state import TrainState
from quant_tpu_torch.utils.profiling import span

logger = logging.getLogger(__name__)

Hook = Callable[..., None]

PHASE_SPANS = {'forward': 'train.forward', 'teacher': 'train.teacher',
               'backward': 'train.backward', 'optimizer': 'train.optimizer'}


class _Phases:
    """A train step's marks: each closes the open phase's span, calls
    the phase hook with its name and opens the next phase's span ('end'
    opens none); leaving the context closes the open one."""

    def __init__(self, hook: Optional[Callable[[str], None]]):
        self.hook = hook
        self.open: Any = None

    def __call__(self, name: str) -> None:
        self._close()
        if self.hook is not None:
            self.hook(name)
        if name in PHASE_SPANS:
            self.open = span(PHASE_SPANS[name], 'phase')
            self.open.__enter__()

    def _close(self) -> None:
        if self.open is not None:
            self.open.__exit__(None, None, None)
            self.open = None

    def __enter__(self) -> '_Phases':
        return self

    def __exit__(self, *exc: object) -> None:
        self._close()


def _accepts_metrics(hook: Hook) -> bool:
    """Hooks of the old protocol (epoch, global_step, values_dict,
    log_interval) are called without the live-metrics kwarg unless they
    declare it (or **kwargs)."""
    try:
        params = inspect.signature(hook).parameters.values()
    except (TypeError, ValueError):
        return True
    return any(p.kind == p.VAR_KEYWORD or p.name == 'metrics'
               for p in params)


def _on(a: Any, device: torch.device,
        dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.asarray(a))
    return a.to(device=device, dtype=dtype)


def _add_global(metric_state: dict, delta: dict,
                group: dist.ProcessGroup) -> tuple[dict, torch.Tensor]:
    """(metric_state plus one batch's increments summed across the
    group's ranks, the global batch's mean loss), by one all-reduce."""
    names = list(delta)
    flat = torch.stack([delta[k] for k in names])
    dist.all_reduce(flat, group=group)
    total = dict(zip(names, flat))
    return ({k: metric_state[k].to(flat.device) + total[k] for k in names},
            total['loss_sum'] / total['count'])


def make_train_step(loss_fn: Callable,
                    teacher_apply: Optional[Callable] = None,
                    phase_hook: Optional[Callable[[str], None]] = None,
                    mesh: Any = None) -> Callable:
    """The train step: (state, data, target, metric_state) -> (state,
    metric_state, loss); the state is updated in place.

    Args:
        loss_fn: (output, target) -> scalar, or with a teacher
            (output, teacher_output, target) -> scalar.
        teacher_apply: optional frozen teacher forward, (data) -> logits
            (train.kd.make_teacher_apply).
        phase_hook: optional, called with 'forward', 'teacher',
            'backward', 'optimizer' and 'end' as each part of the step
            starts (and it ends), e.g. to record CUDA events. The step
            runs in a span of kind 'step' named 'train.step', each part
            in one of kind 'phase' (PHASE_SPANS) that opens and closes
            at the same marks (utils.profiling).
        mesh: optional DeviceMesh (parallel.make_mesh, or one with a
            'space' axis) whose 'data' ranks step together on one
            logical batch, whose 'model' ranks hold a model sharded over
            them and whose 'space' ranks a model banded over them
            (module docstring); the returned loss is then the global
            batch's.
    """
    group = data_group(mesh)
    banded = axis_size(mesh, 'space') > 1

    def step(state: TrainState, data: torch.Tensor, target: torch.Tensor,
             metric_state: dict) -> tuple[TrainState, dict, torch.Tensor]:
        with span('train.step', 'step'), _Phases(phase_hook) as mark:
            return marked(state, data, target, metric_state, mark)

    def marked(state: TrainState, data: torch.Tensor, target: torch.Tensor,
               metric_state: dict, mark: _Phases
               ) -> tuple[TrainState, dict, torch.Tensor]:
        model, optimizer = state.model.train(), state.optimizer
        if banded and getattr(model, 'space', None) is None:
            raise ValueError("the mesh has a 'space' axis but the model is "
                             'not banded: parallel.band_model(model, mesh)')
        state.tx.set_lr(optimizer, state.step)
        optimizer.zero_grad(set_to_none=True)
        mark('forward')
        with global_stats.over(group):
            output = model(data)
            if teacher_apply is None:
                loss = loss_fn(output, target)
            else:
                mark('teacher')
                loss = loss_fn(output, teacher_apply(data), target)
        mark('backward')
        loss.backward()
        spatial.sum_banded_grads(model)
        if group is not None:
            all_reduce_flat([p.grad for g in optimizer.param_groups
                             for p in g['params'] if p.grad is not None],
                            group, dist.get_world_size(group))
        mark('optimizer')
        optimizer.step()
        mark('end')
        state.step += 1
        loss = loss.detach()
        if group is None:
            return state, update_metric_state(metric_state, loss, output,
                                              target), loss
        metric_state, loss = _add_global(metric_state, update_metric_state(
            init_metric_state(), loss, output, target), group)
        return state, metric_state, loss

    return step


def make_eval_step(loss_fn: Callable, mesh: Any = None) -> Callable:
    """The eval step: (state, data, target, metric_state) ->
    (metric_state, output), the model in eval mode (cached and EMA
    scales, running statistics), nothing written. A banded model takes
    this rank's band and gives the whole logits.

    When loss_fn has a `.per_sample` form (the built-in losses do), rows
    with target < 0 (padding) are left out of the metrics. With a mesh,
    the metric increments are summed across its 'data' ranks."""
    per_sample = getattr(loss_fn, 'per_sample', None)
    group = data_group(mesh)

    @torch.no_grad()
    def step(state: TrainState, data: torch.Tensor, target: torch.Tensor,
             metric_state: dict) -> tuple[dict, torch.Tensor]:
        output = state.model.eval()(data)
        base = metric_state if group is None else init_metric_state()
        if per_sample is not None:
            safe_t = torch.clamp(target, min=0)
            new = update_metric_state_masked(
                base, per_sample(output, safe_t), output, target)
        else:
            new = update_metric_state(base, loss_fn(output, target),
                                      output, target)
        if group is not None:
            new, _ = _add_global(metric_state, new, group)
        return new, output

    return step


def train_epoch(train_step: Callable, state: TrainState,
                loader: Iterable, epoch: int, log_interval: int = 10,
                hooks: Optional[list[Hook]] = None,
                lr_schedule: Optional[Callable] = None,
                steps_per_epoch: Optional[int] = None,
                stop: Optional[Callable[[], bool]] = None,
                ) -> tuple[TrainState, dict[str, float]]:
    """Run one training epoch; returns (state, computed metrics).

    stop: polled before each batch; when it turns true the epoch ends
    early with the metrics accumulated so far.
    """
    hooks = hooks or []
    hook_metrics_ok = [_accepts_metrics(h) for h in hooks]
    metrics = MetricAccumulator()
    metric_state = metrics.state
    seen = 0
    n_total = getattr(loader, 'num_examples', None)
    device = state.device
    for batch_idx, (data, target) in enumerate(loader):
        if stop is not None and stop():
            logger.warning('Stop requested: ending epoch %d after %d '
                           'batches.', epoch, batch_idx)
            break
        data = _on(data, device)
        target = _on(target, device, torch.int64)
        state, metric_state, loss = train_step(state, data, target,
                                               metric_state)
        seen += data.shape[0]
        global_step = 1 + (epoch - 1) * (steps_per_epoch or 0) + batch_idx
        if hooks:
            metrics.state = metric_state
            lr = (float(lr_schedule(state.step - 1))
                  if lr_schedule else None)
            for hook, with_metrics in zip(hooks, hook_metrics_ok):
                kw = ({'metrics': {'train': metrics}}
                      if with_metrics else {})
                hook(epoch=epoch, global_step=global_step,
                     values_dict={'lr': lr}, log_interval=log_interval,
                     **kw)
        if batch_idx % log_interval == 0:
            logger.info('Train Epoch: %d [%d/%s]\tBatch Loss: %.6f',
                        epoch, seen, n_total or '?', float(loss))
    metrics.state = metric_state
    computed = metrics.compute()
    logger.info('Training set evaluation metrics: %s', computed)
    return state, computed


def evaluate(eval_step: Callable, state: TrainState, loader: Iterable,
             epoch: int = 1, hooks: Optional[list[Hook]] = None,
             stop: Optional[Callable[[], bool]] = None,
             pad_rows_to: Optional[int] = None) -> dict[str, float]:
    """Evaluate on a held-out set; returns computed metrics.

    pad_rows_to: pad each batch's rows up to a multiple of this with
    rows of target -1, which the masked metrics leave out (valid only
    with a loss that has `.per_sample`).
    """
    hooks = hooks or []
    metrics = MetricAccumulator()
    metric_state = metrics.state
    device = state.device
    batch_idx = 0
    for batch_idx, (data, target) in enumerate(loader):
        if stop is not None and stop():
            logger.warning('Stop requested: ending eval at epoch %d '
                           'after %d batches.', epoch, batch_idx)
            break
        data = _on(data, device)
        target = _on(target, device, torch.int64)
        if pad_rows_to and data.shape[0] % pad_rows_to:
            extra = pad_rows_to - data.shape[0] % pad_rows_to
            data = torch.cat([data, data.new_zeros(
                (extra,) + tuple(data.shape[1:]))])
            target = torch.cat([target, target.new_full((extra,), -1)])
        metric_state, _ = eval_step(state, data, target, metric_state)
    metrics.state = metric_state
    computed = metrics.compute()
    for hook in hooks:
        kw = ({'metrics': {'test': metrics}}
              if _accepts_metrics(hook) else {})
        hook(epoch=epoch, global_step=batch_idx + 1, **kw)
    logger.info('Test set evaluation metrics: %s', computed)
    return computed
