"""Sharding rules and tensor-parallel placement (port of
quant_tpu/parallel/sharding.py).

DP: the batch axis of (N, H, W, C) inputs sharded over mesh axis 'data'.
TP: the trailing out-channel axis of conv and dense kernels and biases,
of the per-out-channel weight-scale stacks in 'quant_state' and of the
packed words and their scales in 'packed_params', sharded over mesh
axis 'model'. `shard_model_variables` gives each leaf of a JAX-layout
variable tree its placements over the DeviceMesh by JAX's rules
(DTensor's `Replicate()` / `Shard(dim)`, a NamedSharding's counterpart).

JAX places these shardings and GSPMD inserts the all-gathers at the fp
boundaries. The port runs one process a card, so tensor parallelism is
explicit:

* `place` cuts a tree to this rank's contiguous slices, `gather`
  rebuilds the full tree on every rank of the 'model' group;
* `shard_model` holds a model's sharded leaves as this rank's slices:
  each Conv, Dense and QuantConv2d computes its slice of the output
  channels and all-gathers it over the 'model' group in rank order
  (`gather_channels`) before the next fp op, and a BatchNorm gathers its
  sharded bias. Everything JAX replicates (BN statistics and scales,
  PReLU slopes, EMA scales, the thresholds of a threshold fold, b_fold)
  stays whole and is computed in full on every rank of the group; a
  conv's epilogue takes its slice of b_fold;
* `gather_model_variables` and `gather_optimizer_state` give a sharded
  model's tree and optimizer state in the unsharded layout (the one a
  checkpoint has whatever the sharding), `place_optimizer_state` cuts
  such a state back to this rank's slices.

The gather's backward is this rank's slice of the incoming gradient,
with no collective: every rank of the group computes the same
replicated consumer, so the gradient it receives is already the whole
one. (torch.distributed.nn.functional.all_gather sums the gradients of
the group's ranks in its backward, which gives P times the gradient
here.) The sharded layer's input is whole and the same on every rank,
but each rank's backward through its slice of the layer gives it only
that slice's part of the input's gradient: `reduce_input_grad` sums the
parts over the group in the backward (identity forward), where GSPMD
inserts the same all-reduce.
"""

from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from quant_tpu_torch.parallel.mesh import axis_size, refuse_grouped_convs
from quant_tpu_torch.utils.jax_import import leaf_slots, to_jax_variables

Placements = tuple  # one Placement a mesh dimension


def replicated(mesh: DeviceMesh) -> Placements:
    return (Replicate(),) * mesh.ndim


def _placements(mesh: DeviceMesh, axis: str, dim: int) -> Placements:
    out = list(replicated(mesh))
    out[mesh.mesh_dim_names.index(axis)] = Shard(dim)
    return tuple(out)


def batch_sharding(mesh: DeviceMesh) -> Placements:
    """Shard the leading (batch) axis over 'data'."""
    return _placements(mesh, 'data', 0)


def _kernel_dim(name: str, ndim: int) -> Optional[int]:
    """Out-channel (trailing-axis) sharding for conv/dense kernels."""
    if name == 'kernel' and ndim >= 2:
        return ndim - 1
    if name == 'bias' and ndim == 1:
        return 0
    return None


def _quant_state_dim(name: str, ndim: int) -> Optional[int]:
    """Weight-scale stacks are (k, out_channels): shard out-channels;
    activation EMA etc. replicated."""
    return 1 if name == 'vs' and ndim == 2 else None


def _packed_dim(name: str, ndim: int) -> Optional[int]:
    """w_packed (kh, kw, Wd, O) or (k_w, kh, kw, Wd, O) and w_scales
    (k_w, O) shard over their trailing O axis; the fold's x_thresh,
    x_flip, x_va (per input channel) and b_fold stay replicated."""
    if name == 'w_packed' and ndim >= 4:
        return ndim - 1
    if name == 'w_scales' and ndim == 2:
        return 1
    return None


_RULES = {'params': _kernel_dim, 'quant_state': _quant_state_dim,
          'packed_params': _packed_dim}


def shard_dim(collection: str, path: Sequence[str],
              ndim: int) -> Optional[int]:
    """The axis of a leaf that JAX's rules shard over 'model', or None
    where the leaf is replicated."""
    rule = _RULES.get(collection)
    return None if rule is None else rule(path[-1], ndim)


def _map_tree(fn: Any, variables: dict) -> dict:
    """fn(collection, path, leaf) over every leaf of a variable tree."""
    def walk(coll: str, tree: Any, path: tuple) -> Any:
        if isinstance(tree, dict):
            return {k: walk(coll, v, path + (k,)) for k, v in tree.items()}
        return fn(coll, path, tree)
    return {coll: walk(coll, tree, ()) for coll, tree in variables.items()}


def shard_model_variables(variables: dict[str, Any], mesh: DeviceMesh,
                          tensor_parallel: bool = False) -> dict[str, Any]:
    """Placements over `mesh` for a model-variable tree, leaf for leaf.

    With tensor_parallel=False everything is replicated (pure DP). With
    tensor_parallel=True, kernels/biases and per-out-channel quantizer
    scales shard over 'model'.
    """
    def placement(coll: str, path: tuple, leaf: Any) -> Placements:
        dim = shard_dim(coll, path, np.ndim(leaf))
        if not tensor_parallel or dim is None:
            return replicated(mesh)
        return _placements(mesh, 'model', dim)
    return _map_tree(placement, variables)


def partition_spec(placements: Placements, ndim: int,
                   mesh: DeviceMesh) -> tuple:
    """A leaf's placements as JAX's PartitionSpec entries: one mesh axis
    name (or None) a tensor axis."""
    spec: list = [None] * ndim
    for axis, p in zip(mesh.mesh_dim_names, placements):
        if isinstance(p, Shard):
            spec[p.dim] = axis
    return tuple(spec)


@dataclass(frozen=True)
class TensorParallel:
    """This rank's place in its 'model' group: the group, its size and
    this rank's coordinate (its index in the group's rank order)."""

    group: dist.ProcessGroup
    size: int
    index: int

    def __deepcopy__(self, memo: dict) -> 'TensorParallel':
        return self  # a copied model shares the process group


def tensor_parallel(mesh: Optional[DeviceMesh], axis: str = 'model'
                    ) -> Optional[TensorParallel]:
    """This rank's group along a mesh axis ('model' by default), None
    where the axis has one rank (no collective is dispatched)."""
    if axis_size(mesh, axis) == 1:
        return None
    group = mesh.get_group(axis)
    return TensorParallel(group, dist.get_world_size(group),
                          dist.get_rank(group))


def all_gather_cat(t: torch.Tensor, dim: int,
                   tp: TensorParallel) -> torch.Tensor:
    """The group's slices of t concatenated along dim, in rank order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(tp.size)]
    dist.all_gather(parts, t, group=tp.group)
    return torch.cat(parts, dim=dim)


class _GatherChannels(torch.autograd.Function):
    """All-gather along the last axis; the backward is this rank's slice
    of the gradient, with no collective (module docstring)."""

    @staticmethod
    def forward(ctx: Any, x: torch.Tensor,
                tp: TensorParallel) -> torch.Tensor:
        ctx.tp = tp
        return all_gather_cat(x, -1, tp)

    @staticmethod
    def backward(ctx: Any, grad: torch.Tensor) -> tuple:
        tp = ctx.tp
        return grad.chunk(tp.size, -1)[tp.index].contiguous(), None


class _ReduceInputGrad(torch.autograd.Function):
    """Identity; the backward sums the gradient over the group."""

    @staticmethod
    def forward(ctx: Any, x: torch.Tensor,
                tp: TensorParallel) -> torch.Tensor:
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx: Any, grad: torch.Tensor) -> tuple:
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.tp.group)
        return grad, None


def reduce_input_grad(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """x, whose gradient is summed over the 'model' group in the backward:
    the input of a layer sharded over its output channels (module
    docstring). x itself where no gradient is recorded."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _ReduceInputGrad.apply(x, tp)


def gather_channels(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """The 'model' group's out-channel slices of x (NHWC: the last axis)
    concatenated in rank order, on every rank of the group."""
    return _GatherChannels.apply(x, tp)


def _local(leaf: Any, dim: int, tp: TensorParallel) -> Any:
    """This rank's slice of a numpy array or tensor along dim, as a
    contiguous copy (the kernels' wrappers take contiguous operands, and
    a slice of the trailing axis is not)."""
    n = leaf.shape[dim]
    if n % tp.size:
        raise ValueError(f'axis {dim} of a {tuple(leaf.shape)} leaf does '
                         f'not divide over {tp.size} ranks')
    per = n // tp.size
    if isinstance(leaf, torch.Tensor):
        return leaf.narrow(dim, tp.index * per, per).clone(
            memory_format=torch.contiguous_format)
    return np.ascontiguousarray(np.take(
        leaf, range(tp.index * per, (tp.index + 1) * per), axis=dim))


def _gather_array(leaf: Any, dim: int, tp: TensorParallel) -> Any:
    """all_gather_cat of a numpy array or tensor; the collective runs on
    the card where the group's backend is NCCL."""
    t = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(leaf))
    comm = (torch.device('cuda', torch.cuda.current_device())
            if dist.get_backend(tp.group) == 'nccl' else t.device)
    full = all_gather_cat(t.to(comm), dim, tp).to(t.device)
    return full if isinstance(leaf, torch.Tensor) else full.numpy()


def place(variables: dict[str, Any], mesh: Optional[DeviceMesh]
          ) -> dict[str, Any]:
    """This rank's contiguous slices of a variable tree (numpy arrays or
    tensors) under tensor_parallel=True; the tree as it is where the
    'model' axis has one rank."""
    tp = tensor_parallel(mesh)

    def local(coll: str, path: tuple, leaf: Any) -> Any:
        dim = None if tp is None else shard_dim(coll, path, np.ndim(leaf))
        return leaf if dim is None else _local(leaf, dim, tp)
    return _map_tree(local, variables)


def gather(variables: dict[str, Any], mesh: Optional[DeviceMesh]
           ) -> dict[str, Any]:
    """The full tree from every rank's `place`d slices (a collective over
    the 'model' group, one a sharded leaf)."""
    tp = tensor_parallel(mesh)

    def full(coll: str, path: tuple, leaf: Any) -> Any:
        dim = None if tp is None else shard_dim(coll, path, np.ndim(leaf))
        return leaf if dim is None else _gather_array(leaf, dim, tp)
    return _map_tree(full, variables)


def shard_model(model: nn.Module, mesh: Optional[DeviceMesh]) -> nn.Module:
    """Hold the model's sharded leaves as this rank's slices and turn on
    the gathers (module docstring); in place, returns the model.

    Every family and both its serving and train forms: a model built or
    loaded whole (weights, statistics, an export's packed words and
    folds) is sharded once, as JAX places its variables after init and
    after every restore. A 'model' axis of one rank leaves it as it is.
    Sets `model.tp` (TensorParallel) and `model.tp_slots`, the (module,
    attribute, collection, path, axis) of each sharded leaf. A grouped
    conv raises ValueError (mesh.refuse_grouped_convs).
    """
    if axis_size(mesh, 'model') == 1:
        return model
    refuse_grouped_convs(model, 'shard_model')
    tp = tensor_parallel(mesh)
    if getattr(model, 'tp', None) is not None:
        raise ValueError('the model is sharded already')
    slots = []
    for module, attr, coll, path, _ in leaf_slots(model):
        value = getattr(module, attr)
        dim = None if value is None else shard_dim(coll, path, value.ndim)
        if dim is None:
            continue
        local = _local(value.detach(), dim, tp)
        if attr in module._parameters:
            local = nn.Parameter(local, requires_grad=value.requires_grad)
        setattr(module, attr, local)
        module.tp = tp
        slots.append((module, attr, coll, path, dim))
    model.tp, model.tp_slots = tp, slots
    return model


def gather_model_variables(model: nn.Module) -> dict[str, Any]:
    """to_jax_variables of the model in the unsharded layout: a sharded
    model's slices gathered (a collective over its 'model' group, one a
    sharded leaf: every rank of the group calls it)."""
    tree = to_jax_variables(model)
    tp = getattr(model, 'tp', None)
    for _, _, coll, path, dim in getattr(model, 'tp_slots', ()):
        node = tree[coll]
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = _gather_array(node[path[-1]], dim, tp)
    return tree


def _map_optimizer_state(model: nn.Module, optimizer: torch.optim.Optimizer,
                         state_dict: dict, fn: Any) -> dict:
    """state_dict with fn(value, param, axis, tp) on each state entry of
    a sharded parameter (fn leaves what is not a moment as it is)."""
    tp = getattr(model, 'tp', None)
    if tp is None:
        return state_dict
    dims = {id(getattr(m, attr)): dim for m, attr, _, _, dim in model.tp_slots}
    params = [p for g in optimizer.param_groups for p in g['params']]
    state = {}
    for idx in sorted(state_dict['state']):
        # An entry past this optimizer's parameters (another model's
        # state) is left for load_state_dict to refuse.
        p = params[idx] if idx < len(params) else None
        dim = dims.get(id(p))
        state[idx] = {k: fn(v, p, dim, tp) if dim is not None else v
                      for k, v in state_dict['state'][idx].items()}
    return {**state_dict, 'state': state}


def gather_optimizer_state(model: nn.Module,
                           optimizer: torch.optim.Optimizer) -> dict:
    """optimizer.state_dict() in the unsharded layout: each moment of a
    sharded parameter (a state tensor of its shape) gathered over the
    'model' group (every rank of the group calls it)."""
    def full(v: Any, p: torch.Tensor, dim: int, tp: TensorParallel) -> Any:
        if isinstance(v, torch.Tensor) and v.shape == p.shape:
            return _gather_array(v, dim, tp)
        return v
    return _map_optimizer_state(model, optimizer, optimizer.state_dict(),
                                full)


def place_optimizer_state(model: nn.Module, optimizer: torch.optim.Optimizer,
                          state_dict: dict) -> dict:
    """An unsharded optimizer state_dict cut to this rank's slices for a
    sharded model (the inverse of gather_optimizer_state)."""
    def local(v: Any, p: torch.Tensor, dim: int, tp: TensorParallel) -> Any:
        if (isinstance(v, torch.Tensor) and v.ndim == p.ndim
                and v.shape[dim] == p.shape[dim] * tp.size):
            return _local(v, dim, tp)
        return v
    return _map_optimizer_state(model, optimizer, state_dict, local)
