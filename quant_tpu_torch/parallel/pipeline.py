"""Pipeline parallelism: GPipe-microbatched stages over a 'pipe' axis (port
of quant_tpu/parallel/pipeline.py).

Per-stage parameters are stacked along a leading axis of S
(`stack_stage_params`); rank d of the 'pipe' group computes with row d.
The schedule is JAX's plain GPipe: with S stages and M microbatches it
runs M + S - 1 ticks, stage d works on microbatch t - d at tick t while
0 <= t - d < M, and its output moves one hop downstream by point to
point ops between ticks. Stage 0 ingests microbatch t; the last stage
banks microbatch t - (S - 1); an all-reduce over the group (JAX's psum
of the last stage's buffer and everyone else's zeros) replicates the
outputs. JAX runs every stage on every tick and discards the bubble's
work; here a stage computes only on its busy ticks, and a pair of
neighbours exchanges only what is real, so both sides issue the same
ops in the same order.

Why one autograd Function over the whole schedule: JAX differentiates
its scan and ppermute, and the transpose is the reverse pipeline. With
one torch Function a send and one a receive, stage 0's graph would
never reach the backward of its send (stage 0 ignores what it
receives), so stage 1 would wait forever for stage 0 to take its
gradient, and stage 0's parameters would get none. `pipeline_apply` is
therefore one Function over the flattened stage parameters and the
microbatches: its forward runs the ticks and keeps each busy tick's
input; its backward runs the reverse schedule explicitly, ticks last to
first: it recomputes the stage under autograd, takes the gradients with
torch.autograd.grad and sends the input's cotangent one hop upstream.

The replicating all-reduce's backward is the identity: every rank
computes its loss from its own replicated copy of the outputs, so the
last stage takes the gradient it holds as its outputs' cotangent; a
summing backward would give it S times that cotangent, and every stage
upstream S times its gradient (the trap of parallel.sharding's gather).
The stacked parameters' gradients are whole on every rank (rank d
computes row d, and the rows are summed over the group), the gradient
of JAX's global stacked array; the
microbatches' gradient is stage 0's, on every rank. With `batch_axis`
each coordinate of that axis pipelines its own rows of every microbatch
(dp x pp); the gradients are then this coordinate's, which a
data-parallel step reduces as it reduces any other.

Stage homogeneity contract (JAX's): every stage maps activations of one
shape and dtype to the same shape and dtype, and the per-stage parameter
trees share one structure. A stage may be a module's functional form,
`torch.func.functional_call(block, params_d, (x,))` over its parameters
and buffers (packed words and thresholds are buffers).
"""

from typing import Any, Callable, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.utils import _pytree as pytree

from quant_tpu_torch.parallel.mesh import AxisGroup, axis_index, axis_size
from quant_tpu_torch.parallel.sharding import Placements, _placements

StageFn = Callable[[Any, torch.Tensor], torch.Tensor]


def stage_sharding(mesh: DeviceMesh, axis: str = 'pipe') -> Placements:
    """Placements of stage-stacked parameters: the leading axis split over
    `axis`."""
    return _placements(mesh, axis, 0)


def stack_stage_params(per_stage: list) -> Any:
    """Stack S per-stage parameter trees along a new leading axis."""
    leaves, spec = zip(*(pytree.tree_flatten(t) for t in per_stage))
    if any(s != spec[0] for s in spec):
        raise ValueError('per-stage parameter trees differ in structure')
    return pytree.tree_unflatten([torch.stack(xs) for xs in zip(*leaves)],
                                 spec[0])


def _replicated_grad(grad: torch.Tensor, pipe: AxisGroup) -> torch.Tensor:
    """The cotangent of the replicated outputs on this rank: its own
    gradient (module docstring)."""
    return grad


def _busy(d: int, t: int, m: int) -> bool:
    return d <= t < d + m


class _Pipeline(torch.autograd.Function):
    """The GPipe schedule over microbatches and flattened stage params."""

    @staticmethod
    def forward(ctx: Any, stage_fn: StageFn, spec: Any, pipe: AxisGroup,
                mb: torch.Tensor, *leaves: torch.Tensor) -> torch.Tensor:
        s, d, m = pipe.size, pipe.index, mb.shape[0]
        params = pytree.tree_unflatten([v[d] for v in leaves], spec)
        keep = any(ctx.needs_input_grad[3:])
        inputs, outs = [], torch.zeros_like(mb)
        incoming = None
        for t in range(m + s - 1):
            y = None
            if _busy(d, t, m):
                x = mb[t] if d == 0 else incoming
                if keep:
                    inputs.append(x)
                y = stage_fn(params, x)
                if d == s - 1:
                    outs[t - d] = y
            sends = [(y, d + 1)] if y is not None and d < s - 1 else []
            recvs = ([(mb[0], d - 1)] if d > 0 and _busy(d - 1, t, m)
                     else [])
            got = pipe.exchange(sends, recvs)
            incoming = got[0] if got else None
        dist.all_reduce(outs, group=pipe.group)
        ctx.stage_fn, ctx.spec, ctx.pipe = stage_fn, spec, pipe
        ctx.inputs = inputs
        ctx.save_for_backward(*leaves)
        return outs

    @staticmethod
    def backward(ctx: Any, grad: torch.Tensor) -> tuple:
        pipe, leaves = ctx.pipe, ctx.saved_tensors
        s, d = pipe.size, pipe.index
        m = grad.shape[0]
        grad = _replicated_grad(grad, pipe)
        needs = ctx.needs_input_grad[4:]
        rows = [v[d].detach().requires_grad_(n)
                for v, n in zip(leaves, needs)]
        wrt = [r for r in rows if r.requires_grad]
        sums = [torch.zeros_like(r) for r in wrt]
        gmb = torch.zeros_like(grad) if ctx.needs_input_grad[3] else None
        cot = None
        for t in reversed(range(m + s - 1)):
            gx = None
            if _busy(d, t, m):
                j = t - d
                x = ctx.inputs[j].detach().requires_grad_(True)
                with torch.enable_grad():
                    y = ctx.stage_fn(pytree.tree_unflatten(rows, ctx.spec),
                                     x)
                    got = torch.autograd.grad(
                        y, [x] + wrt, grad[j] if d == s - 1 else cot,
                        allow_unused=True)
                gx = got[0] if got[0] is not None else torch.zeros_like(x)
                for acc, g in zip(sums, got[1:]):
                    if g is not None:
                        acc.add_(g)
                if d == 0 and gmb is not None:
                    gmb[j] = gx
            sends = [(gx, d - 1)] if gx is not None and d > 0 else []
            recvs = ([(grad[0], d + 1)] if d < s - 1 and _busy(d + 1, t, m)
                     else [])
            got = pipe.exchange(sends, recvs)
            cot = got[0] if got else None
        grads = []
        it = iter(sums)
        for v, n in zip(leaves, needs):
            if not n:
                grads.append(None)
                continue
            g = torch.zeros_like(v)
            g[d] = next(it)
            dist.all_reduce(g, group=pipe.group)
            grads.append(g)
        if gmb is not None:
            dist.all_reduce(gmb, group=pipe.group)
        return (None, None, None, gmb, *grads)


def pipeline_apply(stage_fn: StageFn, stage_params: Any,
                   microbatches: torch.Tensor, *, mesh: DeviceMesh,
                   axis: str = 'pipe',
                   batch_axis: Optional[str] = None) -> torch.Tensor:
    """Run microbatches through a stage-stacked pipeline.

    Args:
        stage_fn: ``(params_for_one_stage, x) -> y`` with ``y.shape ==
            x.shape`` and the same dtype (homogeneity contract).
        stage_params: a tree (dicts, lists, tuples) of tensors whose
            leading dim is S (one slice per stage), the same on every
            rank; rank d computes with slice d.
        microbatches: (M, mb, ...) stacked microbatch inputs, the same on
            every rank. With `batch_axis` each coordinate of that axis
            pipelines its own mb / D rows (true dp x pp).
        mesh: mesh containing `axis` of size S.

    Returns:
        (M, mb, ...) outputs after all S stages (this coordinate's rows
        under `batch_axis`), the same on every rank of the 'pipe' group.
    """
    s = axis_size(mesh, axis)
    m = microbatches.shape[0]
    leaves, spec = pytree.tree_flatten(stage_params)
    leading = {leaf.shape[0] if leaf.ndim else None for leaf in leaves}
    if leading != {s}:
        raise ValueError(
            f'stage_params leaves must all have leading dim {s} '
            f'(= mesh.shape[{axis!r}], one slice per stage); got leading '
            f'dims {sorted(leading, key=str)}. A leading dim of k*{s} would '
            'silently give each device k stages and drop all but the first.')
    if m < 1:
        raise ValueError('microbatches must have leading dim M >= 1')
    if batch_axis is not None:
        dsz, j = axis_size(mesh, batch_axis), axis_index(mesh, batch_axis)
        if microbatches.shape[1] % dsz:
            raise ValueError(f'microbatch rows {microbatches.shape[1]} must '
                             f'divide by {dsz}')
        per = microbatches.shape[1] // dsz
        microbatches = microbatches[:, j * per:(j + 1) * per]
    if s == 1:
        params = pytree.tree_unflatten([v[0] for v in leaves], spec)
        return torch.stack([stage_fn(params, x) for x in microbatches])
    return _Pipeline.apply(stage_fn, spec, AxisGroup(mesh, axis),
                           microbatches.contiguous(), *leaves)
