"""Train-mode statistics over the global batch.

The JAX package's data-parallel train step is one program over the
global batch, so BatchNorm's E[x] and E[x^2] and the activation
quantizers' EMA batch means are means over every rank's rows. The port's
step runs one process a rank: inside `over(group)` the layers reduce
their sums across the group (BatchNorm's through an autograd-aware
all-reduce, so the backward carries the other ranks' share, as JAX's
gradient of the global mean does). Every rank
holds the same number of rows (the train loaders drop the ragged tail).
Outside it, and for a group of None, the layers reduce locally and no
collective is dispatched.

A model banded over 'space' (parallel.spatial) holds each image's rows
on several ranks: while its forward runs on bands (`banded(space)`,
entered by spatial.forward, and `space.banded`), a statistic over the
batch's pixels also sums over the 'space' group, so it is the whole
image's; after the map is gathered the ranks hold whole images and the
statistics reduce over the 'data' group alone. Values each 'space' rank
holds whole (the per-sample activation scales) never sum over 'space'.
A block recomputed in the backward pass (nn.resnet.remat_block) runs
after its forward's contexts have ended: it reads them here (`current`,
`current_space`) when the forward runs and re-enters them (`over`,
`banded`) when it recomputes.
"""

import contextlib
import functools
from typing import Any, Callable, Iterator, Optional

import torch
import torch.distributed as dist

_GROUP: Optional[dist.ProcessGroup] = None
_SPACE: Any = None  # the SpatialParallel of the banded forward running


@contextlib.contextmanager
def over(group: Optional[dist.ProcessGroup]) -> Iterator[None]:
    """Reduce train-mode statistics across `group` inside."""
    global _GROUP
    saved, _GROUP = _GROUP, group
    try:
        yield
    finally:
        _GROUP = saved


@contextlib.contextmanager
def banded(space: Any) -> Iterator[None]:
    """Inside, while `space.banded` holds, pixel statistics also reduce
    over `space.group` (a parallel.spatial.SpatialParallel, or None)."""
    global _SPACE
    saved, _SPACE = _SPACE, space
    try:
        yield
    finally:
        _SPACE = saved


def current() -> Optional[dist.ProcessGroup]:
    """The group that train-mode statistics are reduced over now (None:
    locally); a recomputation in the backward pass (nn.resnet.remat_block)
    restores the one its forward ran under."""
    return _GROUP


def current_space() -> Any:
    """The SpatialParallel of the banded forward running now (None outside
    one); a recomputation re-enters it with `banded`."""
    return _SPACE


def groups(pixels: bool = True) -> tuple[dist.ProcessGroup, ...]:
    """The groups a statistic reduces over now, in order: 'space' while
    the forward is banded (for statistics over pixels), then 'data'."""
    out = () if _GROUP is None else (_GROUP,)
    if pixels and _SPACE is not None and _SPACE.banded:
        out = (_SPACE.group,) + out
    return out


class _AllReduceSum(torch.autograd.Function):
    """Sum across the group's ranks; the backward sums the gradient the
    same way, so each rank's share of the sum receives every rank's
    gradient (the derivative of the global sum). Each rank's gradient
    here is its own rows' share: over 'data' its own loss's, over
    'space' its band's. `tally`, if given, is told each collective's
    tensor (SpatialParallel.tally)."""

    @staticmethod
    def forward(ctx: Any, x: torch.Tensor, group: dist.ProcessGroup,
                tally: Optional[Callable[[torch.Tensor], None]] = None
                ) -> torch.Tensor:
        ctx.group, ctx.tally = group, tally
        out = x.clone()
        if tally is not None:
            tally(out)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx: Any, grad: torch.Tensor) -> tuple:
        grad = grad.contiguous().clone()
        if ctx.tally is not None:
            ctx.tally(grad)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None, None


def batch_means(xs: list[torch.Tensor], dims: tuple[int, ...],
                differentiable: bool = True,
                pixels: bool = True) -> list[torch.Tensor]:
    """Each x's mean over dims (the batch dimension among them) across
    the ranks that hold its rows (`groups(pixels)`): x.mean(dims)
    locally, else the sums all-reduced, one collective a group, over the
    global count. `pixels` False: x holds per-sample values that every
    'space' rank has whole."""
    reduce_over = groups(pixels)
    if not reduce_over:
        return [x.mean(dim=dims) for x in xs]
    sums = [x.sum(dim=dims) for x in xs]
    sizes = [s.numel() for s in sums]
    flat = torch.cat([s.reshape(-1) for s in sums])
    if not differentiable:
        flat = flat.detach().clone()
    rows = xs[0].numel() // sums[0].numel()
    for group in reduce_over:
        tally = None
        if _SPACE is not None and group is _SPACE.group:
            tally = functools.partial(_SPACE.tally, 'statistics')
        if differentiable:
            flat = _AllReduceSum.apply(flat, group, tally)
        else:
            if tally is not None:
                tally(flat)
            dist.all_reduce(flat, group=group)
        rows *= dist.get_world_size(group)
    return [part.reshape(s.shape) / rows
            for part, s in zip(flat.split(sizes), sums)]
