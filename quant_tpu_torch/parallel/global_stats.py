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
"""

import contextlib
from typing import Any, Iterator, Optional

import torch
import torch.distributed as dist

_GROUP: Optional[dist.ProcessGroup] = None


@contextlib.contextmanager
def over(group: Optional[dist.ProcessGroup]) -> Iterator[None]:
    """Reduce train-mode statistics across `group` inside."""
    global _GROUP
    saved, _GROUP = _GROUP, group
    try:
        yield
    finally:
        _GROUP = saved


def current() -> Optional[dist.ProcessGroup]:
    """The group that train-mode statistics are reduced over now (None:
    locally); a recomputation in the backward pass (nn.resnet.remat_block)
    restores the one its forward ran under."""
    return _GROUP


class _AllReduceSum(torch.autograd.Function):
    """Sum across the group's ranks; the backward sums the gradient the
    same way, so each rank's share of the sum receives every rank's
    gradient (the derivative of the global sum)."""

    @staticmethod
    def forward(ctx: Any, x: torch.Tensor,
                group: dist.ProcessGroup) -> torch.Tensor:
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx: Any, grad: torch.Tensor) -> tuple:
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def batch_means(xs: list[torch.Tensor], dims: tuple[int, ...],
                differentiable: bool = True) -> list[torch.Tensor]:
    """Each x's mean over dims (the batch dimension among them) across
    the group's ranks: x.mean(dims) locally, else the sums all-reduced in
    one collective over the global row count."""
    if _GROUP is None:
        return [x.mean(dim=dims) for x in xs]
    sums = [x.sum(dim=dims) for x in xs]
    sizes = [s.numel() for s in sums]
    flat = torch.cat([s.reshape(-1) for s in sums])
    if differentiable:
        flat = _AllReduceSum.apply(flat, _GROUP)
    else:
        flat = flat.detach().clone()
        dist.all_reduce(flat, group=_GROUP)
    rows = xs[0].numel() // sums[0].numel() * dist.get_world_size(_GROUP)
    return [part.reshape(s.shape) / rows
            for part, s in zip(flat.split(sizes), sums)]
