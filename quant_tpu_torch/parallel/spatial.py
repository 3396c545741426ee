"""Spatial partitioning: H-banded convs and pools with halo exchange (port
of quant_tpu/parallel/spatial.py).

Each rank of a 'space' group holds an H/P row band of the NHWC
activations and trades the boundary rows a window needs with its
neighbours (non-cyclic: the image's own top and bottom rows are padding,
not halos). JAX has two forms, and so has the port:

* `halo_exchange_conv2d` / `halo_exchange_max_pool2d` take this rank's
  band (JAX's take the global array, H sharded over `axis`) and return
  its band of the output: the halo rows exchanged (`halo_rows`, a
  differentiable exchange whose backward sends each halo row's gradient
  back to its owner, as JAX's ppermute transposes), the image's edges
  filled with the pad value, then a local conv or pool.
* `spatial_sharding(mesh)` is how JAX runs a whole model banded, served
  or trained: the input H-banded, GSPMD partitioning every layer and
  its backward. The port has no GSPMD, so `band_model` bands a model in
  place, layer by layer: the fp convs, the quantized convs, the stem
  pool and the global average pool run on bands, each exchanging its
  own halo rows. A packed conv exchanges its input's packed sign words,
  not the activations (a pixel's words depend on that pixel alone: C/32
  int32 a pixel instead of C values), and runs its kernel with the
  band's own top padding (ops.binary_infer.RowBand): the binary operand
  is zero-padded, a 0 a packed word cannot hold, so the edges are the
  kernel's padding and never a filled row. Where a layer's geometry does
  not hold on the band (a stride that does not divide the band's
  height, a conv that is not shape-preserving), the map is all-gathered
  over 'space' once and the rest of the forward runs whole on every
  rank: for the ResNets at 224 px and P = 2 the stem, the pool and
  layer1-3 band and layer4 and the head run whole; LeNet-5's VALID convs
  gather before conv1. The global average pool all-reduces its band's
  sums; a per-batch activation solve reads the whole sample, so every
  rank has the same scales.

Train mode (JAX's step on a `spatial_sharding`-placed batch, which GSPMD
partitions forward and backward): a quantized conv quantizes its band
with the whole sample's scales (solved without a gradient, as JAX's
stop_gradient), exchanges the halo rows of the quantized operand and
runs the dense conv with zero edges; train-mode statistics reduce over
'space' while the forward is banded (parallel.global_stats). Each
collective's backward is what its consumer needs, not a property of the
collective: the statistics' all-reduce sums its gradient (each band
holds only its rows' share of the gradient of the mean); the gather's
backward is this rank's rows of the gradient and the average pool's
all-reduce has the identity backward, because everything after them
runs replicated and every rank already holds the whole gradient. A
parameter of a module that ran on bands holds only its band's share of
the gradient, summed over 'space' by `sum_banded_grads`; one of the
whole section holds the whole gradient already. `band_model` records,
each forward, which modules ran on bands. With `remat` (JAX's
`nn.remat`, which GSPMD partitions like the rest of the step) a block is
recomputed in the backward pass, after `forward` has ended: `recompute`
puts back the banded state the block ran under, so the recomputation
exchanges the same halos and reduces the same statistics and solves over
'space' as the forward did.

Geometry contract (JAX's): output height H // stride ("shape-preserving
modulo stride"); 3x3/s1/p1, 3x3/s2/p1, 1x1/s2/p0, 7x7/s2/p3, 5x5/s1/p2
and the 3x3/s2/p1 pool hold. A group whose backend moves only host
memory point to point (gloo) sends the rows through host copies.
Collectives run in the same order on every rank, forward and backward:
every rank of the group must run the same forwards.
"""

import contextlib
from typing import Any, Iterator, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Shard

from quant_tpu_torch.ops.binary_infer import RowBand
from quant_tpu_torch.ops import conv as C
from quant_tpu_torch.ops.conv import IntOr2, _pair, conv2d, max_pool2d
from quant_tpu_torch.ops.quantize import _rows32, solve_scales
from quant_tpu_torch.parallel import global_stats
from quant_tpu_torch.parallel.mesh import (
    AxisGroup, all_reduce_flat, axis_index, axis_size, refuse_grouped_convs,
)
from quant_tpu_torch.parallel.sharding import (
    Placements, all_gather_cat, replicated,
)

H = -3  # the H axis of NHWC maps and of (k, N, H, W, Wc) packed words


def spatial_sharding(mesh: DeviceMesh, axis: str = 'space',
                     batch_axis: Optional[str] = None) -> Placements:
    """NHWC activation placements with the H axis split over `axis` (and
    the batch over `batch_axis`)."""
    out = list(replicated(mesh))
    out[mesh.mesh_dim_names.index(axis)] = Shard(1)
    if batch_axis is not None:
        out[mesh.mesh_dim_names.index(batch_axis)] = Shard(0)
    return tuple(out)


class SpatialParallel(AxisGroup):
    """This rank's place in its 'space' group (AxisGroup) and whether the
    model's current forward still runs on bands (`banded`, set by
    `forward`); `collectives` counts the collectives on the group by
    kind ('halo', 'statistics', 'solves', 'gather', 'average pool',
    'gradient sum'), forward and backward, as [collectives this rank
    took part in, bytes it contributed]; `recomputed` counts those of the
    blocks recomputed in the backward pass (`recompute`) apart. A halo
    exchange counts once on every rank that sends or receives a row.
    `ran_banded` holds the ids of the modules that ran on bands in the
    model's last forward (`band_model`'s hooks)."""

    def __init__(self, mesh: DeviceMesh, axis: str):
        super().__init__(mesh, axis)
        self.banded = False
        self.recomputing = False
        self.collectives: dict[str, list[int]] = {}
        self.recomputed: dict[str, list[int]] = {}
        self.ran_banded: set[int] = set()

    def tally(self, kind: str, *ts: torch.Tensor) -> None:
        """Count one collective of `kind` moving the tensors ts from this
        rank (in `recomputed` while a block is recomputed)."""
        rec = (self.recomputed if self.recomputing
               else self.collectives).setdefault(kind, [0, 0])
        rec[0] += 1
        rec[1] += sum(t.numel() * t.element_size() for t in ts)

    def note(self, module: nn.Module, args: Any, out: Any) -> None:
        """Forward hook: record `module` if it ran on bands (the flag
        after its forward: a conv that gathers its input ran whole)."""
        if self.banded:
            self.ran_banded.add(id(module))

    def band(self, halo_top: int, halo_bot: int, pad: int) -> RowBand:
        """The RowBand of a conv with these halos and H pad: the image's
        pad at the group's first (top) and last (bottom) rank, halos
        elsewhere."""
        first, last = self.index == 0, self.index == self.size - 1
        return RowBand(
            extend=lambda t: halo_rows(t, self, halo_top, halo_bot),
            pad_top=pad if first else 0, pad_bottom=pad if last else 0)


def space_parallel(mesh: Optional[DeviceMesh], axis: str = 'space'
                   ) -> Optional[SpatialParallel]:
    """This rank's group along `axis`, None where it has one rank."""
    if axis_size(mesh, axis) == 1:
        return None
    return SpatialParallel(mesh, axis)


def _halo_geometry(h_loc: int, kh: int, sh: int, ph: int, p: int
                   ) -> tuple[int, int]:
    """Validate the sharded-H geometry and return (halo_top, halo_bot).

    Rank d owns input rows [d*h_loc, (d+1)*h_loc) and produces output
    rows [d*h_loc//sh, (d+1)*h_loc//sh). The first local output window
    starts at global row d*h_loc - ph (needs ph rows from above); the
    last reaches kh - sh - ph rows below the band.
    """
    if h_loc % sh:
        raise ValueError(
            f'local height {h_loc} must divide by stride {sh}')
    if ph >= kh:
        raise ValueError(f'padding {ph} >= kernel {kh} unsupported')
    h = h_loc * p
    out_global = (h + 2 * ph - kh) // sh + 1
    if out_global != h // sh:
        raise ValueError(
            f'conv geometry (kh={kh}, stride={sh}, pad={ph}) is not '
            f'shape-preserving modulo stride on H={h}; spatial '
            f'partitioning needs out_H == H // stride')
    halo_top = ph
    halo_bot = max(0, kh - sh - ph)
    if max(halo_top, halo_bot) > h_loc:
        raise ValueError(
            f'halo ({halo_top}, {halo_bot}) exceeds the local band '
            f'{h_loc}; use fewer spatial shards')
    return halo_top, halo_bot


def _rows(t: torch.Tensor, start: int, n: int) -> torch.Tensor:
    return t.narrow(H, start, n)


class _HaloExchange(torch.autograd.Function):
    """t with the `top` rows of the member above and the `bottom` rows of
    the member below put around it (none at the group's edges); the
    backward sends each halo row's gradient to its owner, which adds it
    to the row's own (JAX's ppermute transposed)."""

    @staticmethod
    def forward(ctx: Any, t: torch.Tensor, space: SpatialParallel,
                top: int, bottom: int) -> torch.Tensor:
        h, d = t.shape[H], space.index
        up = d > 0
        down = d < space.size - 1
        ctx.space, ctx.h = space, h
        ctx.top, ctx.bottom = top, bottom
        ctx.got_top, ctx.got_bottom = top if up else 0, bottom if down else 0
        sends, recvs = [], []
        if top and down:
            sends.append((_rows(t, h - top, top), d + 1))
        if bottom and up:
            sends.append((_rows(t, 0, bottom), d - 1))
        if ctx.got_top:
            recvs.append((_rows(t, 0, top), d - 1))
        if ctx.got_bottom:
            recvs.append((_rows(t, 0, bottom), d + 1))
        if sends or recvs:
            space.tally('halo', *(t_send for t_send, _ in sends))
        got = space.exchange(sends, recvs)
        parts = got[:1] if ctx.got_top else []
        parts.append(t)
        if ctx.got_bottom:
            parts.append(got[-1])
        return torch.cat(parts, dim=H) if len(parts) > 1 else t.clone()

    @staticmethod
    def backward(ctx: Any, grad: torch.Tensor) -> tuple:
        space, h, d = ctx.space, ctx.h, ctx.space.index
        top, bottom = ctx.top, ctx.bottom
        up, down = d > 0, d < space.size - 1
        sends, recvs = [], []
        if ctx.got_top:
            sends.append((_rows(grad, 0, top), d - 1))
        if ctx.got_bottom:
            sends.append((_rows(grad, ctx.got_top + h, bottom), d + 1))
        gx = _rows(grad, ctx.got_top, h).clone()
        if top and down:
            recvs.append((_rows(gx, h - top, top), d + 1))
        if bottom and up:
            recvs.append((_rows(gx, 0, bottom), d - 1))
        if sends or recvs:
            space.tally('halo', *(t_send for t_send, _ in sends))
        got = iter(space.exchange(sends, recvs))
        if top and down:
            _rows(gx, h - top, top).add_(next(got))
        if bottom and up:
            _rows(gx, 0, bottom).add_(next(got))
        return gx, None, None, None


def halo_rows(t: torch.Tensor, space: SpatialParallel, top: int,
              bottom: int) -> torch.Tensor:
    """t (H on dim -3) with the halo rows its neighbours hold: `top` rows
    from the member above, `bottom` from the member below, none at the
    group's edges. Differentiable (the module docstring)."""
    return _HaloExchange.apply(t, space, top, bottom)


class _GatherRows(torch.autograd.Function):
    """All-gather of the bands along H; the backward is this rank's rows
    of the gradient, with no collective: what follows runs replicated,
    so every rank already holds the whole gradient (the channel gather's
    rule, parallel.sharding._GatherChannels, on H)."""

    @staticmethod
    def forward(ctx: Any, x: torch.Tensor, space: SpatialParallel,
                kind: str) -> torch.Tensor:
        ctx.space = space
        space.tally(kind, x)
        return all_gather_cat(x, H, space)

    @staticmethod
    def backward(ctx: Any, grad: torch.Tensor) -> tuple:
        space = ctx.space
        return (grad.chunk(space.size, H)[space.index].contiguous(), None,
                None)


def gather_rows(x: torch.Tensor, space: SpatialParallel,
                kind: str = 'gather') -> torch.Tensor:
    """The group's bands of x (H on dim -3) concatenated in rank order:
    the whole map, on every rank (tallied as `kind`). Differentiable
    (_GatherRows)."""
    return _GatherRows.apply(x, space, kind)


def local_band(x: torch.Tensor, mesh: DeviceMesh, axis: str = 'space',
               batch_axis: Optional[str] = None) -> torch.Tensor:
    """This rank's part of a whole (N, H, W, C) tensor under
    spatial_sharding(mesh, axis, batch_axis): its H/P row band (and its
    N/D rows of the batch), contiguous."""
    p, i = axis_size(mesh, axis), axis_index(mesh, axis)
    if x.shape[1] % p:
        raise ValueError(f'H={x.shape[1]} must divide by shards {p}')
    h = x.shape[1] // p
    x = x[:, i * h:(i + 1) * h]
    if batch_axis is not None:
        d, j = axis_size(mesh, batch_axis), axis_index(mesh, batch_axis)
        if x.shape[0] % d:
            raise ValueError(f'N={x.shape[0]} must divide by shards {d}')
        n = x.shape[0] // d
        x = x[j * n:(j + 1) * n]
    return x.contiguous()


def _pad_rows(x: torch.Tensor, band: RowBand, value: float) -> torch.Tensor:
    """An extended band padded by its pad rows of `value` (the image's
    edges)."""
    if band.pad_top or band.pad_bottom:
        x = F.pad(x, (0, 0, 0, 0, band.pad_top, band.pad_bottom),
                  value=value)
    return x


def conv_rows(x: torch.Tensor, w: torch.Tensor, band: RowBand,
              stride: IntOr2, padding: IntOr2,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ops.conv.conv2d of a band: its halo rows, its zero pad rows, then
    the conv with W padding only."""
    return conv2d(_pad_rows(band.extend(x), band, 0.0), w, stride=stride,
                  padding=(0, _pair(padding)[1]), bias=bias)


def max_pool_rows(x_ext: torch.Tensor, band: RowBand, kernel_size: IntOr2,
                  stride: IntOr2, padding: IntOr2) -> torch.Tensor:
    """Max pool of a band extended by its halo rows (band.extend): its
    -inf pad rows, then the pool with -inf W padding only."""
    pw = _pair(padding)[1]
    xp = F.pad(_pad_rows(x_ext, band, float('-inf')), (0, 0, pw, pw),
               value=float('-inf'))
    y = F.max_pool2d(xp.permute(0, 3, 1, 2), kernel_size=_pair(kernel_size),
                     stride=_pair(stride))
    return y.permute(0, 2, 3, 1).contiguous()


def _band_of(space: SpatialParallel, h_loc: int, kernel_size: IntOr2,
             stride: IntOr2, padding: IntOr2) -> RowBand:
    kh, sh, ph = _pair(kernel_size)[0], _pair(stride)[0], _pair(padding)[0]
    return space.band(*_halo_geometry(h_loc, kh, sh, ph, space.size), ph)


def halo_exchange_conv2d(x: torch.Tensor, w: torch.Tensor, *,
                         mesh: DeviceMesh, axis: str = 'space',
                         batch_axis: Optional[str] = None,
                         stride: IntOr2 = 1, padding: IntOr2 = 0,
                         bias: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Conv2d of an H-banded map (halo exchange).

    Args:
        x: this rank's (N, H/P, W, Cin) band (of its batch rows under
            `batch_axis`), as local_band cuts it.
        w: (kh, kw, Cin, Cout) filters, the same on every rank.
        stride/padding: ints or (h, w) pairs, symmetric integer padding.

    Returns:
        this rank's (N, H/P // stride_h, W_out, Cout) band of the output.
    """
    space = space_parallel(mesh, axis)
    if space is None:
        return conv2d(x, w, stride=stride, padding=padding, bias=bias)
    band = _band_of(space, x.shape[1], w.shape[0], stride, padding)
    return conv_rows(x, w, band, stride, padding, bias)


def halo_exchange_max_pool2d(x: torch.Tensor, *, mesh: DeviceMesh,
                             axis: str = 'space',
                             batch_axis: Optional[str] = None,
                             kernel_size: IntOr2, stride: IntOr2,
                             padding: IntOr2 = 0) -> torch.Tensor:
    """Max pool of an H-banded map (halo exchange); x and the result as
    in halo_exchange_conv2d."""
    space = space_parallel(mesh, axis)
    if space is None:
        return max_pool2d(x, kernel_size=kernel_size, stride=stride,
                          padding=padding)
    band = _band_of(space, x.shape[1], kernel_size, stride, padding)
    return max_pool_rows(band.extend(x), band, kernel_size, stride, padding)


# ------------------------------------------------------ banded models


def band_model(model: nn.Module, mesh: Optional[DeviceMesh],
               axis: str = 'space') -> nn.Module:
    """Run the model H-banded over `axis`, in eval and train mode (module
    docstring); in place, returns the model. Sets `space` (a
    SpatialParallel) on the model and on every module that bands (those
    with a `space` attribute: the fp and quantized convs, the models'
    pools and global average pool) and hooks every module that holds
    parameters, to record whether it ran on bands. A forward then takes
    this rank's band of the input (local_band) and returns the whole
    logits on every rank of the group. An axis of one rank leaves the
    model as it is; a grouped conv raises ValueError
    (mesh.refuse_grouped_convs)."""
    if axis_size(mesh, axis) == 1:
        return model
    refuse_grouped_convs(model, 'band_model')
    space = space_parallel(mesh, axis)
    if getattr(model, 'space', None) is not None:
        raise ValueError('the model is banded already')
    if getattr(model, 'tp', None) is not None:
        raise ValueError('a tensor-parallel model cannot be banded too')
    for module in model.modules():
        if hasattr(module, 'space'):
            module.space = space
        if any(True for _ in module.parameters(recurse=False)):
            module.register_forward_hook(space.note)
    return model


@contextlib.contextmanager
def forward(space: Optional[SpatialParallel]) -> Iterator[None]:
    """The body of a model's forward: banded until it gathers or ends
    where the model is banded, its train-mode statistics reduced over
    'space' meanwhile; the record of the modules that ran on bands
    starts anew."""
    if space is None:
        yield
        return
    space.banded = True
    space.ran_banded = set()
    try:
        with global_stats.banded(space):
            yield
    finally:
        space.banded = False


@contextlib.contextmanager
def recompute(space: Optional[SpatialParallel],
              banded: bool) -> Iterator[None]:
    """The recomputation of a block in the backward pass
    (nn.resnet.remat_block), after `forward` has ended: `space.banded` as
    it stood at the block's entry (it holds through a block: block_input
    gathers first where a conv of the block would not band), the
    statistics' 'space' state re-entered (global_stats.banded), its
    collectives counted in `space.recomputed`. The state the backward
    found is put back on exit, also when the recomputation stops early
    or raises. Nothing is recorded anew: `ran_banded` keeps the
    forward's record, which the recomputation's hooks only repeat."""
    if space is None:
        yield
        return
    saved = space.banded, space.recomputing
    space.banded, space.recomputing = banded, True
    try:
        with global_stats.banded(space):
            yield
    finally:
        space.banded, space.recomputing = saved


def _whole(x: torch.Tensor, space: SpatialParallel) -> torch.Tensor:
    """x gathered; the rest of the forward runs whole."""
    space.banded = False
    return gather_rows(x, space)


def conv_band(space: Optional[SpatialParallel], x: torch.Tensor,
              kernel_size: IntOr2, stride: IntOr2, padding: IntOr2
              ) -> tuple[torch.Tensor, Optional[RowBand]]:
    """(x, its RowBand) where the forward runs banded and the conv's
    geometry holds on the band; (x gathered, None) where it does not, and
    the rest of the forward runs whole; (x, None) in a forward that is
    not banded."""
    if space is None or not space.banded:
        return x, None
    try:
        band = _band_of(space, x.shape[H], kernel_size, stride, padding)
    except ValueError:
        return _whole(x, space), None
    return x, band


def block_input(space: Optional[SpatialParallel], block: nn.Module,
                x: torch.Tensor) -> torch.Tensor:
    """The input of a residual block: x where every conv of the block
    bands at the height it sees, else x gathered (the block's shortcut
    and body must see the same map). The body's convs are the block's
    children in order (each dividing the height by its stride), the
    shortcut's conv sees x."""
    if space is None or not space.banded:
        return x
    h = x.shape[H]
    convs = []
    for m in block.children():
        if hasattr(m, 'kernel_size') and hasattr(m, 'space'):
            convs.append((m, h))
            h //= _pair(m.stride)[0]
    shortcut = getattr(getattr(block, 'shortcut', None), 'conv', None)
    if shortcut is not None:
        convs.append((shortcut, x.shape[H]))
    for m, h_in in convs:
        try:
            _halo_geometry(h_in, _pair(m.kernel_size)[0],
                           _pair(m.stride)[0], _pair(m.padding)[0],
                           space.size)
        except ValueError:
            return _whole(x, space)
    return x


def solve_input(space: Optional[SpatialParallel],
                x: torch.Tensor) -> torch.Tensor:
    """The map a per-sample activation solve reads: x, or the whole
    sample gathered where x is a band."""
    if space is None or not space.banded:
        return x
    return gather_rows(x, space, 'solves')


def solve_band(space: SpatialParallel, scheme: str, x: torch.Tensor,
               skip: int, mode: str) -> Optional[torch.Tensor]:
    """The (k, N) scales ops.quantize.solve_scales gives the whole
    samples of which x holds this rank's band, on every rank, without a
    gradient. ls-1's mean |x| is the band's sums all-reduced over the
    group (N floats; its float32 rounding differs from one mean of the
    row by a few ulps); the other schemes solve the sample gathered."""
    if scheme == 'fp':
        return None
    with torch.no_grad():
        if scheme != 'ls-1':
            return solve_scales(scheme, solve_input(space, x), skip, mode)
        rows = _rows32(x)
        sums = rows.abs().sum(dim=-1)
        space.tally('solves', sums)
        dist.all_reduce(sums, group=space.group)
        return (sums / (rows.shape[1] * space.size))[None, :]


def output_band(space: SpatialParallel, y: torch.Tensor) -> torch.Tensor:
    """This rank's band of a whole map y."""
    h = y.shape[H] // space.size
    return _rows(y, space.index * h, h).contiguous()


class _ReplicatedSum(torch.autograd.Function):
    """All-reduce sum whose result every rank consumes whole (the head
    after the average pool runs replicated): the backward is the
    identity, since each rank's gradient is already the whole one; a
    summing backward would give P times it."""

    @staticmethod
    def forward(ctx: Any, x: torch.Tensor,
                space: SpatialParallel) -> torch.Tensor:
        out = x.clone()
        space.tally('average pool', out)
        dist.all_reduce(out, group=space.group)
        return out

    @staticmethod
    def backward(ctx: Any, grad: torch.Tensor) -> tuple:
        return grad, None


def replicated_sum(x: torch.Tensor, space: SpatialParallel) -> torch.Tensor:
    """x summed over the group, for a replicated consumer (_ReplicatedSum)."""
    return _ReplicatedSum.apply(x, space)


def global_avg_pool(space: Optional[SpatialParallel],
                    x: torch.Tensor) -> torch.Tensor:
    """ops.conv.global_avg_pool of a map or of a band: a band's sums
    all-reduced over the group (replicated_sum), over the whole H * W;
    the rest of the forward runs whole. Reduced-precision inputs sum in
    float32 and round once."""
    if space is None or not space.banded:
        return C.global_avg_pool(x)
    low = x.dtype in (torch.bfloat16, torch.float16)
    sums = replicated_sum((x.float() if low else x).sum(dim=(1, 2)), space)
    space.banded = False
    mean = sums / (x.shape[1] * space.size * x.shape[2])
    return mean.to(x.dtype) if low else mean


def sum_banded_grads(model: nn.Module) -> None:
    """Sum over 'space', in place, the gradients of the parameters of the
    modules that ran on bands in the model's last forward (each holds its
    band's share); those of the whole section hold the whole gradient
    already. One all-reduce a dtype, in the model's parameter order (the
    same on every rank). A model that is not banded is left as it is."""
    space = getattr(model, 'space', None)
    if space is None:
        return
    grads = [p.grad for m in model.modules() if id(m) in space.ran_banded
             for p in m.parameters(recurse=False) if p.grad is not None]
    for flat in all_reduce_flat(grads, space.group):
        space.tally('gradient sum', flat)
