"""Multi-process execution helpers (port of quant_tpu/parallel/multihost.py).

The JAX package runs one process a host under jax.distributed; the port
runs one process a card under torch.distributed:

* `initialize()`: `torch.distributed.init_process_group` guard
  (idempotent; a no-op for a single process). The backend is NCCL on
  CUDA and gloo on the CPU, unless the environment variable named by
  BACKEND_ENV names another.
* `host_shard(n)`: this process's contiguous [start, stop) of a global
  dataset of n examples, for per-process input pipelines.
* `shard_loader_for_host(loader)`: this process's disjoint share of a
  batched loader (train drops the ragged tail, eval pads it with rows of
  target -1).
* `global_batch(local, mesh)`: this process's rows on its card; the
  step's collectives (train.engine, parallel.global_stats) make the
  ranks' rows one logical batch, laid out in rank order.
* `collective_any(flag)`: a consensus across processes.

Given a mesh with a 'model' or 'space' axis, a process's share is
indexed by its 'data' coordinate among the 'data' axis' size, not by its
rank among all ranks: the ranks of one 'model' or 'space' group compute
one batch together, so they read the same rows; a 'space' rank then
takes its row band of each image (parallel.spatial.local_band).
"""

import logging
import os
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from quant_tpu_torch.parallel.mesh import axis_index, axis_size

logger = logging.getLogger(__name__)

# Names the torch.distributed backend a process group uses, overriding
# the default (NCCL for CUDA, gloo for the CPU): e.g. gloo, which takes
# two ranks on one card where NCCL refuses them.
BACKEND_ENV = 'QUANT_TPU_TORCH_DIST_BACKEND'

_initialized = False


def default_backend(device: 'str | torch.device') -> str:
    """The backend of a process group whose ranks drive `device`."""
    return os.environ.get(BACKEND_ENV) or (
        'nccl' if torch.device(device).type == 'cuda' else 'gloo')


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device: 'str | torch.device' = 'cuda') -> None:
    """Join the process group once; harmless for a single process.

    With a coordinator_address ('host:port') the group is formed over
    TCP with the given world size and rank, and a failure raises: a run
    that asked for several processes must not train one replica alone.
    Without one, a launcher's environment (MASTER_ADDR, WORLD_SIZE,
    RANK) is used where present; else the process continues alone.
    A CUDA process drives card rank % device_count.
    """
    global _initialized
    if _initialized:
        return
    if dist.is_initialized():
        _initialized = True
        return
    device = torch.device(device)
    backend = default_backend(device)
    if coordinator_address is not None:
        kwargs = dict(init_method=f'tcp://{coordinator_address}',
                      world_size=int(num_processes), rank=int(process_id))
    elif all(k in os.environ for k in ('MASTER_ADDR', 'WORLD_SIZE', 'RANK')):
        kwargs = dict(init_method='env://')
    else:
        _initialized = True
        logger.warning('no coordinator and no launcher environment; '
                       'continuing as a single process')
        return
    try:
        if device.type == 'cuda':
            rank = int(kwargs.get('rank', os.environ.get('RANK', 0)))
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, **kwargs)
    except Exception as e:
        raise RuntimeError(
            f'torch.distributed.init_process_group({backend!r}, '
            f'coordinator_address={coordinator_address!r}) failed: {e}'
        ) from e
    _initialized = True


def rank() -> int:
    """This process's rank (0 for a single process)."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """The number of processes (1 for a single process)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def collective_any(flag: bool) -> bool:
    """True when ANY process raised `flag`: a consensus point.

    Per-process decisions that change control flow (the preemption stop
    of the train loop) must be agreed: one process leaving the batch loop
    while a peer enters the next step's collectives is a deadlock. Every
    process must call this at the same loop points. A single process
    returns its own flag and dispatches no collective.
    """
    if world_size() == 1:
        return bool(flag)
    device = 'cuda' if dist.get_backend() == 'nccl' else 'cpu'
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def _share(process_index: Optional[int], process_count: Optional[int],
           mesh: Any) -> tuple[int, int]:
    """(index, count) of this process's share of a dataset: the given
    ones, else the mesh's 'data' coordinate and size, else the rank and
    the world size."""
    if mesh is not None:
        pi, pc = axis_index(mesh, 'data'), axis_size(mesh, 'data')
    else:
        pi, pc = rank(), world_size()
    return (pi if process_index is None else process_index,
            pc if process_count is None else process_count)


def host_shard(num_examples: int,
               process_index: Optional[int] = None,
               process_count: Optional[int] = None,
               equal: bool = False, mesh: Any = None) -> tuple[int, int]:
    """Contiguous [start, stop) slice of the dataset owned by a process.

    equal=True drops the remainder so every process owns exactly
    num_examples // process_count rows, as the train path needs: every
    process must dispatch the same number of identically-shaped steps
    (a ragged tail would deadlock the collectives, and the mean of the
    ranks' gradients is the global batch's only for equal batches).
    `mesh`: index the share by the 'data' coordinate (module docstring).
    """
    pi, pc = _share(process_index, process_count, mesh)
    per = num_examples // pc
    start = pi * per
    stop = start + per if (equal or pi != pc - 1) else num_examples
    return start, stop


def _require_int_targets(t: object) -> np.ndarray:
    """Padded eval shards mark pad rows with the integer sentinel -1;
    that convention is only defined for SIGNED integer classification
    labels (-1 in an unsigned dtype wraps to the dtype max and the
    masked metrics' `target >= 0` test would count pad rows as real
    examples). Fail loudly on float or unsigned targets, and keep the
    loader's own dtype so padding and non-padding processes agree."""
    arr = np.asarray(t)
    if not np.issubdtype(arr.dtype, np.signedinteger):
        raise TypeError(
            'padded per-host eval shards require SIGNED integer '
            f'classification targets (sentinel -1 marks pad rows); got '
            f'dtype {arr.dtype}. Cast the loader\'s labels to a signed '
            'dtype, or use pad=False (trim).')
    return arr


class _ShardedBatches:
    """Per-process view of a batched loader: yields rows [pi::pc] of
    every batch, so processes read disjoint rows and step in lockstep.
    For loaders without in-memory arrays (e.g. the lazy ImageNet loader).

    Ragged final batches (rows not divisible by pc) would give processes
    row counts differing by 1. pad=False trims every process to the
    common count (train: a <pc-row tail is dropped); pad=True pads every
    process to the ceil count with rows of sentinel target -1 that the
    masked eval metrics exclude, covering every example.
    """

    def __init__(self, inner: Any, pi: int, pc: int,
                 pad: bool = False) -> None:
        self._inner, self._pi, self._pc = inner, pi, pc
        self._pad = pad
        n = getattr(inner, 'num_examples', 0)
        self.num_examples = -(-n // pc) if pad else n // pc

    def __len__(self) -> int:
        return len(self._inner)

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self._inner, 'set_epoch'):
            self._inner.set_epoch(epoch)

    def __iter__(self) -> Any:
        for data, target in self._inner:
            d = data[self._pi::self._pc]
            t = target[self._pi::self._pc]
            n = data.shape[0]
            if self._pad:
                want = -(-n // self._pc)
                if d.shape[0] < want:
                    extra = want - d.shape[0]
                    d = np.concatenate(
                        [d, np.zeros((extra,) + d.shape[1:], d.dtype)])
                    t = np.concatenate(
                        [_require_int_targets(t),
                         np.full((extra,), -1, np.asarray(t).dtype)])
            else:
                common = n // self._pc
                d, t = d[:common], t[:common]
            yield d, t


def _padded_host_slice(images: np.ndarray, labels: np.ndarray,
                       pi: int, pc: int
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Split n rows into pc equal shards of ceil(n/pc), padding the tail
    with sentinel target -1 rows (masked out of the eval metrics)."""
    n = len(labels)
    per = -(-n // pc)
    pad = per * pc - n
    if pad:
        images = np.concatenate(
            [images, np.zeros((pad,) + images.shape[1:], images.dtype)])
        labels = np.concatenate(
            [_require_int_targets(labels),
             np.full((pad,), -1, np.asarray(labels).dtype)])
    return images[pi * per:(pi + 1) * per], labels[pi * per:(pi + 1) * per]


def shard_loader_for_host(loader: Any,
                          process_index: Optional[int] = None,
                          process_count: Optional[int] = None,
                          pad: bool = False, mesh: Any = None) -> Any:
    """Give this process its disjoint 1/process_count of a batched loader.

    The config's batch size is GLOBAL (one logical batch scattered over
    the ranks); each process loads batch_size/process_count rows.
    BatchIterable loaders are resliced at the array level (each process
    holds only its examples); other loaders get a row-striding wrapper.

    pad=False (train): the remainder rows are DROPPED so every process
    dispatches identically-shaped steps. pad=True (eval): every process
    is padded to ceil coverage with sentinel target -1 rows, so the
    masked eval metrics cover the FULL set exactly.

    mesh: index the share by the 'data' coordinate, so the ranks of one
    'model' or 'space' group get the same rows, and with a 'space' axis
    yield this rank's row band of each batch (module docstring).
    """
    loader = _rows_for_host(loader, process_index, process_count, pad,
                            mesh)
    if axis_size(mesh, 'space') > 1:
        return _BandedBatches(loader, mesh)
    return loader


class _BandedBatches:
    """This rank's row band of every batch's NHWC images
    (parallel.spatial.local_band's); targets whole."""

    def __init__(self, inner: Any, mesh: Any) -> None:
        self._inner, self._mesh = inner, mesh
        self.num_examples = getattr(inner, 'num_examples', 0)

    def __len__(self) -> int:
        return len(self._inner)

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self._inner, 'set_epoch'):
            self._inner.set_epoch(epoch)

    def __iter__(self) -> Any:
        from quant_tpu_torch.parallel.spatial import local_band
        for data, target in self._inner:
            band = local_band(torch.as_tensor(data), self._mesh)
            yield (band if isinstance(data, torch.Tensor)
                   else band.numpy()), target


def _rows_for_host(loader: Any, process_index: Optional[int],
                   process_count: Optional[int], pad: bool,
                   mesh: Any) -> Any:
    """This process's disjoint share of the batches' rows
    (shard_loader_for_host)."""
    from quant_tpu_torch.data.loaders import BatchIterable
    pi, pc = _share(process_index, process_count, mesh)
    if pc == 1:
        return loader
    if isinstance(loader, BatchIterable):
        local_bs = max(1, loader.batch_size // pc)
        if pad:
            imgs, labels = _padded_host_slice(
                loader.images, loader.labels, pi, pc)
            return BatchIterable(
                imgs, labels, local_bs, shuffle=loader.shuffle,
                seed=loader._seed + 7919 * pi, augment=loader.augment,
                drop_last=False, pad_value=loader.pad_value)
        start, stop = host_shard(loader.num_examples, pi, pc, equal=True)
        return BatchIterable(
            loader.images[start:stop], loader.labels[start:stop],
            local_bs, shuffle=loader.shuffle,
            seed=loader._seed + 7919 * pi, augment=loader.augment,
            drop_last=True, pad_value=loader.pad_value)
    return _ShardedBatches(loader, pi, pc, pad=pad)


def global_batch(local: Any, mesh: Any = None) -> torch.Tensor:
    """This process's rows of the logical global batch, on its card.

    The JAX package assembles one array sharded over the mesh's 'data'
    axis (make_array_from_process_local_data); here each rank keeps its
    own rows, and the step's collectives make them one logical
    (data_size * local_rows, ...) batch in the order of the ranks' 'data'
    coordinates: gradients and metrics summed across the 'data' group,
    train-mode statistics over every rank's rows; the ranks of one
    'model' group hold the same rows. `mesh` (a DeviceMesh, or None for
    the CPU) names the card's type. It only moves the rows, as train.engine's loops do
    for every batch, so they take no such step; it serves a caller's own
    loop.
    """
    device_type = getattr(mesh, 'device_type', 'cpu')
    device = (torch.device('cuda', torch.cuda.current_device())
              if device_type == 'cuda' else torch.device('cpu'))
    if not isinstance(local, torch.Tensor):
        local = torch.from_numpy(np.ascontiguousarray(local))
    return local.to(device)
