"""Mesh construction (port of quant_tpu/parallel/mesh.py).

One process drives one card, so a mesh's devices are the processes'
ranks: a `torch.distributed.device_mesh.DeviceMesh` with dimensions
('data', 'model') over the initialized process group, laid out row
major as JAX's `reshape(data, model)`: the ranks of one 'model' group
are consecutive.
"""

from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

MESH_DIMS = ('data', 'model')


def make_mesh(data: Optional[int] = None, model: int = 1,
              devices: Optional[Sequence[int]] = None,
              device_type: str = 'cuda') -> DeviceMesh:
    """A ('data', 'model') mesh over the ranks of the process group.

    Args:
        data: size of the data axis; defaults to len(devices) // model.
        model: size of the model (tensor-parallel) axis.
        devices: the ranks, one card each (defaults to every rank).
        device_type: 'cuda' or 'cpu', the cards' type.

    Raises ValueError where the ranks cannot fill the grid: unlike JAX's
    devices, a rank left out of the mesh cannot be dropped.
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    devices = list(devices if devices is not None else range(world))
    if data is None:
        data = len(devices) // model
    if data < 1 or model < 1 or data * model > len(devices):
        raise ValueError(
            f'mesh {data}x{model} needs {max(data, 1) * model} devices, '
            f'have {len(devices)}')
    grid = torch.tensor(devices[:data * model]).reshape(data, model)
    return DeviceMesh(device_type, grid, mesh_dim_names=MESH_DIMS)


def _has(mesh: Optional[DeviceMesh], axis: str) -> bool:
    return mesh is not None and axis in (mesh.mesh_dim_names or ())


def axis_size(mesh: Optional[DeviceMesh], axis: str) -> int:
    """The size of a mesh axis; 1 without a mesh or where the mesh has
    no such axis (a ('space',) mesh has one 'data' coordinate)."""
    return mesh[axis].size() if _has(mesh, axis) else 1


def refuse_grouped_convs(model: torch.nn.Module, what: str) -> None:
    """Raise ValueError naming the model's first grouped conv: `what`
    (shard_model, band_model) has no rule for a grouped conv's slice of
    channels or rows, and JAX's sharded and banded convs take no groups
    either."""
    for name, module in model.named_modules():
        groups = getattr(module, 'groups', 1)
        if groups != 1:
            raise ValueError(
                f'{what} does not take grouped convs: '
                f'{name or type(module).__name__} has groups={groups}')


def axis_index(mesh: Optional[DeviceMesh], axis: str) -> int:
    """This rank's coordinate along a mesh axis; 0 without a mesh or
    where the mesh has no such axis."""
    return mesh[axis].get_local_rank() if _has(mesh, axis) else 0


def data_size(mesh: Optional[DeviceMesh]) -> int:
    """The 'data' axis' size; 1 without a mesh."""
    return axis_size(mesh, 'data')


def data_group(mesh: Optional[DeviceMesh]
               ) -> Optional[dist.ProcessGroup]:
    """The process group of this rank's 'data' axis, or None where the
    axis has one rank (nothing to reduce: no collective is dispatched)."""
    if data_size(mesh) == 1:
        return None
    return mesh.get_group('data')


def model_group(mesh: Optional[DeviceMesh]
                ) -> Optional[dist.ProcessGroup]:
    """The process group of this rank's 'model' axis, or None where the
    axis has one rank (the model runs unsharded: no collective)."""
    if axis_size(mesh, 'model') == 1:
        return None
    return mesh.get_group('model')


def all_reduce_flat(tensors: list[torch.Tensor], group: dist.ProcessGroup,
                    divisor: int = 1) -> list[torch.Tensor]:
    """Each tensor in place to its sum across the group's ranks over
    `divisor`, by one all-reduce a dtype of the tensors flattened in the
    list's order (the same on every rank); the flat tensors reduced."""
    flats = []
    for dtype in sorted({t.dtype for t in tensors}, key=str):
        same = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.all_reduce(flat, group=group)
        if divisor != 1:
            flat /= divisor
        for t, part in zip(same, flat.split([t.numel() for t in same])):
            t.copy_(part.view_as(t))
        flats.append(flat)
    return flats


class AxisGroup:
    """This rank's place along a mesh axis: the axis' process group, its
    size, this rank's index in it, and the mesh and axis. `exchange`
    runs point-to-point ops on the group."""

    def __init__(self, mesh: DeviceMesh, axis: str):
        self.mesh, self.axis = mesh, axis
        self.group = mesh.get_group(axis)
        self.size = dist.get_world_size(self.group)
        self.index = dist.get_rank(self.group)

    def __deepcopy__(self, memo: dict) -> 'AxisGroup':
        return self  # a copied model shares the process group

    def rank(self, index: int) -> int:
        """The global rank of the group's member `index`."""
        return dist.get_global_rank(self.group, index)

    def exchange(self, sends: list, recvs: list) -> list[torch.Tensor]:
        """Send each (tensor, member index) of `sends` and receive a
        tensor shaped like each (tensor, member index) of `recvs`, in one
        batch of point-to-point ops; the received tensors, on their
        likes' devices. A group whose backend moves only host memory
        point to point (gloo) sends and receives through host copies."""
        host = dist.get_backend(self.group) == 'gloo'
        ops, bufs = [], []
        for t, peer in sends:
            t = t.contiguous()
            ops.append(dist.P2POp(dist.isend, t.cpu() if host else t,
                                  self.rank(peer), self.group))
        for like, peer in recvs:
            buf = torch.empty(like.shape, dtype=like.dtype,
                              device='cpu' if host else like.device)
            ops.append(dist.P2POp(dist.irecv, buf, self.rank(peer),
                                  self.group))
            bufs.append(buf)
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return [b.to(like.device) for b, (like, _) in zip(bufs, recvs)]
