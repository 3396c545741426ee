"""Mesh construction (port of quant_tpu/parallel/mesh.py).

One process drives one card, so a mesh's devices are the processes'
ranks: a `torch.distributed.device_mesh.DeviceMesh` with dimensions
('data', 'model') over the initialized process group.
"""

from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def make_mesh(data: Optional[int] = None, model: int = 1,
              devices: Optional[Sequence[int]] = None,
              device_type: str = 'cuda') -> DeviceMesh:
    """A ('data', 'model') mesh over the ranks of the process group.

    Args:
        data: size of the data axis; defaults to len(devices) // model.
        model: size of the model (tensor-parallel) axis; only 1 runs.
        devices: the ranks, one card each (defaults to every rank).
        device_type: 'cuda' or 'cpu', the cards' type.
    """
    if model > 1:
        raise NotImplementedError(
            f'mesh model axis {model}: tensor parallelism is Slice E part 2 '
            'of ROADMAP.md; the port runs data parallel only (model=1).')
    world = dist.get_world_size() if dist.is_initialized() else 1
    devices = list(devices if devices is not None else range(world))
    if data is None:
        data = len(devices) // model
    if data * model > len(devices):
        raise ValueError(
            f'mesh {data}x{model} needs {data * model} devices, '
            f'have {len(devices)}')
    grid = torch.tensor(devices[:data * model]).reshape(data, model)
    return DeviceMesh(device_type, grid, mesh_dim_names=('data', 'model'))


def data_size(mesh: Optional[DeviceMesh]) -> int:
    """The 'data' axis' size; 1 without a mesh."""
    return 1 if mesh is None else mesh['data'].size()


def data_group(mesh: Optional[DeviceMesh]
               ) -> Optional[dist.ProcessGroup]:
    """The process group of this rank's 'data' axis, or None where the
    axis has one rank (nothing to reduce: no collective is dispatched)."""
    if data_size(mesh) == 1:
        return None
    return mesh.get_group('data')
