"""Data, tensor, spatial and pipeline parallelism over processes (port of
quant_tpu/parallel).

The JAX package runs one program over a device mesh; the port runs one
process a card, joined by torch.distributed: a `DeviceMesh` over the
ranks (`make_mesh` for ('data', 'model'); a mesh with a 'space' or
'pipe' axis is a plain `DeviceMesh(device_type, grid,
mesh_dim_names=(...))`, as JAX's tests build `Mesh(devs, ('space',))`),
the per-process input pipeline and consensus helpers (`multihost`),
train-mode statistics over the global batch (`global_stats`), the
out-channel sharding of the model's variables with its explicit
all-gathers (`sharding`), the ring-overlapped tensor-parallel binary
GEMM (`tp_overlap`), H-banded convs, pools and models with halo exchange
(`spatial`) and the GPipe schedule over stage-stacked parameters
(`pipeline`).
"""

from quant_tpu_torch.parallel.mesh import (
    data_group, make_mesh, model_group,
)
from quant_tpu_torch.parallel.pipeline import (
    pipeline_apply, stack_stage_params, stage_sharding,
)
from quant_tpu_torch.parallel.sharding import (
    batch_sharding, replicated, shard_model, shard_model_variables,
)
from quant_tpu_torch.parallel.spatial import (
    band_model, halo_exchange_conv2d, halo_exchange_max_pool2d, local_band,
    spatial_sharding,
)
from quant_tpu_torch.parallel.tp_overlap import (
    tp_binary_matmul_overlapped, tp_binary_matmul_reference,
    tp_packed_matmul_overlapped,
)

__all__ = ['data_group', 'make_mesh', 'model_group', 'batch_sharding',
           'replicated', 'shard_model', 'shard_model_variables',
           'band_model', 'halo_exchange_conv2d', 'halo_exchange_max_pool2d',
           'local_band', 'spatial_sharding', 'pipeline_apply',
           'stack_stage_params', 'stage_sharding',
           'tp_binary_matmul_overlapped', 'tp_binary_matmul_reference',
           'tp_packed_matmul_overlapped']
