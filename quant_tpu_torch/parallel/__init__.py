"""Data and tensor parallelism over processes (port of quant_tpu/parallel,
its data- and tensor-parallel parts).

The JAX package runs one program over a ('data', 'model') device mesh;
the port runs one process a card, joined by torch.distributed: a
`DeviceMesh` over the ranks (`make_mesh`), the per-process input
pipeline and consensus helpers (`multihost`), train-mode statistics
over the global batch (`global_stats`), the out-channel sharding of the
model's variables with its explicit all-gathers (`sharding`) and the
ring-overlapped tensor-parallel binary GEMM (`tp_overlap`). Spatial and
pipeline parallelism are Slice E part 3 of ROADMAP.md.
"""

from quant_tpu_torch.parallel.mesh import (
    data_group, make_mesh, model_group,
)
from quant_tpu_torch.parallel.sharding import (
    batch_sharding, replicated, shard_model, shard_model_variables,
)
from quant_tpu_torch.parallel.tp_overlap import (
    tp_binary_matmul_overlapped, tp_binary_matmul_reference,
    tp_packed_matmul_overlapped,
)

__all__ = ['data_group', 'make_mesh', 'model_group', 'batch_sharding',
           'replicated', 'shard_model', 'shard_model_variables',
           'tp_binary_matmul_overlapped', 'tp_binary_matmul_reference',
           'tp_packed_matmul_overlapped']
