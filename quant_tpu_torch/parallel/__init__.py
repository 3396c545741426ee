"""Data parallelism over processes (port of quant_tpu/parallel, its data
parallel part).

The JAX package runs one program over a ('data', 'model') device mesh;
the port runs one process a card, joined by torch.distributed: a
`DeviceMesh` over the ranks (`make_mesh`), the per-process input
pipeline and consensus helpers (`multihost`), and train-mode statistics
over the global batch (`global_stats`). Tensor parallelism (sharding,
tp_overlap), spatial and pipeline parallelism are Slice E parts 2 and 3
of ROADMAP.md.
"""

from quant_tpu_torch.parallel.mesh import data_group, make_mesh

__all__ = ['data_group', 'make_mesh']
