"""Tensor-parallel binary GEMM with communication/compute overlap (port
of quant_tpu/parallel/tp_overlap.py).

The input-channel-sharded (contraction-sharded) case: each rank of the
'model' group holds a K/P slice of the activations and the weights, and
the partial products must be summed across the ranks; the naive form
serializes a whole all-reduce after all compute.

Each rank passes its own K-shard (the rank's part of JAX's operands
sharded over `axis`). The schedule is JAX's: at step i rank `me`
computes the partial of output column block (me + i) % P from its
K-shard and adds it to the accumulator it holds; the accumulator then
moves one hop left, (j -> j - 1) mod P, by `dist.batch_isend_irecv` on
the group, and the next block's GEMM is issued before the wait, so the
transfer rides beside it. After P hops every rank holds its own block
fully reduced, a reduce-scatter by construction; `gather_output`
all-gathers the (M, N/P) blocks into the replicated (M, N).

The packed form runs each local block through ops.binary_gemm.xnor_gemm
(the kernel on a card, its plain twin on the CPU) on the rank's own sign
words with unit scales, without unpacking; its integer dots are exact
in float32 below 2^24. A group whose backend moves only host memory
point to point (gloo) sends the accumulator through a host copy.
"""

from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from quant_tpu_torch.ops.binary_gemm import xnor_gemm
from quant_tpu_torch.ops.packing import WORD
from quant_tpu_torch.parallel.sharding import (
    TensorParallel, all_gather_cat, tensor_parallel,
)


def _local_binary_matmul(x_signs: torch.Tensor,
                         w_signs: torch.Tensor) -> torch.Tensor:
    """Local-shard sign GEMM: +-1 operands in float32, exact (JAX's bf16
    dot with float32 accumulation)."""
    return x_signs.to(torch.float32) @ w_signs.to(torch.float32)


def _ring(block: Callable[[int], torch.Tensor],
          tp: Optional[TensorParallel]) -> torch.Tensor:
    """JAX's ring over block(b), this rank's partial of output block b:
    this rank's block, reduced over the group (block(0) without one)."""
    if tp is None:
        return block(0)
    me, p = tp.index, tp.size
    left = dist.get_global_rank(tp.group, (me - 1) % p)
    right = dist.get_global_rank(tp.group, (me + 1) % p)
    host = dist.get_backend(tp.group) == 'gloo'
    acc = block(me)
    for i in range(p):
        send = acc.cpu() if host else acc
        recv = torch.empty_like(send)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, left, tp.group),
            dist.P2POp(dist.irecv, recv, right, tp.group)])
        nxt = block((me + i + 1) % p) if i + 1 < p else None
        for r in reqs:
            r.wait()
        acc = recv.to(acc.device)
        if nxt is not None:
            acc = acc + nxt
    return acc


def _blocks(w: torch.Tensor, p: int) -> list[torch.Tensor]:
    """The P column blocks of w, each contiguous."""
    n = w.shape[1]
    if n % p:
        raise ValueError(f'N {n} does not divide over {p} ranks')
    return [b.contiguous() for b in w.split(n // p, dim=1)]


def _finish(acc: torch.Tensor, tp: Optional[TensorParallel],
            gather_output: bool) -> torch.Tensor:
    if tp is None or not gather_output:
        return acc
    return all_gather_cat(acc, 1, tp)


def tp_binary_matmul_overlapped(x_signs: torch.Tensor, w_signs: torch.Tensor,
                                mesh: DeviceMesh, axis: str = 'model',
                                gather_output: bool = True) -> torch.Tensor:
    """Contraction-sharded binary matmul with ring-overlapped reduction.

    Args:
        x_signs: (M, K/P) {-1,+1} activations, this rank's K-shard.
        w_signs: (K/P, N) {-1,+1} weights, this rank's K-shard.
        mesh: mesh containing `axis` (size P; N must divide by P).
        gather_output: all-gather the (M, N) result to every rank;
            False returns this rank's reduce-scattered (M, N/P) block
            (block `index` of the group).

    Returns:
        (M, N) float32, replicated (or this rank's (M, N/P) block).
    """
    tp = tensor_parallel(mesh, axis)
    w_blocks = _blocks(w_signs, 1 if tp is None else tp.size)
    acc = _ring(lambda b: _local_binary_matmul(x_signs, w_blocks[b]), tp)
    return _finish(acc, tp, gather_output)


def tp_binary_matmul_reference(x_signs: torch.Tensor, w_signs: torch.Tensor,
                               mesh: Optional[DeviceMesh] = None
                               ) -> torch.Tensor:
    """Unsharded oracle on the whole operands."""
    return _local_binary_matmul(x_signs, w_signs)


def tp_packed_matmul_overlapped(x_packed: torch.Tensor, w_packed: torch.Tensor,
                                k_total: int, mesh: DeviceMesh,
                                axis: str = 'model',
                                gather_output: bool = True) -> torch.Tensor:
    """The packed form: bit-packed binary operands sharded over the
    group, the ring overlapped with xnor_gemm on each block.

    Args:
        x_packed: (M, W/P) int32 sign words of X (M, K), packed along K:
            this rank's words.
        w_packed: (W/P, N) int32 sign words of W (K, N), packed along K
            (word axis leading, as ops.binary_gemm.pack_for_xnor gives
            them): this rank's words.
        k_total: unpacked K. Must divide by 32 * P, so every shard holds
            whole words without pad bits.
        mesh / axis / gather_output: as in tp_binary_matmul_overlapped.
    """
    tp = tensor_parallel(mesh, axis)
    p = 1 if tp is None else tp.size
    if k_total % (WORD * p):
        raise ValueError(f'k_total {k_total} does not divide by {WORD} x {p}')
    k_loc = k_total // p
    if x_packed.shape[1] * WORD != k_loc or w_packed.shape[0] * WORD != k_loc:
        raise ValueError(f'shards {tuple(x_packed.shape)}, '
                         f'{tuple(w_packed.shape)} do not hold K/P = {k_loc}')
    x_packed = x_packed.contiguous()
    w_blocks = _blocks(w_packed, p)
    ones_m = torch.ones(x_packed.shape[0], device=x_packed.device)
    ones_n = torch.ones(w_blocks[0].shape[1], device=x_packed.device)
    acc = _ring(lambda b: xnor_gemm(x_packed, w_blocks[b], ones_m, ones_n,
                                    k_loc), tp)
    return _finish(acc, tp, gather_output)
