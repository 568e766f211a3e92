"""Megatron-style tensor parallelism over explicit local shards
(``horovod_tpu/parallel/tensor_parallel.py``, the sequence-parallel pair
that ``fused_tp_apply`` runs).

:func:`column_parallel_dense_ag` and :func:`row_parallel_dense_rs` keep the
activations token-sharded between blocks and move them inside the
boundary products (:mod:`horovod_tpu_torch.ops.fused_collectives`).  Rows
are rank-major flattened tokens: the gather concatenates the ranks' chunks
and the scatter hands rank ``r`` rows ``[r·m/world, (r+1)·m/world)``.

Kernels are ``(in, out)`` as in the JAX package; a PyTorch ``(out, in)``
weight goes in as its transposed view, which the matmul kernel reads in
place.  The all-reduce pair (``column_parallel_dense``,
``row_parallel_dense``) waits for the slice that first calls it; the GSPMD
``ColumnParallelDense``/``RowParallelDense`` modules, whose partitioning
XLA owns, have no counterpart here.
"""

from __future__ import annotations

from typing import Optional

import torch

from horovod_tpu_torch.ops.fused_collectives import (
    allgather_matmul,
    matmul_reducescatter,
)


def column_parallel_dense_ag(x: torch.Tensor, kernel: torch.Tensor,
                             bias: Optional[torch.Tensor] = None,
                             group=None, fused: bool = True) -> torch.Tensor:
    """Column-parallel dense over a token-sharded input: gathers the
    ``(m_local, in)`` rank-major row shard across ``group`` inside the
    product (:func:`~horovod_tpu_torch.ops.fused_collectives.allgather_matmul`)
    and applies this rank's ``(in, out_local)`` column shard; returns the
    full-token ``(world·m_local, out_local)`` activation."""
    y = allgather_matmul(x, kernel, group, fused=fused)
    return y + bias if bias is not None else y


def row_parallel_dense_rs(x: torch.Tensor, kernel: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          group=None, fused: bool = True) -> torch.Tensor:
    """Row-parallel dense closed by a tile-fused reduce-scatter over tokens:
    ``x`` is the full-token feature-sharded ``(m, in_local)`` activation
    (rows rank-major), ``kernel`` this rank's ``(in_local, out)`` row slice;
    returns this rank's reduced ``(m/world, out)`` token block
    (:func:`~horovod_tpu_torch.ops.fused_collectives.matmul_reducescatter`).
    The bias is added after the reduction, on the owned block only."""
    y = matmul_reducescatter(x, kernel, group, fused=fused)
    return y + bias if bias is not None else y
