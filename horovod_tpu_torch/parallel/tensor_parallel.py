"""Megatron-style tensor parallelism over a ``tp`` process group
(``horovod_tpu/parallel/tensor_parallel.py``).

Two forms, as in the JAX package:

* **Modules that hold this rank's shard.**  :class:`ColumnParallelDense`
  keeps the ``(out/tp, in)`` block of output features of its weight, and
  :class:`RowParallelDense` the ``(out, in/tp)`` block of input features.
  The JAX modules carry partition annotations that GSPMD turns into
  collectives; here the collectives are the conjugate pair of
  ``torch.autograd.Function`` classes Megatron places by hand: at a column
  module's input the identity forward and an all-reduce of dx over tp
  backward (:func:`copy_to_group`), at a row module's output an all-reduce
  over tp forward and the identity backward (:func:`reduce_from_group`).
  A column then a row around an elementwise function costs one
  all-reduce forward and one backward.  A module built with ``group=None``
  is a tp extent of one: the plain product, no collective.  A module holds
  the full weight until it is given a group, and :meth:`shard_` slices
  it in place, so that the parameter the optimizer holds becomes the
  shard (``DistributedTrainStep(plan="...,tp=n")`` does so in ``init``).
  A model that draws its weights draws each at its full shape and keeps
  :meth:`ColumnParallelDense.local` of it, as JAX draws the global array
  and shards it: a rank's shard is its slice of one draw, whatever the tp
  extent.
* **Functions over explicit local shards**: :func:`column_parallel_dense`
  and :func:`row_parallel_dense` (the all-reduce pair), and
  :func:`column_parallel_dense_ag` and :func:`row_parallel_dense_rs`, which
  keep the activations token-sharded between blocks and move them inside
  the boundary products (:mod:`horovod_tpu_torch.ops.fused_collectives`).
  Rows are rank-major flattened tokens: the gather concatenates the ranks'
  chunks and the scatter hands rank ``r`` rows ``[r·m/world, (r+1)·m/world)``.

A function's kernel is ``(in, out)`` as in the JAX package; a PyTorch
``(out, in)`` weight goes in as its transposed view, which the matmul kernel
reads in place.
"""

from __future__ import annotations

import math
from typing import Iterator, List, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.ops.fused_collectives import (
    allgather_matmul,
    group_rank,
    group_size,
    matmul_reducescatter,
)
from horovod_tpu_torch.parallel.mesh import mark_shard


# ---------------------------------------------------------------------------
# the conjugate pair
# ---------------------------------------------------------------------------

class _CopyToGroup(torch.autograd.Function):
    """Identity forward; backward sums dx over ``group`` (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromGroup(torch.autograd.Function):
    """All-reduce (sum) over ``group`` forward; identity backward
    (Megatron's g)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """A column boundary's input: ``x`` forward, its gradient summed over
    ``group`` backward (None: a group of one, ``x`` itself)."""
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """A row boundary's output: ``x`` summed over ``group`` forward, the
    gradient passed through backward (None: ``x`` itself)."""
    return x if group is None else _ReduceFromGroup.apply(x, group)


# ---------------------------------------------------------------------------
# modules that hold this rank's shard
# ---------------------------------------------------------------------------

def column_rows(features: int, tp: int, index: int,
                parts: int = 1) -> List[int]:
    """The output features rank ``index`` of ``tp`` holds of a column
    weight whose ``features`` are ``parts`` equal blocks (a fused QKV has
    three): its contiguous ``1/tp`` of each block, blocks in order.  A
    contiguous cut of the whole would give rank 0 all of q and half of k
    at tp = 2."""
    block = features // parts
    step = block // tp
    return [j * block + index * step + i
            for j in range(parts) for i in range(step)]


def _resharding(module, group) -> bool:
    """Whether ``module.shard_(group)`` has slicing to do: not when
    ``group`` is the module's own or one rank on a full module; a module
    sharded over another group raises."""
    if group is module.group or (group_size(group) == 1 and module.tp == 1):
        return False
    if module.tp > 1:
        raise ValueError(f"{type(module).__name__} is sharded over a group "
                         f"of {module.tp} already")
    return True


def _linear_weight(features: int, in_features: int,
                   device) -> nn.Parameter:
    """A full ``(features, in_features)`` weight drawn as ``nn.Linear``
    draws its own (Kaiming uniform from the global generator), so that a
    model built of these modules leaves the generator where ``nn.Linear``
    layers would; models overwrite it with their own initialisation."""
    w = nn.Parameter(torch.empty(features, in_features, device=device))
    nn.init.kaiming_uniform_(w, a=math.sqrt(5))
    return w


def _cast(t: Optional[torch.Tensor], dtype) -> Optional[torch.Tensor]:
    return t if t is None or dtype is None else t.to(dtype)


class ColumnParallelDense(nn.Module):
    """Dense with its output features sharded over ``group``
    (``ColumnParallelDense``, JAX ``:113``): ``weight`` is this rank's
    ``(features/tp, in_features)`` block (of each of ``parts`` blocks, see
    :func:`column_rows`), ``bias`` its ``(features/tp,)`` slice.  The output
    stays feature-sharded; the input's gradient is summed over the group.
    ``dtype`` is the compute dtype (both operands and the bias cast; None:
    as given)."""

    def __init__(self, in_features: int, features: int, group=None,
                 use_bias: bool = True, dtype: Optional[torch.dtype] = None,
                 parts: int = 1, device=None):
        super().__init__()
        self.in_features, self.features = in_features, features
        self.use_bias, self.dtype, self.parts = use_bias, dtype, parts
        self.group = None
        self.weight = _linear_weight(features, in_features, device)
        self.bias = nn.Parameter(torch.zeros(features, device=device)) \
            if use_bias else None
        self.shard_(group)

    @property
    def tp(self) -> int:
        """The tp extent this module is sharded over."""
        return group_size(self.group)

    def _rows(self, group) -> List[int]:
        tp = group_size(group)
        if self.features % (self.parts * tp):
            raise ValueError(
                f"ColumnParallelDense: {self.features} output features in "
                f"{self.parts} part(s) do not split over tp={tp}")
        return column_rows(self.features, tp, group_rank(group), self.parts)

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of a full ``(features, in_features)`` weight
        or ``(features,)`` bias, over the module's group."""
        if self.tp == 1:
            return full
        return full[torch.tensor(self._rows(self.group),
                                 device=full.device)].contiguous()

    @torch.no_grad()
    def shard_(self, group) -> "ColumnParallelDense":
        """Keep this rank's block of the full weight (and bias) in place:
        the parameters stay the same objects.  A no-op for the group the
        module is sharded over already, or a group of one on a full
        module."""
        if not _resharding(self, group):
            return self
        self._rows(group)               # the shape check, before any cut
        self.group = group
        for p in (self.weight, self.bias):
            if p is not None:
                p.data = self.local(p.data)
                mark_shard(p, f"tensor-parallel columns over "
                              f"{group_size(group)} ranks")
        return self

    def forward(self, x):
        x = copy_to_group(x, self.group)
        return F.linear(_cast(x, self.dtype), _cast(self.weight, self.dtype),
                        _cast(self.bias, self.dtype))


class RowParallelDense(nn.Module):
    """Dense with its input features sharded over ``group``
    (``RowParallelDense``, JAX ``:152``): ``weight`` is this rank's
    ``(features, in_features/tp)`` block; the partial products are summed
    over the group and the (replicated) ``bias`` is added after the
    reduction.  ``dtype`` as :class:`ColumnParallelDense`'s."""

    def __init__(self, in_features: int, features: int, group=None,
                 use_bias: bool = True, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        self.in_features, self.features = in_features, features
        self.use_bias, self.dtype = use_bias, dtype
        self.group = None
        self.weight = _linear_weight(features, in_features, device)
        self.bias = nn.Parameter(torch.zeros(features, device=device)) \
            if use_bias else None
        self.shard_(group)

    @property
    def tp(self) -> int:
        return group_size(self.group)

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of input features of a full ``(features,
        in_features)`` weight, over the module's group."""
        tp = self.tp
        if tp == 1:
            return full
        w, r = self.in_features // tp, group_rank(self.group)
        return full[:, r * w:(r + 1) * w].contiguous()

    @torch.no_grad()
    def shard_(self, group) -> "RowParallelDense":
        """Keep this rank's block of input features of the full weight, in
        place (the bias stays whole)."""
        if not _resharding(self, group):
            return self
        tp = group_size(group)
        if self.in_features % tp:
            raise ValueError(
                f"RowParallelDense: {self.in_features} input features do "
                f"not split over tp={tp}")
        self.group = group
        self.weight.data = self.local(self.weight.data)
        mark_shard(self.weight, f"tensor-parallel rows over {tp} ranks")
        return self

    def forward(self, x):
        y = reduce_from_group(
            F.linear(_cast(x, self.dtype), _cast(self.weight, self.dtype)),
            self.group)
        return y if self.bias is None else y + _cast(self.bias, self.dtype)


def tp_modules(model: nn.Module) -> Iterator[nn.Module]:
    """The :class:`ColumnParallelDense` and :class:`RowParallelDense`
    modules of ``model``."""
    for m in model.modules():
        if isinstance(m, (ColumnParallelDense, RowParallelDense)):
            yield m


# ---------------------------------------------------------------------------
# functions over explicit local shards
# ---------------------------------------------------------------------------

def column_parallel_dense(x: torch.Tensor, kernel: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          group=None) -> torch.Tensor:
    """Local shard of a column-parallel product: ``kernel`` is this rank's
    ``(in, out_local)`` slice; the output stays feature-sharded, and with a
    ``group`` the input's gradient is summed over it."""
    y = copy_to_group(x, group) @ kernel
    return y + bias if bias is not None else y


def row_parallel_dense(x: torch.Tensor, kernel: torch.Tensor,
                       bias: Optional[torch.Tensor] = None,
                       group=None) -> torch.Tensor:
    """Local shard of a row-parallel product closed by a sum over
    ``group``: ``x`` is feature-sharded ``(…, in_local)``, ``kernel`` the
    matching ``(in_local, out)`` slice; the output is replicated over the
    group and the bias added after the sum."""
    y = reduce_from_group(x @ kernel, group)
    return y + bias if bias is not None else y


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
