"""Cross-rank synchronized batch normalization
(``horovod_tpu/optim/sync_batch_norm.py``).

The JAX package synchronizes the batch statistics with a ``psum`` inside
the compiled step and lets XLA differentiate through it (the transpose of
a psum is a psum) and fuse the reductions into one collective.  Here
``torch.distributed.all_reduce`` has no gradient, so
:func:`sync_batch_stats` packs the local sums into one fp32 buffer,
``[Σx (C), Σx² (C), n (1)]``, and all-reduces it in a
``torch.autograd.Function`` whose backward all-reduces the incoming
gradient of the same buffer: one collective each way.  On a card it runs
over NCCL, ordered with the current stream.

Two entry points:

* :class:`SyncBatchNorm` — a BatchNorm module over NCHW (or channels-last
  NCHW, as :mod:`horovod_tpu_torch.models.resnet` runs its convs) whose
  batch statistics are exact over the global batch;
* :func:`sync_batch_stats` — the statistics alone, for hand-rolled
  normalization or unequal per-rank batch sizes (``counts``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn


class _AllReduceSum(torch.autograd.Function):
    """The sum of ``buf`` over ``group``; its gradient is the sum of the
    incoming gradients over the group (the transpose of a psum)."""

    @staticmethod
    def forward(ctx, buf, group):
        ctx.group = group
        out = buf.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def _channel_dims(x: torch.Tensor) -> Tuple[int, ...]:
    return (0,) + tuple(range(2, x.dim()))


def sync_batch_stats(x: torch.Tensor, group=None,
                     reduction_dims: Optional[Sequence[int]] = None,
                     counts=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global (mean, var) of ``x`` over its local reduction dims (all but
    dim 1, the channels, by default) and the ranks of ``group`` (a
    ``torch.distributed`` group; default the whole world).  With
    ``counts`` (this rank's element count), ranks with unequal batches
    weight correctly.  fp32, ``var = E[x²] − E[x]²`` clipped at 0, as the
    JAX package computes them."""
    if reduction_dims is None:
        reduction_dims = _channel_dims(x)
    reduction_dims = tuple(reduction_dims)
    x32 = x.float()
    if counts is None:
        counts = 1
        for d in reduction_dims:
            counts *= x.shape[d]
    if isinstance(counts, torch.Tensor):
        counts = counts.to(device=x.device, dtype=torch.float32).reshape(1)
    else:
        # filled on the device: a copy from the host would wait for the
        # stream
        counts = torch.full((1,), float(counts), dtype=torch.float32,
                            device=x.device)
    s = x32.sum(reduction_dims)
    c = s.numel()
    total = _AllReduceSum.apply(
        torch.cat([s.reshape(-1), x32.square().sum(reduction_dims)
                   .reshape(-1), counts]),
        group if group is not None else dist.group.WORLD)
    # times the reciprocal, as torch's CUDA mean computes a mean: at a
    # world of one the forward is then BatchNorm's on the card bit for bit
    inv = 1.0 / total[2 * c]
    mean = (total[:c] * inv).reshape(s.shape)
    var = (total[c:2 * c] * inv).reshape(s.shape) - mean.square()
    return mean, var.clamp_min(0.0)


def _channel(v: torch.Tensor, ndim: int) -> torch.Tensor:
    return v.reshape((-1,) + (1,) * (ndim - 2))


class SyncBatchNorm(nn.Module):
    """BatchNorm whose batch statistics are exact over the global batch
    (flax ``SyncBatchNorm`` of the JAX package: momentum 0.9, eps 1e-5,
    fp32 statistics, the result in ``dtype`` or the input's).

    ``scale`` and ``bias`` are parameters; the running ``mean`` and
    ``var`` are fp32 buffers (flax's ``batch_stats``).  Since the synced
    statistics are the same on every rank, the running statistics stay
    replicated with no extra collective.  ``use_running_average`` (at
    construction, or per call) normalizes with them and makes no
    collective call.  ``group`` is a ``torch.distributed`` group, such as
    a plan's dp group (``step.mesh.group("dp")``); default the world.
    """

    def __init__(self, num_features: int, use_running_average: bool = False,
                 group=None, momentum: float = 0.9, eps: float = 1e-5,
                 dtype: Optional[torch.dtype] = None, use_bias: bool = True,
                 use_scale: bool = True, device=None):
        super().__init__()
        self.use_running_average = use_running_average
        self.group = group
        self.momentum, self.eps, self.dtype = momentum, eps, dtype
        self.scale = nn.Parameter(torch.ones(num_features, device=device)) \
            if use_scale else None
        self.bias = nn.Parameter(torch.zeros(num_features, device=device)) \
            if use_bias else None
        self.register_buffer("mean", torch.zeros(num_features,
                                                 device=device))
        self.register_buffer("var", torch.ones(num_features, device=device))

    def forward(self, x: torch.Tensor,
                use_running_average: Optional[bool] = None) -> torch.Tensor:
        if use_running_average is None:
            use_running_average = self.use_running_average
        # one cast for the statistics and the normalization: the input's
        # gradient is then summed in fp32 and rounded once, as BatchNorm's
        # (the JAX module casts twice and rounds the two parts apart)
        x32 = x.float()
        if use_running_average:
            mean, var = self.mean, self.var
        else:
            mean, var = sync_batch_stats(x32, group=self.group)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        # the order of the port's BatchNorm (flax's): (x - mean) times
        # rsqrt(var + eps)·scale, plus bias
        mul = torch.rsqrt(var + self.eps)
        if self.scale is not None:
            mul = mul * self.scale
        y = (x32 - _channel(mean, x.dim())) * _channel(mul, x.dim())
        if self.bias is not None:
            y = y + _channel(self.bias, x.dim())
        return y.to(self.dtype or x.dtype)
