"""Collectives of the PyTorch port over ``torch.distributed``.

Counterpart of ``horovod_tpu/ops/collectives.py``: ``allreduce``,
``grouped_allreduce``, ``allgather``, ``broadcast`` and ``barrier`` with
the reference's semantics.  Where the JAX package emits XLA collectives
inside the compiled step, the port calls NCCL (gloo on the CPU) on packed
flat buffers, one per dtype, and runs the pre/postscale passes itself:
each is one :func:`~horovod_tpu_torch.ops.kernels.fused_scale` launch over
the whole buffer, skipped when the factor is 1 and the dtype unchanged.
Average's ``1/size`` is folded into the postscale factor, as the
reference's ``operations.cc`` does, and a compressor's wire cast is folded
into the prescale pass.
"""

from __future__ import annotations

import enum
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from horovod_tpu_torch.ops.kernels import fused_scale
from horovod_tpu_torch.runtime import state


class ReduceOp(enum.IntEnum):
    """Reduction selector (reference ``ReduceOp``: Average=0, Sum=1,
    Adasum=2; min/max/product as in the JAX package)."""

    AVERAGE = 0
    SUM = 1
    ADASUM = 2
    MIN = 3
    MAX = 4
    PRODUCT = 5


Average = ReduceOp.AVERAGE
Sum = ReduceOp.SUM
Adasum = ReduceOp.ADASUM

_DIST_OPS = {ReduceOp.AVERAGE: dist.ReduceOp.SUM,
             ReduceOp.SUM: dist.ReduceOp.SUM,
             ReduceOp.MIN: dist.ReduceOp.MIN,
             ReduceOp.MAX: dist.ReduceOp.MAX,
             ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT}


def _scale(x: torch.Tensor, factor: Optional[float],
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x * factor`` cast to ``out_dtype``; ``x`` itself when there is
    nothing to do.  Floating buffers take the kernel (in place when the
    dtype is unchanged: the buffers here are the exchange's own)."""
    out_dtype = out_dtype or x.dtype
    factor = 1.0 if factor is None else float(factor)
    if factor == 1.0 and out_dtype == x.dtype:
        return x
    if not x.is_floating_point():
        # integer buffers (Average of counts): scaled in float64 and
        # truncated back; the kernel takes floating types only
        return (x.double() * factor).to(out_dtype)
    return fused_scale(x, factor, out_dtype,
                       out=x if out_dtype == x.dtype else None)


def _reduce_flat(flat: torch.Tensor, op: ReduceOp, dtype: torch.dtype,
                 prescale_factor, postscale_factor,
                 wire_dtype) -> torch.Tensor:
    wire = wire_dtype if wire_dtype is not None and \
        flat.is_floating_point() else dtype
    buf = _scale(flat, prescale_factor, wire)
    dist.all_reduce(buf, op=_DIST_OPS[op])
    post = 1.0 if postscale_factor is None else float(postscale_factor)
    if op == ReduceOp.AVERAGE:
        post /= state.global_state().size
    return _scale(buf, post, dtype)


def grouped_allreduce(xs: Sequence[torch.Tensor],
                      op: ReduceOp = Average,
                      prescale_factor: Optional[float] = None,
                      postscale_factor: Optional[float] = None,
                      compression=None) -> List[torch.Tensor]:
    """Fused allreduce of many tensors (Tensor Fusion): one flat buffer
    and one collective per dtype, then split back.  ``compression``'s
    ``wire_dtype`` (``Compression.fp16``/``bf16``) is the dtype floating
    buffers travel in; results come back in each input's dtype."""
    if not xs:
        return []
    if op not in _DIST_OPS:
        raise NotImplementedError(
            f"{op!r} is not ported to horovod_tpu_torch yet")
    wire_dtype = getattr(compression, "wire_dtype", None)
    groups: dict = {}
    for i, x in enumerate(xs):
        groups.setdefault(x.dtype, []).append(i)
    out: List[Optional[torch.Tensor]] = [None] * len(xs)
    for dtype, idxs in groups.items():
        flat = torch.cat([xs[i].reshape(-1) for i in idxs])
        red = _reduce_flat(flat, op, dtype, prescale_factor,
                           postscale_factor, wire_dtype)
        offset = 0
        for i in idxs:
            n = xs[i].numel()
            out[i] = red[offset:offset + n].view(xs[i].shape)
            offset += n
    return out


def allreduce(x: torch.Tensor, op: ReduceOp = Average,
              prescale_factor: Optional[float] = None,
              postscale_factor: Optional[float] = None,
              compression=None) -> torch.Tensor:
    """Allreduce of one tensor with the reference's semantics (a new
    tensor; ``x`` is left as it was)."""
    return grouped_allreduce([x], op=op, prescale_factor=prescale_factor,
                             postscale_factor=postscale_factor,
                             compression=compression)[0]


def allgather(x: torch.Tensor) -> torch.Tensor:
    """Concatenate every rank's ``x`` along dim 0 (same shape on every
    rank, the reference's same-shape ``allgather``)."""
    parts = [torch.empty_like(x) for _ in range(state.global_state().size)]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts, dim=0)


def broadcast(x: torch.Tensor, root_rank: int = 0) -> torch.Tensor:
    """The value ``root_rank`` holds, on every rank (a new tensor)."""
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.broadcast(out, src=root_rank)
    return out


def barrier() -> None:
    """Block until every rank reaches this point."""
    dist.barrier()
