"""Collectives of the PyTorch port over ``torch.distributed``.

Counterpart of ``horovod_tpu/ops/collectives.py``, with the world as the
group: ``allreduce``, ``grouped_allreduce``, ``allgather`` (tiled or
stacked), ``allgather_v``, ``reducescatter``, ``alltoall``,
``alltoall_v``, ``broadcast``, ``barrier``, the bitwise AND/OR and the
row-sparse :func:`sparse_allreduce`, with the reference's semantics, and
Adasum (``op=Adasum``, ``ops/adasum.py``); the shared-scale int8/fp8 wire codec
(:func:`quantized_allreduce`, :func:`quantized_reducescatter`,
:func:`ef_quantized_reducescatter`); and the ZeRO-style sharded exchange,
:func:`grouped_reducescatter` → shard-local update →
:func:`grouped_allgather`, planned by :func:`make_fusion_spec`.  Where the
JAX package emits XLA collectives inside the compiled step, the port calls
NCCL (gloo on the CPU) on packed flat buffers and runs the pre/postscale
passes itself: each is one
:func:`~horovod_tpu_torch.ops.kernels.fused_scale` launch over the whole
buffer, skipped when the factor is 1 and the dtype unchanged.  Average's
``1/size`` is folded into the postscale factor, as the reference's
``operations.cc`` does (the codec divides by the world itself, as JAX's
does), and a compressor's wire cast is folded into the prescale pass.

The sharded exchange marks its phases for ``torch.profiler`` with
``record_function`` ranges: ``hvd.reduce_scatter``, ``hvd.wire_codec``
(the codec's quantize and dequantize passes and its scale agreement),
``hvd.allgather`` and, in the optimizer, ``hvd.shard_update``.
"""

from __future__ import annotations

import dataclasses
import enum
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.profiler import record_function

from horovod_tpu_torch.ops.adasum import adasum_flat
from horovod_tpu_torch.ops.bucketing import plan_buckets
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


def _reduce_adasum(flat: torch.Tensor, dtype: torch.dtype,
                   segments: Sequence[int], prescale_factor,
                   postscale_factor, wire_dtype) -> torch.Tensor:
    """Adasum of one dtype group's flat buffer over the world's layout
    (:func:`~horovod_tpu_torch.ops.adasum.adasum_flat`), every tensor with
    its own coefficients, between the prescale pass (with the wire cast)
    and the postscale pass.  No ``1/size`` is folded in."""
    wire = wire_dtype if wire_dtype is not None and \
        flat.is_floating_point() else dtype
    buf = adasum_flat(_scale(flat, prescale_factor, wire), segments)
    return _scale(buf, postscale_factor, dtype)


def grouped_allreduce(xs: Sequence[torch.Tensor],
                      op: ReduceOp = Average,
                      prescale_factor: Optional[float] = None,
                      postscale_factor: Optional[float] = None,
                      compression=None,
                      quantized_bits: Optional[int] = None
                      ) -> List[torch.Tensor]:
    """Fused allreduce of many tensors (Tensor Fusion): one flat buffer
    and one collective per dtype, then split back.  ``compression``'s
    ``wire_dtype`` (``Compression.fp16``/``bf16``) is the dtype floating
    buffers travel in; results come back in each input's dtype.

    ``quantized_bits=8`` (or ``compression=Compression.int8``) routes each
    *float* dtype group through :func:`quantized_allreduce`, one shared
    scale per tensor; integer groups stay on the exact sum.

    ``op=Adasum`` reduces each dtype group's buffer over the world's
    layout (``ops/adasum.py``: the average within a node, Adasum across
    nodes), each tensor with its own coefficients; the prescale pass runs
    before it and the postscale pass after, and no ``1/size`` is folded
    in.  The JAX package drops ``postscale_factor`` on its grouped Adasum
    call; here it applies, as it does on the single-tensor call in both."""
    if not xs:
        return []
    if quantized_bits is None:
        quantized_bits = getattr(compression, "wire_reduce_bits", None)
    if quantized_bits is not None and op not in (ReduceOp.SUM,
                                                 ReduceOp.AVERAGE):
        raise ValueError("quantized_bits supports op=Sum/Average")
    if op not in _DIST_OPS and op != ReduceOp.ADASUM:
        raise ValueError(f"unsupported ReduceOp {op!r}")
    wire_dtype = getattr(compression, "wire_dtype", None)
    groups: dict = {}
    for i, x in enumerate(xs):
        groups.setdefault(x.dtype, []).append(i)
    out: List[Optional[torch.Tensor]] = [None] * len(xs)
    for dtype, idxs in groups.items():
        flat = torch.cat([xs[i].reshape(-1) for i in idxs])
        if quantized_bits is not None and flat.is_floating_point():
            red = _scale(quantized_allreduce(
                _scale(flat, prescale_factor), op=op, bits=quantized_bits,
                segments=tuple(xs[i].numel() for i in idxs)),
                postscale_factor)
        elif op == ReduceOp.ADASUM:
            red = _reduce_adasum(flat, dtype,
                                 [xs[i].numel() for i in idxs],
                                 prescale_factor, postscale_factor,
                                 wire_dtype)
        else:
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


def _world() -> int:
    return state.global_state().size


def _reduce_scatter_tensor(out: torch.Tensor, inp: torch.Tensor) -> None:
    """Sum-reduce-scatter the flat ``inp`` into ``out`` (its 1/world
    slice), under the ``hvd.reduce_scatter`` range.  torch 2.13
    deprecates ``reduce_scatter_tensor`` for ``reduce_scatter_single``,
    which older versions lack: the new name where it exists."""
    fn = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    with record_function("hvd.reduce_scatter"):
        fn(out, inp, op=dist.ReduceOp.SUM)


def _all_gather_tensor(out: torch.Tensor, inp: torch.Tensor) -> None:
    """Gather every rank's ``inp`` into ``out`` (world × ``inp``), under
    the ``hvd.allgather`` range (``all_gather_single`` from torch 2.13)."""
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    with record_function("hvd.allgather"):
        fn(out, inp)


def allgather(x: torch.Tensor, tiled: bool = True) -> torch.Tensor:
    """Every rank's ``x`` (same shape on every rank): concatenated along
    dim 0 with ``tiled=True``, Horovod's layout, else stacked along a new
    leading dim of the world's size.  Variable first dims take
    :func:`allgather_v`."""
    if tiled and x.dim() == 0:
        raise ValueError("a tiled allgather needs a tensor of rank >= 1")
    world = _world()
    out = x.new_empty(world * x.numel())
    _all_gather_tensor(out, x.reshape(-1).contiguous())
    if tiled:
        return out.view((world * x.shape[0],) + tuple(x.shape[1:]))
    return out.view((world,) + tuple(x.shape))


def allgather_v(x: torch.Tensor, valid_count: int, max_count: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Variable-first-dim allgather: each rank contributes its first
    ``valid_count`` <= ``max_count`` rows of ``x`` (padded with zeros to
    ``max_count``).  Returns ``(gathered, counts)``: ``gathered`` is
    ``(world, max_count, ...)`` and ``counts`` the int32 ``(world,)``
    valid sizes (JAX ``allgather_v``'s static-shape layout)."""
    if x.shape[0] != max_count:
        padded = x.new_zeros((max_count,) + tuple(x.shape[1:]))
        padded[:x.shape[0]] = x
        x = padded
    gathered = allgather(x, tiled=False)
    counts = allgather(torch.tensor([int(valid_count)], dtype=torch.int32,
                                    device=x.device))
    return gathered, counts


def allgather_v_mask(counts: torch.Tensor, max_count: int) -> torch.Tensor:
    """``(world, max_count)`` bool mask of the valid rows of an
    :func:`allgather_v` result."""
    return torch.arange(max_count, device=counts.device)[None, :] < \
        counts[:, None]


def allgather_v_compact(gathered: torch.Tensor,
                        counts: torch.Tensor) -> torch.Tensor:
    """Every rank's valid rows of an :func:`allgather_v` result,
    concatenated along dim 0 (Horovod's variable allgather layout)."""
    c = counts.reshape(-1).tolist()
    return torch.cat([gathered[i, :int(n)] for i, n in enumerate(c)],
                     dim=0)


def sparse_allreduce(values: torch.Tensor, indices: torch.Tensor,
                     dense_rows: int, op: ReduceOp = Average
                     ) -> torch.Tensor:
    """Row-sparse reduction, the reference's ``IndexedSlices`` path (JAX
    ``sparse_allreduce``): every rank's ``values`` (``(n, ...)``) and
    ``indices`` (``(n,)``, its rows of the dense result) are all-gathered
    and scatter-added into the dense ``(dense_rows, ...)`` result in a
    dtype of at least fp32, one rank's shard at a time in rank order, then
    divided by the world for Average and cast back to ``values``' dtype.

    An index outside ``[0, dense_rows)`` (the fill slot ``dense_rows``) is
    dropped, as JAX's scatter drops it: it lands on a spare row past the
    result, so no host sync masks it out.  Each shard's in-range indices
    must be unique (a shard of a leaf's nonzero rows is), so each shard's
    scatter, and the result, is the same bits on every rank.  Only Sum and
    Average reduce; another op raises ``ValueError``."""
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError("sparse_allreduce supports Sum/Average")
    world = _world()
    all_vals = allgather(values, tiled=False)
    all_idx = allgather(indices, tiled=False)
    acc = torch.promote_types(values.dtype, torch.float32)
    dense = torch.zeros((dense_rows + 1,) + tuple(values.shape[1:]),
                        dtype=acc, device=values.device)
    for s in range(world):
        idx = all_idx[s].long()
        idx = torch.where((idx >= 0) & (idx < dense_rows), idx, dense_rows)
        dense.index_add_(0, idx, all_vals[s].to(acc))
    dense = dense[:dense_rows]
    if op == ReduceOp.AVERAGE:
        dense = dense / world
    return dense.to(values.dtype)


def broadcast(x: torch.Tensor, root_rank: int = 0) -> torch.Tensor:
    """The value ``root_rank`` holds, on every rank (a new tensor)."""
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.broadcast(out, src=root_rank)
    return out


def reducescatter(x: torch.Tensor, op: ReduceOp = Sum,
                  scatter_dimension: int = 0) -> torch.Tensor:
    """Reduce-scatter: each rank gets its reduced 1/world slice of ``x``
    along ``scatter_dimension``, slices in rank order (JAX
    ``psum_scatter(tiled=True)``).  ``op`` is Sum or Average."""
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError("reducescatter supports op=Sum/Average")
    world = _world()
    d = scatter_dimension % x.dim()
    if x.shape[d] % world:
        raise ValueError(f"reducescatter dim {d} of {x.shape[d]} does not "
                         f"divide by world size {world}")
    inp = x.movedim(d, 0).contiguous()
    out = inp.new_empty((inp.shape[0] // world,) + tuple(inp.shape[1:]))
    _reduce_scatter_tensor(out, inp)
    if op == ReduceOp.AVERAGE:
        out = _scale(out, 1.0 / world)
    return out.movedim(0, d)


def alltoall(x: torch.Tensor, split_axis: int = 0,
             concat_axis: int = 0) -> torch.Tensor:
    """Equal-splits alltoall (JAX ``all_to_all(tiled=True)``): ``x`` is
    split into world chunks along ``split_axis``, chunk ``j`` goes to rank
    ``j``, and the chunks received are concatenated in rank order along
    ``concat_axis``."""
    world = _world()
    s = split_axis % x.dim()
    c = concat_axis % x.dim()
    if x.shape[s] % world:
        raise ValueError(f"alltoall split dim {x.shape[s]} not divisible "
                         f"by world size {world}")
    inp = x.movedim(s, 0).contiguous()
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp)
    chunks = out.reshape((world, inp.shape[0] // world) +
                         tuple(inp.shape[1:]))
    return torch.cat([chunk.movedim(0, s) for chunk in chunks], dim=c)


def alltoall_v(x: torch.Tensor, send_counts: torch.Tensor, max_count: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Variable-splits alltoall on the equal-tile one: slot ``d`` of the
    ``(world, max_count, ...)`` ``x`` holds the rows for rank ``d``, of
    which ``send_counts[d]`` are valid.  Returns ``(received,
    recv_counts)``: slot ``s`` holds what rank ``s`` sent here."""
    world = _world()
    if x.shape[0] != world or x.shape[1] != max_count:
        raise ValueError("alltoall_v input must be (world, max_count, ...) "
                         f"slot-packed, got {tuple(x.shape)}")
    received = alltoall(x)
    recv_counts = alltoall(torch.as_tensor(send_counts, dtype=torch.int32,
                                           device=x.device))
    return received, recv_counts


def barrier() -> None:
    """Block until every rank reaches this point."""
    dist.barrier()


def _bits(x: torch.Tensor, nbits: int) -> torch.Tensor:
    """``x`` as ``(..., nbits)`` {0, 1}: arithmetic right shift and ``& 1``
    read every bit position, the sign bit included."""
    shifts = torch.arange(nbits, dtype=x.dtype, device=x.device)
    return (x[..., None] >> shifts) & 1


def _pack(bits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Repack ``(..., nbits)`` {0, 1} into ``dtype`` words.  Summed in
    int64 with the sign bit of a full-width signed word weighted
    ``-2**(nbits-1)``: the two's-complement value, so no word overflows
    (JAX accumulates unsigned and reinterprets)."""
    nbits = bits.shape[-1]
    weights = [1 << k for k in range(nbits)]
    if dtype.is_signed and nbits == torch.iinfo(dtype).bits:
        weights[-1] = -weights[-1]
    w = torch.tensor(weights, dtype=torch.int64, device=bits.device)
    return (bits.to(torch.int64) * w).sum(-1).to(dtype)


def _bit_counts(x: torch.Tensor, nbits: Optional[int]):
    """How many ranks set each bit of ``x`` (int32 ``(..., nbits)``):
    bits summed with SUM, which NCCL has, where BAND/BOR it has not."""
    nbits = nbits or torch.iinfo(x.dtype).bits
    counts = _bits(x, nbits).to(torch.int32)
    dist.all_reduce(counts, op=dist.ReduceOp.SUM)
    return counts


def bitwise_and(x: torch.Tensor, nbits: Optional[int] = None
                ) -> torch.Tensor:
    """Cross-rank bitwise AND of integer bitvectors (reference
    ``CrossRankBitwiseAnd``): a bit survives iff every rank set it, that is
    its count is the world size.  All bits of ``x``'s dtype by default;
    ``nbits`` keeps the low ones.  A bool tensor is ANDed elementwise."""
    if x.dtype == torch.bool:
        n = x.to(torch.int32)
        dist.all_reduce(n, op=dist.ReduceOp.SUM)
        return n == _world()
    return _pack((_bit_counts(x, nbits) == _world()).to(torch.int32),
                 x.dtype)


def bitwise_or(x: torch.Tensor, nbits: Optional[int] = None
               ) -> torch.Tensor:
    """Cross-rank bitwise OR (reference ``CrossRankBitwiseOr``): a bit is
    set iff any rank set it."""
    if x.dtype == torch.bool:
        n = x.to(torch.int32)
        dist.all_reduce(n, op=dist.ReduceOp.SUM)
        return n > 0
    return _pack((_bit_counts(x, nbits) > 0).to(torch.int32), x.dtype)


# ---------------------------------------------------------------------------
# the shared-scale wire codec
# ---------------------------------------------------------------------------

#: Wire codecs of ``Compression.int8`` (``HOROVOD_EXCHANGE_WIRE_DTYPE``):
#: shared-scale int8 summed exactly in int32, or fp8 e4m3 summed in fp32.
WIRE_DTYPES = ("int8", "fp8_e4m3")

#: absmax quantization targets: int8 clips at ±127, e4m3's largest finite
#: value is ±448
_WIRE_QMAX = {"int8": 127.0, "fp8_e4m3": 448.0}

#: Combine operators of the sharded exchange (``HOROVOD_EXCHANGE_REDUCTION``)
REDUCTIONS = ("sum", "adasum")


def _resolve_knob(value: Optional[str], field: str, env: str,
                  default: str, valid: Sequence[str], what: str) -> str:
    """Explicit argument > runtime config > environment > default."""
    if value is None:
        if state.is_initialized():
            value = getattr(state.global_state().config, field)
        else:
            value = os.environ.get(env, default).lower() or default
    if value not in valid:
        raise ValueError(f"{what} must be one of {tuple(valid)}, got "
                         f"{value!r}")
    return value


def _resolve_wire_dtype(wire_dtype: Optional[str]) -> str:
    """Wire codec: explicit argument > runtime config
    (``HOROVOD_EXCHANGE_WIRE_DTYPE``) > int8."""
    return _resolve_knob(wire_dtype, "exchange_wire_dtype",
                         "HOROVOD_EXCHANGE_WIRE_DTYPE", "int8",
                         WIRE_DTYPES, "exchange wire dtype")


def _resolve_reduction(reduction: Optional[str]) -> str:
    """Reduction operator: explicit argument > runtime config
    (``HOROVOD_EXCHANGE_REDUCTION``) > sum."""
    return _resolve_knob(reduction, "exchange_reduction",
                         "HOROVOD_EXCHANGE_REDUCTION", "sum", REDUCTIONS,
                         "exchange reduction")


def _bounds(n: int, segments: Sequence[int]) -> List[int]:
    """Segment boundaries of a flat buffer of ``n``; one segment without
    ``segments`` (or with one)."""
    if segments and len(segments) > 1:
        if sum(segments) != n:
            raise ValueError("segments must partition a flat buffer")
        out = [0]
        for s in segments:
            out.append(out[-1] + int(s))
        return out
    return [0, n]


def _shared_wire_scale(x32: torch.Tensor, bounds: Sequence[int],
                       qmax: float) -> torch.Tensor:
    """The shared quantization scale of each segment of the flat fp32
    ``x32``: ``max(max over ranks of the segment's absmax / qmax,
    1e-30)``, agreed by one MAX allreduce (JAX ``_shared_wire_scale``).
    The division is the multiply by fp32 ``1/qmax`` that XLA compiles
    JAX's ``/ qmax`` to, so the scales agree bit for bit.  Returns one
    scale per segment; the passes apply each through views of its segment
    instead of a full-length repeat."""
    amax = torch.stack([
        x32[a:b].abs().amax() if b > a else x32.new_zeros(())
        for a, b in zip(bounds[:-1], bounds[1:])])
    dist.all_reduce(amax, op=dist.ReduceOp.MAX)
    return torch.clamp_min(amax * (1.0 / qmax), 1e-30)


def _encode(x32: torch.Tensor, bounds: Sequence[int], scales: torch.Tensor,
            wire: str) -> torch.Tensor:
    """The wire buffer of ``x32``: ``round(x / scale)`` clipped to ±127 as
    int32 (the int8 codes, widened so the sum cannot overflow), or
    ``x / scale`` clipped to ±448 through e4m3 as fp32."""
    out = torch.empty(x32.shape, device=x32.device,
                      dtype=torch.float32 if wire == "fp8_e4m3"
                      else torch.int32)
    for i, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])):
        if b == a:
            continue
        v = x32[a:b] / scales[i]
        if wire == "fp8_e4m3":
            out[a:b] = v.clamp_(-448.0, 448.0).to(torch.float8_e4m3fn)
        else:
            out[a:b] = v.round_().clamp_(-127.0, 127.0)
    return out


def _decode(total: torch.Tensor, lo: int, bounds: Sequence[int],
            scales: torch.Tensor) -> torch.Tensor:
    """``total * scale`` in fp32 for the elements ``[lo, lo + len)`` of
    the flat buffer that ``bounds`` segments."""
    y = torch.empty(total.shape, dtype=torch.float32, device=total.device)
    hi = lo + total.numel()
    for i, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])):
        a, b = max(a, lo), min(b, hi)
        if b > a:
            torch.mul(total[a - lo:b - lo], scales[i], out=y[a - lo:b - lo])
    return y


def _subtract_sent(e: torch.Tensor, q: torch.Tensor,
                   bounds: Sequence[int], scales: torch.Tensor) -> None:
    """``e -= q * scale`` rounded once, as the fused multiply-add XLA
    compiles JAX's ``x32 - sent * scale`` to: what the wire did not carry,
    the error-feedback residual.  In float64 the product is exact and,
    since ``q * scale`` is within a few binades of ``e`` (or 0), so is the
    difference, which then rounds once to fp32."""
    for i, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])):
        if b > a:
            e[a:b] = e[a:b].double() - q[a:b].double() * \
                scales[i].double()


def _check_codec(bits: int, op: ReduceOp, name: str) -> None:
    if bits != 8:
        raise ValueError("only 8-bit quantization is supported")
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError(f"{name} supports Sum/Average")


def _check_scatter(x: torch.Tensor, world: int, name: str) -> None:
    if x.dim() != 1 or x.shape[0] % world:
        raise ValueError(f"{name} needs a flat buffer divisible by world "
                         f"size {world}, got shape {tuple(x.shape)}")


def quantized_allreduce(x: torch.Tensor, op: ReduceOp = Average,
                        bits: int = 8, segments: Sequence[int] = (),
                        wire_dtype: Optional[str] = None) -> torch.Tensor:
    """Sum/Average with the shared-scale quantized wire (JAX
    ``quantized_allreduce``, EQuARX-style): one MAX agrees each segment's
    scale, every element is quantized against it (int8, or e4m3 under
    ``wire_dtype``/``HOROVOD_EXCHANGE_WIRE_DTYPE``), the codes are summed
    exactly (int32 for int8, fp32 for e4m3, so 4 bytes an element on the
    wire) and dequantized with the same scale.  ``segments`` gives the
    lengths of the tensors fused in a flat ``x``, each with its own
    scale.  The result has ``x``'s dtype; the operation order is JAX's, so
    the two agree bit for bit."""
    _check_codec(bits, op, "quantized_allreduce")
    wire = _resolve_wire_dtype(wire_dtype)
    if len(segments) > 1 and x.dim() != 1:
        raise ValueError("segments must partition a flat buffer")
    flat = x.float().reshape(-1)
    bounds = _bounds(flat.numel(), segments)
    with record_function("hvd.wire_codec"):
        scales = _shared_wire_scale(flat, bounds, _WIRE_QMAX[wire])
        q = _encode(flat, bounds, scales, wire)
    dist.all_reduce(q, op=dist.ReduceOp.SUM)
    with record_function("hvd.wire_codec"):
        y = _decode(q, 0, bounds, scales)
        if op == ReduceOp.AVERAGE:      # XLA's `/ world`: a multiply
            y.mul_(1.0 / _world())
    return y.reshape(x.shape).to(x.dtype)


def quantized_reducescatter(x: torch.Tensor, op: ReduceOp = Average,
                            bits: int = 8, segments: Sequence[int] = (),
                            wire_dtype: Optional[str] = None
                            ) -> torch.Tensor:
    """Reduce-scatter with the codec of :func:`quantized_allreduce` (JAX
    ``quantized_reducescatter``): the flat ``x``, divisible by the world,
    is quantized whole and this rank receives its dequantized 1/world
    slice, each element with its own segment's scale."""
    return _quantized_rs(x, op, None, bits, segments, wire_dtype,
                         "quantized_reducescatter")[0]


def ef_quantized_reducescatter(x: torch.Tensor, op: ReduceOp = Average,
                               residual: Optional[torch.Tensor] = None,
                               bits: int = 8, segments: Sequence[int] = (),
                               wire_dtype: Optional[str] = None):
    """:func:`quantized_reducescatter` with error feedback (JAX
    ``ef_quantized_reducescatter``)::

        e   = x + r                  # error-compensated input (fp32)
        q   = Q(e)                   # shared-scale int8 / e4m3 codes
        r'  = e - dQ(q)              # what the wire failed to carry
        out = reduce_scatter(q)

    Returns ``(shard, new_residual)``, the residual fp32 at ``x``'s full
    length.  A given ``residual`` is updated in place and returned: the
    exchange's residuals are its own buffers, and the step keeps one copy.
    ``op=Average`` scales only the reduced shard."""
    return _quantized_rs(x, op, residual, bits, segments, wire_dtype,
                         "ef_quantized_reducescatter", feedback=True)


def _quantized_rs(x, op, residual, bits, segments, wire_dtype, name,
                  feedback: bool = False):
    _check_codec(bits, op, name)
    wire = _resolve_wire_dtype(wire_dtype)
    world = _world()
    _check_scatter(x, world, name)
    with record_function("hvd.wire_codec"):
        if feedback:
            # e = x + r, into the residual's own buffer (or a new one)
            e = residual.add_(x) if residual is not None else \
                x.to(torch.float32, copy=True)
        else:
            e = x.float()
        bounds = _bounds(e.numel(), segments)
        scales = _shared_wire_scale(e, bounds, _WIRE_QMAX[wire])
        q = _encode(e, bounds, scales, wire)
    shard = x.shape[0] // world
    total = q.new_empty(shard)
    _reduce_scatter_tensor(total, q)
    with record_function("hvd.wire_codec"):
        if feedback:
            _subtract_sent(e, q, bounds, scales)
        y = _decode(total, state.global_state().rank * shard, bounds,
                    scales)
        if op == ReduceOp.AVERAGE:
            y.mul_(1.0 / world)
    return y.to(x.dtype), (e if feedback else None)


# ---------------------------------------------------------------------------
# the fusion plan and the sharded exchange
# ---------------------------------------------------------------------------

def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


@dataclasses.dataclass(frozen=True)
class ShardGroup:
    """One fused wire buffer of the sharded exchange: the leaves of one
    (bucket, dtype) cell, concatenated flat and zero-padded to a length
    the world divides."""

    key: str                        # "b<bucket>/<dtype>", the shard dict key
    dtype: str                      # dtype name ("float32", "bfloat16", ...)
    indices: Tuple[int, ...]        # leaf indices, bucket order
    sizes: Tuple[int, ...]          # per-leaf element counts
    shapes: Tuple[Tuple[int, ...], ...]
    padded: int                     # flat length after zero-padding
    shard: int                      # padded // world, one rank's slice


@dataclasses.dataclass(frozen=True)
class FusionSpec:
    """The static reassembly plan of a bucketed sharded exchange, built
    from leaf shapes alone, so every rank plans the same collectives."""

    groups: Tuple[ShardGroup, ...]
    world: int
    num_leaves: int


def make_fusion_spec(leaves: Sequence[torch.Tensor], world: int,
                     bucket_bytes: Optional[int] = None) -> FusionSpec:
    """Plan the bucketed sharded exchange of ``leaves`` (JAX
    ``make_fusion_spec``): :func:`plan_buckets` in reverse-layer order,
    each bucket split by dtype, each group's flat length padded up to a
    multiple of ``world``."""
    nbytes = [x.numel() * x.element_size() for x in leaves]
    groups: List[ShardGroup] = []
    for b, idxs in enumerate(plan_buckets(nbytes, bucket_bytes,
                                          reverse=True)):
        by_dtype: Dict[str, List[int]] = {}
        for i in idxs:
            by_dtype.setdefault(_dtype_name(leaves[i].dtype), []).append(i)
        for dtype, members in by_dtype.items():
            total = sum(leaves[i].numel() for i in members)
            padded = -(-max(total, 1) // world) * world
            groups.append(ShardGroup(
                key=f"b{b}/{dtype}", dtype=dtype, indices=tuple(members),
                sizes=tuple(int(leaves[i].numel()) for i in members),
                shapes=tuple(tuple(leaves[i].shape) for i in members),
                padded=padded, shard=padded // world))
    return FusionSpec(groups=tuple(groups), world=world,
                      num_leaves=len(leaves))


def _group_flat(group: ShardGroup, leaves: Sequence[torch.Tensor],
                prescale: Optional[float] = None) -> torch.Tensor:
    """A group's wire buffer: its leaves concatenated, zero-padded, and
    scaled by ``prescale`` in one pass."""
    first = leaves[group.indices[0]]
    flat = torch.empty(group.padded, dtype=first.dtype, device=first.device)
    total = sum(group.sizes)
    torch.cat([leaves[i].reshape(-1) for i in group.indices],
              out=flat[:total])
    flat[total:].zero_()
    return _scale(flat, prescale)


def local_fusion_shards(leaves: Sequence[torch.Tensor], spec: FusionSpec,
                        out: Optional[Dict[str, torch.Tensor]] = None
                        ) -> Dict[str, torch.Tensor]:
    """This rank's slice of every group buffer, no collective (JAX
    ``local_fusion_shards``): the sharded optimizer's view of the
    parameters that sit beside the gradient shard it owns.  Copied from
    the leaves slice by slice, without building the group buffer;
    written into ``out[key]`` when given."""
    me = state.global_state().rank
    result: Dict[str, torch.Tensor] = {}
    for g in spec.groups:
        first = leaves[g.indices[0]]
        buf = out[g.key] if out is not None else torch.empty(
            g.shard, dtype=first.dtype, device=first.device)
        lo, hi = me * g.shard, (me + 1) * g.shard
        buf.zero_()
        off = 0
        for i, n in zip(g.indices, g.sizes):
            a, b = max(off, lo), min(off + n, hi)
            if b > a:
                buf[a - lo:b - lo].copy_(leaves[i].reshape(-1)[a - off:
                                                               b - off])
            off += n
        result[g.key] = buf
    return result


def grouped_reducescatter(xs: Sequence[torch.Tensor],
                          op: ReduceOp = Sum,
                          prescale_factor: Optional[float] = None,
                          postscale_factor: Optional[float] = None,
                          quantized_bits: Optional[int] = None,
                          bucket_bytes: Optional[int] = None,
                          spec: Optional[FusionSpec] = None,
                          residuals: Optional[Dict[str, torch.Tensor]]
                          = None):
    """Fused reduce-scatter of many tensors, the first half of the
    ZeRO-style exchange (JAX ``grouped_reducescatter``): one zero-padded
    flat buffer per (bucket, dtype) group, prescaled in one pass,
    reduce-scattered, and this rank's slice postscaled in one pass.

    Returns ``(shards, spec)``: ``shards`` maps each :class:`ShardGroup`
    key to this rank's reduced ``(shard,)`` slice, and ``spec`` is the plan
    :func:`grouped_allgather` and :func:`local_fusion_shards` take.
    ``bucket_bytes`` splits the exchange into reverse-layer-order buckets
    (``None``: one bucket).  ``quantized_bits=8`` sends float groups
    through :func:`quantized_reducescatter`, one scale per leaf (the pad
    rides the last).  ``residuals`` (``{key: (padded,) fp32}``) switches
    quantized groups to
    :func:`ef_quantized_reducescatter`, updating those buffers in place,
    and the return to ``(shards, spec, new_residuals)``."""
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError("grouped_reducescatter supports op=Sum/Average")
    world = _world()
    if spec is None:
        spec = make_fusion_spec(xs, world, bucket_bytes)
    elif spec.world != world:
        raise ValueError(f"spec was planned for world {spec.world}, the "
                         f"world has {world}")
    shards: Dict[str, torch.Tensor] = {}
    new_residuals = dict(residuals) if residuals is not None else {}
    post = 1.0 if postscale_factor is None else float(postscale_factor)
    for g in spec.groups:
        flat = _group_flat(g, xs, prescale_factor)
        floating = flat.is_floating_point()
        if quantized_bits is not None and floating:
            segs = list(g.sizes)
            segs[-1] += g.padded - sum(g.sizes)
            if residuals is not None and g.key in residuals:
                red, new_residuals[g.key] = ef_quantized_reducescatter(
                    flat, op=op, residual=residuals[g.key],
                    bits=quantized_bits, segments=tuple(segs))
            else:
                red = quantized_reducescatter(flat, op=op,
                                              bits=quantized_bits,
                                              segments=tuple(segs))
            shards[g.key] = _scale(red, post)
            continue
        if op == ReduceOp.AVERAGE and not floating:
            raise ValueError(f"op=Average requires floating dtypes, got "
                             f"{g.dtype}")
        red = flat.new_empty(g.shard)
        _reduce_scatter_tensor(red, flat)
        shards[g.key] = _scale(red, post / world
                               if op == ReduceOp.AVERAGE else post)
    if residuals is not None:
        return shards, spec, new_residuals
    return shards, spec


def grouped_allgather(shards: Dict[str, torch.Tensor],
                      spec: FusionSpec) -> List[torch.Tensor]:
    """Reassemble every rank's group shards into full tensors, the second
    half of the sharded exchange (JAX ``grouped_allgather``): each group
    buffer is all-gathered, its padding dropped, and split back into the
    leaves' order and shapes (views of the gathered buffer)."""
    out: List[Optional[torch.Tensor]] = [None] * spec.num_leaves
    for g in spec.groups:
        s = shards[g.key].contiguous()
        flat = s.new_empty(g.padded)
        _all_gather_tensor(flat, s)
        offset = 0
        for i, n, shape in zip(g.indices, g.sizes, g.shapes):
            out[i] = flat[offset:offset + n].view(shape)
            offset += n
    return out
