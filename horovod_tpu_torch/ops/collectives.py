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

from horovod_tpu_torch.ops.adasum import adasum_flat, adasum_tree, swap
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


class _Alone:
    def __repr__(self) -> str:
        return "ALONE"


#: The scope of a collective over this rank alone (a mesh group of extent
#: 1, an :class:`ExchangeLevel` of one rank): it is the identity and
#: launches nothing.  A ``group`` of None is the world.
ALONE = _Alone()
_ALONE = ALONE


def _world() -> int:
    return state.global_state().size


def _extent(group) -> int:
    """The number of ranks in ``group`` (None: the world)."""
    if group is None:
        return _world()
    return 1 if group is _ALONE else dist.get_world_size(group)


def _index(group) -> int:
    """This rank's index in ``group`` (None: its global rank)."""
    if group is None:
        return state.global_state().rank
    return 0 if group is _ALONE else dist.get_rank(group)


def is_world(group) -> bool:
    """Whether a collective over ``group`` spans every rank: None, the
    world's group, or any group (``ALONE`` too) as large as the world."""
    return group is None or group is dist.group.WORLD or \
        _extent(group) == _world()


def _reduce_flat(flat: torch.Tensor, op: ReduceOp, dtype: torch.dtype,
                 prescale_factor, postscale_factor,
                 wire_dtype, group=None) -> torch.Tensor:
    wire = wire_dtype if wire_dtype is not None and \
        flat.is_floating_point() else dtype
    buf = _scale(flat, prescale_factor, wire)
    if group is not _ALONE:
        dist.all_reduce(buf, op=_DIST_OPS[op], group=group)
    post = 1.0 if postscale_factor is None else float(postscale_factor)
    if op == ReduceOp.AVERAGE:
        post /= _extent(group)
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
                      quantized_bits: Optional[int] = None,
                      group=None) -> List[torch.Tensor]:
    """Fused allreduce of many tensors (Tensor Fusion): one flat buffer
    and one collective per dtype, then split back.  ``compression``'s
    ``wire_dtype`` (``Compression.fp16``/``bf16``) is the dtype floating
    buffers travel in; results come back in each input's dtype.
    ``group`` is the scope (JAX's ``axis``): None for the world, a process
    group (Average divides by its size), or :data:`ALONE`, where the
    pre/postscale passes run and no collective; the quantized wire and
    Adasum take the world only.

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
    if not is_world(group) and (quantized_bits is not None or
                                op == ReduceOp.ADASUM):
        raise ValueError("the quantized wire and Adasum reduce over the "
                         "world's layout; pass group=None")
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
                               postscale_factor, wire_dtype, group)
        offset = 0
        for i in idxs:
            n = xs[i].numel()
            out[i] = red[offset:offset + n].view(xs[i].shape)
            offset += n
    return out


def allreduce(x: torch.Tensor, op: ReduceOp = Average,
              prescale_factor: Optional[float] = None,
              postscale_factor: Optional[float] = None,
              compression=None, group=None) -> torch.Tensor:
    """Allreduce of one tensor with the reference's semantics (a new
    tensor; ``x`` is left as it was), over ``group`` as
    :func:`grouped_allreduce` takes it."""
    return grouped_allreduce([x], op=op, prescale_factor=prescale_factor,
                             postscale_factor=postscale_factor,
                             compression=compression, group=group)[0]


def _reduce_scatter_tensor(out: torch.Tensor, inp: torch.Tensor,
                           group: Optional[dist.ProcessGroup] = None
                           ) -> None:
    """Sum-reduce-scatter the flat ``inp`` over ``group`` (None: the
    world) into ``out``, its slice of this rank's index, under the
    ``hvd.reduce_scatter`` range.  torch 2.13 deprecates
    ``reduce_scatter_tensor`` for ``reduce_scatter_single``, which older
    versions lack: the new name where it exists."""
    fn = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    with record_function("hvd.reduce_scatter"):
        fn(out, inp, op=dist.ReduceOp.SUM, group=group)


def _all_gather_tensor(out: torch.Tensor, inp: torch.Tensor,
                       group: Optional[dist.ProcessGroup] = None) -> None:
    """Gather the ``inp`` of every rank of ``group`` (None: the world)
    into ``out`` (extent × ``inp``, in index order), under the
    ``hvd.allgather`` range (``all_gather_single`` from torch 2.13)."""
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    with record_function("hvd.allgather"):
        fn(out, inp, group=group)


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
                       qmax: float, group=None) -> torch.Tensor:
    """The shared quantization scale of each segment of the flat fp32
    ``x32``: ``max(max over the ranks of group of the segment's absmax /
    qmax, 1e-30)``, agreed by one MAX allreduce over ``group`` (None: the
    world; none for a level of one rank), as JAX's ``pmax`` over the
    level's axis (JAX ``_shared_wire_scale``).
    The division is the multiply by fp32 ``1/qmax`` that XLA compiles
    JAX's ``/ qmax`` to, so the scales agree bit for bit.  Returns one
    scale per segment; the passes apply each through views of its segment
    instead of a full-length repeat."""
    amax = torch.stack([
        x32[a:b].abs().amax() if b > a else x32.new_zeros(())
        for a, b in zip(bounds[:-1], bounds[1:])])
    if group is not _ALONE:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
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
                  feedback: bool = False, group=None):
    """The codec's reduce-scatter over ``group`` (None: the world): the
    scale agreed, the codes summed and the slice of this rank's index
    decoded within that group only."""
    _check_codec(bits, op, name)
    wire = _resolve_wire_dtype(wire_dtype)
    world = _extent(group)
    _check_scatter(x, world, name)
    with record_function("hvd.wire_codec"):
        if feedback:
            # e = x + r, into the residual's own buffer (or a new one)
            e = residual.add_(x) if residual is not None else \
                x.to(torch.float32, copy=True)
        else:
            e = x.float()
        bounds = _bounds(e.numel(), segments)
        scales = _shared_wire_scale(e, bounds, _WIRE_QMAX[wire], group)
        q = _encode(e, bounds, scales, wire)
    shard = x.shape[0] // world
    if group is _ALONE:
        total = q
    else:
        total = q.new_empty(shard)
        _reduce_scatter_tensor(total, q, group)
    with record_function("hvd.wire_codec"):
        if feedback:
            _subtract_sent(e, q, bounds, scales)
        y = _decode(total, _index(group) * shard, bounds, scales)
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
                        out: Optional[Dict[str, torch.Tensor]] = None,
                        index: Optional[int] = None
                        ) -> Dict[str, torch.Tensor]:
    """This rank's slice of every group buffer, no collective (JAX
    ``local_fusion_shards``): the sharded optimizer's view of the
    parameters that sit beside the gradient shard it owns.  ``index`` is
    the block this rank owns: its rank under the flat exchange (the
    default), :func:`tree_shard_index` under the tree's.  Copied from the
    leaves slice by slice, without building the group buffer; written
    into ``out[key]`` when given."""
    me = state.global_state().rank if index is None else int(index)
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
        _unpack(flat, g, out)
    return out


def _unpack(flat: torch.Tensor, g: ShardGroup,
            out: List[Optional[torch.Tensor]]) -> None:
    """``g``'s leaves as views of its gathered buffer ``flat``, into
    ``out`` at their leaf indices (the padding dropped)."""
    offset = 0
    for i, n, shape in zip(g.indices, g.sizes, g.shapes):
        out[i] = flat[offset:offset + n].view(shape)
        offset += n


# ---------------------------------------------------------------------------
# the hierarchical and tree exchange
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ExchangeLevel:
    """One level of the tree exchange (JAX ``ExchangeLevel``): the process
    group its collectives run over (None at extent 1, where they are the
    identity), its extent, and the wire codec's width on its hop (None =
    full precision).  Levels go INNERMOST first: ``local`` (the NVLink
    node) before ``cross`` (the fabric between nodes).  :meth:`over`
    reads the extent from the group."""

    group: Optional[dist.ProcessGroup]
    extent: int
    quantized_bits: Optional[int] = None

    def __post_init__(self):
        if (self.group is None) != (self.extent == 1):
            raise ValueError(f"an exchange level of extent {self.extent} "
                             f"needs {'no' if self.extent == 1 else 'a'} "
                             f"process group")

    @staticmethod
    def over(group: Optional[dist.ProcessGroup],
             quantized_bits: Optional[int] = None) -> "ExchangeLevel":
        """The level over ``group`` (None: a level of one rank)."""
        return ExchangeLevel(group, 1 if group is None
                             else dist.get_world_size(group), quantized_bits)

    @property
    def index(self) -> int:
        """This rank's index in the level's group."""
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def scope(self):
        """What the codec takes as its group: the level's, or
        :data:`_ALONE` at extent 1."""
        return _ALONE if self.group is None else self.group


def exchange_levels_from_topology(tree) -> Tuple[ExchangeLevel, ...]:
    """The :class:`ExchangeLevel` of each level of a resolved
    ``runtime/topology.TopologyTree``, over the world's layout groups
    (``GlobalState.layout_group``), each at its ``wire_bits``: a ``local``
    or ``cross`` level over that group, the flat tree's one level over the
    world.  Every rank must call it together: the first call makes the
    layout's groups."""
    st = state.global_state()
    out = []
    for lv in tree.levels:
        if lv.axes is not None or lv.extent == st.size:
            group = dist.group.WORLD if lv.extent > 1 else None
        elif lv.name in state.LAYOUT_LEVELS:
            group = st.layout_group(lv.name)
        else:
            raise ValueError(f"level {lv.name!r} is not a layout level of "
                             f"this world {state.LAYOUT_LEVELS}")
        level = ExchangeLevel.over(group, lv.wire_bits)
        if level.extent != lv.extent:
            raise ValueError(f"level {lv.name!r} has extent {lv.extent}, "
                             f"its group {level.extent}")
        out.append(level)
    return tuple(out)


def tree_shard_index(levels: Sequence[ExchangeLevel]) -> int:
    """The flat block this rank owns after :func:`tree_reducescatter`
    (JAX ``tree_index_axes``): row-major over the levels innermost FIRST,
    ``k = i0·(n1·n2·…) + i1·(n2·…) + …``, so the rank at ``(cross c, local
    l)`` owns block ``l·C + c``, not its global rank ``c·L + l``."""
    k = 0
    for lv in levels:
        k = k * lv.extent + lv.index
    return k


def _adasum_combine(a: torch.Tensor, b: torch.Tensor,
                    scalar_groups: Sequence[dist.ProcessGroup]
                    ) -> torch.Tensor:
    """:func:`~horovod_tpu_torch.ops.adasum.adasum_pair` with the fp32
    ``⟨a,b⟩``, ``‖a‖²`` and ``‖b‖²`` of this rank's segment summed over
    ``scalar_groups``, the inner levels the bucket is scattered across
    (JAX ``_adasum_combine``), so that every rank applies the
    coefficients of the whole bucket.  Each sum gathers the three partials
    of every rank of the group and adds them in index order: two XOR
    partners, whose inner groups are different communicators, then hold
    the same bits, where two all-reduces could add in different orders.
    Callers pass the lower cross index's operand as ``a`` on both
    partners."""
    af, bf = a.float(), b.float()
    partial = torch.stack([torch.dot(af, bf), torch.dot(af, af),
                           torch.dot(bf, bf)])
    for group in scalar_groups:
        rows = partial.new_empty(3 * dist.get_world_size(group))
        _all_gather_tensor(rows, partial, group)
        partial = rows.view(-1, 3).sum(0)
    dot, anormsq, bnormsq = partial
    one = torch.ones((), dtype=torch.float32, device=a.device)
    acoeff = torch.where(anormsq >= 1e-30,
                         1.0 - dot / (2.0 * anormsq + 1e-30), one)
    bcoeff = torch.where(bnormsq >= 1e-30,
                         1.0 - dot / (2.0 * bnormsq + 1e-30), one)
    return (acoeff * af + bcoeff * bf).to(a.dtype)


def _quantized_pair_exchange(x: torch.Tensor, level: ExchangeLevel,
                             partner: int, wire: str):
    """One codec round of the Adasum schedule (JAX
    ``_quantized_pair_exchange``): the scale agreed over the whole level
    by one MAX, ``x`` encoded (int8 codes, or e4m3), the codes swapped
    with ``partner`` (1 byte an element), and both sides decoded, so both
    partners combine the same dequantized values.  Returns (own,
    partner's) in ``x``'s dtype."""
    x32 = x.float()
    bounds = [0, x32.numel()]
    with record_function("hvd.wire_codec"):
        scale = _shared_wire_scale(x32, bounds, _WIRE_QMAX[wire],
                                   level.group)
        codes = _encode(x32, bounds, scale, wire).to(
            torch.float8_e4m3fn if wire == "fp8_e4m3" else torch.int8)
    recv = torch.empty_like(codes)
    swap(codes.view(torch.uint8), recv.view(torch.uint8), partner,
         level.group)
    with record_function("hvd.wire_codec"):
        return ((codes.float() * scale).to(x.dtype),
                (recv.float() * scale).to(x.dtype))


def _adasum_reducescatter(block: torch.Tensor, level: ExchangeLevel,
                          scalar_groups: Sequence[dist.ProcessGroup],
                          wire_dtype: Optional[str] = None) -> torch.Tensor:
    """Adasum reduce-scatter of ``block`` over the outer ``level`` (JAX
    ``_adasum_psum_scatter``): the whole surviving block combined across
    the level, then this rank's 1/extent slice.  At a power-of-two extent,
    log2 rounds with the XOR partner (``dist.batch_isend_irecv``), each
    through the codec when the level has bits, the lower index's operand
    first on both partners so both hold the same bits; otherwise one
    all-gather and the same binary tree on every rank, without the codec,
    as JAX gathers its fallback unquantized.  Coefficients are the whole
    bucket's (:func:`_adasum_combine`), not each tensor's as
    :func:`~horovod_tpu_torch.ops.adasum.adasum_flat` takes them."""
    n, me = level.extent, level.index
    x = block
    if n & (n - 1) == 0:
        wire = _resolve_wire_dtype(wire_dtype)
        for r in range(n.bit_length() - 1):
            partner = me ^ (1 << r)
            if level.quantized_bits is not None:
                own, other = _quantized_pair_exchange(x, level, partner, wire)
            else:
                own, other = x, torch.empty_like(x)
                with record_function("hvd.reduce_scatter"):
                    swap(x, other, partner, level.group)
            lo, hi = (own, other) if me < partner else (other, own)
            x = _adasum_combine(lo, hi, scalar_groups)
    else:
        rows = x.new_empty(n * x.numel())
        _all_gather_tensor(rows, x, level.group)
        x = adasum_tree(list(rows.view(n, -1)), lambda a, b: _adasum_combine(
            a, b, scalar_groups))
    shard = x.numel() // n
    return x[me * shard:(me + 1) * shard].clone()


def tree_reducescatter(xs: Sequence[torch.Tensor],
                       levels: Sequence[ExchangeLevel],
                       op: ReduceOp = Sum,
                       prescale_factor: Optional[float] = None,
                       postscale_factor: Optional[float] = None,
                       bucket_bytes: Optional[int] = None,
                       spec: Optional[FusionSpec] = None,
                       residuals: Optional[Dict[str, torch.Tensor]] = None,
                       reduction: str = "sum"):
    """The N-level reduce-scatter (JAX ``tree_reducescatter``): each
    (bucket, dtype) group buffer is prescaled in one pass, then phase ℓ
    reduce-scatters the block that phases 0..ℓ-1 left over level ℓ's
    group, so level ℓ's fabric carries only ``(nℓ−1)/nℓ`` of
    ``B/∏inner``, and the surviving shard is postscaled in one pass (the
    Average's ``1/world`` folded in).  A level of extent 1 launches
    nothing.  Ownership is :func:`tree_shard_index`'s; reassemble with
    :func:`tree_allgather`.

    A level with ``quantized_bits`` runs its hop through the shared-scale
    codec, its scale agreed over that level's group.  The innermost hop's
    buffer is still whole, so its codec takes one scale a leaf and honours
    ``residuals`` (error feedback; the return is then ``(shards, spec,
    new_residuals)``); an outer hop's takes one scale a block, since the
    inner scatter leaves rank-dependent segment boundaries.  A codec level
    of extent 1 still quantizes, as JAX's does.

    ``reduction="adasum"`` combines on the OUTERMOST level with Adasum
    (:func:`_adasum_reducescatter`) where the tree has an outer hop of
    extent > 1; a one-level tree or an outer extent of 1 is the plain sum,
    bit for bit.  With ``op=Average`` the inner levels deliver the mean of
    the inner replicas and no ``1/world`` is applied after: the
    ``1/inner`` JAX multiplies in before the outer hop is folded into the
    prescale pass's factor here, so each group still takes two
    ``fused_scale`` passes.  That is the same bits as JAX's two multiplies
    when the inner extent is a power of two, and within one rounding
    otherwise; under error feedback the residuals then carry ``1/inner``
    of JAX's."""
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError("tree_reducescatter supports op=Sum/Average")
    if reduction not in REDUCTIONS:
        raise ValueError(f"tree_reducescatter reduction must be one of "
                         f"{REDUCTIONS}, got {reduction!r}")
    levels = tuple(levels)
    if not levels:
        raise ValueError("tree_reducescatter needs >= 1 level")
    if residuals is not None and levels[0].quantized_bits is None:
        raise ValueError("residuals carry the innermost hop's codec error "
                         "feedback; give levels[0] quantized_bits to enable "
                         "it")
    world = 1
    for lv in levels:
        world *= lv.extent
    if spec is None:
        spec = make_fusion_spec(xs, world, bucket_bytes)
    elif spec.world != world:
        raise ValueError(f"spec was planned for world {spec.world}, the "
                         f"{len(levels)}-level tree has {world}")
    outer = levels[-1]
    adasum_outer = reduction == "adasum" and len(levels) >= 2 and \
        outer.extent > 1
    scalar_groups = [lv.group for lv in levels[:-1] if lv.group is not None]
    shards: Dict[str, torch.Tensor] = {}
    new_residuals = dict(residuals) if residuals is not None else {}
    for g in spec.groups:
        floating = xs[g.indices[0]].is_floating_point()
        if op == ReduceOp.AVERAGE and not floating:
            raise ValueError(f"op=Average requires floating dtypes, got "
                             f"{g.dtype}")
        adasum = adasum_outer and floating
        pre, post = prescale_factor, \
            1.0 if postscale_factor is None else float(postscale_factor)
        if adasum and op == ReduceOp.AVERAGE:
            pre = (1.0 if pre is None else float(pre)) * \
                (outer.extent / world)
        elif op == ReduceOp.AVERAGE:
            post /= world
        block = _group_flat(g, xs, pre)
        for li, lv in enumerate(levels):
            bits = lv.quantized_bits if floating else None
            if li == 0 and bits is not None:
                segs = list(g.sizes)
                segs[-1] += g.padded - sum(g.sizes)
                res = residuals.get(g.key) if residuals is not None \
                    else None
                block, r = _quantized_rs(
                    block, ReduceOp.SUM, res, bits, tuple(segs), None,
                    "tree_reducescatter", feedback=res is not None,
                    group=lv.scope)
                if res is not None:
                    new_residuals[g.key] = r
            elif adasum and li == len(levels) - 1:
                block = _adasum_reducescatter(block, lv, scalar_groups)
            elif bits is not None:
                block = _quantized_rs(block, ReduceOp.SUM, None, bits, (),
                                      None, "tree_reducescatter",
                                      group=lv.scope)[0]
            elif lv.extent > 1:
                red = block.new_empty(block.numel() // lv.extent)
                _reduce_scatter_tensor(red, block, lv.group)
                block = red
        shards[g.key] = _scale(block, post)
    if residuals is not None:
        return shards, spec, new_residuals
    return shards, spec


def tree_allgather(shards: Dict[str, torch.Tensor], spec: FusionSpec,
                   levels: Sequence[ExchangeLevel]) -> List[torch.Tensor]:
    """Reassemble :func:`tree_reducescatter`'s shards (JAX
    ``tree_allgather``): each group's shard is all-gathered over the
    levels outermost FIRST, so each level's gather runs while the buffer
    is still shrunk by every level inside it (the slow hop moves the least
    bytes) and the concatenations land in ownership order, no permute;
    then split into the leaves (views of the gathered buffer)."""
    out: List[Optional[torch.Tensor]] = [None] * spec.num_leaves
    for g in spec.groups:
        buf = shards[g.key].contiguous()
        for lv in reversed(tuple(levels)):
            if lv.extent > 1:
                whole = buf.new_empty(buf.numel() * lv.extent)
                _all_gather_tensor(whole, buf, lv.group)
                buf = whole
        _unpack(buf, g, out)
    return out


def layout_levels(quantized_bits: Optional[int] = None,
                  quantize_inner: bool = False
                  ) -> Tuple[ExchangeLevel, ...]:
    """The world's two layout levels, ``local`` then ``cross``
    (``GlobalState.layout_group``), with ``quantized_bits`` on the cross
    hop and, with ``quantize_inner``, on the local one too.  Every rank
    must call it together: the first call makes the layout's groups."""
    st = state.global_state()
    return (ExchangeLevel.over(st.layout_group(state.LOCAL),
                               quantized_bits if quantize_inner else None),
            ExchangeLevel.over(st.layout_group(state.CROSS),
                               quantized_bits))


def hierarchical_reducescatter(xs: Sequence[torch.Tensor],
                               op: ReduceOp = Sum,
                               prescale_factor: Optional[float] = None,
                               postscale_factor: Optional[float] = None,
                               quantized_bits: Optional[int] = None,
                               bucket_bytes: Optional[int] = None,
                               spec: Optional[FusionSpec] = None,
                               quantize_inner: bool = False,
                               inner_residuals: Optional[
                                   Dict[str, torch.Tensor]] = None,
                               reduction: str = "sum"):
    """The two-level reduce-scatter over the world's layout (JAX
    ``hierarchical_reducescatter``; reference ``NCCLHierarchicalAllreduce``,
    ``nccl_operations.cc:191-341``): each group buffer is reduce-scattered
    within the node (``local``), then its surviving 1/L block across the
    nodes (``cross``), which so carries ``(C−1)/C·B/L`` bytes.
    ``quantized_bits=8`` puts the codec on the cross hop only;
    ``quantize_inner`` also on the local hop, where ``inner_residuals``
    feed its rounding back (the return is then ``(shards, spec,
    new_inner_residuals)``).  ``reduction="adasum"`` combines across the
    nodes with Adasum.  The rank at ``(cross c, local l)`` owns block
    ``l·C + c`` (:func:`tree_shard_index`); reassemble with
    :func:`hierarchical_allgather`.  Every rank must call it together: the
    first call makes the layout's groups."""
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError("hierarchical_reducescatter supports "
                         "op=Sum/Average")
    if quantize_inner and quantized_bits is None:
        raise ValueError("quantize_inner puts the codec on the local hop; "
                         "pass quantized_bits=8 to select it")
    if inner_residuals is not None and not quantize_inner:
        raise ValueError("inner_residuals carry the local codec's error "
                         "feedback; pass quantize_inner=True to enable that "
                         "hop")
    return tree_reducescatter(
        xs, layout_levels(quantized_bits, quantize_inner), op=op,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
        bucket_bytes=bucket_bytes, spec=spec, residuals=inner_residuals,
        reduction=reduction)


def hierarchical_allgather(shards: Dict[str, torch.Tensor],
                           spec: FusionSpec) -> List[torch.Tensor]:
    """Reassemble :func:`hierarchical_reducescatter`'s shards (JAX
    ``hierarchical_allgather``): across the nodes first, while the buffers
    are 1/world, then within each node."""
    return tree_allgather(shards, spec, layout_levels())
