"""Eager, named, asynchronous collectives with Horovod's API shape
(``horovod_tpu/ops/eager.py``).

The reference's user surface (``horovod/torch/mpi_ops.py``) is eager and
per tensor: each call enqueues one named tensor, which the background loop
negotiates across ranks, fuses and executes (``operations.cc:840-1068``).
The port keeps the call shape (``allreduce``/``allreduce_async``/
``synchronize``/``poll``, named tensors, pre/postscale, Average/Sum/Adasum/
Min/Max/Product, ``join``) with this machinery underneath:

* *world*: the ranks of the runtime (``runtime/state.py``).  Each
  collective negotiates first (:func:`_negotiate`): a fixed head of
  integers over the host gloo group, so negotiation never waits on the
  card; then it runs on the data plane :mod:`.op_manager` picks (NCCL on a
  card).  A world of one skips negotiation.
* *async*: a :class:`Handle` holds the result of a call that has been
  issued; on a card the result is ordered on the current stream, and an
  event recorded after it tells :func:`poll` whether the card is done
  without waiting.
* *fusion*: :class:`~horovod_tpu_torch.ops.bucketing.Bucketer` gathers the
  ``allreduce_async`` submissions of one (op, dtype, scales) key and
  dispatches them as one reduction of their flat concatenation, at the
  byte threshold and on ``synchronize``/``poll``/``join``.

:func:`_reduce_stacked` is the single source of the eager numerics: fp16
and bf16 are promoted to fp32 only when a scale is given, a scale of 0.0
is legal, Average of integers is the mean cast back to the integer type,
and Min, Max and Product have no zero identity, so they raise under join.
The device plane's :func:`_reduce_flat` runs the same steps around one
``all_reduce``.  These differ from the in-step exchange
(``ops/collectives.grouped_allreduce``), which scales bf16 in bf16 and
folds Average's ``1/size`` into its postscale.

The reference's stall inspector and timeline spans around each phase are
not ported yet.
"""

from __future__ import annotations

import hashlib
import pickle
import threading
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from horovod_tpu_torch.exceptions import HorovodInternalError
from horovod_tpu_torch.ops import op_manager
from horovod_tpu_torch.ops.adasum import adasum_tree
from horovod_tpu_torch.ops.collectives import Average, ReduceOp, Sum
from horovod_tpu_torch.ops.kernels import fused_scale
from horovod_tpu_torch.runtime import state

# Reference error text: common.h:163 DUPLICATE_NAME_ERROR
_DUPLICATE_NAME_ERROR = (
    "Requested to collect a tensor with the same name as another tensor "
    "that is currently being processed. If you want to request another "
    "tensor, use a different tensor name.")

# Reference join-incompatibility error texts (``controller.cc:487-497,569``).
_JOIN_UNSUPPORTED = {
    "allgather": "Allgather is not supported with Join at this time. "
                 "Specify sparse_as_dense=True if using DistributedOptimizer",
    "alltoall": "Alltoall is not supported with Join at this time.",
    "broadcast": "Broadcast is not supported with Join at this time.",
}
# Allreduce ops a joined rank can zero-fill: zeros are the identity for
# SUM; AVERAGE is sum then 1/world, so joined zeros lower the mean as in the
# reference (``operations.cc:851-854``); Adasum's combine is zero-safe.
# MIN/MAX/PRODUCT have no zero identity and raise under join.
_JOIN_ZERO_OPS = (ReduceOp.SUM, ReduceOp.AVERAGE, ReduceOp.ADASUM)

_INT8_REJECTED = (
    "Compression.int8 is an in-jit wire reduction (shard_map mode); the "
    "eager plane exchanges whole tensors — use Compression.fp16/bf16 here")

#: the dtypes ``fused_scale``'s kernel takes; float64 is scaled in float64
_SCALE_DTYPES = (torch.float32, torch.bfloat16, torch.float16)

_name_lock = threading.Lock()
_name_counter = 0


def _join_bad_op_error(op_name: str) -> str:
    """One message for active and joined ranks: every rank of an error
    cycle raises the identical error."""
    return (f"Allreduce op {op_name} is not supported with Join: zero "
            f"contributions from joined ranks have no identity under "
            f"{op_name}.")


class _World:
    """The eager plane's state for one world (``GlobalState.eager``): the
    handles in flight, the negotiation cycle counter and caches, and the
    Bucketer.  A new ``init()`` starts from a fresh one."""

    def __init__(self):
        from horovod_tpu_torch.ops.bucketing import Bucketer

        self.lock = threading.Lock()
        self.in_flight: dict = {}
        # Every eager collective runs one negotiation round, and rounds are
        # themselves collectives, so the counter advances in lock-step on
        # every rank; join() records the tick at which each rank joined.
        self.cycle = 0
        self.validated: set = set()
        # digest -> descriptor, kept on every rank so that a joined rank
        # can replay a collective it has seen without the payload exchange
        self.desc_cache: dict = {}
        self.bucketer = Bucketer()


def _world() -> _World:
    st = state.global_state()
    if st.eager is None:
        st.eager = _World()
    return st.eager


def _next_name(prefix: str) -> str:
    global _name_counter
    with _name_lock:
        _name_counter += 1
        return f"{prefix}.noname.{_name_counter}"


def _size() -> int:
    return state.global_state().size


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name.removeprefix("torch."))


def _intake(tensor) -> torch.Tensor:
    """A tensor as given; anything else (a numpy array, a number) as a
    tensor on the runtime's device."""
    if isinstance(tensor, torch.Tensor):
        return tensor.detach()
    return torch.as_tensor(np.asarray(tensor),
                           device=state.global_state().device)


# ---------------------------------------------------------------------------
# negotiation
# ---------------------------------------------------------------------------

class _Negotiation:
    """Outcome of one controller cycle."""

    __slots__ = ("all_joined", "last_rank", "joined", "desc")

    def __init__(self, all_joined, last_rank, joined, desc):
        self.all_joined = all_joined
        self.last_rank = last_rank
        self.joined = joined      # ranks currently in join()
        self.desc = desc          # the agreed collective descriptor


def _allgather_host_metadata(arr: np.ndarray) -> np.ndarray:
    """Fixed-shape host metadata allgather over the ranks (the controller's
    recvcount/splits exchange, ``mpi_controller.cc:164-231``), over the
    host group; ``(world, *arr.shape)``.  int64 stays int64."""
    arr = np.ascontiguousarray(arr)
    if _size() == 1:
        return arr[None]
    return op_manager.active_op().metadata_allgather(arr)


def _negotiate(desc: Optional[dict], join_cycle: int = -1) -> _Negotiation:
    """One negotiation cycle: controller-lite with join.

    The reference's coordinator gathers each rank's requests every cycle,
    checks that dtype, shape and op agree, counts JOIN requests, and turns
    a mismatch into an error delivered on every rank
    (``controller.cc:63, 220-223, 380``).  Here each cycle allgathers a
    fixed head over the host group:

      ``[is_join, join_cycle, payload_len, sha256(payload) as 4 words]``

    * every rank joined: all leave join(); the last rank is the one with
      the highest join tick (ties: the highest rank);
    * joined and active ranks mixed: while the descriptor's digest is
      unseen, one payload exchange tells the joined ranks the collective,
      so that they can contribute zeros (allreduce only; the others raise
      the reference's texts, ``controller.cc:487-497,569``);
    * active ranks' digests disagree: HorovodInternalError on all of them,
      and on every joined rank, naming the divergent ranks.

    The caches are wire state: whether the payload is exchanged is read
    from cache membership on every rank, which is sound because every
    rank changes the caches at the same cycle (the size bound below
    clears them at the same cycle too)."""
    w = _world()
    st = state.global_state()
    nproc = st.size
    w.cycle += 1
    if len(w.validated) > st.config.cache_capacity:
        w.validated.clear()
        w.desc_cache.clear()

    if desc is None:
        payload = b""
        head = np.zeros((7,), np.int64)
        head[0], head[1] = 1, join_cycle
    else:
        payload = pickle.dumps(desc, protocol=4)
        digest = hashlib.sha256(payload).digest()
        head = np.empty((7,), np.int64)
        head[0], head[1], head[2] = 0, -1, len(payload)
        head[3:] = np.frombuffer(digest, np.int64)[:4]

    heads = _allgather_host_metadata(head)  # (nproc, 7)
    joined = [p for p in range(nproc) if heads[p, 0]]
    active = [p for p in range(nproc) if not heads[p, 0]]

    if not active:
        ticks = heads[:, 1]
        last = max(range(nproc), key=lambda p: (int(ticks[p]), p))
        return _Negotiation(True, int(last), joined, None)

    ref = active[0]
    ref_digest = heads[ref, 3:].tobytes()
    seen = ref_digest in w.validated

    need_payload = bool(joined) and not seen
    shared_desc = desc
    if need_payload:
        maxlen = int(heads[:, 2].max())
        wire_len = ((maxlen + 7) // 8) * 8
        raw = np.zeros((wire_len,), np.uint8)
        raw[:len(payload)] = np.frombuffer(payload, np.uint8)
        allp = _allgather_host_metadata(raw.view(np.int64))
        if desc is None:
            # bytes this program's ranks wrote, in this negotiation
            shared_desc = pickle.loads(
                allp[ref].tobytes()[:int(heads[ref, 2])])
    elif desc is None:
        shared_desc = w.desc_cache.get(ref_digest)
        if shared_desc is None:  # pragma: no cover - invariant violation
            raise HorovodInternalError(
                "internal: joined process has no cached descriptor for a "
                "previously-validated collective — negotiation caches "
                "desynchronized across processes.")

    bad = [p for p in active
           if not (heads[p, 2:] == heads[ref, 2:]).all()]
    if desc is None:
        # a joined rank raises the active ranks' mismatch too: they stop
        # issuing collectives, so its next head exchange would never end
        if bad:
            raise HorovodInternalError(
                f"Mismatched collective across processes while this "
                f"process (rank {st.rank}) was in join(): "
                f"process(es) {bad} disagree with process {ref} on the "
                f"name/dtype/shape/op for this collective slot. All "
                f"processes must issue identical collectives in "
                f"identical order.")
        if not seen:
            w.validated.add(ref_digest)
            w.desc_cache[ref_digest] = shared_desc
        return _Negotiation(False, -1, joined, shared_desc)
    if bad:
        raise HorovodInternalError(
            f"Mismatched {desc.get('kind')} across processes: process "
            f"{st.rank} submitted [{desc.get('sig')}] but "
            f"process(es) {bad} disagree with process {ref} on the "
            f"name/dtype/shape/op for this collective slot. All processes "
            f"must issue identical collectives in identical order.")

    if not seen:
        w.validated.add(ref_digest)
        w.desc_cache[ref_digest] = desc
    st.cache_stats["hits" if seen else "misses"] += 1

    if joined:
        kind = desc.get("kind")
        if kind in _JOIN_UNSUPPORTED:
            raise HorovodInternalError(_JOIN_UNSUPPORTED[kind])
        if kind == "allreduce" and \
                ReduceOp[desc["op"]] not in _JOIN_ZERO_OPS:
            raise HorovodInternalError(_join_bad_op_error(desc["op"]))
    return _Negotiation(False, -1, joined, shared_desc)


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------

def _scale_pass(x: torch.Tensor, factor: float,
                dtype: torch.dtype) -> torch.Tensor:
    """``x * factor`` cast to ``dtype``: a ``fused_scale`` pass (in place
    when the dtype is unchanged: ``x`` is the reduction's own buffer) for
    the kernel's dtypes, else a float64 product."""
    if x.dtype in _SCALE_DTYPES and dtype in _SCALE_DTYPES:
        return fused_scale(x, factor, dtype,
                           out=x if x.dtype == dtype else None)
    return (x.double() * factor).to(dtype)


def _prescaled(x: torch.Tensor, prescale, scaled: bool) -> torch.Tensor:
    """The first two steps of :func:`_reduce_stacked`: when any scale is
    given, fp16/bf16 widen to fp32 and integers to float64 (the host
    plane's numpy types); then ``x * prescale``."""
    if not scaled:
        return x
    wide = torch.float32 if x.dtype in (torch.float16, torch.bfloat16) \
        else x.dtype if x.is_floating_point() else torch.float64
    if prescale is None:
        return x.to(wide)
    return _scale_pass(x, prescale, wide)


def _postscaled(y: torch.Tensor, postscale, dtype) -> torch.Tensor:
    """The last two steps: ``y * postscale``, cast back to ``dtype``."""
    if postscale is None:
        return y.to(dtype)
    return _scale_pass(y, postscale, dtype)


def _mean(total: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """Average of ``n`` contributions summed in ``total``: floats divide in
    their own type; integers take the float64 mean, truncated back."""
    if total.is_floating_point():
        return total.div_(n) if n > 1 else total
    return (total.double() / n).to(dtype)


def _reduce_stacked(x: torch.Tensor, op: ReduceOp, prescale, postscale,
                    segments: tuple = ()) -> torch.Tensor:
    """Reduce a stacked ``(world, n)`` tensor of per-rank rows: the single
    source of the eager numerics (JAX ``_reduce_stacked``), run by the
    host plane and, for Adasum, by the device plane."""
    # 0.0 is a legal scale factor, so test against None, not truthiness
    scaled = prescale is not None or postscale is not None
    dtype = x.dtype
    nproc = x.shape[0]
    x = _prescaled(x, prescale, scaled)
    if op == ReduceOp.ADASUM:
        if segments:
            outs, off = [], 0
            for seg in segments:
                outs.append(adasum_tree([x[i, off:off + seg]
                                         for i in range(nproc)]))
                off += seg
            y = torch.cat(outs) if len(outs) > 1 else outs[0]
        else:
            y = adasum_tree([x[i] for i in range(nproc)])
    elif op in (ReduceOp.AVERAGE, ReduceOp.SUM):
        y = x.sum(0, dtype=x.dtype)
        if op == ReduceOp.AVERAGE:
            y = _mean(y, nproc, x.dtype)
    elif op == ReduceOp.MIN:
        y = x.amin(0)
    elif op == ReduceOp.MAX:
        y = x.amax(0)
    elif op == ReduceOp.PRODUCT:
        y = x.prod(0, dtype=x.dtype)
    else:
        raise ValueError(f"unsupported op {op}")
    return _postscaled(y, postscale, dtype)


_DIST_OPS = {ReduceOp.AVERAGE: "SUM", ReduceOp.SUM: "SUM",
             ReduceOp.MIN: "MIN", ReduceOp.MAX: "MAX",
             ReduceOp.PRODUCT: "PRODUCT"}


def _reduce_flat(flat: torch.Tensor, op: ReduceOp, prescale,
                 postscale) -> torch.Tensor:
    """The device plane's reduction of this rank's ``flat`` row: the steps
    of :func:`_reduce_stacked` around one ``all_reduce`` of the whole
    buffer, which ``flat`` is (it is overwritten)."""
    scaled = prescale is not None or postscale is not None
    dtype = flat.dtype
    buf = _prescaled(flat, prescale, scaled)
    dist.all_reduce(buf, op=getattr(dist.ReduceOp, _DIST_OPS[op]))
    if op == ReduceOp.AVERAGE:
        buf = _mean(buf, _size(), buf.dtype)
    return _postscaled(buf, postscale, dtype)


# ---------------------------------------------------------------------------
# handles
# ---------------------------------------------------------------------------

class Handle:
    """Async collective handle (reference torch handle model:
    ``allreduce_async`` returns a handle that ``synchronize()`` resolves,
    ``torch/mpi_ops.py:606``)."""

    def __init__(self, name: str):
        self.name = name
        self._result = None
        self._done = False
        self._error: Optional[Exception] = None
        self._event = None
        self._decompress = (None, None)

    def _fulfill(self, result: torch.Tensor) -> None:
        self._result = result
        if result.is_cuda:
            self._event = torch.cuda.Event()
            self._event.record()
        self._finish()

    def _fail(self, err: Exception) -> None:
        self._error = err
        self._finish()

    def _finish(self) -> None:
        self._done = True
        w = _world()
        with w.lock:
            w.in_flight.pop(self.name, None)


def _register(name: str, handle: Handle) -> None:
    w = _world()
    with w.lock:
        if name in w.in_flight:
            raise HorovodInternalError(_DUPLICATE_NAME_ERROR +
                                       f" (name={name})")
        w.in_flight[name] = handle


def _fulfilled(name: str, value: torch.Tensor) -> Handle:
    """A completed handle: the world-of-one short cut of the async
    variants keeps the handle API."""
    h = Handle(name)
    h._result = value
    h._done = True
    return h


# ---------------------------------------------------------------------------
# public eager ops
# ---------------------------------------------------------------------------

def allreduce(tensor, average: Optional[bool] = None,
              name: Optional[str] = None, op: Optional[ReduceOp] = None,
              prescale_factor: Optional[float] = None,
              postscale_factor: Optional[float] = None,
              compression=None) -> torch.Tensor:
    """Synchronous allreduce across the ranks (reference
    ``horovod/torch/mpi_ops.py:allreduce``); a new tensor, the input left
    as it was."""
    return synchronize(allreduce_async(
        tensor, average=average, name=name, op=op,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
        compression=compression))


def allreduce_async(tensor, average: Optional[bool] = None,
                    name: Optional[str] = None,
                    op: Optional[ReduceOp] = None,
                    prescale_factor: Optional[float] = None,
                    postscale_factor: Optional[float] = None,
                    compression=None) -> Handle:
    """Submit ``tensor`` to the Bucketer; ``op`` defaults to Average, or
    Sum with ``average=False``.  ``Compression.fp16/bf16`` casts the
    tensor for the wire; ``Compression.int8`` is refused."""
    from horovod_tpu_torch.ops.bucketing import global_bucketer

    if op is None:
        op = Average if (average is None or average) else Sum
    if compression is not None and not hasattr(compression, "compress"):
        # refused before the handle registers: a rejected call leaves no
        # handle in flight
        raise ValueError(_INT8_REJECTED)
    name = name or _next_name("allreduce")
    handle = Handle(name)
    _register(name, handle)
    tensor = _intake(tensor)
    ctx = None
    if compression is not None:
        tensor, ctx = compression.compress(tensor)
    handle._decompress = (compression, ctx)
    global_bucketer().add(name, tensor, op, prescale_factor,
                          postscale_factor, handle)
    return handle


def _dispatch_group(entries) -> None:
    """The Bucketer's flush: one fused reduction of the entries' flat
    concatenation (``PerformOperation``, ``operations.cc:253``).  A joined
    rank replays the same flat reduction with zeros, so the descriptor
    carries the flat length, dtype, op, scales, segments and plane."""
    e0 = entries[0]
    try:
        plane = op_manager.active_op(e0.tensor)
        segments = tuple(int(e.tensor.numel()) for e in entries) \
            if e0.op == ReduceOp.ADASUM else ()
        total = int(sum(e.tensor.numel() for e in entries))
        if _size() > 1:
            _negotiate({
                "kind": "allreduce",
                "n": total,
                "dtype": str(e0.tensor.dtype),
                "op": e0.op.name,
                "pre": e0.prescale,
                "post": e0.postscale,
                "segments": segments,
                "plane": plane.name,
                "sig": "; ".join(
                    f"{e.name}:{e.tensor.dtype}:{tuple(e.tensor.shape)}:"
                    f"{e.op.name}:{e.prescale}:{e.postscale}"
                    for e in entries),
            })
        # always the concatenation, a single entry too: the buffer is the
        # reduction's own, and joined ranks replay it by length alone
        flat = torch.cat([e.tensor.reshape(-1) for e in entries])
        red = plane.reduce_rows(flat, e0.op, e0.prescale, e0.postscale,
                                segments)
        off = 0
        for e in entries:
            n = e.tensor.numel()
            e.handle._fulfill(red[off:off + n].view(e.tensor.shape))
            off += n
    except Exception as err:  # noqa: BLE001 - delivered on every handle
        for e in entries:
            e.handle._fail(err if isinstance(err, HorovodInternalError)
                           else HorovodInternalError(str(err)))


def synchronize(handle: Handle) -> torch.Tensor:
    """The handle's result once its collective has completed (reference
    ``torch/mpi_ops.py:606``): pending buckets are flushed first, and on a
    card the host waits for the handle's own event."""
    from horovod_tpu_torch.ops.bucketing import global_bucketer

    if not handle._done:
        global_bucketer().flush()
    if handle._error is not None:
        raise handle._error
    if handle._event is not None:
        handle._event.synchronize()
    result = handle._result
    compression, ctx = handle._decompress
    if compression is not None:
        result = compression.decompress(result, ctx)
    return result


def poll(handle: Handle) -> bool:
    """Whether the handle's collective has completed, without waiting
    (reference ``torch/mpi_ops.py:590``).  An undispatched handle drains
    the pending buckets first: with no background thread, the poll is the
    cycle edge, in program order on every rank.  On a card the answer is
    the handle's event's ``query()``."""
    if not handle._done:
        from horovod_tpu_torch.ops.bucketing import global_bucketer

        global_bucketer().flush()
    if not handle._done:
        return False
    return handle._event is None or handle._event.query()


def allgather(tensor, name: Optional[str] = None) -> torch.Tensor:
    """Every rank's tensor, concatenated on dim 0; first dims may differ
    by rank (reference ``EnqueueTensorAllgather``, ``operations.cc:903``)."""
    out, _ = allgather_with_sizes(tensor, name=name)
    return out


def allgather_async(tensor, name: Optional[str] = None) -> Handle:
    """Async ``allgather`` (reference ``torch/mpi_ops.py:692``): the
    negotiation runs inline, so that collectives leave in program order
    on every rank; the data moves on the plane's stream."""
    handle, _ = _allgather_submit(tensor, name)
    return handle


def allgather_with_sizes(tensor, name: Optional[str] = None):
    """``allgather`` and the negotiated first-dim sizes of every rank, a
    host ``np.ndarray`` (``allgather_object`` reuses them)."""
    handle, sizes = _allgather_submit(tensor, name)
    return synchronize(handle), sizes


def _allgather_submit(tensor, name: Optional[str] = None):
    name = name or _next_name("allgather")
    tensor = _intake(tensor)
    nproc = _size()
    if nproc == 1:
        return (_fulfilled(name, tensor.clone()),
                np.asarray([tensor.shape[0]], np.int64))
    handle = Handle(name)
    _register(name, handle)
    sizes = None
    try:
        plane = op_manager.active_op(tensor)
        # first dims may differ by rank; everything else must agree
        _negotiate({
            "kind": "allgather", "plane": plane.name,
            "sig": f"{name}:{tensor.dtype}:{tuple(tensor.shape[1:])}",
        })
        sizes = _allgather_host_metadata(
            np.asarray([tensor.shape[0]], np.int64)).reshape(nproc)
        max_rows = int(sizes.max())
        pad = tensor.new_zeros((max_rows,) + tuple(tensor.shape[1:]))
        pad[:tensor.shape[0]] = tensor
        rows = plane.allgather_padded(pad)
        handle._fulfill(torch.cat([rows[p, :int(sizes[p])]
                                   for p in range(nproc)], dim=0))
    except Exception as err:  # noqa: BLE001 - delivered by synchronize
        handle._fail(err if isinstance(err, HorovodInternalError)
                     else HorovodInternalError(str(err)))
    return handle, sizes


def broadcast(tensor, root_rank: int,
              name: Optional[str] = None) -> torch.Tensor:
    """``root_rank``'s tensor on every rank (reference
    ``EnqueueTensorBroadcast``, ``operations.cc:928``); a new tensor."""
    return synchronize(broadcast_async(tensor, root_rank, name=name))


def broadcast_async(tensor, root_rank: int,
                    name: Optional[str] = None) -> Handle:
    """Async ``broadcast`` (reference ``torch/mpi_ops.py:755``)."""
    name = name or _next_name("broadcast")
    tensor = _intake(tensor)
    if _size() == 1:
        return _fulfilled(name, tensor.clone())
    handle = Handle(name)
    _register(name, handle)
    try:
        plane = op_manager.active_op(tensor)
        _negotiate({
            "kind": "broadcast", "plane": plane.name,
            "sig": f"{name}:{tensor.dtype}:{tuple(tensor.shape)}:"
                   f"{root_rank}",
        })
        handle._fulfill(plane.bcast(tensor, root_rank))
    except Exception as err:  # noqa: BLE001 - delivered by synchronize
        handle._fail(err if isinstance(err, HorovodInternalError)
                     else HorovodInternalError(str(err)))
    return handle


def alltoall(tensor, splits=None,
             name: Optional[str] = None) -> torch.Tensor:
    """Send ``splits[i]`` rows of dim 0 to rank ``i`` (an even split when
    ``splits`` is None) and return the rows received, concatenated in
    rank order (reference ``EnqueueTensorAlltoall``,
    ``operations.cc:979``)."""
    return synchronize(alltoall_async(tensor, splits, name=name))


def alltoall_async(tensor, splits=None,
                   name: Optional[str] = None) -> Handle:
    """Async ``alltoall`` (reference ``torch/mpi_ops.py:812``)."""
    name = name or _next_name("alltoall")
    tensor = _intake(tensor)
    nproc = _size()
    if splits is None:
        if tensor.shape[0] % nproc != 0:
            raise ValueError(
                "tensor dim 0 not divisible by world size; pass splits")
        splits = np.full((nproc,), tensor.shape[0] // nproc, np.int64)
    splits = np.asarray(splits, np.int64)
    if splits.sum() != tensor.shape[0]:
        raise ValueError("splits must sum to tensor.shape[0]")
    if splits.shape != (nproc,) or (splits < 0).any():
        raise ValueError(f"splits must hold one count >= 0 for each of "
                         f"the {nproc} ranks")
    if nproc == 1:
        return _fulfilled(name, tensor.clone())
    handle = Handle(name)
    _register(name, handle)
    try:
        plane = op_manager.active_op(tensor)
        _negotiate({
            "kind": "alltoall", "plane": plane.name,
            "sig": f"{name}:{tensor.dtype}:{tuple(tensor.shape[1:])}",
        })
        all_splits = _allgather_host_metadata(splits).reshape(nproc, nproc)
        max_rows = int(all_splits.max())
        me = state.global_state().rank
        # slot-pack: slot d holds the rows for rank d
        slots = tensor.new_zeros((nproc, max_rows) + tuple(tensor.shape[1:]))
        off = 0
        for d in range(nproc):
            cnt = int(splits[d])
            slots[d, :cnt] = tensor[off:off + cnt]
            off += cnt
        cols = plane.alltoall_slots(slots)
        handle._fulfill(torch.cat(
            [cols[src, :int(all_splits[src, me])] for src in range(nproc)],
            dim=0))
    except Exception as err:  # noqa: BLE001 - delivered by synchronize
        handle._fail(err if isinstance(err, HorovodInternalError)
                     else HorovodInternalError(str(err)))
    return handle


def barrier(name: Optional[str] = None) -> None:
    """Block until every rank arrives (reference ``MPIController::Barrier``,
    ``mpi_controller.cc:225``).  The negotiation head is the barrier; a
    rank in ``join()`` sees the barrier's descriptor and keeps cycling."""
    del name
    if _size() == 1:
        return
    _negotiate({"kind": "barrier", "sig": "barrier"})


def join() -> int:
    """Uneven data: a joined rank keeps serving the other ranks'
    collectives with zero contributions until every rank has joined
    (reference ``EnqueueJoin``, ``operations.cc:1044``; zero synthesis
    ``controller.cc:263-274``), and returns the last rank to join, by the
    negotiation tick at which each rank joined (ties: the higher rank).

    While a rank is joined, the others may still issue ``allreduce``
    (Sum, Average and Adasum: the joined rank issues the identical flat
    reduction with zeros, so Average still divides by the whole world) and
    ``barrier``.  ``allgather``, ``broadcast`` and ``alltoall`` raise the
    reference's "not supported with Join" errors, and so do Min, Max and
    Product, on the active ranks and out of this loop alike; the error
    cycle completes its exchanges everywhere first, so ranks that catch
    the error stay aligned and may join again.  Ragged participation
    inside a training step is :func:`~horovod_tpu_torch.optim.join_step`'s
    zero-masking instead."""
    from horovod_tpu_torch.ops.bucketing import global_bucketer

    global_bucketer().flush()
    if _size() == 1:
        return 0
    my_tick = _world().cycle
    while True:
        neg = _negotiate(None, join_cycle=my_tick)
        if neg.all_joined:
            return neg.last_rank
        d = neg.desc
        kind = d.get("kind")
        if kind in _JOIN_UNSUPPORTED:
            raise HorovodInternalError(_JOIN_UNSUPPORTED[kind])
        if kind == "allreduce":
            op = ReduceOp[d["op"]]
            if op not in _JOIN_ZERO_OPS:
                raise HorovodInternalError(_join_bad_op_error(d["op"]))
            plane = op_manager.PLANES[d["plane"]]
            device = state.global_state().device \
                if plane is op_manager.PLANES["XLA"] else "cpu"
            zeros = torch.zeros((d["n"],), dtype=_dtype(d["dtype"]),
                                device=device)
            plane.reduce_rows(zeros, op, d["pre"], d["post"],
                              tuple(d["segments"]))
        # barrier: the head exchange was the whole contribution
