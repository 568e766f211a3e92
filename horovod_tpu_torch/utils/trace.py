"""The structure and cost of a step, read from the port's own record of it
(the counterpart of ``horovod_tpu/utils/hlo.py``).

The JAX package reads a step's collectives, FLOPs and memory from its
compiled HLO.  The port has no HLO: it runs the step, and records it.

* :func:`record_collectives` patches ``torch.distributed`` itself while a
  block runs, so every collective the block issues is recorded whatever
  module issues it (``ops/collectives``, ``parallel/*``,
  ``ops/fused_collectives``, ``optim/sync_batch_norm``...): its kind in
  JAX's spelling, shapes, bytes (JAX's convention: a reduce-scatter's
  result per shard, an all-gather's output, an all-reduce's payload), the
  group's global ranks, and whether it was issued async.  The group comes
  from the call (``dist.get_process_group_ranks``): the profiler's
  ``c10d::*``/``gloo:*`` events carry no group.  Every module of the port
  calls the collectives as ``dist.<name>`` at call time, so none escapes
  the patch.
* :func:`op_flops`/:func:`module_flops` count the matmul class through
  ``torch.utils.flop_counter.FlopCounterMode``; the port's kernels count the
  dense work they replace (flop formulas in ``ops/kernels.py``).
* :func:`memory_high_water` is measured from the profiler's allocation
  events, not estimated.
* :func:`trace_call` runs a callable under all three and returns a
  :class:`StepTrace` (:func:`trace_collectives` under the record and the
  profiler alone), which carries each collective's stream and device
  interval on a card; :func:`serial_tail_collectives` judges the last
  reduce-scatter/all-gather window against the compute kernels of the
  other streams.

The profiler helpers that split a step's device time by host range
(:func:`launched_kernels`, :func:`range_kernels`, :func:`split_ranges`)
live here too.

Usage::

    with record_collectives() as rec:
        step(model, opt, batch)
    count_by_kind(rec.ops)            # {"all-reduce": 3}
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
import json
import re
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed import distributed_c10d as _c10d

from horovod_tpu_torch.analysis.cost_model import group_stride
from horovod_tpu_torch.ops.collectives import _dtype_name

#: the sharded exchange's ``record_function`` ranges (``ops/collectives.py``,
#: ``optim/optimizer.py``) and the parts of a step they name
ZERO_RANGES = {"hvd.reduce_scatter": "reduce-scatter",
               "hvd.wire_codec": "codec passes",
               "hvd.allgather": "allgather",
               "hvd.shard_update": "shard AdamW"}

#: the dtypes of a one-byte wire (JAX's s8/u8/fp8 set)
LOW_PRECISION = {"int8", "uint8", "float8_e4m3fn", "float8_e5m2"}

#: torch.distributed's entry points, by the kind they issue (JAX's
#: spellings); isend/irecv and batch_isend_irecv issue collective-permutes
_KIND_OF = {"all_reduce": "all-reduce",
            "reduce_scatter_tensor": "reduce-scatter",
            "reduce_scatter_single": "reduce-scatter",
            "all_gather_into_tensor": "all-gather",
            "all_gather_single": "all-gather",
            "all_gather": "all-gather",
            "all_to_all_single": "all-to-all",
            "broadcast": "collective-broadcast",
            "isend": "collective-permute",
            "irecv": "collective-permute"}

#: the tensor argument whose result carries the payload, by entry point
_PAYLOAD_ARG = {"all_reduce": "tensor", "reduce_scatter_tensor": "output",
                "reduce_scatter_single": "output",
                "all_gather_into_tensor": "output_tensor",
                "all_gather_single": "output_tensor",
                "all_gather": "tensor_list", "all_to_all_single": "output",
                "broadcast": "tensor", "isend": "tensor", "irecv": "tensor"}


@dataclasses.dataclass
class CollectiveOp:
    """One collective the recorded code issued (JAX ``CollectiveOp``; the
    group's global ranks in place of ``replica_groups``)."""

    kind: str                      # e.g. "all-reduce"
    shapes: List[Tuple[str, Tuple[int, ...]]]   # (dtype, dims) per result
    bytes: int                     # payload bytes (JAX's convention)
    ranks: Optional[Tuple[int, ...]]  # the group's global ranks
    group_size: Optional[int]      # ranks in the group
    line: str = ""                 # the call, for diagnostics
    asynchronous: bool = False     # issued with async_op=True, or a p2p op
    # on a card, from the profiler: the stream of its kernels and their
    # device interval (start, end) in us; None off the card
    stream: Optional[int] = None
    interval: Optional[Tuple[float, float]] = None
    # the record_function range it ran under while traced (internal)
    tag: str = ""

    @property
    def dtypes(self) -> set:
        return {d for d, _ in self.shapes}

    def as_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["shapes"] = [[dt, list(dims)] for dt, dims in self.shapes]
        return d

    @classmethod
    def from_json(cls, d: dict) -> "CollectiveOp":
        d = dict(d)
        d["shapes"] = [(dt, tuple(dims)) for dt, dims in d["shapes"]]
        for key in ("ranks", "interval"):
            if d.get(key) is not None:
                d[key] = tuple(d[key])
        return cls(**d)


def _tensor_shapes(t) -> List[Tuple[str, Tuple[int, ...]]]:
    ts = t if isinstance(t, (list, tuple)) else [t]
    return [(_dtype_name(x.dtype), tuple(x.shape)) for x in ts]


def _tensor_bytes(t) -> int:
    ts = t if isinstance(t, (list, tuple)) else [t]
    return sum(x.numel() * x.element_size() for x in ts)


def group_members(group=None) -> List[int]:
    """The global ranks of ``group`` (None: the world), in group-rank
    order: the counterpart of JAX's ``replica_group_members``, for the one
    group a rank calls on."""
    return list(dist.get_process_group_ranks(
        group if group is not None else dist.group.WORLD))


class _TracedWork:
    """An async work handed to the recorded code: the real one, noting
    whether it was waited within the record (HLO002)."""

    def __init__(self, work, recs: list, index: int):
        self._work = work
        self._recs = recs
        self._index = index

    def wait(self, *args, **kwargs):
        for rec in self._recs:
            rec._waited(self._index)
        return self._work.wait(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._work, name)


class CollectiveRecord:
    """What :func:`record_collectives` yields: the ops in issue order and
    the async works not (yet) waited."""

    def __init__(self):
        self.ops: List[CollectiveOp] = []
        self._pending: Dict[int, int] = {}      # work index -> op index
        self._lock = threading.Lock()

    def _add(self, op: CollectiveOp) -> int:
        with self._lock:
            self.ops.append(op)
            return len(self.ops) - 1

    def _issued(self, work_index: int, op_index: int) -> None:
        with self._lock:
            self._pending[work_index] = op_index

    def _waited(self, work_index: int) -> None:
        with self._lock:
            self._pending.pop(work_index, None)

    @property
    def unwaited(self) -> List[CollectiveOp]:
        """The ops whose async work was never waited."""
        with self._lock:
            return [self.ops[i] for i in sorted(set(self._pending.values()))]


_ACTIVE: List[CollectiveRecord] = []
_PATCH_LOCK = threading.Lock()
_ORIGINALS: Dict[str, Callable] = {}
_LOCAL = threading.local()
_COUNTER = [0]


def _active() -> List["CollectiveRecord"]:
    with _PATCH_LOCK:
        return list(_ACTIVE)


def _next_index() -> int:
    with _PATCH_LOCK:
        _COUNTER[0] += 1
        return _COUNTER[0]


def _new_op(name: str, payload, group, async_op: bool, tag: str
            ) -> CollectiveOp:
    ranks = tuple(group_members(group))
    shapes = _tensor_shapes(payload)
    return CollectiveOp(kind=_KIND_OF[name], shapes=shapes,
                        bytes=_tensor_bytes(payload), ranks=ranks,
                        group_size=len(ranks),
                        line=f"{name}({shapes}, group={list(ranks)})",
                        asynchronous=async_op, tag=tag)


def _watched(works, recs, added) -> list:
    """Each async work of a recorded call, watched for its wait, pending
    against the ops ``added`` ([(record, op index)]) until then."""
    out = []
    for work in works:
        widx = _next_index()
        for rec, i in added:
            rec._issued(widx, i)
        out.append(_TracedWork(work, recs, widx))
    return out


def _recording(name: str, fn: Callable) -> Callable:
    """``fn`` recording each call into every active record; a call made
    inside another recorded call (torch's own internals) is not."""
    sig = inspect.signature(fn)

    def record(*args, **kwargs):
        recs = _active()
        if not recs or getattr(_LOCAL, "depth", 0):
            return fn(*args, **kwargs)
        a = sig.bind(*args, **kwargs).arguments
        async_op = bool(a.get("async_op")) or name in ("isend", "irecv")
        added = []
        tag = f"hvd.trace#op{_next_index()}"
        if name != "irecv":         # the receiving half of a send's permute
            op = _new_op(name, a[_PAYLOAD_ARG[name]], a.get("group"),
                         async_op, tag)
            added = [(rec, rec._add(dataclasses.replace(op)))
                     for rec in recs]
        _LOCAL.depth = 1
        try:
            with torch.profiler.record_function(tag):
                work = fn(*args, **kwargs)
        finally:
            _LOCAL.depth = 0
        if work is None or not async_op:
            return work
        return _watched([work], recs, added)[0]

    record.__wrapped__ = fn
    return record


class _PointToPoint:
    """``dist.isend``/``dist.irecv`` while recorded: the recording call,
    equal to the real function, since ``P2POp`` accepts an op that
    compares equal to ``isend`` or ``irecv``."""

    def __init__(self, name: str, fn: Callable):
        self.__wrapped__ = fn
        self._record = _recording(name, fn)

    def __call__(self, *args, **kwargs):
        return self._record(*args, **kwargs)

    def __eq__(self, other):
        return other is self or other is self.__wrapped__

    def __hash__(self):
        return hash(self.__wrapped__)


def _recording_batch(fn: Callable) -> Callable:
    """``batch_isend_irecv`` recording each send of the list as a
    collective-permute; the real ``isend``/``irecv`` go to torch, which
    tells a send from a receive by identity."""

    def record(p2p_op_list):
        for p in p2p_op_list:
            if isinstance(p.op, _PointToPoint):
                p.op = p.op.__wrapped__
        recs = _active()
        if not recs or getattr(_LOCAL, "depth", 0):
            return fn(p2p_op_list)
        tag = f"hvd.trace#batch{_next_index()}"
        added = []
        for p in p2p_op_list:
            if p.op is _c10d.isend:
                op = _new_op("isend", p.tensor, p.group, True, tag)
                added += [(rec, rec._add(dataclasses.replace(op)))
                          for rec in recs]
        _LOCAL.depth = 1
        try:
            with torch.profiler.record_function(tag):
                works = fn(p2p_op_list)
        finally:
            _LOCAL.depth = 0
        return _watched(works, recs, added)

    record.__wrapped__ = fn
    return record


def _patch() -> None:
    for name in _KIND_OF:
        fn = getattr(dist, name, None)
        if fn is None:
            continue
        _ORIGINALS[name] = fn
        setattr(dist, name, _PointToPoint(name, fn)
                if name in ("isend", "irecv") else _recording(name, fn))
    _ORIGINALS["batch_isend_irecv"] = dist.batch_isend_irecv
    dist.batch_isend_irecv = _recording_batch(dist.batch_isend_irecv)


def _unpatch() -> None:
    for name, fn in _ORIGINALS.items():
        setattr(dist, name, fn)
    _ORIGINALS.clear()


@contextlib.contextmanager
def record_collectives():
    """Record every collective that the code under the block issues, on
    any thread (the autograd engine's device threads run the gradient
    hooks), into the :class:`CollectiveRecord` it yields.  Records nest;
    ``torch.distributed`` is patched while any is open."""
    rec = CollectiveRecord()
    with _PATCH_LOCK:
        if not _ACTIVE:
            _patch()
        _ACTIVE.append(rec)
    try:
        yield rec
    finally:
        with _PATCH_LOCK:
            _ACTIVE.remove(rec)
            if not _ACTIVE:
                _unpatch()


# -- structure ---------------------------------------------------------------


def count_by_kind(ops: Sequence[CollectiveOp]) -> dict:
    out: dict = {}
    for o in ops:
        out[o.kind] = out.get(o.kind, 0) + 1
    return out


def scopes_by_kind(ops: Sequence[CollectiveOp]) -> dict:
    """kind → sorted tuple of distinct group sizes (JAX's
    ``scopes_by_kind``).  ``None`` sizes are kept so that a scopeless op
    cannot hide."""
    out: dict = {}
    for o in ops:
        out.setdefault(o.kind, set()).add(o.group_size)
    return {k: tuple(sorted(v, key=lambda s: (s is None, s)))
            for k, v in out.items()}


def level_scopes_by_kind(ops: Sequence[CollectiveOp]) -> dict:
    """kind → sorted tuple of distinct ``(group size, stride)`` level
    signatures of groups of more than one rank.  Sizes alone alias two
    levels of equal extent (a ``(2, 2)`` layout's local and cross groups
    both have 2 ranks); the stride tells them apart (:func:`group_stride`)."""
    out: dict = {}
    for o in ops:
        if o.group_size and o.group_size > 1:
            out.setdefault(o.kind, set()).add(
                (o.group_size, group_stride(o.ranks)))
    return {k: tuple(sorted(v, key=lambda s: (s[0], s[1] is None, s[1])))
            for k, v in out.items()}


# -- FLOPs -------------------------------------------------------------------


def _flop_counter():
    from torch.utils.flop_counter import FlopCounterMode

    return FlopCounterMode(display=False)


def _counts(counter) -> Dict[str, int]:
    return {str(op): int(n)
            for op, n in counter.get_flop_counts().get("Global", {}).items()
            if n}


def op_flops(fn: Callable, *args, **kwargs) -> List[Tuple[str, int]]:
    """``(op, flops)`` of each matmul-class op that ``fn(*args,
    **kwargs)`` ran (JAX's ``op_flops``, by op rather than by HLO
    instruction), counted by ``FlopCounterMode``: matmuls, convolutions,
    attention, and the port's kernels, each of which counts the dense
    work it replaces.  Elementwise work counts nothing, as on the MXU.
    Runs ``fn``: a backward inside it counts, and so does a recomputed
    forward under a remat tier."""
    counter = _flop_counter()
    with counter:
        fn(*args, **kwargs)
    return sorted(_counts(counter).items())


def module_flops(fn: Callable, *args, **kwargs) -> int:
    """Total countable FLOPs of one call (see :func:`op_flops`)."""
    return sum(n for _, n in op_flops(fn, *args, **kwargs))


# -- memory ------------------------------------------------------------------


def _memory_events(prof, device_type: str) -> List[Tuple[int, int]]:
    """(ns, signed bytes) of the profiler's allocation events on one
    device type ("CPU" or "CUDA"), in time order."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name() == "[memory]" and \
                str(e.device_type()).endswith(device_type):
            out.append((e.start_ns(), int(e.nbytes())))
    out.sort()
    return out


def high_water_of(prof, device_type: str) -> int:
    """The peak of the bytes allocated since the profile began (its
    allocation events summed in time order, frees negative), on one
    device type: what the profiled code added at most on top of what was
    live when it began."""
    cur = peak = 0
    for _, n in _memory_events(prof, device_type):
        cur += n
        peak = max(peak, cur)
    return peak


def memory_high_water(fn: Callable, *args, **kwargs) -> int:
    """Measured peak bytes that ``fn(*args, **kwargs)`` allocated on top
    of what was live when it began, on the card when one is in use and
    else on the host, from the profiler's allocation events
    (``profile_memory=True``).  JAX's ``memory_high_water`` is a static
    liveness estimate over the HLO's buffers; this is a measurement of one
    run, so the two are not held against each other."""
    from torch.profiler import profile

    cuda, acts = _activities()
    with profile(activities=acts, profile_memory=True) as prof:
        fn(*args, **kwargs)
        if cuda:
            torch.cuda.synchronize()
    return high_water_of(prof, "CUDA" if cuda else "CPU")


def _activities():
    """(whether the card is in use, the profiler's activities for it)."""
    from torch.profiler import ProfilerActivity

    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    return cuda, [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                           else [])


# -- the step's trace --------------------------------------------------------


@dataclasses.dataclass
class Kernel:
    """One device kernel of a traced call."""

    name: str
    stream: Optional[int]
    start_us: float
    dur_us: float

    @property
    def end_us(self) -> float:
        return self.start_us + self.dur_us


@dataclasses.dataclass
class StepTrace:
    """The record of one traced call: its collectives, its device kernels
    (on a card), its FLOPs by op and its measured memory high-water.  The
    counterpart of a compiled step's HLO text; :meth:`save` writes it as
    JSON, the counterpart of an HLO dump on disk."""

    ops: List[CollectiveOp]
    kernels: List[Kernel]
    flops_by_op: Dict[str, int]
    memory_high_water_bytes: int
    # bytes allocated on the card when the call began (None off the card):
    # the base the high-water adds to
    memory_base_bytes: Optional[int] = None
    # the async works never waited within the call (HLO002)
    unwaited: int = 0
    device: str = "cpu"
    world: int = 1
    seconds: float = 0.0
    # the sp ring's extent when the call ran one (HLO007), else 1
    sp: int = 1

    @property
    def flops(self) -> int:
        return sum(self.flops_by_op.values())

    def as_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["ops"] = [o.as_json() for o in self.ops]
        return d

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.as_json(), f)

    @classmethod
    def from_json(cls, d: dict) -> "StepTrace":
        d = dict(d)
        d["ops"] = [CollectiveOp.from_json(o) for o in d["ops"]]
        d["kernels"] = [Kernel(**k) for k in d["kernels"]]
        return cls(**d)

    @classmethod
    def load(cls, path: str) -> "StepTrace":
        with open(path) as f:
            return cls.from_json(json.load(f))


def is_trace(data) -> bool:
    """Whether a loaded JSON object is a saved :class:`StepTrace`."""
    return isinstance(data, dict) and {"ops", "kernels", "flops_by_op"} \
        <= set(data)


def _is_collective_kernel(name: str) -> bool:
    return "nccl" in name.lower()


def _is_copy(name: str) -> bool:
    low = name.lower()
    return low.startswith("memcpy") or low.startswith("memset")


def _on_card(e) -> bool:
    return str(getattr(e, "device_type", "")).endswith("CUDA")


def _device_kernels(events) -> List[Kernel]:
    """The device kernels among a profiler's ``events()``: the card's
    events but the device side of annotations (``record_function``
    ranges)."""
    kernels = [Kernel(e.name, getattr(e, "device_resource_id", None),
                      float(e.time_range.start),
                      float(e.time_range.elapsed_us()))
               for e in events if _on_card(e) and
               not getattr(e, "is_user_annotation", False) and
               not is_annotation(e.name)]
    return sorted(kernels, key=lambda k: k.start_us)


def kernel_links(prof) -> Dict[int, List[Kernel]]:
    """{correlation id of a host operation: the device kernels it
    launched} of a finished profile, read from its kineto events, which
    carry the link on every torch (``FunctionEvent`` carries it only on
    some); each kernel's start in µs from the trace's start, as the
    ``FunctionEvent``'s."""
    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    out: Dict[int, List[Kernel]] = {}
    for e in res.events():
        corr = e.linked_correlation_id()
        if corr > 0 and str(e.device_type()).endswith("CUDA"):
            out.setdefault(corr, []).append(Kernel(
                e.name(), e.device_resource_id(), (e.start_ns() - t0) / 1e3,
                e.duration_ns() / 1e3))
    return out


def range_kernels_by_name(prof, prefix: str = "hvd.trace#"
                          ) -> Dict[str, List[Kernel]]:
    """{name of a host range that starts with ``prefix``: the device
    kernels that the host operations inside it launched} of a finished
    profile, from its kineto events (:func:`kernel_links`).  A host
    operation lies in a range when it starts within it on the same
    thread.  Operations and ranges carry no link of their own (linked
    id 0) and share one id space; the CUDA runtime calls carry the link
    and ids of another space, so they are left out."""
    import bisect

    links = kernel_links(prof)
    by_thread: Dict[int, list] = {}
    ranges = []
    for e in prof.profiler.kineto_results.events():
        if not str(e.device_type()).endswith("CPU") or \
                e.linked_correlation_id() != 0:
            continue
        by_thread.setdefault(e.start_thread_id(), []).append(
            (e.start_ns(), e.end_ns(), e.correlation_id()))
        if e.name().startswith(prefix):
            ranges.append((e.name(), e.start_thread_id(), e.start_ns(),
                           e.end_ns()))
    for ops in by_thread.values():
        ops.sort()
    out: Dict[str, List[Kernel]] = {}
    for name, thread, lo, hi in ranges:
        ops = by_thread[thread]
        i = bisect.bisect_left(ops, (lo,))
        ks = out.setdefault(name, [])
        while i < len(ops) and ops[i][0] <= hi:
            ks.extend(links.get(ops[i][2], ()))
            i += 1
    return out


def _place_ops(ops: List[CollectiveOp],
               spans: Dict[str, List[Kernel]]) -> None:
    """Each op's stream and device window: the span of the collective
    (NCCL) kernels that the host operations in its ``hvd.trace#`` range
    launched (:func:`range_kernels_by_name`).  An op none of whose kernels
    came back linked stays unplaced."""
    for op in ops:
        ks = [k for k in spans.get(op.tag, ())
              if _is_collective_kernel(k.name)]
        if ks:
            op.stream = ks[0].stream
            op.interval = (min(k.start_us for k in ks),
                           max(k.end_us for k in ks))


def trace_call(fn: Callable, *args, sp: int = 1, **kwargs):
    """Run ``fn(*args, **kwargs)`` once under :func:`record_collectives`,
    the profiler (with the card's activity and allocation events) and
    ``FlopCounterMode``; returns ``(result, StepTrace)``.  ``sp`` is the
    extent of an sp ring the call runs (HLO007 reads it)."""
    return _traced(fn, args, kwargs, sp=sp, full=True)


def trace_collectives(fn: Callable, *args, **kwargs):
    """:func:`trace_call` under the record and the profiler alone: the
    collectives and, on a card, the kernels and the ops' device windows,
    which :func:`serial_tail_collectives` reads.  No FLOPs are counted and
    no allocation events taken (the trace's FLOPs and memory read 0)."""
    return _traced(fn, args, kwargs, sp=1, full=False)


def _traced(fn: Callable, args, kwargs, sp: int, full: bool):
    """The body of :func:`trace_call` and :func:`trace_collectives`."""
    from torch.profiler import profile

    cuda, acts = _activities()
    base = None
    if cuda:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated() if full else None
    counter = _flop_counter() if full else contextlib.nullcontext()
    with profile(activities=acts, profile_memory=full) as prof:
        t0 = time.perf_counter()
        with record_collectives() as rec, counter:
            result = fn(*args, **kwargs)
        if cuda:
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    events = prof.events()
    kernels = _device_kernels(events) if cuda else []
    ops = rec.ops
    if cuda:
        _place_ops(ops, range_kernels_by_name(prof))
    world = dist.get_world_size() if dist.is_initialized() else 1
    device = f"cuda:{torch.cuda.current_device()}" if cuda else "cpu"
    return result, StepTrace(
        ops=ops, kernels=kernels,
        flops_by_op=_counts(counter) if full else {},
        memory_high_water_bytes=high_water_of(
            prof, "CUDA" if cuda else "CPU") if full else 0,
        memory_base_bytes=base, unwaited=len(rec.unwaited), device=device,
        world=world, seconds=seconds, sp=int(sp))


def serial_tail_collectives(trace: StepTrace,
                            kinds=("reduce-scatter", "all-gather")
                            ) -> Optional[int]:
    """1 if the device interval of the trace's last collective of
    ``kinds`` (by start) has no compute kernel running on another stream
    (a serial tail: the wire fully exposed), else 0.  A trace with no such
    collective on the device returns 0, as JAX's scan does for a
    synchronous schedule: gloo, or the CPU, has no window to judge.  On a
    card, a collective of more than one rank that got no device window
    (:func:`_place_ops`) leaves the verdict unknown: None."""
    cands = [o for o in trace.ops if o.kind in kinds]
    if trace.device.startswith("cuda") and any(
            o.interval is None and (o.group_size or 0) > 1 for o in cands):
        return None
    cands = [o for o in cands if o.interval is not None]
    if not cands:
        return 0
    last = max(cands, key=lambda o: o.interval[0])
    start, end = last.interval
    for k in trace.kernels:
        if _is_collective_kernel(k.name) or _is_copy(k.name) or \
                (last.stream is not None and k.stream == last.stream):
            continue
        if k.start_us < end and k.end_us > start:
            return 0
    return 1


# -- profiler helpers: a step's device time by host range --------------------


def is_annotation(name: str) -> bool:
    """Whether a device event is the device side of an annotation (a
    ``record_function`` range, "Optimizer.step#AdamW.step"): it spans
    kernels counted already."""
    return name in ZERO_RANGES or bool(re.fullmatch(r"[\w.]+#[\w.]+", name))


def launched_kernels(events) -> dict:
    """{correlation id of the host operation that launched it: [(name,
    start us, device us)]} of the device events among a profiler's
    ``events()``; empty where this torch's events carry no
    ``linked_correlation_id``."""
    out: dict = {}
    for e in events:
        corr = getattr(e, "linked_correlation_id", 0) or 0
        if corr > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            out.setdefault(corr, []).append(
                (e.name, e.time_range.start, e.time_range.elapsed_us()))
    return out


def range_kernels(event, launched=None) -> list:
    """(name, start us, device us) of the kernels that a host-side
    profiler event and the events under it launched, each kernel once.
    ``launched`` is :func:`launched_kernels`'s map: a kernel is then the
    device event of a host operation's correlation id, with its start, so
    one filed under both an event and its child counts once.  Without it
    the events' own ``kernels`` lists are read, which carry no start: a
    kernel is then known by (name, duration).  Annotations are left out
    (``FunctionEvent.device_time_total`` keeps them and read more than
    the step on the sharded phase)."""
    seen, out = set(), []

    def walk(e):
        found = (launched or {}).get(getattr(e, "id", None))
        if found is None:
            found = [(k.name, None, k.duration) for k in e.kernels]
        for name, start, us in found:
            key = (name, start, us)
            if not is_annotation(name) and key not in seen:
                seen.add(key)
                out.append(key)
        for c in e.cpu_children:
            walk(c)

    walk(event)
    return out


def split_ranges(events, ranges: dict, busy_ms: float) -> tuple:
    """({part: device ms}, {part: {kernel: ms}}, {part: device-side span
    ms}) of the ``record_function`` ranges in ``ranges`` ({range name:
    part}) among a profiler's ``events()``: the kernels launched under
    each range's host side, each kernel once, in the innermost range
    that holds it; "rest" is the busy time outside every range.  Raises
    when the ranges sum to more than ``busy_ms``, the step's busy device
    time."""
    launched = launched_kernels(events)
    split = dict.fromkeys(ranges.values(), 0.0)
    span = dict.fromkeys(ranges.values(), 0.0)
    top: dict = {part: {} for part in ranges.values()}
    hosts = []
    for e in events:
        if e.name not in ranges:
            continue
        if str(e.device_type).endswith("CPU"):
            hosts.append(e)
        else:
            span[ranges[e.name]] += e.time_range.elapsed_us() / 1e3
    claimed = set()
    for e in sorted(hosts, key=lambda e: e.time_range.elapsed_us()):
        part = ranges[e.name]
        for key in range_kernels(e, launched):
            if key[1] is not None and key in claimed:
                continue
            claimed.add(key)
            split[part] += key[2] / 1e3
            top[part][key[0]] = top[part].get(key[0], 0.0) + key[2] / 1e3
    total = sum(split.values())
    if total > busy_ms * (1 + 1e-9):
        raise AssertionError(
            f"the ranges' kernels read {total:.3f} ms of a step whose "
            f"device was busy {busy_ms:.3f} ms: {split}")
    split["rest"] = busy_ms - total
    return split, top, span
