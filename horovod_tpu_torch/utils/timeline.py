"""Chrome-tracing timeline (``horovod_tpu/utils/timeline.py``), the
reference's profiling subsystem.

The reference's ``Timeline`` (``horovod/common/timeline.{h,cc}``) writes
Chrome ``chrome://tracing`` JSON from a writer thread fed by a lock-free
queue (``timeline.h:47-75``); every tensor walks a NEGOTIATING →
TOP_LEVEL → ACTIVITY state machine (``timeline.h:77``) with activity names
from ``common.h:32-62`` (QUEUE, MEMCPY_IN_FUSION_BUFFER, NCCL_ALLREDUCE,
...).  Here each eager tensor walks NEGOTIATE (submitted, until its cycle's
negotiation agrees) → the collective, whose activity is named after the
backend that moved the data, as the reference names it: ``NCCL_ALLREDUCE``
on a card, ``GLOO_ALLREDUCE`` on the CPU or the host plane
(:func:`collective_activity`; the JAX package says ``XLA_ALLREDUCE``).
This is the host's view of the orchestration; the card's kernels are in
``torch.profiler`` traces, where every span of the timeline also shows as a
``record_function`` range named ``hvd:ACTIVITY:tensor``
(:class:`ProfilerRangeBridge`).  Enabled by ``HOROVOD_TIMELINE=file.json``
(``operations.cc:417-424``) or ``hvd.start_timeline``; the native writer
(:class:`~horovod_tpu_torch.native.NativeTimeline`) serves unless
``HOROVOD_TIMELINE_PYTHON`` is set or the library is unavailable.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from typing import Optional

import torch

from horovod_tpu_torch import faults

# Activity names mirroring common.h:32-62
QUEUE = "QUEUE"
NEGOTIATE = "NEGOTIATE"            # NEGOTIATE_ALLREDUCE/... analogue
FUSE = "FUSE"                      # MEMCPY_IN_FUSION_BUFFER analogue
COLLECTIVE = "COLLECTIVE"
COMPILE = "COMPILE"
UNFUSE = "UNFUSE"                  # MEMCPY_OUT_FUSION_BUFFER analogue
#: the collectives' kinds; :func:`collective_activity` prefixes the backend
ALLREDUCE = "ALLREDUCE"
ALLGATHER = "ALLGATHER"
BROADCAST = "BROADCAST"
ALLTOALL = "ALLTOALL"
REDUCESCATTER = "REDUCESCATTER"
BARRIER = "BARRIER"


def collective_activity(kind: str, backend: str) -> str:
    """The activity of a ``kind`` collective that ran on ``backend``
    (``"nccl"`` or ``"gloo"``): ``NCCL_ALLREDUCE``, ``GLOO_ALLGATHER``, ..."""
    return f"{backend.upper()}_{kind}"


class ProfilerRangeBridge:
    """Mirrors the timeline's activity spans into ``torch.profiler`` as
    ``record_function`` ranges named ``hvd:ACTIVITY:tensor`` (the JAX
    package's ``TraceAnnotationBridge`` over ``jax.profiler``), so that a
    profiler trace shows the host rows of the timeline above the kernels
    they launched.  With no profiler running no range is opened, so the
    bridge costs one check an event.  Ranges are keyed by (thread,
    tensor): an end on another thread than the start is dropped, a second
    start of an open tensor keeps the first range."""

    def __init__(self):
        self._open: dict = {}

    def start(self, tensor_name: str, activity: str) -> None:
        if not torch.autograd._profiler_enabled():
            return
        key = (threading.get_ident(), tensor_name)
        if key in self._open:
            return
        rf = torch.autograd.profiler.record_function(
            f"hvd:{activity}:{tensor_name}")
        rf.__enter__()
        self._open[key] = rf

    def end(self, tensor_name: str) -> None:
        rf = self._open.pop((threading.get_ident(), tensor_name), None)
        if rf is not None:
            rf.__exit__(None, None, None)

    def clear(self) -> None:
        # ranges still open at close are dropped, not closed across threads
        self._open.clear()


_TICK = object()    # writer-loop sentinel: periodic flush, no event


class Timeline:
    """Asynchronous Chrome-trace writer (reference ``TimelineWriter``).

    Events go onto a thread-safe queue and a writer thread serializes
    them (the SPSC design of ``timeline.h:47-75``), so dispatch never
    waits on the file.  The writer flushes on a time or event-count bound
    (``flush_interval_s``/``flush_events``): a crashed worker leaves at
    most one window in the buffer, and the file on disk stays
    truncated-valid (:func:`load_trace` recovers every complete event).
    On each flush the writer also renders every registered telemetry
    gauge as a Chrome counter row (``"ph": "C"``)."""

    def __init__(self, filename: str, mark_cycles: bool = False,
                 flush_interval_s: float = 5.0, flush_events: int = 128):
        self.filename = filename
        self._mark_cycles = mark_cycles
        self._flush_interval_s = max(float(flush_interval_s), 0.05)
        self._flush_events = max(int(flush_events), 1)
        self._queue: "queue.Queue" = queue.Queue()
        self._start_ns = time.monotonic_ns()
        # wall clock at the monotonic origin: event wall time =
        # wall_origin_us + ts, the rebasing key of the cross-process merge
        self.wall_origin_us = time.time_ns() / 1e3
        self._ranges = ProfilerRangeBridge()
        self._closed = False
        self._pid = os.getpid()
        self._file = open(filename, "w")
        self._file.write("[\n")
        self._first = True
        self._writer = threading.Thread(target=self._write_loop, daemon=True,
                                        name="hvd_torch_timeline_writer")
        self._writer.start()
        # correlation stamp: a run context set explicitly (elastic runs)
        # opens the trace, so spans, metric snapshots and logs share the
        # (run_id, generation) key
        from horovod_tpu_torch.telemetry import context as tel_context

        ctx = tel_context.run_context()
        if ctx.explicit:
            self.instant("run_context", args=ctx.as_dict())

    # -- event API (Timeline::ActivityStart/End, MarkCycleStart) ----------

    def _ts_us(self) -> float:
        return (time.monotonic_ns() - self._start_ns) / 1e3

    def start_activity(self, tensor_name: str, activity: str) -> None:
        self._queue.put({"ph": "B", "name": activity, "cat": activity,
                         "tid": tensor_name, "pid": self._pid,
                         "ts": self._ts_us()})
        self._ranges.start(tensor_name, activity)

    def end_activity(self, tensor_name: str) -> None:
        self._queue.put({"ph": "E", "tid": tensor_name, "pid": self._pid,
                         "ts": self._ts_us()})
        self._ranges.end(tensor_name)

    def instant(self, name: str, args: Optional[dict] = None) -> None:
        self._queue.put({"ph": "i", "name": name, "s": "p",
                         "tid": "runtime", "pid": self._pid,
                         "ts": self._ts_us(), "args": args or {}})

    def mark_cycle_start(self) -> None:
        """``HOROVOD_TIMELINE_MARK_CYCLES`` (``operations.cc:428,578``):
        marks each eager-bucket flush."""
        if self._mark_cycles:
            self.instant("CYCLE_START")

    # -- writer thread ------------------------------------------------------

    def _write_loop(self) -> None:
        unflushed = 0
        last_flush = time.monotonic()
        while True:
            try:
                ev = self._queue.get(timeout=self._flush_interval_s)
            except queue.Empty:
                ev = _TICK
            if ev is None:
                self._file.flush()
                return
            if ev is _TICK:
                self._emit_gauge_counters()
                self._file.flush()
                unflushed = 0
                last_flush = time.monotonic()
                continue
            # chaos hook: a raise or delay models a failing trace sink
            faults.inject("timeline.write")
            self._write_event(ev)
            unflushed += 1
            now = time.monotonic()
            if unflushed >= self._flush_events or \
                    now - last_flush >= self._flush_interval_s:
                self._emit_gauge_counters()
                self._file.flush()
                unflushed = 0
                last_flush = now

    def _write_event(self, ev: dict) -> None:
        if not self._first:
            self._file.write(",\n")
        self._first = False
        json.dump(ev, self._file)

    def _emit_gauge_counters(self) -> None:
        """Chrome counter rows from the telemetry registry's gauges, one
        event a gauge name with its label sets as counter series, written
        by the writer thread itself (never queued)."""
        try:
            from horovod_tpu_torch import telemetry

            if not telemetry.enabled():
                return
            samples = telemetry.default_registry().gauge_samples()
        except Exception:      # noqa: BLE001 - metrics must not kill tracing
            return
        if not samples:
            return
        ts = self._ts_us()
        by_name: dict = {}
        for name, labels, value in samples:
            series = ",".join(f"{k}={v}" for k, v in
                              sorted(labels.items())) or "value"
            by_name.setdefault(name, {})[series] = value
        for name, args in sorted(by_name.items()):
            self._write_event({"ph": "C", "name": name, "pid": self._pid,
                               "tid": "metrics", "ts": ts, "args": args})

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._ranges.clear()
        self._queue.put(None)
        self._writer.join(timeout=5)
        self._file.write("\n]\n")
        self._file.close()


def load_trace(filename: str) -> list:
    """Parse a Chrome-trace file, tolerating a truncated tail: the writer
    emits one event a line joined by ``",\\n"``, so every complete event
    of a crashed worker's file is recovered."""
    with open(filename) as f:
        text = f.read()
    try:
        return json.loads(text)
    except ValueError:
        pass
    events = []
    body = text.lstrip()
    if body.startswith("["):
        body = body[1:]
    for part in body.split(",\n"):
        part = part.strip()
        if part.endswith("]"):
            part = part[:-1].rstrip()
        if not part:
            continue
        try:
            events.append(json.loads(part))
        except ValueError:
            break          # the incomplete tail event, the crash point
    return events


def merge_traces(blobs) -> list:
    """Merge per-process Chrome-trace events into one trace.

    ``blobs`` is ``[(proc_index, wall_origin_us, events), ...]``.  Events
    are rebased onto the earliest wall origin, their ``pid`` is the
    process index, and ``process_name`` rows label each process: the
    reference's rank-0 aggregated timeline (``timeline.cc``)."""
    if not blobs:
        return []
    base = min(origin for _, origin, _ in blobs)
    merged = []
    for p, origin, events in sorted(blobs):
        merged.append({"ph": "M", "name": "process_name", "pid": p,
                       "args": {"name": f"process {p}"}})
        off = origin - base
        for e in events:
            e = dict(e)
            e["pid"] = p
            if "ts" in e:
                e["ts"] = e["ts"] + off
            merged.append(e)
    return merged


#: seconds rank 0 waits, over all peers together, for their uploads
AGGREGATE_DEADLINE_S = 30.0


def aggregate_after_close(filename: str, wall_origin_us) -> None:
    """Cross-process aggregation after the local writer closed its file.

    Every other rank uploads its events and wall origin to the world's
    store (:func:`horovod_tpu_torch.runtime.distributed.world_store`:
    the elastic driver's, else the process group's); rank 0 collects them,
    merges them with its own through :func:`merge_traces` and rewrites its
    file as the one trace.  Calls come in program order on every rank
    (``stop_timeline``, ``shutdown``), so a per-world sequence number
    keeps the keys apart.  Best effort: a peer that uploads nothing within
    one shared deadline is warned about and left out."""
    from horovod_tpu_torch.runtime import distributed as hvd_dist
    from horovod_tpu_torch.runtime import state

    if not state.is_initialized():
        return
    st = state.global_state()
    store = hvd_dist.world_store()
    if st.size == 1 or store is None:
        return
    st.aggregate_seq += 1
    seq = st.aggregate_seq
    if wall_origin_us is None:
        wall_origin_us = time.time_ns() / 1e3
    if st.rank != 0:
        store.set(f"hvdtl/{seq}/{st.rank}", json.dumps(
            {"origin": wall_origin_us,
             "events": _load_events(filename)}).encode())
        return
    import datetime

    from horovod_tpu_torch.utils import logging as hvd_logging

    blobs = [(0, wall_origin_us, _load_events(filename))]
    deadline = time.monotonic() + AGGREGATE_DEADLINE_S
    for p in range(1, st.size):
        key = f"hvdtl/{seq}/{p}"
        try:
            left = max(deadline - time.monotonic(), 0.001)
            store.wait([key], datetime.timedelta(seconds=left))
            payload = json.loads(store.get(key))
            blobs.append((p, payload["origin"], payload["events"]))
            store.delete_key(key)
        except Exception:  # noqa: BLE001 - a missing peer is skipped
            hvd_logging.warning(
                "timeline aggregation: no upload from rank %d; writing a "
                "partial merged trace", p)
    with open(filename, "w") as f:
        json.dump(merge_traces(blobs), f)


def _load_events(filename: str) -> list:
    try:
        return load_trace(filename)
    except Exception:  # noqa: BLE001 - an unreadable file merges as empty
        return []


def activity(tensor_name: str, name: str):
    """Context manager recording one activity on the runtime's timeline."""
    from horovod_tpu_torch.runtime import state

    class _Ctx:
        def __enter__(self):
            self.tl = None
            if state.is_initialized():
                self.tl = state.global_state().timeline
            if self.tl is not None:
                self.tl.start_activity(tensor_name, name)
            return self

        def __exit__(self, *exc):
            if self.tl is not None:
                self.tl.end_activity(tensor_name)
            return False

    return _Ctx()


def make_timeline(filename: str, mark_cycles: bool = False, rank: int = 0):
    """The timeline of rank ``rank`` for ``filename``: a rank other than 0
    writes ``<filename>.<rank>``, so that a path every rank was given never
    has two writers (:func:`aggregate_after_close` merges the files into
    rank 0's).  The native lock-free writer (the reference's
    ``timeline.{h,cc}`` is C++), or the Python one when
    ``HOROVOD_TIMELINE_PYTHON`` is set or the native library is
    unavailable (:func:`horovod_tpu_torch.native.load` has warned when it
    failed to build)."""
    if rank:
        filename = f"{filename}.{rank}"
    if not os.environ.get("HOROVOD_TIMELINE_PYTHON"):
        from horovod_tpu_torch.native import NativeTimeline

        try:
            return NativeTimeline(filename, mark_cycles=mark_cycles)
        except RuntimeError:
            pass
    return Timeline(filename, mark_cycles=mark_cycles)
