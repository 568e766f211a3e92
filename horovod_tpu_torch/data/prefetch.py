"""Host-side prefetching and device placement for the input feed
(``horovod_tpu/data/prefetch.py``).

:class:`PrefetchIterator` takes batch assembly and the host→device copy
off the training step's critical path:

* a feeder thread pulls host batches from the source iterator (sources
  are rarely thread-safe, so exactly one thread touches the iterator —
  order is preserved by construction);
* each batch's placement — the ``place`` callable, typically
  ``step.shard_local_batch`` or ``step.shard_batch`` — runs on a small
  thread pool (``HOROVOD_INPUT_THREADS``), so the copy of batch ``k+1``
  is issued while batch ``k`` computes;
* a bounded queue (``HOROVOD_PREFETCH_DEPTH``) applies backpressure:
  the feeder pulls at most ``depth + 1`` items beyond what the consumer
  took, so host memory holds a bounded number of in-flight batches no
  matter how slow the step is;
* exceptions from the source or from ``place`` surface at ``next()``
  — never silently swallowed on a worker thread;
* ``close()`` is idempotent, unblocks a parked feeder, joins every
  thread and leaves nothing running; iterators also close themselves on
  exhaustion.

On a card the copy needs what JAX's ``device_put`` gave the JAX package
for free.  A copy issued from a worker thread goes to the card's default
stream, where it queues behind the running step, and a copy from
pageable memory blocks the host.  So, when the runtime runs on a card and
``place`` is given, each pipeline owns:

* **a copy stream**: every placement runs under
  ``torch.cuda.stream(copy_stream)`` and ``torch.cuda.device(device)``
  (worker threads start on card 0), and an event is recorded after it;
  ``next()`` makes the consumer's current stream wait on that event and
  calls ``record_stream`` on each delivered tensor, so that the caching
  allocator does not hand its memory to the next copy while the step
  still reads it;
* **a pinned staging ring**: ``depth + threads`` page-locked buffers for
  each leaf of the batch (by position, shape and dtype).  A worker copies the host batch into a free
  buffer (one host copy, where ``pin_memory()`` would allocate and copy),
  and ``place`` copies that buffer to the card asynchronously.  A buffer
  is reused only once its copy event has completed, and ``close()``
  waits for the copies in flight before it lets the buffers go.

There is no fallback: on a card a failure to pin, to make the stream or
to copy raises at ``next()``.  On the CPU, which only the tests ask
for, ``place`` runs as given and nothing is pinned.

Live iterators register in a process-wide set; :func:`close_all` tears
them all down (the elastic reset hook of the JAX package).
"""

from __future__ import annotations

import queue
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_leaves, tree_map

from horovod_tpu_torch import faults, telemetry
from horovod_tpu_torch.runtime.config import _env_int

_LIVE: "weakref.WeakSet[PrefetchIterator]" = weakref.WeakSet()
_THREAD_PREFIX = "hvd-input"

_DEFAULT_DEPTH = 2
_DEFAULT_THREADS = 2

#: the attribute naming the CUDA event recorded after a placed tensor's
#: copy (read by :func:`horovod_tpu_torch.utils.input_probe.fence_batch`)
COPY_EVENT_ATTR = "_hvd_copy_event"


def _config_default(attr: str, env: str, fallback: int) -> int:
    """Knob resolution: runtime config when initialized (the env
    contract resolved at init()), a direct env read before init, the
    built-in default last."""
    from horovod_tpu_torch.runtime import state

    if state.is_initialized():
        return int(getattr(state.global_state().config, attr))
    return _env_int(env, fallback)


def default_prefetch_depth() -> int:
    return max(_config_default("prefetch_depth", "HOROVOD_PREFETCH_DEPTH",
                               _DEFAULT_DEPTH), 1)


def default_input_threads() -> int:
    return max(_config_default("input_threads", "HOROVOD_INPUT_THREADS",
                               _DEFAULT_THREADS), 1)


class _End:
    """Queue sentinel: normal exhaustion, or a carried source error."""

    __slots__ = ("error",)

    def __init__(self, error: Optional[BaseException] = None):
        self.error = error


class _Slot:
    """One pinned staging buffer and the event of its last copy."""

    __slots__ = ("buf", "event", "busy", "seq")

    def __init__(self, buf: torch.Tensor):
        self.buf = buf
        self.event: Optional[torch.cuda.Event] = None
        self.busy = True
        self.seq = 0


class CardStager:
    """A copy stream and pinned staging rings for placements onto
    ``device``: :meth:`place` stages a host batch and runs ``place`` on
    it under the copy stream; :meth:`hand_over` passes a placed batch to
    the consumer's current stream.  Each leaf of a batch (by position,
    shape and dtype) has a ring of ``slots`` buffers."""

    def __init__(self, device: torch.device, place: Callable, slots: int):
        self.device = device
        self._place = place
        self._slots = int(slots)
        with torch.cuda.device(device):
            self.stream = torch.cuda.Stream(device)
        self._rings: dict = {}
        self._lock = threading.Lock()
        self._seq = 0

    def _acquire(self, key: tuple, shape: tuple,
                  dtype: torch.dtype) -> _Slot:
        while True:
            with self._lock:
                ring = self._rings.setdefault(key, [])
                for slot in ring:
                    if not slot.busy and (slot.event is None
                                          or slot.event.query()):
                        slot.busy = True
                        return slot
                if len(ring) < self._slots:
                    slot = _Slot(torch.empty(shape, dtype=dtype,
                                             pin_memory=True))
                    ring.append(slot)
                    return slot
                # a worker holds one slot of a leaf's ring at most, and a
                # ring has more slots than workers: some copy is in flight
                oldest = min((s for s in ring if not s.busy),
                             key=lambda s: s.seq)
            oldest.event.synchronize()

    def _stage(self, leaf, slots: list):
        if isinstance(leaf, np.ndarray):
            leaf = torch.from_numpy(leaf)
        elif not (isinstance(leaf, torch.Tensor) and leaf.device.type == "cpu"):
            return leaf
        shape = tuple(leaf.shape)
        slot = self._acquire((len(slots), shape, leaf.dtype), shape,
                             leaf.dtype)
        slots.append(slot)
        slot.buf.copy_(leaf)
        return slot.buf

    def place(self, batch):
        """``place`` of ``batch`` staged through pinned buffers, on the
        copy stream; every tensor of the result carries the copy's event
        (:data:`COPY_EVENT_ATTR`)."""
        slots: list = []
        event = None
        try:
            staged = tree_map(lambda x: self._stage(x, slots), batch)
            with torch.cuda.device(self.device), \
                    torch.cuda.stream(self.stream):
                placed = self._place(staged)
                event = torch.cuda.Event()
                event.record(self.stream)
        finally:
            with self._lock:
                self._seq += 1
                for slot in slots:
                    slot.event, slot.busy, slot.seq = event, False, self._seq
        pinned = {s.buf.data_ptr() for s in slots}
        for t in tree_leaves(placed):
            if isinstance(t, torch.Tensor):
                if t.device.type == "cpu" and t.data_ptr() in pinned:
                    raise ValueError(
                        "place returned a pinned staging buffer; it must "
                        "copy the batch to the card")
                setattr(t, COPY_EVENT_ATTR, event)
        return placed, event

    def hand_over(self, placed, event):
        """``placed`` for the consumer: its current stream waits for the
        copy, and the allocator keeps each tensor's memory until the work
        queued on that stream has used it."""
        current = torch.cuda.current_stream(self.device)
        current.wait_event(event)
        for t in tree_leaves(placed):
            if isinstance(t, torch.Tensor) and t.is_cuda:
                t.record_stream(current)
        return placed

    def close(self) -> None:
        """Wait for the copies in flight, then let the buffers go."""
        with self._lock:
            rings, self._rings = self._rings, {}
        for ring in rings.values():
            for slot in ring:
                if slot.event is not None:
                    slot.event.synchronize()


def _card_device() -> Optional[torch.device]:
    """The runtime's card, or None on the CPU or before ``init()``."""
    from horovod_tpu_torch.runtime import state

    if state.is_initialized():
        device = state.global_state().device
        if device.type == "cuda":
            return device
    return None


class PrefetchIterator:
    """Bounded, ordered, background-assembled batch iterator.

    ::

        feed = PrefetchIterator(dataset.iter_epochs(),
                                place=step.shard_local_batch)
        for batch in feed:            # or: batch = next(feed)
            model, opt, loss = step(model, opt, batch)
        feed.close()                  # or use as a context manager

    ``source`` is any iterable of host batches; ``place`` (optional)
    maps a host batch to its device placement and runs on the worker
    pool — on a card, over pinned copies of the batch's arrays, under the
    pipeline's copy stream (module doc).  ``depth`` bounds the prefetch
    queue; ``threads`` sizes the assembly pool.  Both default to the
    runtime knobs.

    Instrumentation (what ``bench.py`` emits): ``stall_s`` accumulates
    wall time ``next()`` spent *blocked* waiting for a batch — the
    input stall the pipeline exists to eliminate — ``stall_samples``
    keeps the per-delivery values (medians over a window stay robust
    to one-off wakeup spikes), and ``batches`` counts deliveries.
    """

    def __init__(self, source: Iterable, place: Optional[Callable] = None,
                 depth: Optional[int] = None,
                 threads: Optional[int] = None,
                 name: str = "feed"):
        self._source = iter(source)
        self._place = place
        self.depth = int(depth) if depth is not None \
            else default_prefetch_depth()
        if self.depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got "
                             f"{self.depth}")
        self._threads = int(threads) if threads is not None \
            else default_input_threads()
        if self._threads < 1:
            raise ValueError(f"input threads must be >= 1, got "
                             f"{self._threads}")
        device = _card_device() if place is not None else None
        # the copy stream and the pinned rings of a pipeline on a card
        self.stager = CardStager(device, place, self.depth + self._threads) \
            if device is not None else None
        self._queue: "queue.Queue" = queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._closed = False
        self._exhausted = False
        self._lock = threading.Lock()
        self.stall_s = 0.0
        self.stall_samples: list = []
        self.batches = 0
        # telemetry: queue depth at delivery, and stall time, the input
        # plane's contract number
        self._tel_batches = telemetry.counter(
            "hvd_input_batches_total",
            "batches delivered by the input pipeline").labels(
                pipeline=name)
        self._tel_stall = telemetry.histogram(
            "hvd_input_stall_seconds",
            "time next() blocked waiting for a batch").labels(
                pipeline=name)
        self._tel_depth = telemetry.gauge(
            "hvd_input_queue_depth",
            "prefetch queue occupancy at delivery").labels(pipeline=name)
        self._pool = ThreadPoolExecutor(
            max_workers=self._threads,
            thread_name_prefix=f"{_THREAD_PREFIX}-{name}")
        self._feeder = threading.Thread(
            target=self._feed, name=f"{_THREAD_PREFIX}-{name}-feeder",
            daemon=True)
        self._feeder.start()
        _LIVE.add(self)

    # -- feeder side -------------------------------------------------------

    def _assemble(self, item):
        if self._place is None:
            return item
        if self.stager is not None:
            return self.stager.place(item)
        return self._place(item)

    def _feed(self) -> None:
        try:
            while not self._stop.is_set():
                # chaos hook: a raise here surfaces at next() via the
                # _End sentinel (the documented worker-exception path);
                # a delay models a slow source
                faults.inject("data.feed")
                try:
                    item = next(self._source)
                except StopIteration:
                    self._put(_End())
                    return
                # submit BEFORE the (possibly blocking) queue put: the
                # copy is exactly the work that must start early, and the
                # put is where backpressure parks the feeder — at most
                # depth+1 items are ever pulled beyond what the consumer
                # consumed
                self._put(self._pool.submit(self._assemble, item))
        except BaseException as e:  # noqa: BLE001 — carried to next()
            self._put(_End(e))

    def _put(self, obj) -> None:
        while not self._stop.is_set():
            try:
                self._queue.put(obj, timeout=0.1)
                return
            except queue.Full:
                continue

    # -- consumer side -----------------------------------------------------

    def __iter__(self) -> "PrefetchIterator":
        return self

    def __next__(self):
        if self._exhausted:
            raise StopIteration
        if self._closed:
            raise RuntimeError("PrefetchIterator is closed")
        t0 = time.perf_counter()
        got = self._queue.get()
        if isinstance(got, _End):
            self._exhausted = True
            self.close()
            if got.error is not None:
                raise got.error
            raise StopIteration
        try:
            batch = got.result()
        except BaseException:
            self.close()
            raise
        dt = time.perf_counter() - t0
        if self.stager is not None:
            batch = self.stager.hand_over(*batch)
        self.stall_s += dt
        self.stall_samples.append(dt)
        self.batches += 1
        self._tel_batches.inc()
        self._tel_stall.observe(dt)
        self._tel_depth.set(self._queue.qsize())
        return batch

    def close(self) -> None:
        """Tear down feeder + pool; idempotent, leak-free.  Queued
        batches are dropped (their device memory released); the pinned
        buffers go once the copies in flight have landed."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._stop.set()
        # the feeder may be parked in _put; it polls _stop every 100 ms,
        # and draining the queue lets it exit immediately instead
        while self._feeder.is_alive():
            try:
                while True:
                    got = self._queue.get_nowait()
                    if not isinstance(got, _End):
                        got.cancel()
            except queue.Empty:
                pass
            self._feeder.join(timeout=0.05)
        self._pool.shutdown(wait=True)
        while True:     # anything the feeder enqueued while draining
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        if self.stager is not None:
            self.stager.close()
        _LIVE.discard(self)

    @property
    def closed(self) -> bool:
        return self._closed

    def __enter__(self) -> "PrefetchIterator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # pragma: no cover - GC timing dependent
        try:
            self.close()
        except Exception:
            pass


def close_all() -> int:
    """Close every live :class:`PrefetchIterator` in the process — the
    elastic reset hook (queued batches hold device memory of the
    torn-down world).  Returns how many were closed."""
    closed = 0
    for it in list(_LIVE):
        if not it.closed:
            it.close()
            closed += 1
    return closed
