"""Async host offload of optimizer state (a copy of
``horovod_tpu/memory/offload.py`` over CUDA streams).

:class:`HostOffloadEngine` streams a pytree of tensors (typically the
optimizer's state) to pinned host memory after the step that produced it
and back just before the step that needs it.  ``offload`` records an
event on the caller's stream and hands the tree to one worker thread,
which copies each card tensor into a pinned host buffer (:data:`PINNED`,
reused across calls) on a side stream behind that event and waits for the
copies to end; at most
``HOROVOD_OFFLOAD_DEPTH`` (default 2, double buffering) copies that have
not ended are in flight, and ``offload`` waits for the oldest of them
beyond that.  ``fetch`` joins the copy and copies the host buffers back
onto the card on the caller's stream; the time it blocks is the stall
the telemetry histogram records (zero when the copy hid under compute).
A CPU tensor's host copy is a clone.

Crash and consistency contract (the ``offload.d2h`` and ``offload.h2d``
fault sites pin it):

* the engine keeps the device tree until ``fetch``; a transfer fault,
  injected or real, degrades to it: the caller gets its state back,
  bit-identical, and loses no step (``hvd_memory_offload_fallbacks_total``
  counts);
* the round trip is bit-exact: raw copies, no dtype change;
* ``close()`` is idempotent, joins the worker, and leaves nothing
  running.

The caller must not change the tree's tensors between ``offload`` and
the ``fetch`` that joins the copy (the training loop below fetches
before the next step updates them).

Telemetry series: ``hvd_memory_offload_bytes_total{direction=d2h|h2d}``,
``hvd_memory_offload_stall_seconds``, ``hvd_memory_offload_inflight``,
``hvd_memory_offload_fallbacks_total``.
"""

from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from horovod_tpu_torch import faults, telemetry
from horovod_tpu_torch.runtime.config import _env_int

_THREAD_PREFIX = "hvd-offload"
_DEFAULT_DEPTH = 2


def default_offload_depth() -> int:
    """HOROVOD_OFFLOAD_DEPTH — in-flight D2H transfers (2 = double
    buffering), resolved config-first like the prefetch knobs."""
    from horovod_tpu_torch.runtime import state

    if state.is_initialized():
        return max(int(state.global_state().config.offload_depth), 1)
    return max(_env_int("HOROVOD_OFFLOAD_DEPTH", _DEFAULT_DEPTH), 1)


class PinnedPool:
    """Pinned host buffers kept for reuse, by shape and dtype: a fresh
    ``torch.empty(pin_memory=True)`` called ``cudaHostAlloc`` again every
    step of the offload remat tier, PyTorch's host cache being busy with
    the step's own copies.  A buffer comes back with the CUDA event after which it may be
    written again and is handed out once that event has completed.  The
    buffers stay pinned for the process's life."""

    def __init__(self):
        self._free = {}
        self._lock = threading.Lock()

    def take(self, shape, dtype):
        import torch

        with self._lock:
            bufs = self._free.get((tuple(shape), dtype), [])
            for i, (buf, ready) in enumerate(bufs):
                if ready.query():
                    del bufs[i]
                    return buf
        return torch.empty(shape, dtype=dtype, pin_memory=True)

    def give(self, buf, ready) -> None:
        with self._lock:
            self._free.setdefault((tuple(buf.shape), buf.dtype),
                                  []).append((buf, ready))


#: the process's pool: the engine's host copies and the offload remat
#: tier's
PINNED = PinnedPool()


def _nbytes(leaves) -> int:
    import torch

    return sum(x.numel() * x.element_size() for x in leaves
               if isinstance(x, torch.Tensor))


class HostOffloadEngine:
    """Double-buffered D2H/H2D streaming of pytrees of tensors.

    ::

        engine = HostOffloadEngine(name="optimizer")
        for i in range(steps):
            state = engine.fetch(i - 1, state)      # H2D (a no-op at i=0)
            ...                                     # the step updates state
            engine.offload(i, state)                # async D2H
        engine.close()

    ``offload(tag, tree)`` issues the background D2H copy and blocks
    only when ``depth`` copies are already in flight (backpressure).
    ``fetch(tag, fallback)`` joins the copy and restores it to the card,
    returning ``fallback`` untouched when the tag was never offloaded
    (the cold first step) or when the transfer faulted (the degrade
    path).  Tags are opaque; a step counter is the usual choice.
    """

    def __init__(self, name: str = "optimizer",
                 depth: Optional[int] = None):
        self.name = name
        self.depth = max(int(depth), 1) if depth is not None \
            else default_offload_depth()
        self._pending = collections.OrderedDict()   # tag -> (future, ref)
        self._executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"{_THREAD_PREFIX}-{name}")
        self._stream = None
        self._closed = False
        self.stall_s = 0.0
        self.fallbacks = 0
        self._tel_bytes = telemetry.counter(
            "hvd_memory_offload_bytes_total",
            "bytes streamed by the host-offload engine, per direction")
        self._tel_stall = telemetry.histogram(
            "hvd_memory_offload_stall_seconds",
            "seconds fetch() blocked on the host round-trip")
        self._tel_inflight = telemetry.gauge(
            "hvd_memory_offload_inflight",
            "offloaded pytrees currently parked on the host")
        self._tel_fallbacks = telemetry.counter(
            "hvd_memory_offload_fallbacks_total",
            "offload faults degraded to the retained device reference")

    # -- D2H ----------------------------------------------------------------

    def _d2h(self, leaves, ready):
        """On the worker thread: each card tensor into a pinned host
        buffer on the side stream behind ``ready`` (the caller's stream
        at ``offload``), then wait for the copies; a CPU tensor cloned."""
        import torch

        faults.inject("offload.d2h")
        if ready is not None:
            self._stream.wait_event(ready)
        host = []
        for x in leaves:
            if not isinstance(x, torch.Tensor):
                host.append(x)
            elif x.is_cuda:
                buf = PINNED.take(x.shape, x.dtype)
                with torch.cuda.stream(self._stream):
                    buf.copy_(x, non_blocking=True)
                host.append(buf)
            else:
                host.append(x.detach().clone())
        if ready is not None:
            self._stream.synchronize()
        self._tel_bytes.labels(
            engine=self.name, direction="d2h").inc(_nbytes(host))
        return host

    def offload(self, tag, tree) -> None:
        """Issue the async D2H copy of ``tree`` under ``tag``.

        Keeps the device tree alongside the future (the degrade
        contract) and applies backpressure at ``depth`` copies in flight
        by joining the oldest unfinished one.  Finished copies stay in
        ``_pending`` until ``fetch``, so only copies not yet done count
        toward the limit (a finished transfer costs host memory, not D2H
        bandwidth); a copy that raised counts as done, and its fault
        surfaces at its own ``fetch`` through the degrade path."""
        import torch
        from torch.utils._pytree import tree_leaves

        if self._closed:
            raise RuntimeError(f"offload engine {self.name!r} is closed")
        if tag in self._pending:
            raise ValueError(f"tag {tag!r} already offloaded — fetch it "
                             "before offloading it again")
        while True:
            in_flight = [f for f, _ in self._pending.values()
                         if not f.done()]
            if len(in_flight) < self.depth:
                break
            try:
                in_flight[0].result()
            except Exception:       # noqa: BLE001 — surfaced at fetch()
                pass
        leaves = tree_leaves(tree)
        ready = None
        if any(isinstance(x, torch.Tensor) and x.is_cuda for x in leaves):
            if self._stream is None:
                self._stream = torch.cuda.Stream()
            ready = torch.cuda.Event()
            ready.record()
        self._pending[tag] = (
            self._executor.submit(self._d2h, leaves, ready), tree)
        self._tel_inflight.labels(engine=self.name).set(
            len(self._pending))

    def wait(self, tag) -> None:
        """Block until ``tag``'s D2H copy has ended (a copy that faulted
        surfaces at its ``fetch``)."""
        entry = self._pending.get(tag)
        if entry is not None:
            try:
                entry[0].result()
            except Exception:       # noqa: BLE001 — surfaced at fetch()
                pass

    # -- H2D ----------------------------------------------------------------

    def fetch(self, tag, fallback):
        """Restore ``tag``'s tree to where it came from, or degrade.

        Blocks on the host copy (the measured stall), copies it back into
        new tensors on each leaf's device (on the caller's stream) and
        returns the restored tree.  Returns ``fallback`` as-is when
        ``tag`` was never offloaded, or when the D2H/H2D path faulted:
        the retained device state, so the training loop continues
        without losing the step."""
        import torch
        from torch.utils._pytree import tree_flatten, tree_unflatten

        entry = self._pending.pop(tag, None)
        self._tel_inflight.labels(engine=self.name).set(
            len(self._pending))
        if entry is None:
            return fallback
        future, device_ref = entry
        t0 = time.perf_counter()
        try:
            host = future.result()
            faults.inject("offload.h2d")
            refs, spec = tree_flatten(device_ref)
            out = [h if not isinstance(d, torch.Tensor) else
                   torch.empty_like(d).copy_(h, non_blocking=h.is_pinned())
                   for h, d in zip(host, refs)]
            if any(isinstance(h, torch.Tensor) and h.is_pinned()
                   for h in host):
                read = torch.cuda.Event()
                read.record()
                for h in host:
                    if isinstance(h, torch.Tensor) and h.is_pinned():
                        PINNED.give(h, read)
            out = tree_unflatten(out, spec)
            self._tel_bytes.labels(
                engine=self.name, direction="h2d").inc(_nbytes(host))
        except Exception:           # noqa: BLE001 — the degrade path
            self.fallbacks += 1
            self._tel_fallbacks.labels(engine=self.name).inc()
            out = device_ref
        dt = time.perf_counter() - t0
        self.stall_s += dt
        self._tel_stall.labels(engine=self.name).observe(dt)
        return out

    # -- lifecycle ----------------------------------------------------------

    def close(self) -> None:
        """Idempotent: drop pending copies, join the worker."""
        if self._closed:
            return
        self._closed = True
        for future, _ref in self._pending.values():
            future.cancel()
        self._pending.clear()
        self._executor.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
