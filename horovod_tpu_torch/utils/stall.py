"""Stall and failure detection (``horovod_tpu/utils/stall.py``).

The reference's ``StallInspector`` (``horovod/common/stall_inspector.
{h,cc}``) watches the negotiation table for tensors some ranks submitted
and others did not, warns after 60 s and optionally shuts down after
``HOROVOD_STALL_SHUTDOWN_TIME_SECONDS`` (``stall_inspector.h:73-81``), and
``CheckForStalledTensors`` names the *ranks* that never submitted each
stalled tensor.

Here a stall is an eager collective that was submitted and has not
completed: a peer died, or its host code diverged so that it never
submitted the op.  :class:`StallInspector` tracks the eager plane's
operations in flight; its watcher thread warns when one has been pending
past the threshold.  Attribution: once an op has been pending for half the
threshold, each rank publishes its pending set under its own key of the
world's store (a non-collective write, which a stalled world can still
make); the warning rank reads every peer's and names each as co-stalled
(it published the same op), diverged (it published, without this op) or
unreported (it published nothing: it never submitted the op, or died).

:class:`ProgressWatchdog` is the primitive behind hung-but-alive
detection that the elastic health monitor uses.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, Optional

from horovod_tpu_torch import faults, telemetry
from horovod_tpu_torch.utils import logging as hvd_logging

_STATUS_DIR = "hvdstall/status"

# hung-worker precursors, scrapeable before the health plane acts:
# pending-op count and oldest age climb while a collective wedges; the
# warning counter records that the inspector spoke, the abort counter that
# it pulled the shutdown lever
_TEL_PENDING = telemetry.gauge(
    "hvd_stall_pending_ops", "eager collectives dispatched, not complete")
_TEL_OLDEST = telemetry.gauge(
    "hvd_stall_oldest_age_seconds", "age of the oldest pending collective")
_TEL_WARNINGS = telemetry.counter(
    "hvd_stall_warnings_total", "stall warnings emitted")
_TEL_ABORTS = telemetry.counter(
    "hvd_stall_aborts_total",
    "stall-shutdown aborts (HOROVOD_STALL_SHUTDOWN_TIME_SECONDS)")


class ProgressWatchdog:
    """Tracks a monotonically-advancing progress counter and reports how
    long it has been stagnant — the primitive behind hung-but-alive
    detection (a rank whose heartbeats keep arriving while its step
    counter stopped moving is wedged, not dead).

    Pure bookkeeping, no thread: the owner decides when to call
    :meth:`stalled_for` and what stagnation threshold means trouble.
    ``clock`` is injectable for deterministic tests."""

    def __init__(self, clock=time.monotonic, name: Optional[str] = None):
        self._clock = clock
        self._value: Optional[int] = None
        self._since: Optional[float] = None
        # named watchdogs publish their stagnation as a labeled gauge —
        # the hung-worker precursor the health plane acts on later
        # (docs/metrics.md); unnamed ones stay pure bookkeeping
        self._tel_stall = None if name is None else telemetry.gauge(
            "hvd_progress_stall_seconds",
            "seconds since a watched progress counter last advanced"
        ).labels(watchdog=name)

    def update(self, value: int, now: Optional[float] = None) -> None:
        """Record the counter's current value; only an *advance*
        restarts the stagnation clock (a repeated or regressed value —
        a worker re-reporting after restore — does not look like
        progress)."""
        if now is None:
            now = self._clock()
        if self._value is None or value > self._value:
            self._value = value
            self._since = now
            if self._tel_stall is not None:
                self._tel_stall.set(0.0)

    @property
    def value(self) -> Optional[int]:
        return self._value

    def stalled_for(self, now: Optional[float] = None) -> float:
        """Seconds since the counter last advanced (0.0 before the
        first update — never-reported is the startup watchdog's job,
        not this one's)."""
        if self._since is None:
            return 0.0
        if now is None:
            now = self._clock()
        stalled = max(now - self._since, 0.0)
        if self._tel_stall is not None:
            self._tel_stall.set(stalled)
        return stalled


class StallInspector:
    """Watches the eager collectives in flight (reference
    ``StallInspector``, ``stall_inspector.{h,cc}``): each registers at
    dispatch and clears at completion; a watcher thread warns once an op
    has been pending past ``warning_time_s`` and names the ranks that have
    not submitted it, and past ``shutdown_time_s`` (0: never) ends the
    process."""

    def __init__(self, warning_time_s: float = 60.0,
                 shutdown_time_s: float = 0.0, poll_interval_s: float = 5.0):
        self._warning_time_s = warning_time_s
        self._shutdown_time_s = shutdown_time_s
        self._poll_interval_s = min(poll_interval_s, max(
            warning_time_s / 4.0, 0.05))
        self._pending: Dict[str, float] = {}
        self._warned: set = set()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._published: Optional[frozenset] = None
        self._thread = threading.Thread(target=self._watch, daemon=True,
                                        name="hvd_torch_stall_inspector")
        self._thread.start()

    def record_dispatch(self, name: str) -> None:
        with self._lock:
            self._pending[name] = time.monotonic()

    def record_complete(self, name: str) -> None:
        with self._lock:
            self._pending.pop(name, None)
            self._warned.discard(name)

    def pending_ops(self):
        with self._lock:
            return dict(self._pending)

    # -- cross-process attribution -----------------------------------------

    def _cluster(self):
        """(store, this rank, world size) in a world of more than one rank
        whose store is reachable (``runtime/distributed.world_store``: the
        elastic driver's, else the process group's), else None."""
        try:
            from horovod_tpu_torch.runtime import distributed as hvd_dist
            from horovod_tpu_torch.runtime import state

            if not state.is_initialized():
                return None
            st = state.global_state()
            store = hvd_dist.world_store()
            if st.size == 1 or store is None:
                return None
            return store, st.rank, st.size
        except Exception:  # noqa: BLE001 - attribution is best effort
            return None

    def _publish(self, store, me: int, pending) -> None:
        """Best-effort non-collective status write under this rank's own
        key, which the store lets a rank overwrite; re-published only when
        the pending set changes."""
        snapshot = frozenset(pending)
        if snapshot == self._published:
            return
        try:
            store.set(f"{_STATUS_DIR}/{me}", json.dumps(
                {"pending": sorted(pending)}).encode())
            self._published = snapshot
        except Exception:  # noqa: BLE001 - store unreachable
            pass

    def _attribute(self, store, me: int, nproc: int, stalled_names):
        """Name each peer's relation to the stalled ops from the published
        statuses (reference ``CheckForStalledTensors`` missing-rank
        report)."""
        unreported, diverged, costalled = [], [], []
        for p in range(nproc):
            if p == me:
                continue
            key = f"{_STATUS_DIR}/{p}"
            try:
                raw = store.get(key) if store.check([key]) else None
            except Exception:  # noqa: BLE001 - store unreachable
                raw = None
            if raw is None:
                unreported.append(p)
                continue
            try:
                peer_pending = set(json.loads(raw)["pending"])
            except Exception:  # noqa: BLE001 - a torn status reads empty
                peer_pending = set()
            missing = sorted(n for n in stalled_names
                             if n not in peer_pending)
            if not peer_pending:
                # published an empty set: nothing pending on its side —
                # it has not submitted the op (or cleared an earlier
                # stall); calling it "stalled on different ops" would
                # send the operator to debug a healthy rank
                unreported.append(p)
            elif missing:
                diverged.append((p, missing))
            else:
                costalled.append(p)
        parts = []
        if unreported:
            parts.append(
                "process(es) %s have not submitted the op (no pending "
                "work published — not reached it yet, or failed)"
                % ", ".join(map(str, unreported)))
        for p, missing in diverged:
            parts.append(
                "process %d is stalled on different op(s) and has not "
                "submitted %s" % (p, ", ".join(missing)))
        if costalled:
            parts.append("process(es) %s are waiting on the same op"
                         % ", ".join(map(str, costalled)))
        return "; ".join(parts)

    # -- watcher ------------------------------------------------------------

    def _watch(self) -> None:
        while not self._stop.wait(self._poll_interval_s):
            # chaos hook: a hang here silences stall warnings — the
            # degradation mode where the inspector itself is wedged
            faults.inject("stall.watch")
            now = time.monotonic()
            stalled, fatal, publish_due = [], [], []
            oldest = 0.0
            with self._lock:
                n_pending = len(self._pending)
                for name, t0 in self._pending.items():
                    age = now - t0
                    oldest = max(oldest, age)
                    if age > self._warning_time_s / 2.0:
                        publish_due.append(name)
                    if age > self._warning_time_s and name not in self._warned:
                        stalled.append((name, age))
                        self._warned.add(name)
                    if self._shutdown_time_s > 0 and age > self._shutdown_time_s:
                        fatal.append((name, age))
            _TEL_PENDING.set(n_pending)
            _TEL_OLDEST.set(oldest)
            if stalled:
                _TEL_WARNINGS.inc(len(stalled))
            # _published non-empty with nothing due means the stall
            # cleared: republish the (empty) set so peers stop blaming us
            cluster = self._cluster() \
                if (publish_due or stalled or self._published) else None
            if cluster is not None:
                self._publish(cluster[0], cluster[1], publish_due)
            if stalled:
                names = ", ".join(f"{n} ({a:.0f}s)" for n, a in stalled)
                who = ""
                if cluster is not None:
                    store, me, nproc = cluster
                    who = self._attribute(store, me, nproc,
                                          [n for n, _ in stalled])
                hvd_logging.warning(
                    "One or more collectives submitted but not completed for "
                    "over %.0fs: %s. A peer process may have failed or host "
                    "control flow may have diverged across processes.%s",
                    self._warning_time_s, names,
                    (" Attribution: " + who) if who else "")
            if fatal:
                hvd_logging.error(
                    "Collective(s) stalled beyond "
                    "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS; aborting process.")
                _TEL_ABORTS.inc()
                import os

                os._exit(1)

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2)
