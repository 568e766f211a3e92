"""Replica pool: leases, crash recovery, graceful drain, scale signals (a
copy of ``horovod_tpu/serve/pool.py``).

The pool owns the mapping between replicas and the requests leased to
them, and converts replica lifecycle events into the queue's
exactly-once transitions (docs/serving.md):

* **execute** — lease a batch to a replica, run it, complete the ids
  and emit responses; a crash mid-batch (``WorkerCrash`` from the
  ``serve.batch`` fault site, or any executor error) flips the replica
  to ``DEAD`` and re-enqueues its leased requests *exactly once*
  (``AdmissionQueue.requeue`` ignores anything not in-flight);
* **drain** — the planned-departure path: stop routing to the replica,
  let in-flight work finish inside ``HOROVOD_SERVE_DRAIN_TIMEOUT_S``,
  then announce the departure to the elastic driver
  (:class:`ElasticServeBridge`) so the exit is graceful — no
  blacklist, no quarantine, no sibling abort.  A drain that cannot
  finish in the window (wedged replica, ``serve.drain`` fault) falls
  back to the dead path;
* **scale signals** — queue depth against
  ``HOROVOD_SERVE_SCALE_UP_DEPTH`` / ``HOROVOD_SERVE_SCALE_DOWN_DEPTH``
  yields +1/0/−1 deltas the :class:`~horovod_tpu_torch.serve.autoscale.
  AutoscaleController` closes into actual acquire/release actions (a
  deep queue asks for a replica, an idle pool releases one through the
  same graceful drain).  The signal source carries its own hysteresis
  (``HOROVOD_SERVE_SCALE_HOLD_S``): after a nonzero signal, the
  *opposite* direction is suppressed for the hold window, so a queue
  depth oscillating across a threshold cannot emit alternating ±1
  every poll — flap damping belongs at the sensor too, not only in
  the controller's cooldown.

Every lifecycle transition lands in the ``hvd_serve_*`` registry
(closed vocabulary: ``analysis/metrics_schema.py SERVE_SERIES``).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from horovod_tpu_torch import faults, telemetry
from horovod_tpu_torch.runtime.config import _env_float, _env_int
from horovod_tpu_torch.serve.queue import AdmissionQueue
from horovod_tpu_torch.serve.replica import DEAD, DEPARTED, Replica
from horovod_tpu_torch.serve.request import InferenceRequest, InferenceResponse
from horovod_tpu_torch.utils import logging as hvd_logging

DEFAULT_DRAIN_TIMEOUT_S = 30.0
DEFAULT_SCALE_UP_DEPTH = 32
DEFAULT_SCALE_DOWN_DEPTH = 2
DEFAULT_SCALE_HOLD_S = 5.0

_TEL_REPLICAS = telemetry.gauge(
    "hvd_serve_replicas", "replicas currently able to take batches")
_TEL_DEATHS = telemetry.counter(
    "hvd_serve_replica_deaths_total",
    "replicas lost to crashes or drain timeouts")
_TEL_DRAINS = telemetry.counter(
    "hvd_serve_drains_total",
    "graceful replica drains completed (planned departure)")
_TEL_DRAIN_TIMEOUTS = telemetry.counter(
    "hvd_serve_drain_timeouts_total",
    "drains that fell back to the dead path")
_TEL_SCALE = telemetry.counter(
    "hvd_serve_scale_events_total",
    "scale signals emitted (direction=up|down)")
_TEL_SCALE_SUPPRESSED = telemetry.counter(
    "hvd_serve_scale_suppressed_total",
    "scale signals swallowed by source hysteresis "
    "(HOROVOD_SERVE_SCALE_HOLD_S)")
_TEL_LATENCY = telemetry.histogram(
    "hvd_serve_latency_seconds",
    "request latency, admission to response")


class ElasticServeBridge:
    """Glue between the pool and the elastic control plane: two
    callbacks, buildable from a live :class:`ElasticDriver` so serving
    rides the exact code paths training recovery already proved."""

    def __init__(self,
                 on_dead: Optional[Callable[[str, int], None]] = None,
                 notify_departure: Optional[Callable[[str, int],
                                                     None]] = None):
        self.on_dead = on_dead
        self.notify_departure = notify_departure

    @classmethod
    def for_driver(cls, driver) -> "ElasticServeBridge":
        """A crashed replica takes the failure-exit path (quarantine +
        regeneration); a drained one announces a planned departure
        first, so its exit is graceful."""
        return cls(
            on_dead=lambda h, lr: driver.record_worker_exit(h, lr, 1),
            notify_departure=lambda h, lr: driver.announce_departure(
                h, lr))


class ReplicaPool:
    def __init__(self, queue: AdmissionQueue,
                 bridge: Optional[ElasticServeBridge] = None,
                 drain_timeout_s: Optional[float] = None,
                 scale_up_depth: Optional[int] = None,
                 scale_down_depth: Optional[int] = None,
                 scale_hold_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        self._queue = queue
        self._bridge = bridge or ElasticServeBridge()
        self.drain_timeout_s = drain_timeout_s \
            if drain_timeout_s is not None \
            else _env_float("HOROVOD_SERVE_DRAIN_TIMEOUT_S",
                            DEFAULT_DRAIN_TIMEOUT_S)
        self.scale_up_depth = scale_up_depth \
            if scale_up_depth is not None \
            else _env_int("HOROVOD_SERVE_SCALE_UP_DEPTH",
                          DEFAULT_SCALE_UP_DEPTH)
        self.scale_down_depth = scale_down_depth \
            if scale_down_depth is not None \
            else _env_int("HOROVOD_SERVE_SCALE_DOWN_DEPTH",
                          DEFAULT_SCALE_DOWN_DEPTH)
        self.scale_hold_s = scale_hold_s if scale_hold_s is not None \
            else _env_float("HOROVOD_SERVE_SCALE_HOLD_S",
                            DEFAULT_SCALE_HOLD_S)
        self._clock = clock
        self._lock = threading.Lock()
        self._replicas: List[Replica] = []
        self._leases: Dict[str, List[InferenceRequest]] = {}
        self._rr = 0
        #: replica deaths observed so far — the autoscale controller
        #: diffs this to treat a chaos kill as lost capacity (a killed
        #: replica both requeues its lease AND feeds the scale loop)
        self.deaths = 0
        self._last_signal = 0
        self._last_signal_t = float("-inf")

    # -- membership ---------------------------------------------------------

    def add_replica(self, replica: Replica) -> Replica:
        with self._lock:
            self._replicas.append(replica)
            _TEL_REPLICAS.set(self._serving_count_locked())
        return replica

    def replicas(self) -> List[Replica]:
        with self._lock:
            return list(self._replicas)

    def _serving_count_locked(self) -> int:
        return sum(1 for r in self._replicas if r.serving)

    def serving_count(self) -> int:
        with self._lock:
            return self._serving_count_locked()

    def pick(self) -> Optional[Replica]:
        """Round-robin over SERVING replicas (deterministic for the
        seeded scenarios); None when the pool has no capacity."""
        with self._lock:
            serving = [r for r in self._replicas if r.serving]
            if not serving:
                return None
            replica = serving[self._rr % len(serving)]
            self._rr += 1
            return replica

    # -- execution ----------------------------------------------------------

    def execute(self, replica: Replica,
                reqs: List[InferenceRequest],
                model_id: Optional[str] = None,
                weights=None,
                weights_fp: Optional[int] = None
                ) -> List[InferenceResponse]:
        """Run one leased batch.  Success completes every id; a crash
        (``WorkerCrash`` or executor error) marks the replica dead and
        re-enqueues the lease exactly once.

        Fleet callers (serve/tenancy.py FleetBatcher) pass the leased
        batch's ``model_id`` plus the weights buffer + fingerprint
        snapshotted *once* before this call — every request in the
        batch runs against that single snapshot (never mixed weights)
        and every response carries its fingerprint."""
        if not reqs:
            return []
        with self._lock:
            self._leases[replica.name] = list(reqs)
        try:
            if model_id is None:
                results = replica.run_batch([r.payload for r in reqs])
            else:
                results = replica.run_batch(
                    [r.payload for r in reqs], model_id=model_id,
                    weights=weights)
        except (faults.WorkerCrash, Exception) as e:  # noqa: BLE001
            self.mark_dead(replica, reason=f"{type(e).__name__}: {e}")
            return []
        now = self._clock()
        with self._lock:
            self._leases.pop(replica.name, None)
        self._queue.complete([r.request_id for r in reqs])
        responses = []
        for req, result in zip(reqs, results):
            latency = max(now - req.arrival_s, 0.0)
            _TEL_LATENCY.observe(latency)
            responses.append(InferenceResponse(
                request_id=req.request_id, result=result,
                replica=replica.name, latency_s=latency,
                requeues=req.requeues, model_id=model_id or "",
                weights_fp=weights_fp))
        return responses

    def mark_dead(self, replica: Replica, reason: str = "") -> int:
        """The crash path: flip to DEAD, re-enqueue the lease (exactly
        once — completed or already-requeued ids are ignored by the
        queue), tell the elastic plane it was a failure exit.  Returns
        how many requests were re-enqueued."""
        with self._lock:
            already_dead = replica.state == DEAD
            replica.state = DEAD
            lease = self._leases.pop(replica.name, [])
            _TEL_REPLICAS.set(self._serving_count_locked())
        if already_dead and not lease:
            return 0
        with self._lock:
            self.deaths += 1
        _TEL_DEATHS.inc()
        requeued = self._queue.requeue(lease)
        hvd_logging.warning(
            "serve: replica %s died (%s) — re-enqueued %d of %d "
            "in-flight request(s)", replica.name, reason or "unknown",
            requeued, len(lease))
        if self._bridge.on_dead is not None:
            self._bridge.on_dead(replica.host, replica.local_rank)
        return requeued

    # -- graceful drain -----------------------------------------------------

    def drain(self, replica: Replica,
              wait: Optional[Callable[[], None]] = None) -> bool:
        """Planned departure (quarantine notice, SIGTERM, scale-down):
        stop routing to the replica, let the in-flight lease finish
        within ``drain_timeout_s`` (``wait`` is called between polls —
        inject a scheduler or fake-clock advance in tests), then
        announce the departure.  Returns True for a graceful drain,
        False when it fell back to the dead path."""
        replica.begin_drain()
        deadline = self._clock() + self.drain_timeout_s
        while True:
            with self._lock:
                pending = bool(self._leases.get(replica.name))
            if not pending:
                break
            if self._clock() >= deadline:
                _TEL_DRAIN_TIMEOUTS.inc()
                self.mark_dead(replica, reason="drain timeout")
                return False
            if wait is not None:
                wait()
        try:
            # chaos hook: a raise/hang here models a drain wedged past
            # its grace window — the replica must fall back to the
            # normal dead path instead of departing half-drained
            faults.inject("serve.drain")
        except Exception as e:  # noqa: BLE001 — fault actions vary
            _TEL_DRAIN_TIMEOUTS.inc()
            self.mark_dead(replica, reason=f"drain fault: {e}")
            return False
        if self._bridge.notify_departure is not None:
            try:
                self._bridge.notify_departure(replica.host,
                                              replica.local_rank)
            except Exception as e:  # noqa: BLE001 — notice is best-effort
                hvd_logging.warning(
                    "serve: departure notice for %s failed: %s",
                    replica.name, e)
        replica.state = DEPARTED
        with self._lock:
            _TEL_REPLICAS.set(self._serving_count_locked())
        _TEL_DRAINS.inc()
        hvd_logging.info("serve: replica %s drained gracefully "
                         "(planned departure)", replica.name)
        return True

    def drain_all(self) -> None:
        """SIGTERM for the whole plane: stop admitting, then drain every
        live replica (docs/serving.md shutdown sequence)."""
        self._queue.stop_admitting()
        for replica in self.replicas():
            if replica.alive:
                self.drain(replica)

    # -- scaling ------------------------------------------------------------

    def scale_signal(self) -> int:
        """+1 (add a replica), −1 (drain one), or 0 — queue depth vs
        the scale thresholds.  The autoscale controller (or the elastic
        driver's discovery plane) is the actuator; this is the sensor.

        Source hysteresis: after a nonzero signal, the *opposite*
        direction is suppressed (0, counted on
        ``hvd_serve_scale_suppressed_total``) until ``scale_hold_s``
        elapses — a depth flapping across ``scale_up_depth`` emits one
        +1 and then silence, not an alternating ±1 train."""
        depth = len(self._queue)
        serving = self.serving_count()
        raw = 0
        if depth >= self.scale_up_depth:
            raw = 1
        elif depth <= self.scale_down_depth and serving > 1:
            raw = -1
        if raw == 0:
            return 0
        now = self._clock()
        with self._lock:
            if raw == -self._last_signal and \
                    now < self._last_signal_t + self.scale_hold_s:
                _TEL_SCALE_SUPPRESSED.inc()
                return 0
            self._last_signal = raw
            self._last_signal_t = now
        _TEL_SCALE.inc(direction="up" if raw > 0 else "down")
        return raw
