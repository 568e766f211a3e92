"""Closed-loop autoscaling: the scale signal has a consumer (a copy of
``horovod_tpu/serve/autoscale.py``, docs/serving.md).

``ReplicaPool.scale_signal()`` is a sensor; :class:`AutoscaleController`
closes the loop: each :meth:`poll` folds
the signal, the queue depth, and the p99 latency EWMA into a target
replica count, then actuates —

* **acquire** (scale up, or replace a killed replica): the injected
  ``acquire()`` factory builds a replica and the controller adds it to
  the pool.  The factory's executor is typically an
  :class:`~horovod_tpu_torch.serve.batcher.ExecutableCache` shared with
  the live replicas, so a new replica reuses the executables already
  built;
* **release** (scale down): the pool's graceful drain —
  ``pool.drain()`` on the most recently added serving replica, so the
  departure announces itself to the elastic driver and nothing is
  lost.

**Oscillation-freedom** is layered: the signal source suppresses
direction reversals for ``HOROVOD_SERVE_SCALE_HOLD_S`` (pool.py), and
the controller adds an actuation cooldown
(``HOROVOD_SERVE_SCALE_COOLDOWN_S``) — after any scale action, further
*signal-driven* actions wait out the cooldown.  Capacity lost to a
death bypasses the cooldown (restoring what the target already calls
for is not an oscillation): ``pool.deaths`` is diffed every poll, so a
killed replica both requeues its lease exactly-once (pool.mark_dead)
AND feeds the scale loop.  A seeded open-loop trace with depth
flapping across the threshold is pinned oscillation-free by test.

``on_capacity_change(serving_count)`` fires after every actuation or
observed death — wire it to the degrade machinery
(``DegradeController.on_world_change`` / ``DegradedPlanResolver``) so
capacity lost mid-traffic re-resolves the serving plan the same way a
training world-change does.

Fault site ``serve.scale`` fires at the top of every poll; a ``hang``
there models a wedged control loop, a ``raise`` a flaky actuator
(docs/faults.md).  Bounds: ``HOROVOD_SERVE_SCALE_MIN_REPLICAS`` /
``HOROVOD_SERVE_SCALE_MAX_REPLICAS``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

from horovod_tpu_torch import faults, telemetry
from horovod_tpu_torch.runtime.config import _env_float, _env_int
from horovod_tpu_torch.serve.pool import ReplicaPool
from horovod_tpu_torch.serve.replica import Replica
from horovod_tpu_torch.utils import logging as hvd_logging

DEFAULT_COOLDOWN_S = 30.0
DEFAULT_MIN_REPLICAS = 1
DEFAULT_MAX_REPLICAS = 8

_TEL_UPS = telemetry.counter(
    "hvd_serve_scale_ups_total",
    "replicas acquired by the autoscale controller")
_TEL_DOWNS = telemetry.counter(
    "hvd_serve_scale_downs_total",
    "replicas released (graceful drain) by the autoscale controller")
_TEL_TARGET = telemetry.gauge(
    "hvd_serve_scale_target",
    "the autoscale controller's current target replica count")


class AutoscaleController:
    """Sensor → target → actuator loop over a :class:`ReplicaPool`
    (module docstring).

    ``p99_target_s`` > 0 arms the latency term: when the p99 EWMA
    (fed by :meth:`note_latency`, folded at each poll) exceeds the
    target, the controller scales up even if the depth signal is
    quiet — queues hide behind deep batches; tails do not.
    """

    def __init__(self, pool: ReplicaPool,
                 acquire: Callable[[], Replica],
                 cooldown_s: Optional[float] = None,
                 min_replicas: Optional[int] = None,
                 max_replicas: Optional[int] = None,
                 p99_target_s: float = 0.0,
                 ewma_alpha: float = 0.2,
                 on_capacity_change: Optional[Callable[[int],
                                                       None]] = None,
                 clock: Callable[[], float] = time.monotonic):
        self._pool = pool
        self._acquire = acquire
        self.cooldown_s = cooldown_s if cooldown_s is not None \
            else _env_float("HOROVOD_SERVE_SCALE_COOLDOWN_S",
                            DEFAULT_COOLDOWN_S)
        self.min_replicas = min_replicas if min_replicas is not None \
            else _env_int("HOROVOD_SERVE_SCALE_MIN_REPLICAS",
                          DEFAULT_MIN_REPLICAS)
        self.max_replicas = max_replicas if max_replicas is not None \
            else _env_int("HOROVOD_SERVE_SCALE_MAX_REPLICAS",
                          DEFAULT_MAX_REPLICAS)
        self.p99_target_s = p99_target_s
        self.ewma_alpha = ewma_alpha
        self._on_capacity_change = on_capacity_change
        self._clock = clock
        self._lock = threading.Lock()
        self._window: List[float] = []
        self.p99_ewma = 0.0
        self._target = max(pool.serving_count(), self.min_replicas)
        self._deaths_seen = pool.deaths
        self._last_action_t = float("-inf")
        self.scale_ups = 0
        self.scale_downs = 0

    # -- sensors ------------------------------------------------------------

    def note_latency(self, latency_s: float) -> None:
        """Feed one response latency (wire to the batcher's
        ``on_response``); folded into the p99 EWMA at the next poll."""
        with self._lock:
            self._window.append(float(latency_s))

    def _fold_window_locked(self) -> None:
        if not self._window:
            return
        window = sorted(self._window)
        self._window = []
        # nearest-rank p99 of the window, EWMA-folded across polls —
        # pure arithmetic, deterministic for the seeded scenarios
        p99 = window[min(len(window) - 1,
                         int(0.99 * (len(window) - 1) + 0.5))]
        self.p99_ewma = p99 if not self.p99_ewma else \
            (1.0 - self.ewma_alpha) * self.p99_ewma \
            + self.ewma_alpha * p99

    @property
    def target(self) -> int:
        with self._lock:
            return self._target

    # -- the loop -----------------------------------------------------------

    def poll(self) -> int:
        """One control iteration; returns the net replica delta
        actuated (+n acquired, −1 released, 0 held)."""
        faults.inject("serve.scale")
        with self._lock:
            self._fold_window_locked()
            p99_breach = self.p99_target_s > 0 \
                and self.p99_ewma > self.p99_target_s
        serving = self._pool.serving_count()
        deaths = self._pool.deaths
        now = self._clock()
        with self._lock:
            new_deaths = deaths - self._deaths_seen
            self._deaths_seen = deaths
            cooled = now >= self._last_action_t + self.cooldown_s
            target = self._target
            if cooled:
                signal = self._pool.scale_signal()
                if signal > 0 or p99_breach:
                    target = serving + 1
                elif signal < 0:
                    target = serving - 1
            target = max(self.min_replicas,
                         min(self.max_replicas, target))
            self._target = target
            _TEL_TARGET.set(target)
        delta = 0
        # deficit repair (death replacement) ignores the cooldown:
        # restoring already-wanted capacity is not an oscillation
        while serving + delta < target and (cooled or new_deaths > 0):
            replica = self._acquire()
            self._pool.add_replica(replica)
            delta += 1
            with self._lock:
                self.scale_ups += 1
            _TEL_UPS.inc()
            hvd_logging.info(
                "serve: autoscale acquired %s (serving %d → target %d"
                "%s)", replica.name, serving, target,
                ", death repair" if new_deaths > 0 else "")
        if delta == 0 and cooled and serving > target:
            victim = next(
                (r for r in reversed(self._pool.replicas())
                 if r.serving), None)
            if victim is not None:
                self._pool.drain(victim)
                delta -= 1
                with self._lock:
                    self.scale_downs += 1
                _TEL_DOWNS.inc()
                hvd_logging.info(
                    "serve: autoscale released %s (serving %d → "
                    "target %d)", victim.name, serving, target)
        if delta != 0:
            with self._lock:
                self._last_action_t = now
            if self._on_capacity_change is not None:
                self._on_capacity_change(self._pool.serving_count())
        elif new_deaths > 0 and self._on_capacity_change is not None:
            self._on_capacity_change(serving)
        return delta
