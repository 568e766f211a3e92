"""Heartbeat health monitoring for the elastic driver (a copy of
``horovod_tpu/elastic/health.py``; docs/faults.md).

The driver previously learned of a dead worker only when its *process
exit* was observed by the launcher thread — a worker wedged in a
collective, or whose host dropped off the network, looked healthy
forever (until the coordination-service heartbeat killed the whole
generation from C++).  :class:`HealthMonitor` closes that gap at the
control plane: workers send periodic heartbeats over the existing
driver RPC channel (``HeartbeatRequest``, piggybacking the training
step counter), and the monitor applies two detectors:

* **liveness**: a worker is *suspect* after ``suspect_misses`` missed
  beats (logged once), and *dead* once no beat has arrived for
  ``dead_s`` — at which point ``on_dead(host, local_rank, detect_s,
  reason)`` fires and the driver starts regeneration *before* the
  process exit is ever observed;
* **progress**: a worker whose beats keep arriving but whose step
  counter has not advanced for ``progress_timeout_s`` is declared hung
  (:class:`~horovod_tpu_torch.utils.stall.ProgressWatchdog` per worker) —
  the hung-but-alive case liveness alone cannot see;
* **stragglers** (observability-only): each worker's step-rate EWMA
  (off the same heartbeat step piggyback) is compared to the fleet
  median; one falling to ``1/straggler_ratio`` of the median gets a
  ``suspect_slow`` verdict — a worker-labeled
  ``hvd_elastic_straggler_ratio`` gauge and a one-shot warning, never
  a regeneration (a slow worker still makes progress; killing it
  trades throughput for a recovery stall).

Workers appear here only after their first heartbeat: never-started
workers are the startup watchdog's job (``driver._check_started``).
``clock`` and ``start_thread`` are injectable so chaos tests drive the
monitor deterministically on a fake clock.

Knobs: ``HOROVOD_ELASTIC_HEARTBEAT_INTERVAL`` (seconds between worker
beats, 0 disables the subsystem), ``HOROVOD_ELASTIC_HEARTBEAT_SUSPECT_
MISSES``, ``HOROVOD_ELASTIC_HEARTBEAT_DEAD_S``,
``HOROVOD_ELASTIC_PROGRESS_TIMEOUT_S`` (0 disables the progress
detector), ``HOROVOD_ELASTIC_DEPART_GRACE_S`` (how long an
announced planned departure may linger before the wedged worker falls
back to the normal dead-worker path), and
``HOROVOD_ELASTIC_STRAGGLER_RATIO`` (suspect_slow threshold, 0
disables the straggler detector).  See docs/running.md.
"""

from __future__ import annotations

import os
import statistics
import threading
import time
from typing import Callable, Dict, Optional, Tuple

from horovod_tpu_torch import faults, telemetry
from horovod_tpu_torch.utils import logging as hvd_logging
from horovod_tpu_torch.utils.stall import ProgressWatchdog

DEFAULT_INTERVAL_S = 2.0
DEFAULT_SUSPECT_MISSES = 3
DEFAULT_DEAD_MULTIPLE = 10     # dead_s default = interval * this
DEFAULT_DEPART_GRACE_MULTIPLE = 3   # depart_grace_s default = dead_s * this
DEFAULT_STRAGGLER_RATIO = 3.0  # suspect_slow at median/rate >= this
STRAGGLER_EWMA_ALPHA = 0.3     # smoothing of the per-worker step rate

# health-plane telemetry (docs/metrics.md): what used to exist only as
# log lines.  Heartbeat age + progress stall are the precursors
# (scrapeable while a worker degrades); detect_s and the death counter
# record the verdicts the driver acts on.
_TEL_BEAT_AGE = telemetry.gauge(
    "hvd_worker_heartbeat_age_seconds",
    "max seconds since any monitored worker's last heartbeat")
_TEL_WORKERS = telemetry.gauge(
    "hvd_workers_monitored", "workers currently heartbeating")
_TEL_SUSPECT = telemetry.counter(
    "hvd_elastic_worker_suspect_total", "suspect declarations")
_TEL_DEATHS = telemetry.counter(
    "hvd_elastic_worker_deaths_total",
    "health-plane death/hang declarations")
_TEL_DETECT = telemetry.gauge(
    "hvd_elastic_detect_seconds",
    "silence/stagnation span of the most recent death declaration")
_TEL_STRAGGLER = telemetry.gauge(
    "hvd_elastic_straggler_ratio",
    "fleet-median step rate over this worker's EWMA step rate "
    "(1.0 = keeping pace; >= the straggler threshold = suspect_slow)")


def heartbeat_interval_s() -> float:
    return float(os.environ.get("HOROVOD_ELASTIC_HEARTBEAT_INTERVAL",
                                DEFAULT_INTERVAL_S))


class _WorkerHealth:
    __slots__ = ("last_beat", "suspect", "progress",
                 "rate", "last_step", "last_step_t", "slow")

    def __init__(self, now: float, clock, name: str = ""):
        self.last_beat = now
        self.suspect = False
        # named: the per-worker progress watchdog publishes its
        # stagnation gauge, the scrapeable hung-worker precursor
        self.progress = ProgressWatchdog(clock=clock, name=name or None)
        # straggler detector state: EWMA steps/s off the heartbeat's
        # step piggyback, compared to the fleet median in check()
        self.rate: Optional[float] = None
        self.last_step: Optional[int] = None
        self.last_step_t: Optional[float] = None
        self.slow = False

    def observe_step(self, step: int, now: float) -> None:
        """Fold a step report into the EWMA rate (advances only — a
        repeated step is the progress watchdog's business)."""
        if self.last_step is None:
            self.last_step, self.last_step_t = step, now
            return
        if step <= self.last_step or now <= self.last_step_t:
            return
        inst = (step - self.last_step) / (now - self.last_step_t)
        self.rate = inst if self.rate is None else (
            STRAGGLER_EWMA_ALPHA * inst
            + (1.0 - STRAGGLER_EWMA_ALPHA) * self.rate)
        self.last_step, self.last_step_t = step, now


class HealthMonitor:
    def __init__(self, on_dead: Callable[[str, int, float, str], None],
                 interval_s: float = DEFAULT_INTERVAL_S,
                 suspect_misses: int = DEFAULT_SUSPECT_MISSES,
                 dead_s: Optional[float] = None,
                 progress_timeout_s: float = 0.0,
                 depart_grace_s: Optional[float] = None,
                 straggler_ratio: float = DEFAULT_STRAGGLER_RATIO,
                 clock: Callable[[], float] = time.monotonic,
                 start_thread: bool = True):
        self._on_dead = on_dead
        self.interval_s = float(interval_s)
        self.suspect_misses = max(int(suspect_misses), 1)
        self.dead_s = float(dead_s) if dead_s is not None \
            else self.interval_s * DEFAULT_DEAD_MULTIPLE
        self.progress_timeout_s = float(progress_timeout_s)
        self.depart_grace_s = float(depart_grace_s) \
            if depart_grace_s is not None \
            else self.dead_s * DEFAULT_DEPART_GRACE_MULTIPLE
        self.straggler_ratio = float(straggler_ratio)  # 0 disables
        self._clock = clock
        self._start_thread = start_thread
        self._lock = threading.Lock()
        self._workers: Dict[Tuple[str, int], _WorkerHealth] = {}
        # workers that announced a planned (preemption) departure,
        # keyed to the announce time: exempt from death/hang verdicts —
        # their silence is expected and must not trigger regeneration
        # ahead of the clean exit.  The exemption is bounded: a worker
        # that announces but never exits within depart_grace_s is
        # wedged, and falls back to the normal dead-worker path
        self._departing: Dict[Tuple[str, int], float] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @classmethod
    def from_env(cls, on_dead) -> "HealthMonitor":
        interval = heartbeat_interval_s()
        dead_env = os.environ.get("HOROVOD_ELASTIC_HEARTBEAT_DEAD_S")
        grace_env = os.environ.get("HOROVOD_ELASTIC_DEPART_GRACE_S")
        return cls(
            on_dead,
            interval_s=interval,
            suspect_misses=int(os.environ.get(
                "HOROVOD_ELASTIC_HEARTBEAT_SUSPECT_MISSES",
                DEFAULT_SUSPECT_MISSES)),
            dead_s=float(dead_env) if dead_env else None,
            progress_timeout_s=float(os.environ.get(
                "HOROVOD_ELASTIC_PROGRESS_TIMEOUT_S", 0.0)),
            depart_grace_s=float(grace_env) if grace_env else None,
            straggler_ratio=float(os.environ.get(
                "HOROVOD_ELASTIC_STRAGGLER_RATIO",
                DEFAULT_STRAGGLER_RATIO)))

    @property
    def enabled(self) -> bool:
        return self.interval_s > 0

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        if not self.enabled or not self._start_thread \
                or self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._watch, daemon=True,
            name="hvd_tpu_elastic_health")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        # a verdict of the monitor's own thread can stop the driver (every
        # host lost), and a thread cannot join itself: it ends on _stop
        if self._thread is not None and \
                self._thread is not threading.current_thread():
            self._thread.join(timeout=2)
        self._thread = None

    def _watch(self) -> None:
        poll = max(self.interval_s / 2.0, 0.05)
        while not self._stop.wait(poll):
            # chaos hook: a hang/delay here models a stalled monitor —
            # death detection latency degrades to the process-exit path
            faults.inject("driver.health")
            self.check()

    # -- recording ----------------------------------------------------------

    def record_heartbeat(self, host: str, local_rank: int,
                         step: int = -1) -> None:
        now = self._clock()
        with self._lock:
            if (host, local_rank) in self._departing:
                # a straggler beat sent during the drain window must not
                # re-enroll the worker: its exit is imminent and planned
                return
            w = self._workers.get((host, local_rank))
            if w is None:
                w = _WorkerHealth(now, self._clock,
                                  name=f"{host}:{local_rank}")
                self._workers[(host, local_rank)] = w
            else:
                if w.suspect:
                    hvd_logging.info(
                        "elastic: worker %s:%d resumed heartbeating",
                        host, local_rank)
                w.last_beat = now
                w.suspect = False
            if step >= 0:
                w.progress.update(step, now=now)
                w.observe_step(step, now)

    def mark_departing(self, host: str, local_rank: int) -> None:
        """A planned (preemption-grace) departure was announced: stop
        counting this worker toward death/hang verdicts.  Its eventual
        exit is handled by the driver as graceful (guard/preempt.py)."""
        with self._lock:
            self._departing[(host, local_rank)] = self._clock()
            self._workers.pop((host, local_rank), None)

    def is_departing(self, host: str, local_rank: int) -> bool:
        with self._lock:
            return (host, local_rank) in self._departing

    def forget(self, host: str, local_rank: int) -> None:
        with self._lock:
            self._workers.pop((host, local_rank), None)
            self._departing.pop((host, local_rank), None)

    def purge(self, assigned: set) -> None:
        """Drop entries for workers no longer assigned (driver calls this
        on every reassignment — a removed worker must not be declared
        dead later, and a re-added one must start with a fresh clock)."""
        with self._lock:
            self._workers = {k: w for k, w in self._workers.items()
                             if k in assigned}
            self._departing = {k: t for k, t in self._departing.items()
                               if k in assigned}

    def max_step(self) -> int:
        """Highest training step any monitored worker ever reported —
        the pre-failure peak the chaos probe diffs against the restored
        step to compute ``steps_lost``."""
        with self._lock:
            vals = [w.progress.value for w in self._workers.values()
                    if w.progress.value is not None]
        return max(vals) if vals else -1

    def stragglers(self) -> list:
        """``(host, local_rank)`` keys currently under a
        ``suspect_slow`` verdict (observability-only: no regeneration,
        no quarantine — docs/elastic.md)."""
        with self._lock:
            return [k for k, w in self._workers.items() if w.slow]

    def _check_stragglers(self) -> None:
        """Per-worker EWMA step rate vs the fleet median (caller holds
        the lock).  A worker whose rate falls to ``1/straggler_ratio``
        of the median gets a one-shot ``suspect_slow`` warning and a
        worker-labeled gauge; the verdict clears when it catches back
        up.  Needs >= 2 rated workers — a fleet of one has no median
        worth trusting."""
        if self.straggler_ratio <= 0:
            return
        rated = [(k, w) for k, w in self._workers.items()
                 if w.rate is not None and w.rate > 0]
        if len(rated) < 2:
            return
        med = statistics.median(w.rate for _, w in rated)
        if med <= 0:
            return
        for (host, lr), w in rated:
            ratio = med / w.rate
            _TEL_STRAGGLER.set(ratio, worker=f"{host}:{lr}")
            if ratio >= self.straggler_ratio:
                if not w.slow:
                    w.slow = True
                    hvd_logging.warning(
                        "elastic: worker %s:%d is suspect_slow — "
                        "stepping at %.3g/s vs fleet median %.3g/s "
                        "(%.1fx slower; threshold %.1fx). "
                        "Observability-only: not a death verdict",
                        host, lr, w.rate, med, ratio,
                        self.straggler_ratio)
            elif w.slow:
                w.slow = False
                hvd_logging.info(
                    "elastic: worker %s:%d caught back up "
                    "(%.1fx the fleet median)", host, lr, ratio)

    # -- detection ----------------------------------------------------------

    def check(self, now: Optional[float] = None) -> list:
        """One detection pass; returns the ``(host, local_rank)`` keys
        declared dead/hung (their ``on_dead`` callbacks have run)."""
        if not self.enabled:
            return []
        if now is None:
            now = self._clock()
        dead = []
        max_age = 0.0
        with self._lock:
            _TEL_WORKERS.set(len(self._workers))
            for key, w in list(self._workers.items()):
                age = now - w.last_beat
                max_age = max(max_age, age)
                if age >= self.dead_s:
                    # detect_s: silence span from the last sign of life
                    # to this declaration
                    dead.append((key, age, "missed heartbeats"))
                    del self._workers[key]
                    continue
                if self.progress_timeout_s > 0:
                    stalled = w.progress.stalled_for(now=now)
                    if stalled >= self.progress_timeout_s:
                        dead.append((key, stalled,
                                     "no step progress (hung)"))
                        del self._workers[key]
                        continue
                if not w.suspect and \
                        age >= self.interval_s * self.suspect_misses:
                    w.suspect = True
                    _TEL_SUSPECT.inc()
                    hvd_logging.warning(
                        "elastic: worker %s:%d is suspect — %.0f missed "
                        "heartbeat(s) (%.1fs silent; declared dead at "
                        "%.1fs)", key[0], key[1],
                        age / self.interval_s, age, self.dead_s)
            self._check_stragglers()
            if self.depart_grace_s > 0:
                # bounded exemption: an announced departure that never
                # became a process exit is a wedged worker, not a
                # graceful one — fall back to the dead-worker path
                for key, announced in list(self._departing.items()):
                    waited = now - announced
                    if waited >= self.depart_grace_s:
                        dead.append((key, waited,
                                     "departure grace expired (wedged)"))
                        del self._departing[key]
        _TEL_BEAT_AGE.set(max_age)
        for (host, local_rank), detect_s, reason in dead:
            # verdict telemetry BEFORE the callback: bench.py --chaos
            # and the driver both read detect_s from the registry
            _TEL_DETECT.set(detect_s)
            if "hung" in reason:
                label = "hung"
            elif "departure" in reason:
                label = "depart_grace_expired"
            else:
                label = "missed_heartbeats"
            _TEL_DEATHS.inc(reason=label)
            self._on_dead(host, local_rank, detect_s, reason)
        return [k for k, _, _ in dead]
