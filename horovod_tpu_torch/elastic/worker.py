"""In-worker notification service for elastic host updates (a copy of
``horovod_tpu/elastic/worker.py``; the plan a degrade transition hands a
worker waits with the degrade controller).

Reference: ``horovod/runner/elastic/worker.py`` — each worker runs a tiny
service the driver pings with ``HostsUpdatedRequest``; the notification
manager fans the timestamp out to registered ``State`` listeners, which
turn it into ``HostsUpdatedInterrupt`` at the next ``commit()``/
``check_host_updates()``.

Health plane (docs/faults.md): alongside the notification service each
elastic worker runs a :class:`HeartbeatSender` — a daemon thread beating
to the driver every ``HOROVOD_ELASTIC_HEARTBEAT_INTERVAL`` seconds and
piggybacking the training step counter (:func:`report_step`, bumped by
``TorchState.save()`` on every commit).  The driver's ``HealthMonitor``
turns missing beats into death detection and a stagnant step counter
into hang detection — both *before* the worker process exit is ever
observed.
"""

from __future__ import annotations

import os
import threading
from typing import List, Optional

from horovod_tpu_torch import faults
from horovod_tpu_torch.utils import logging as hvd_logging

# training progress, exported to the driver through heartbeats — written
# by TorchState.save() (one bump per commit), read by the sender thread
_step_lock = threading.Lock()
_current_step = -1


def report_step(step: int) -> None:
    """Record this worker's training progress counter (monotonic; the
    elastic commit count).  Cheap enough to call every step."""
    global _current_step
    with _step_lock:
        if step > _current_step:
            _current_step = step


def current_step() -> int:
    with _step_lock:
        return _current_step


class HeartbeatSender:
    """Daemon thread beating ``(host, local_rank, step)`` to the elastic
    driver.  Send failures are logged at debug and dropped — the next
    beat IS the retry, and a worker must never die because the control
    plane hiccupped."""

    def __init__(self, driver_addr: str, secret_key: Optional[str],
                 host: str, local_rank: int, interval_s: float):
        self._driver_addr = driver_addr
        self._key = secret_key
        self._host = host
        self._local_rank = local_rank
        self.interval_s = float(interval_s)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"hvd_torch_heartbeat_{host}_{local_rank}")

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _run(self) -> None:
        from horovod_tpu_torch import telemetry
        from horovod_tpu_torch.runner.network import notify_heartbeat

        while not self._stop.wait(self.interval_s):
            try:
                # chaos hook: a hang fault here silences the beats while
                # the process stays alive — exactly the failure mode the
                # driver-side HealthMonitor exists to catch
                faults.inject("worker.heartbeat")
                # metrics piggyback: this rank's counter snapshot rides
                # the beat the way the step counter does, so the driver
                # aggregates rank registries with no extra RPC or thread
                metrics = telemetry.counters_snapshot() \
                    if telemetry.enabled() else None
                notify_heartbeat(self._driver_addr, self._key,
                                 self._host, self._local_rank,
                                 current_step(), metrics=metrics)
            except OSError as e:
                hvd_logging.debug("elastic: heartbeat send failed: %s", e)


class WorkerNotificationManager:
    def __init__(self):
        self._lock = threading.Lock()
        self._listeners: List = []
        self._service: Optional["WorkerNotificationService"] = None
        self._heartbeat: Optional[HeartbeatSender] = None
        # peer-repair provider (guard/repair.py): a callable returning
        # this worker's committed (step, state) snapshot, served to a
        # diverged peer over the notification channel
        self._state_provider = None

    def init(self) -> None:
        if self._service is not None:
            return
        secret_key = os.environ.get("HOROVOD_SECRET_KEY")
        addr = os.environ.get("HOROVOD_ELASTIC_NOTIFY_ADDR")
        if addr:
            self._service = WorkerNotificationService(self, secret_key)
            self._service.start()
            # register our address with the driver so it can notify us,
            # and report READY: startup finished, training loop entered
            # (worker-reported readiness — reference registration.py)
            driver_addr = os.environ.get("HOROVOD_ELASTIC_DRIVER_ADDR")
            if driver_addr:
                import socket

                from horovod_tpu_torch.runner.network import (
                    notify_worker_ready,
                    notify_worker_registered,
                )
                from horovod_tpu_torch.runtime.retry import default_policy

                host = os.environ.get("HOROVOD_HOSTNAME",
                                      socket.gethostname())
                local_rank = int(os.environ.get("HOROVOD_LOCAL_RANK", "0"))
                # the driver may still be binding its service when a
                # fast worker comes up — transient connect failures are
                # retried under the unified policy instead of failing
                # the worker's whole startup
                policy = default_policy(name="worker-register",
                                        retry_on=(OSError,))
                faults.inject("worker.register")
                policy.call(notify_worker_registered, driver_addr,
                            self._service.address, secret_key)
                policy.call(notify_worker_ready, driver_addr, secret_key,
                            host, local_rank)
                from horovod_tpu_torch.elastic.health import heartbeat_interval_s

                interval = heartbeat_interval_s()
                if interval > 0:
                    self._heartbeat = HeartbeatSender(
                        driver_addr, secret_key, host, local_rank,
                        interval)
                    self._heartbeat.start()

    def set_state_provider(self, provider) -> None:
        """Install the callable a diverged peer's ``FetchStateRequest``
        is served from: ``provider() -> (step, state)`` or None when
        nothing is committed yet (guard/repair.py).  Typically
        ``lambda: (state._commit_count, state._saved_state)`` guarded by
        the training loop's commit."""
        with self._lock:
            self._state_provider = provider

    def handle_fetch_state(self):
        """NotificationServer dispatch target for FetchStateRequest."""
        with self._lock:
            provider = self._state_provider
        if provider is None:
            return None
        return provider()

    def register_listener(self, listener) -> None:
        with self._lock:
            self._listeners.append(listener)

    def remove_listener(self, listener) -> None:
        with self._lock:
            if listener in self._listeners:
                self._listeners.remove(listener)

    def handle_hosts_updated(self, timestamp: int, update_res=None,
                             generation: int = -1) -> None:
        """Fan a host change out to the listeners, unless it made a
        generation this worker already runs in (a survivor of a failure
        re-rendezvouses on its own, and the driver's ping of the same
        change can land after that: it would reset the new world again)."""
        joined = int(os.environ.get("HOROVOD_ELASTIC_GENERATION", "-1"))
        if 0 <= generation <= joined:
            hvd_logging.debug(
                "elastic: hosts-updated notification ts=%s for generation "
                "%d, already joined (%d): dropped", timestamp, generation,
                joined)
            return
        with self._lock:
            listeners = list(self._listeners)
        for listener in listeners:
            listener.on_hosts_updated(timestamp, update_res)
        hvd_logging.debug("elastic: hosts-updated notification ts=%s",
                          timestamp)


class WorkerNotificationService:
    """TCP listener receiving HostsUpdated pings (lazy import of runner
    network layer; constructed only under an elastic launcher)."""

    def __init__(self, manager: WorkerNotificationManager, secret_key):
        from horovod_tpu_torch.runner.network import NotificationServer

        self._server = NotificationServer(manager, secret_key)

    def start(self) -> None:
        self._server.start()

    @property
    def address(self):
        return self._server.address


def refresh_assignment_from_driver(timeout_s: float = 60.0) -> bool:
    """After a reset, fetch this worker's new identity from the elastic
    driver's rendezvous RPC and export it into the env the runtime reads
    (reference: workers re-read rank/size from the rendezvous on reset,
    ``elastic/rendezvous.py``).  No-op (False) outside elastic runs.

    Waits for a generation STRICTLY newer than the one this worker was
    running: a reset is only ever triggered after something the driver
    will also observe (a worker death → resume, a host change → resume
    after reassignment), so re-initializing against the old generation's
    coordinator would race the driver's reassignment and hang in
    ``init_process_group`` waiting for a world that will never form
    again.  A worker whose (host, local_rank) has no slot in the new
    generation was scaled away — it exits 0 (the reference driver stops
    removed workers via the host event; here the worker retires itself).

    Transport failures (a driver mid-restart, a dropped connection) are
    retried with backoff+jitter under the unified policy instead of
    killing the worker — giving up only at ``timeout_s``.
    """
    import socket
    import sys
    import time

    driver_addr = os.environ.get("HOROVOD_ELASTIC_DRIVER_ADDR")
    if not driver_addr:
        return False
    from horovod_tpu_torch.elastic.driver import GetRankAndSizeRequest
    from horovod_tpu_torch.runner.network import BasicClient
    from horovod_tpu_torch.runtime.retry import default_policy

    key = os.environ.get("HOROVOD_SECRET_KEY")
    hostname = os.environ.get("HOROVOD_HOSTNAME", socket.gethostname())
    local_rank = int(os.environ.get("HOROVOD_LOCAL_RANK", "0"))
    known_gen = int(os.environ.get("HOROVOD_ELASTIC_GENERATION", "-1"))
    host, port = driver_addr.rsplit(":", 1)
    client = BasicClient((host, int(port)), key)
    policy = default_policy(name="rendezvous", retry_on=(OSError,),
                            deadline_s=timeout_s)
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        faults.inject("worker.rendezvous")
        resp = policy.call(
            client.request,
            GetRankAndSizeRequest(hostname, local_rank, known_gen))
        if resp.generation > known_gen:
            if resp.slot is None:
                hvd_logging.info(
                    "elastic: (%s, %d) has no slot in generation %d — "
                    "worker removed by scale-down, exiting cleanly",
                    hostname, local_rank, resp.generation)
                sys.exit(0)
            os.environ.update(resp.slot.to_env())
            os.environ["HOROVOD_COORDINATOR_ADDR"] = resp.coordinator_addr
            os.environ["HOROVOD_ELASTIC_GENERATION"] = str(resp.generation)
            # a degrade/promote transition re-resolved the plan to this
            # generation's world: export it, so that the step made after
            # reset builds its mesh at the current factorization
            # (elastic/degrade.py); getattr: the driver may predate the
            # plan field
            plan = getattr(resp, "plan", None)
            if plan:
                os.environ["HOROVOD_PLAN"] = plan
            hvd_logging.info(
                "elastic: new assignment rank=%d/%d (generation %d%s)",
                resp.slot.rank, resp.slot.size, resp.generation,
                f", plan {plan}" if plan else "")
            return True
        time.sleep(0.5)
    raise TimeoutError(
        f"elastic: no new-generation assignment for ({hostname}, "
        f"{local_rank}) from driver within {timeout_s}s")


_manager: Optional[WorkerNotificationManager] = None
_manager_lock = threading.Lock()


def init_notification_manager() -> Optional[WorkerNotificationManager]:
    global _manager
    with _manager_lock:
        if _manager is None:
            _manager = WorkerNotificationManager()
            try:
                _manager.init()
            except Exception as e:  # non-elastic runs have no driver
                hvd_logging.debug("notification manager init skipped: %s", e)
        return _manager


def announce_departure(step: int = -1) -> bool:
    """Worker-side planned-departure announcement: tell the elastic
    driver this process will exit on purpose (preemption grace, serve
    replica drain) so the exit is graceful — no blacklist, no
    quarantine, no sibling abort.  Reads the worker identity from the
    env the driver exported; no-op (False) outside elastic runs.  The
    exemption is bounded by ``HOROVOD_ELASTIC_DEPART_GRACE_S``: a
    worker that announces but wedges instead of exiting falls back to
    the normal dead-worker path."""
    import socket

    driver_addr = os.environ.get("HOROVOD_ELASTIC_DRIVER_ADDR")
    if not driver_addr:
        return False
    from horovod_tpu_torch.runner.network import notify_planned_departure

    if step < 0:
        step = current_step()
    try:
        notify_planned_departure(
            driver_addr, os.environ.get("HOROVOD_SECRET_KEY"),
            os.environ.get("HOROVOD_HOSTNAME", socket.gethostname()),
            int(os.environ.get("HOROVOD_LOCAL_RANK", "0")), step)
        return True
    except OSError as e:
        # best-effort: a dead driver cannot grant grace anyway
        hvd_logging.warning("departure announcement failed: %s", e)
        return False
