"""The elastic driver: orchestrates a dynamic worker set (a copy of
``horovod_tpu/elastic/driver.py``).

Reference: ``horovod/runner/elastic/driver.py`` — periodic host
discovery (1 s), rank-stable reassignment on host changes, host
blacklisting on worker failure, worker notification, and the rendezvous
workers query for their new identity after a reset.  Each world
generation gets a fresh coordinator address: a ``torch.distributed``
store that this process hosts (``runtime/distributed.py``), on which the
generation's process group rendezvouses, handed out through the same
rendezvous RPC.  A degrade controller (:class:`~horovod_tpu_torch.
elastic.degrade.DegradeController`, plan-aware graceful degradation) is
taken through :meth:`ElasticDriver.set_degrade_controller`; the elastic
launcher attaches one under ``HOROVOD_DEGRADE=1``.
"""

from __future__ import annotations

import os
import socket
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from horovod_tpu_torch import faults, telemetry
from horovod_tpu_torch.elastic.discovery import HostManager, HostUpdateResult
from horovod_tpu_torch.elastic.health import HealthMonitor
from horovod_tpu_torch.elastic.registration import WorkerStateRegistry
from horovod_tpu_torch.runner.hosts import HostInfo, SlotInfo, get_host_assignments
from horovod_tpu_torch.runner.network import (
    AckResponse,
    BasicService,
    GetHealthyPeerRequest,
    HeartbeatRequest,
    PeerAddressResponse,
    PlannedDepartureRequest,
    RegisterWorkerRequest,
    WorkerReadyRequest,
    notify_hosts_updated,
)
from horovod_tpu_torch.utils import logging as hvd_logging

DISCOVER_INTERVAL_S = 1.0    # reference driver.py:30
START_TIMEOUT_S = 120.0      # worker must report READY within this window


class GetRankAndSizeRequest:
    """Worker → driver: my (host, local_rank); give me my current
    assignment (reference ``ElasticRendezvousHandler`` GET rank_and_size)."""

    def __init__(self, host: str, local_rank: int, generation: int = -1):
        self.host = host
        self.local_rank = local_rank
        self.generation = generation


class RankAndSizeResponse:
    def __init__(self, slot: Optional[SlotInfo], coordinator_addr: str,
                 generation: int, plan: Optional[str] = None):
        self.slot = slot
        self.coordinator_addr = coordinator_addr
        self.generation = generation
        # the parallelism plan of this generation's world (canonical
        # HOROVOD_PLAN string) when a degrade controller is attached:
        # a worker rejoining after a degrade/promote transition must
        # rebuild its mesh for the CURRENT plan, not the one it was
        # launched with (elastic/degrade.py)
        self.plan = plan


class ElasticDriver:
    def __init__(self, discovery, min_np: int, max_np: Optional[int] = None,
                 timeout: float = 600.0, reset_limit: int = 0,
                 secret_key: Optional[str] = None,
                 start_timeout: float = START_TIMEOUT_S):
        self._host_manager = HostManager(discovery)
        self._registry = WorkerStateRegistry(self, self._host_manager,
                                             reset_limit=reset_limit)
        self._min_np = min_np
        self._max_np = max_np
        self._timeout = timeout
        self._start_timeout = start_timeout
        self._secret_key = secret_key

        self._lock = threading.RLock()
        self._assignments: Dict[Tuple[str, int], SlotInfo] = {}
        self._abort_events: Dict[Tuple[str, int], threading.Event] = {}
        # per-spawn token so a startup watchdog armed for an earlier
        # spawn of the same (host, local_rank) slot cannot fail a newer
        # worker that reuses the key (see _check_started)
        self._spawn_tokens: Dict[Tuple[str, int], int] = {}
        # workers that asked for a generation newer than the current one
        # (worker-initiated re-rendezvous, see _handle)
        self._regen_requests: set = set()
        self._generation = 0
        # recovery observability: wall-clock from each generation's
        # assignment to every assigned worker reporting READY
        self._generation_started: float = time.monotonic()
        self._generation_ready_logged = -1
        self.last_recovery_s: Optional[float] = None
        # heartbeat health plane: workers beat over the driver RPC
        # channel; the monitor declares a silent worker dead (and a
        # beating-but-stuck one hung) BEFORE its process exit is
        # observed, so regeneration starts detect_s after the failure
        # instead of whenever the launcher thread notices the exit
        self._health = HealthMonitor.from_env(self._on_worker_dead)
        self.last_detect_s: Optional[float] = None
        self.last_detect_reason: Optional[str] = None
        # structured per-generation recovery record (docs/metrics.md):
        # what the recovery_s/detect_s log lines said, as data — appended
        # when a generation reaches fully-READY, mirrored into the
        # registry as generation-labeled gauges
        self._generation_history: List[dict] = []
        self._step_at_detect: Optional[int] = None
        # per-worker counter snapshots off the heartbeat piggyback; the
        # driver's Prometheus endpoint serves them worker-labeled
        self._worker_metrics = telemetry.worker_store()
        self._worker_fn_takes_abort = True
        self._coordinator_addr = ""
        # Driver-hosted per-generation stores.  Old generations are
        # retired, NOT shut down, until job completion: a worker of an old
        # generation may still be leaving its process group, and a store
        # that vanished under it would fail that worker's teardown.
        self._coord_services: List = []
        self._worker_notify_addrs: Dict[int, Tuple[str, int]] = {}
        # (host, local_rank) keys that announced a preemption-grace
        # departure (guard/preempt.py): their exit — any code — is
        # graceful, so no blacklist, no quarantine, no sibling abort
        self._planned_departures: set = set()
        # plan-aware graceful degradation (elastic/degrade.py): when a
        # DegradeController is attached, a world-size change re-resolves
        # the ShardingPlan to the survivors instead of blocking on full
        # capacity, and promotion grows it back when hosts return
        self._degrade = None
        self._create_worker_fn: Optional[Callable] = None
        self._shutdown = threading.Event()
        self._resume_lock = threading.Lock()   # serialize concurrent resumes
        self._hosts_avail = threading.Event()
        self._exit_code: Optional[int] = None
        self._finished = threading.Event()

        self._service = BasicService("elastic_driver", secret_key,
                                     self._handle, host="0.0.0.0")
        self._discovery_thread = threading.Thread(
            target=self._discovery_loop, daemon=True,
            name="hvd_torch_elastic_discovery")

    # -- service plumbing ---------------------------------------------------

    @property
    def registry(self) -> WorkerStateRegistry:
        return self._registry

    @property
    def host_manager(self) -> HostManager:
        return self._host_manager

    @property
    def address(self) -> Tuple[str, int]:
        return self._service.address

    @property
    def generation(self) -> int:
        with self._lock:
            return self._generation

    @property
    def degrade_controller(self):
        return self._degrade

    def set_degrade_controller(self, controller) -> None:
        """Attach a degrade controller (:class:`~horovod_tpu_torch.
        elastic.degrade.DegradeController`; any object with its ``current_plan``,
        ``on_world_change``, ``min_world`` and ``wait_s``): reassignment
        consults it for the plan the surviving world should run,
        ``resume`` waits only for its minimum world (the model extent)
        instead of ``min_np``, and workers receive the current plan with
        their assignment."""
        with self._lock:
            self._degrade = controller

    def _plan_string(self) -> Optional[str]:
        ctl = self._degrade
        return None if ctl is None else ctl.current_plan.to_string()

    @property
    def health_monitor(self) -> HealthMonitor:
        return self._health

    @property
    def generation_history(self) -> List[dict]:
        """Per-generation recovery records (newest last): generation,
        worker count, ``recovery_s`` (assignment → all-READY),
        ``detect_s``/``detect_reason`` when a health-plane verdict
        triggered the generation, ``step_at_detect`` (the pre-failure
        training peak the monitor saw) and best-effort ``steps_lost``
        (peak minus the highest step reported by the new generation at
        ready time; None until a worker reports)."""
        with self._lock:
            return [dict(e) for e in self._generation_history]

    def _handle(self, req):
        if isinstance(req, RegisterWorkerRequest):
            with self._lock:
                self._worker_notify_addrs[req.rank] = tuple(req.address)
            return AckResponse()
        if isinstance(req, HeartbeatRequest):
            self._health.record_heartbeat(req.host, req.local_rank,
                                          getattr(req, "step", -1))
            metrics = getattr(req, "metrics", None)
            if metrics:
                # rank-registry aggregation rides the beat the way the
                # step counter does — no extra RPC (docs/metrics.md)
                self._worker_metrics.update(
                    f"{req.host}:{req.local_rank}", metrics)
            return AckResponse()
        if isinstance(req, WorkerReadyRequest):
            self._registry.record_ready(req.host, req.local_rank)
            self._check_generation_ready()
            return AckResponse()
        if isinstance(req, PlannedDepartureRequest):
            self.announce_departure(req.host, req.local_rank,
                                    step=getattr(req, "step", -1))
            return AckResponse()
        if isinstance(req, GetHealthyPeerRequest):
            # peer repair (guard/repair.py): hand the diverged worker a
            # healthy peer's notification address.  Healthy = currently
            # assigned to a different rank, registered a notification
            # service, not departing; prefer rank 0 (the checkpoint
            # writer — its copy is the recovery reference).
            with self._lock:
                rank_of = {s.rank: k for k, s in self._assignments.items()}
                candidates = []
                for rank in sorted(self._worker_notify_addrs):
                    if rank == req.rank or rank not in rank_of:
                        continue
                    key = rank_of[rank]
                    if key in self._planned_departures:
                        continue
                    candidates.append(
                        (rank, self._worker_notify_addrs[rank]))
            for rank, addr in candidates:
                if not self._health.is_departing(*rank_of[rank]):
                    return PeerAddressResponse(rank=rank,
                                               address=tuple(addr))
            return PeerAddressResponse()
        if isinstance(req, GetRankAndSizeRequest):
            with self._lock:
                slot = self._assignments.get((req.host, req.local_rank))
                if slot is not None and req.generation >= self._generation:
                    # Worker-initiated re-rendezvous: the worker already
                    # has the current generation but needs a newer one —
                    # its collectives failed without anything the driver
                    # can observe (e.g. a cross-rank signature mismatch
                    # raised on every rank at once).  When every assigned
                    # worker asks, regenerate: new generation + fresh
                    # coordinator, same assignments.  This is the
                    # reference's rendezvous-round advance: workers
                    # re-registering IS the signal for a new round.
                    self._regen_requests.add((req.host, req.local_rank))
                    if self._regen_requests >= set(self._assignments):
                        hvd_logging.info(
                            "elastic: all %d workers requested a new "
                            "generation — re-rendezvousing",
                            len(self._assignments))
                        self._update_host_assignments()
                    slot = self._assignments.get((req.host, req.local_rank))
                resp = RankAndSizeResponse(slot, self._coordinator_addr,
                                           self._generation,
                                           plan=self._plan_string())
            if slot is not None:
                # a worker fetching its assignment has a live control loop
                # — the reference records READY at the rendezvous GET
                # (``elastic/rendezvous.py`` → driver.record_ready)
                self._registry.record_ready(req.host, req.local_rank)
                self._check_generation_ready()
            return resp
        raise ValueError(f"unexpected request {type(req).__name__}")

    def _check_generation_ready(self) -> None:
        """Log (once per generation) the assignment→all-READY latency:
        ``recovery_s`` is the operational cost of a world change, the
        quantity the persistent compile cache takes off restarts."""
        from horovod_tpu_torch.elastic.registration import READY, SUCCESS

        # registry state is read OUTSIDE the driver lock: the registry's
        # failure path calls driver.stop() while holding its own lock,
        # so holding ours while taking its would invert the order
        with self._lock:
            if self._generation_ready_logged >= self._generation \
                    or not self._assignments:
                return
            gen = self._generation
            keys = list(self._assignments)
            started = self._generation_started
        if not all(self._registry.get_state(h, lr) in (READY, SUCCESS)
                   for (h, lr) in keys):
            return
        # read the post-recovery training peak BEFORE taking our lock
        # (the monitor has its own lock; keep the acquisition one-way)
        step_now = self._health.max_step()
        with self._lock:
            if gen != self._generation \
                    or self._generation_ready_logged >= gen:
                return      # a newer generation superseded this reading
            self._generation_ready_logged = gen
            # log the local, not the attribute: a ready-check for a newer
            # generation may overwrite last_recovery_s before the log runs
            recovery_s = time.monotonic() - started
            self.last_recovery_s = recovery_s
            detect_s = self.last_detect_s
            detect_reason = self.last_detect_reason
            step_at_detect = self._step_at_detect
            self.last_detect_s = None        # consumed by this generation
            self._step_at_detect = None
            entry = {
                "generation": gen,
                "workers": len(keys),
                "recovery_s": round(recovery_s, 4),
                "detect_s": None if detect_s is None
                else round(detect_s, 4),
                "detect_reason": detect_reason if detect_s is not None
                else None,
                "step_at_detect": step_at_detect,
                "steps_lost": (max(step_at_detect - step_now, 0)
                               if step_at_detect is not None
                               and step_now >= 0 else None),
                # the plan this generation's world runs (None without a
                # degrade controller): ties the recovery record to the
                # shrink/promote transitions in docs/elastic.md
                "plan": self._plan_string(),
            }
            self._generation_history.append(entry)
        # registry mirror of the history entry (generation-labeled so a
        # scraper keeps every generation, not just the last)
        g = str(gen)
        telemetry.counter("hvd_elastic_generations_ready_total",
                          "generations that reached fully-READY").inc()
        telemetry.gauge("hvd_elastic_recovery_seconds",
                        "assignment → all-READY latency").set(
                            recovery_s, generation=g)
        if detect_s is not None:
            telemetry.gauge("hvd_elastic_generation_detect_seconds",
                            "failure-detection latency that triggered "
                            "the generation").set(detect_s, generation=g)
        if entry["steps_lost"] is not None:
            telemetry.gauge("hvd_elastic_generation_steps_lost",
                            "training steps lost across the generation "
                            "change (best effort)").set(
                                entry["steps_lost"], generation=g)
        detect = "" if detect_s is None else f" detect_s={detect_s:.1f}"
        hvd_logging.info(
            "elastic: generation %d fully ready — %d worker(s) in "
            "recovery_s=%.1f%s", gen, len(keys), recovery_s, detect)

    def announce_departure(self, host: str, local_rank: int,
                           step: int = -1) -> None:
        """A planned (preemption-grace or serve-drain) departure: the
        worker has committed (or is committing) its state and will
        exit.  Exempt it from death verdicts now; its exit is handled
        as graceful in :meth:`record_worker_exit` — no blacklist, no
        quarantine, no sibling abort (guard/preempt.py, serve/pool.py).
        """
        self._health.mark_departing(host, local_rank)
        with self._lock:
            self._planned_departures.add((host, local_rank))
        telemetry.counter(
            "hvd_guard_preempt_departures_total",
            "planned (preemption-grace) departures announced").inc()
        hvd_logging.info(
            "elastic: worker %s:%d announced a planned departure at "
            "step %d — exempt from death verdicts and quarantine",
            host, local_rank, step)

    def _on_worker_dead(self, host: str, local_rank: int,
                        detect_s: float, reason: str) -> None:
        """Health-monitor verdict: treat as a failure exit NOW — the
        regeneration starts before the worker process is ever observed
        to exit (it may never exit: a hang holds its chips until the
        abort event kills the tree)."""
        if self._shutdown.is_set():
            return    # completed/stopped job: silence is expected
        if "departure" in reason:
            # the planned-departure grace expired: the worker announced
            # but wedged instead of exiting.  Revoke the graceful-exit
            # exemption so this takes the normal failure path
            with self._lock:
                self._planned_departures.discard((host, local_rank))
        # the pre-failure training peak, for the generation_history
        # steps_lost estimate (monitor lock first, ours second — the
        # same one-way order _check_generation_ready uses)
        step_at_detect = self._health.max_step()
        # the monitor thread calls this; _check_generation_ready reads
        # and consumes last_detect_s under the lock
        with self._lock:
            self.last_detect_s = detect_s
            self.last_detect_reason = reason
            self._step_at_detect = step_at_detect \
                if step_at_detect >= 0 else None
        hvd_logging.warning(
            "elastic: worker %s:%d declared dead (%s) — detect_s=%.2f; "
            "regenerating without waiting for process exit",
            host, local_rank, reason, detect_s)
        self.record_worker_exit(host, local_rank, 1)

    # -- lifecycle ----------------------------------------------------------

    def start(self, np: int, create_worker_fn: Callable) -> None:
        """Wait for ``min(np, …)`` slots, compute assignments, spawn all
        workers (reference ``driver.start``).  ``create_worker_fn`` takes
        ``(slot, coordinator_addr, generation[, abort_event])``; when the
        4th parameter is accepted, the driver sets the event to demand
        the worker process tree be killed (hung startup, de-assignment)."""
        self._create_worker_fn = create_worker_fn
        import inspect

        try:
            nparams = len(inspect.signature(create_worker_fn).parameters)
        except (TypeError, ValueError):
            nparams = 4
        self._worker_fn_takes_abort = nparams >= 4
        self._service.start()
        self._discovery_thread.start()
        self._health.start()
        # wait for the REQUESTED world, not the minimum (reference
        # ``driver.start`` → ``wait_for_available_slots(np)``): with racy
        # discovery (e.g. executor-pool registration) waiting only for
        # min_np starts a world of whichever slots registered first and a
        # fast job can finish before the rest ever join.  But np is a
        # request, not a contract: past the start timeout an elastic
        # cluster that can muster min_np starts small and grows when
        # hosts arrive — failing it outright would defeat elasticity.
        self.wait_for_available_slots(max(np, self._min_np),
                                      fallback_min=self._min_np,
                                      fallback_after=self._start_timeout)
        with self._lock:
            self._update_host_assignments()
        self._spawn_all()

    def stop(self, exit_code: int = 1) -> None:
        # under the lock: stop() runs from resume/discovery threads as
        # well as the main thread, and record_worker_exit's success path
        # writes _exit_code concurrently — first finisher wins, torn
        # writes lose (hvdlint HVD004)
        with self._lock:
            if not self._finished.is_set():
                self._exit_code = exit_code
                self._finished.set()
        self._shutdown.set()
        self._health.stop()
        with self._lock:
            keys = list(self._abort_events)
        self._abort_workers(keys)

    def finished(self) -> bool:
        return self._finished.is_set()

    def wait_for_completion(self) -> int:
        self._finished.wait()
        self._health.stop()
        self._service.shutdown()
        with self._lock:
            services, self._coord_services = self._coord_services, []
        for svc in services:
            svc.shutdown()
        return self._exit_code if self._exit_code is not None else 0

    def wait_for_available_slots(self, min_np: int,
                                 fallback_min: Optional[int] = None,
                                 fallback_after: Optional[float] = None,
                                 deadline_s: Optional[float] = None
                                 ) -> None:
        """Block until discovery supplies ≥ min_np slots (reference
        ``wait_for_available_slots:145``).  With a fallback, accept
        ``fallback_min`` slots once ``fallback_after`` seconds have
        passed — start-small-grow-later elasticity when the requested
        world doesn't fully materialize.  ``deadline_s`` overrides the
        driver timeout (the degrade path's ``HOROVOD_DEGRADE_WAIT_S``
        bound on waiting for a lost model extent to return)."""
        start = time.monotonic()
        deadline = start + (self._timeout if deadline_s is None
                            else deadline_s)
        while not self._shutdown.is_set():
            avail = self._host_manager.available_slots
            if avail >= min_np:
                return
            if fallback_min is not None and fallback_after is not None \
                    and avail >= fallback_min and \
                    time.monotonic() - start > fallback_after:
                hvd_logging.warning(
                    "elastic: only %d of the requested %d slots appeared "
                    "within %.0fs — starting with %d and growing as "
                    "hosts arrive", avail, min_np, fallback_after, avail)
                return
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"timed out waiting for {min_np} slots; discovered "
                    f"{self._host_manager.available_slots}")
            self._hosts_avail.wait(timeout=DISCOVER_INTERVAL_S)
            self._hosts_avail.clear()

    # -- discovery / reassignment ------------------------------------------

    def _discovery_loop(self) -> None:
        while not self._shutdown.is_set():
            try:
                faults.inject("driver.discovery")
                res = self._host_manager.update_available_hosts()
            except Exception as e:
                hvd_logging.warning("elastic: discovery failed: %s", e)
                res = HostUpdateResult.no_update
            if res != HostUpdateResult.no_update:
                hvd_logging.info("elastic: host set changed (res=%d)", res)
                self._hosts_avail.set()
                with self._lock:
                    started = bool(self._assignments)
                if started:
                    # recompute assignments + spawn added workers + notify
                    # survivors; async so discovery keeps feeding
                    # wait_for_available_slots during the resume
                    threading.Thread(target=self.resume, daemon=True).start()
            self._shutdown.wait(DISCOVER_INTERVAL_S)

    def _notify_workers_host_changes(self, res: int) -> None:
        """Ping every registered worker so rank 0's next commit raises
        HostsUpdatedInterrupt (reference ``driver.py:197-225``)."""
        timestamp = int(time.time() * 1e6)
        with self._lock:
            addrs = dict(self._worker_notify_addrs)
            generation = self._generation
        for rank, addr in addrs.items():
            try:
                # the generation the change made: a survivor of a failure
                # has often joined it already when the ping lands, and
                # must not reset again (see WorkerNotificationManager)
                notify_hosts_updated(addr, self._secret_key, timestamp, res,
                                     generation)
            except OSError as e:
                hvd_logging.debug(
                    "elastic: could not notify rank %d at %s: %s",
                    rank, addr, e)

    def _update_host_assignments(self) -> Dict[Tuple[str, int], SlotInfo]:
        """Recompute SlotInfos with ranks stable for surviving workers
        (reference ``_update_host_assignments:227``): hosts keep their
        discovery order, so a surviving (host, local_rank) keeps its rank
        unless an earlier host vanished; at least one previously-assigned
        host must survive to carry the state forward."""
        # every caller already holds self._lock, but the generation swap
        # must be atomic regardless of future call sites — the RLock
        # makes re-acquiring free (hvdlint HVD004)
        with self._lock:
            current = self._host_manager.current_hosts
            prev = self._assignments
            if prev:
                surviving = {h for h, _ in prev} & set(current)
                if not surviving:
                    raise RuntimeError(
                        "elastic: no previously-assigned host survived — "
                        "model state is lost (reference guarantee "
                        "driver.py:236-242)")
            hosts = [HostInfo(h, s) for h, s in current.items()]
            assignments = get_host_assignments(
                hosts, self._min_np,
                self._max_np or sum(h.slots for h in hosts))
            self._assignments = {(s.hostname, s.local_rank): s
                                 for s in assignments}
            if self._degrade is not None:
                # re-resolve the plan to the new world BEFORE workers
                # fetch their assignment: shrink when capacity was
                # lost, promote when it came back (a "wait" verdict
                # leaves the current plan standing — resume() already
                # blocked for at least the model extent)
                self._degrade.on_world_change(len(self._assignments))
            self._registry.purge_unassigned(set(self._assignments))
            self._health.purge(set(self._assignments))
            self._worker_metrics.purge(
                {f"{h}:{lr}" for (h, lr) in self._assignments})
            self._coordinator_addr = self._new_coordinator_addr(assignments)
            self._generation += 1
            self._generation_started = time.monotonic()
            self._regen_requests.clear()
            telemetry.gauge("hvd_elastic_generation",
                            "current elastic world generation").set(
                                self._generation)
            telemetry.gauge("hvd_elastic_world_size",
                            "assigned workers in the current "
                            "generation").set(len(self._assignments))
            telemetry.run_context().advance(generation=self._generation)
            return self._assignments

    def _new_coordinator_addr(self, assignments: List[SlotInfo]) -> str:
        """Fresh coordination service per generation, hosted HERE in the
        driver process (see ``runtime/distributed.py``): a worker death —
        including rank 0's — must not take the coordination plane down,
        the same reason the reference's rendezvous server lives in the
        launcher (``gloo_run.py:213``), never in a worker."""
        from horovod_tpu_torch.runtime import distributed as hvd_dist

        nproc = len(assignments)
        if nproc > 1:   # single-process generations never connect
            heartbeat = int(float(os.environ.get(
                "HOROVOD_ELASTIC_HEARTBEAT_TIMEOUT",
                hvd_dist.DEFAULT_HEARTBEAT_TIMEOUT_S)))
            # the store binds a port of its own choosing: no free port is
            # picked and then taken by another socket before it binds
            service = hvd_dist.start_coordination_service(
                0, nproc, heartbeat_timeout=heartbeat)
            self._coord_services.append(service)
            port = service.port
        else:
            with socket.socket() as sock:
                sock.bind(("", 0))
                port = sock.getsockname()[1]
        host = socket.gethostname()
        if all(s.hostname in ("localhost", "127.0.0.1", host)
               for s in assignments):
            host = "127.0.0.1"
        return f"{host}:{port}"

    # -- worker management --------------------------------------------------

    def _spawn_all(self) -> None:
        with self._lock:
            slots = list(self._assignments.values())
        for slot in slots:
            self._spawn(slot)

    def _spawn(self, slot: SlotInfo) -> None:
        # SPAWNED, not READY: readiness is worker-reported (it arrives via
        # WorkerReadyRequest / the rendezvous GET) so a worker hung in
        # startup is observable — the round-1 design marked workers ready
        # at spawn, making a wedged startup look healthy forever.
        abort = threading.Event()
        key = (slot.hostname, slot.local_rank)
        # token first, SPAWNED second: a stale watchdog firing in between
        # fails its token check; the reverse order would let it see the
        # new worker's SPAWNED state while the token still matches its own
        with self._lock:
            self._abort_events[key] = abort
            token = self._spawn_tokens.get(key, 0) + 1
            self._spawn_tokens[key] = token
        self._registry.record_spawned(slot.hostname, slot.local_rank)
        thread = threading.Thread(
            target=self._run_worker, args=(slot, abort, token), daemon=True,
            name=f"hvd_torch_elastic_worker_{slot.rank}")
        thread.start()
        watchdog = threading.Timer(
            self._start_timeout, self._check_started, args=(slot, token))
        watchdog.daemon = True
        watchdog.start()

    def _check_started(self, slot: SlotInfo, token: int) -> None:
        """Startup watchdog: a worker that never reported READY within the
        start timeout is treated as a startup failure (blacklist + resume),
        the reference's start-timeout semantics
        (``runner/elastic/settings.py`` elastic start timeout).

        ``token`` pins the watchdog to the spawn that armed it: a slot
        removed by scale-down and re-spawned at the same (host,
        local_rank) within start_timeout is again SPAWNED when the stale
        timer fires — without the token it would fail the new worker."""
        from horovod_tpu_torch.elastic.registration import SPAWNED

        if self._shutdown.is_set():
            return
        with self._lock:
            if self._spawn_tokens.get(
                    (slot.hostname, slot.local_rank)) != token:
                return
        if self._registry.get_state(slot.hostname, slot.local_rank) == SPAWNED:
            hvd_logging.warning(
                "elastic: worker %s:%d never reported ready within %.0fs — "
                "treating as startup failure",
                slot.hostname, slot.local_rank, self._start_timeout)
            self.record_worker_exit(slot.hostname, slot.local_rank, 1,
                                    token=token)

    def _run_worker(self, slot: SlotInfo,
                    abort: Optional[threading.Event] = None,
                    token: Optional[int] = None) -> None:
        with self._lock:
            coordinator = self._coordinator_addr
            generation = self._generation
        try:
            if self._worker_fn_takes_abort:
                exit_code = self._create_worker_fn(slot, coordinator,
                                                   generation, abort)
            else:
                exit_code = self._create_worker_fn(slot, coordinator,
                                                   generation)
        except Exception as e:
            hvd_logging.warning("elastic: worker rank %d crashed in "
                                "launcher: %s", slot.rank, e)
            exit_code = 1
        self.record_worker_exit(slot.hostname, slot.local_rank, exit_code,
                                token=token)

    def _abort_workers(self, keys) -> None:
        """Fire abort events so the launcher kills the worker process
        trees (reference: host events passed into create_worker_fn,
        ``driver.py:276-283``) — a hung or de-assigned worker must not
        keep holding its host's chips."""
        with self._lock:
            events = [self._abort_events[k] for k in keys
                      if k in self._abort_events]
        for ev in events:
            ev.set()

    def record_worker_exit(self, host: str, local_rank: int,
                           exit_code: int,
                           token: Optional[int] = None) -> None:
        """Reference ``_handle_worker_exit``: zero → success (job completes
        when every assigned worker succeeded); non-zero → blacklist +
        resume with survivors.  Exits from workers without a current rank
        assignment (scale-down removals, already-blacklisted hosts) are
        ignored (reference ``driver.py:292-296``) — otherwise a gracefully
        removed worker's exit would blacklist its still-healthy host.

        ``token``, when given, pins the exit to the spawn that produced
        it: a slot removed and re-spawned at the same (host, local_rank)
        key can otherwise have the *old* worker's late exit recorded
        against the *new* worker — exit 0 would mark it SUCCESS (and
        could complete the job mid-training), non-zero would blacklist
        its healthy host."""
        with self._lock:
            if token is not None and \
                    self._spawn_tokens.get((host, local_rank)) != token:
                hvd_logging.debug(
                    "elastic: ignoring exit code %d from superseded spawn "
                    "of %s:%d", exit_code, host, local_rank)
                return
            if (host, local_rank) not in self._assignments:
                hvd_logging.debug(
                    "elastic: ignoring exit code %d from unassigned worker "
                    "%s:%d", exit_code, host, local_rank)
                return
            if (host, local_rank) in self._planned_departures:
                # preemption grace: the departure was announced and the
                # state committed — this exit is not a failure (no
                # blacklist, no quarantine, no sibling abort) and not a
                # job-completing success either (the work is unfinished;
                # the host returns to the pool when discovery re-lists it)
                self._planned_departures.discard((host, local_rank))
                hvd_logging.info(
                    "elastic: worker %s:%d exited (code %d) after a "
                    "planned departure — treating as graceful",
                    host, local_rank, exit_code)
                return
        if self._host_manager.is_blacklisted(host):
            # one incident, one reset: the first failure on this host
            # blacklisted it and queued the resume; its sibling workers'
            # exits (aborted, or crashing on the dead host) must not each
            # burn a --reset-limit slot, and a straggler exit 0 from a
            # blacklisted host must not count toward job completion.
            hvd_logging.debug(
                "elastic: ignoring exit code %d from blacklisted host "
                "%s:%d", exit_code, host, local_rank)
            return
        if exit_code == 0:
            self._registry.record_success(host, local_rank)
            with self._lock:
                all_done = all(
                    self._registry.get_state(h, lr) == "SUCCESS"
                    for (h, lr) in self._assignments)
                if all_done and not self._finished.is_set():
                    self._exit_code = 0
                    self._finished.set()
            if all_done:
                self._shutdown.set()
        else:
            # record_failure's check-and-set is atomic: it returns False
            # when the worker is already FAILURE — e.g. the startup
            # watchdog recorded the failure and the aborted process's
            # real exit lands before resume() purges the assignment.  A
            # second count would halve the effective --reset-limit and
            # queue a redundant resume.
            if not self._registry.record_failure(host, local_rank):
                hvd_logging.debug(
                    "elastic: ignoring duplicate failure exit %d from "
                    "%s:%d", exit_code, host, local_rank)
                return
            hvd_logging.warning(
                "elastic: worker %s:%d exited with code %d",
                host, local_rank, exit_code)
            # the whole host is blacklisted: kill its other workers too
            with self._lock:
                siblings = [k for k in self._abort_events if k[0] == host]
            self._abort_workers(siblings)

    def resume(self) -> None:
        """Failure/host-change recovery: recompute assignments, spawn
        workers for newly-added slots, notify survivors (reference
        ``driver.resume``)."""
        if self._shutdown.is_set():
            return
        with self._resume_lock:
            # Unrecoverable-fast-path: the state carrier rule requires a
            # previously-assigned host to survive (reference
            # driver.py:236-242).  If every one of them is blacklisted,
            # no future discovery output can help — stop now instead of
            # waiting out the elastic timeout for slots that cannot
            # carry the state anyway.
            with self._lock:
                prev_hosts = {h for h, _ in self._assignments}
            if prev_hosts and all(self._host_manager.is_blacklisted(h)
                                  for h in prev_hosts):
                hvd_logging.warning(
                    "elastic: every previously-assigned host is "
                    "blacklisted — model state is lost; stopping job")
                self.stop(1)
                return
            try:
                if self._degrade is not None:
                    # degraded continuation: only the model extent is
                    # load-bearing — any world that hosts it can train
                    # (at a shrunk dp/fsdp).  Bound the wait with the
                    # degrade deadline, not the full elastic timeout.
                    self.wait_for_available_slots(
                        max(1, self._degrade.min_world()),
                        deadline_s=self._degrade.wait_s)
                else:
                    self.wait_for_available_slots(self._min_np)
            except TimeoutError as e:
                hvd_logging.warning("elastic: %s", e)
                self.stop(1)
                return
            with self._lock:
                before = set(self._assignments)
                try:
                    self._update_host_assignments()
                except RuntimeError as e:
                    hvd_logging.warning("elastic: %s", e)
                    self.stop(1)
                    return
                added = [s for k, s in self._assignments.items()
                         if k not in before]
                removed = before - set(self._assignments)
            for slot in added:
                self._spawn(slot)
            self._notify_workers_host_changes(HostUpdateResult.mixed)
            # give de-assigned workers a grace window to self-retire via
            # the rendezvous (clean exit 0), then force-kill stragglers.
            # Capture the Event objects NOW: resolving keys at fire time
            # would abort a worker re-spawned at the same (host,
            # local_rank) during the grace window, since _spawn
            # overwrites _abort_events entries.
            if removed:
                with self._lock:
                    stale_events = {k: self._abort_events[k] for k in removed
                                    if k in self._abort_events}

                def _reap():
                    self._shutdown.wait(30.0)
                    for ev in stale_events.values():
                        ev.set()
                    # drop bookkeeping for slots that stayed de-assigned
                    # so host churn doesn't grow these dicts without
                    # bound; a slot re-spawned at the same key in the
                    # grace window has fresh entries (identity differs)
                    # and keeps them
                    with self._lock:
                        for k, ev in stale_events.items():
                            if k not in self._assignments:
                                if self._abort_events.get(k) is ev:
                                    self._abort_events.pop(k, None)
                                    self._spawn_tokens.pop(k, None)

                threading.Thread(target=_reap, daemon=True,
                                 name="hvd_torch_elastic_reaper").start()

    def get_slot_info(self, host: str, local_rank: int) -> Optional[SlotInfo]:
        with self._lock:
            return self._assignments.get((host, local_rank))

    @property
    def world_size(self) -> int:
        with self._lock:
            return len(self._assignments)
