"""Worker lifecycle registry for the elastic driver (a copy of
``horovod_tpu/elastic/registration.py``).

Reference: ``horovod/runner/elastic/registration.py`` —
``WorkerStateRegistry`` collects per-worker READY/SUCCESS/FAILURE
records, acts as the barrier deciding when a generation is complete, and
triggers ``driver.resume()`` when a failure requires re-assignment.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

from horovod_tpu_torch.utils import logging as hvd_logging

SPAWNED = "SPAWNED"   # process launched, worker has not reported in yet
READY = "READY"       # worker-reported: startup done, training loop entered
SUCCESS = "SUCCESS"
FAILURE = "FAILURE"


class WorkerStateRegistry:
    def __init__(self, driver, host_manager, reset_limit: int = 0):
        self._driver = driver
        self._host_manager = host_manager
        self._lock = threading.Lock()
        self._states: Dict[Tuple[str, int], str] = {}
        self._reset_limit = reset_limit      # 0 = unlimited resets
        self._reset_count = 0
        self._failure_count = 0

    @property
    def reset_count(self) -> int:
        return self._reset_count

    @property
    def failure_count(self) -> int:
        """Total FAILURE records this job — the degrade plane's cheap
        capacity-churn signal (a world that keeps failing should stay
        shrunk rather than promote into the same flaky hosts)."""
        with self._lock:
            return self._failure_count

    def get_state(self, host: str, local_rank: int) -> str:
        with self._lock:
            return self._states.get((host, local_rank), "")

    def record_spawned(self, host: str, local_rank: int) -> None:
        """Launcher-side: the process was exec'd; READY comes from the
        worker itself (reference registration.py: READY is reported via
        the rendezvous, not assumed at spawn)."""
        with self._lock:
            self._states.setdefault((host, local_rank), SPAWNED)

    def record_ready(self, host: str, local_rank: int) -> None:
        with self._lock:
            # never regress a terminal state (late READY after FAILURE)
            if self._states.get((host, local_rank)) not in (SUCCESS, FAILURE):
                self._states[(host, local_rank)] = READY

    def record_success(self, host: str, local_rank: int) -> None:
        with self._lock:
            self._states[(host, local_rank)] = SUCCESS

    def record_failure(self, host: str, local_rank: int) -> bool:
        """A worker exited non-zero: exclude its host immediately and
        resume with the survivors (the reference's immediate-blacklist
        rule, ``driver.py:291-307``) — but through the decaying
        quarantine (``discovery.HostQuarantine``), so a flapping host's
        cooldown grows exponentially while a recovered host is
        readmitted on probation without operator action.  Permanent
        exclusion remains available via ``HostManager.blacklist``.

        Returns False (and does nothing) when the worker is already in
        FAILURE — the check-and-set is atomic under the registry lock so
        two concurrent exit records for the same incident (startup
        watchdog + the aborted process's real exit) cannot both
        increment reset_count or queue two resumes."""
        with self._lock:
            if self._states.get((host, local_rank)) == FAILURE:
                return False
            self._states[(host, local_rank)] = FAILURE
            self._failure_count += 1
        self._host_manager.quarantine(host)
        self._maybe_resume()
        return True

    def _maybe_resume(self) -> None:
        # decide under the lock, call the driver OUTSIDE it: stop()
        # takes the driver lock, and the driver calls back into this
        # registry (purge_unassigned) while holding it — calling out
        # with our lock held is the registry->driver half of a
        # driver->registry lock-order inversion, i.e. a deadlock with
        # the resume path (hvdlint HVD004 lock-order graph)
        with self._lock:
            stop = bool(self._reset_limit
                        and self._reset_count >= self._reset_limit)
            if not stop:
                self._reset_count += 1
        if stop:
            hvd_logging.warning(
                "elastic: reset limit %d reached — stopping job",
                self._reset_limit)
            self._driver.stop()
            return
        self._driver.resume()

    def count(self, state: str) -> int:
        with self._lock:
            return sum(1 for s in self._states.values() if s == state)

    def purge_unassigned(self, assigned: set) -> None:
        """Drop states for workers no longer in the assignment set —
        otherwise a host removed and later re-added would inherit its old
        worker's READY/SUCCESS state, blinding the startup watchdog and
        the completion check for the re-spawned worker."""
        with self._lock:
            self._states = {k: v for k, v in self._states.items()
                            if k in assigned}

    def reset(self, expected: int) -> None:
        with self._lock:
            self._states = {}
