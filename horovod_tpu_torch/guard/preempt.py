"""Preemption grace: turn SIGTERM into a planned, stateless departure (a
copy of ``horovod_tpu/guard/preempt.py``).

Cloud reservations of cards get reclaimed; the host gets SIGTERM and a short
grace window.  Without handling, the elastic driver sees the same thing
it sees for a crash — a missed heartbeat, then a death verdict, then
host blacklist and quarantine — and the cluster loses capacity it will
get back in minutes.  :class:`PreemptionHandler` converts the signal
into three ordered moves inside the grace window:

1. **drain** — the training loop polls :attr:`draining` and finishes
   the in-flight step instead of being killed mid-allreduce;
2. **commit** — a priority checkpoint commit that bypasses
   ``checkpoint_every`` (``commit_fn``, typically
   ``TorchState.priority_commit``), so zero steps are lost;
3. **notify** — a :class:`PlannedDepartureRequest` to the driver
   (``notify_fn``, typically ``elastic.worker.announce_departure``), which marks the worker departing: the
   HealthMonitor stops counting it toward death verdicts and
   ``record_worker_exit`` skips blacklist/quarantine entirely.

The signal handler itself only sets an event — every heavy action runs
on the training thread via :meth:`finalize`, keeping the handler
async-signal-safe.
"""

from __future__ import annotations

import logging
import signal
import threading
from typing import Any, Callable, Optional

from horovod_tpu_torch import faults, telemetry

logger = logging.getLogger("horovod_tpu_torch.guard")

_TEL_DRAINS = telemetry.counter(
    "hvd_guard_preempt_drains_total",
    "preemption drains completed (commit + departure notice)")


class PreemptionHandler:
    """SIGTERM → drain → priority commit → planned-departure notice."""

    def __init__(self, commit_fn: Callable[[], Any],
                 notify_fn: Optional[Callable[[], Any]] = None,
                 signum: int = signal.SIGTERM):
        self._commit_fn = commit_fn
        self._notify_fn = notify_fn
        self._signum = signum
        self._event = threading.Event()
        self._prev_handler = None
        self._installed = False
        self.finalized = False

    def install(self) -> "PreemptionHandler":
        """Install the signal handler (main thread only, per the signal
        module's contract); returns self for chaining."""
        self._prev_handler = signal.signal(self._signum, self._on_signal)
        self._installed = True
        return self

    def uninstall(self) -> None:
        if self._installed:
            signal.signal(self._signum, self._prev_handler or signal.SIG_DFL)
            self._installed = False

    def _on_signal(self, signum, frame) -> None:
        # async-signal-safe: set the flag, do nothing else
        self._event.set()

    def request(self) -> None:
        """Programmatic preemption (tests, cloud-metadata watchers)."""
        self._event.set()

    @property
    def draining(self) -> bool:
        """True once preemption was requested — the loop should finish
        the in-flight step and call :meth:`finalize`."""
        return self._event.is_set()

    def finalize(self) -> bool:
        """Run the grace sequence (idempotent): priority commit, then
        the planned-departure notice.  Returns True if it ran."""
        if not self._event.is_set() or self.finalized:
            return False
        self.finalized = True
        faults.inject("worker.preempt")
        logger.info("preemption drain: committing priority checkpoint")
        self._commit_fn()
        if self._notify_fn is not None:
            try:
                self._notify_fn()
            except Exception:
                # the departure notice is best-effort: a dead driver
                # must not stop the checkpoint from landing
                logger.warning("planned-departure notice failed",
                               exc_info=True)
        _TEL_DRAINS.inc()
        return True
