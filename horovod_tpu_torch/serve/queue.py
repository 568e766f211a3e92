"""Bounded admission queue for the serving plane (a copy of
``horovod_tpu/serve/queue.py``, docs/serving.md).

Overload policy is decided at the *front door*, not by collapse: the
queue holds at most ``HOROVOD_SERVE_QUEUE_DEPTH`` requests and sheds
instead of growing — a full queue rejects with backpressure
(``shed_full``), and a request whose deadline cannot be met even if it
ran *right now* (less than the EWMA service-time estimate of budget
left) is shed at admission (``shed_deadline``) rather than queued to
time out after consuming a batch slot.  Requests that expire while
queued are shed at dequeue for the same reason.

Exactly-once bookkeeping: every admitted id carries a state —
``queued`` → ``inflight`` (leased to a replica by :meth:`take`) →
``done`` (:meth:`complete`).  :meth:`requeue` re-admits **only** ids
currently ``inflight``; a second requeue attempt for the same lease, a
resubmission of a live id, or a requeue after completion is a no-op.
That single transition rule is what makes "a replica died mid-batch"
re-execute each in-flight request exactly once (docs/serving.md walks
the proof obligations).

Every mutation is lock-guarded: the continuous batcher's feeder thread
calls :meth:`take`/:meth:`complete` while client threads call
:meth:`submit` (HVD004 discipline).  ``clock`` is injectable so the
seeded scenarios run on a logical clock.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional

from horovod_tpu_torch import telemetry
from horovod_tpu_torch.runtime.config import _env_int
from horovod_tpu_torch.serve.request import DONE, INFLIGHT, QUEUED, \
    InferenceRequest

DEFAULT_QUEUE_DEPTH = 256
DEFAULT_MAX_REQUEUES = 3

#: admission verdicts (the ``reason`` label on ``hvd_serve_shed_total``)
ADMITTED = "admitted"
SHED_FULL = "shed_full"
SHED_DEADLINE = "shed_deadline"
SHED_DUPLICATE = "shed_duplicate"
SHED_REQUEUE_BUDGET = "shed_requeue_budget"
#: emitted by the tenancy layer (serve/tenancy.py), not this queue: a
#: sheddable SLO class rejected while the fleet is past its overload
#: watermark — counted on ``hvd_serve_tenant_shed_total``
SHED_OVERLOAD = "shed_overload"

_TEL_DEPTH = telemetry.gauge(
    "hvd_serve_queue_depth", "requests waiting for a batch slot")
_TEL_ADMITTED = telemetry.counter(
    "hvd_serve_admitted_total", "requests admitted past the front door")
_TEL_SHED = telemetry.counter(
    "hvd_serve_shed_total",
    "requests shed (reason=shed_full|shed_deadline|shed_duplicate|"
    "shed_requeue_budget)")
_TEL_REQUEUED = telemetry.counter(
    "hvd_serve_requeued_total",
    "in-flight requests re-enqueued after a replica death")
_TEL_COMPLETED = telemetry.counter(
    "hvd_serve_completed_total", "requests completed with a response")


class AdmissionQueue:
    """Bounded FIFO with deadline-aware shedding and exactly-once
    requeue semantics (module docstring)."""

    def __init__(self, depth: Optional[int] = None,
                 max_requeues: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic,
                 service_est_s: Optional[float] = None):
        self.depth = depth if depth is not None \
            else _env_int("HOROVOD_SERVE_QUEUE_DEPTH", DEFAULT_QUEUE_DEPTH)
        self.max_requeues = max_requeues if max_requeues is not None \
            else _env_int("HOROVOD_SERVE_MAX_REQUEUES",
                          DEFAULT_MAX_REQUEUES)
        self._clock = clock
        self._lock = threading.Lock()
        self._queue: collections.deque = collections.deque()
        self._state: Dict[str, str] = {}
        # EWMA of observed batch service time — the admission
        # controller's "could this run in time if it ran right now"
        # estimate; fed back by the batcher after every batch.  Seed it
        # (``service_est_s``, typically the cost model's plan_cost_s
        # for the model's plan — serve/tenancy.py does) so the FIRST
        # wave of deadline-tiered requests is judged against a real
        # estimate instead of the unseeded zero that admitted
        # guaranteed-late work until the first batch completed.
        self._service_est_s = float(service_est_s or 0.0)
        self._admitting = True

    # -- admission ----------------------------------------------------------

    def submit(self, req: InferenceRequest) -> str:
        """Admit or shed one request; returns the verdict string."""
        now = self._clock()
        with self._lock:
            if not self._admitting:
                return self._shed_locked(SHED_FULL)
            if req.request_id in self._state and \
                    self._state[req.request_id] != DONE:
                # a live id resubmitted (client retry racing its own
                # response) must not yield two responses
                return self._shed_locked(SHED_DUPLICATE)
            if req.deadline_s > 0 and \
                    req.deadline_s - now < self._service_est_s:
                return self._shed_locked(SHED_DEADLINE)
            if len(self._queue) >= self.depth:
                return self._shed_locked(SHED_FULL)
            if not req.arrival_s:
                req.arrival_s = now
            self._queue.append(req)
            self._state[req.request_id] = QUEUED
            _TEL_ADMITTED.inc()
            _TEL_DEPTH.set(len(self._queue))
            return ADMITTED

    def stop_admitting(self) -> None:
        """Drain mode for the whole plane: every subsequent submit is
        shed with backpressure; queued/in-flight work still completes."""
        with self._lock:
            self._admitting = False

    def _shed_locked(self, reason: str) -> str:
        _TEL_SHED.inc(reason=reason)
        return reason

    # -- dequeue / completion ----------------------------------------------

    def take(self, max_n: int, signature=None) -> List[InferenceRequest]:
        """Lease up to ``max_n`` batch-compatible requests (the head's
        signature, or ``signature`` when given); expired-deadline
        requests are shed in passing.  Leased ids go ``inflight``."""
        now = self._clock()
        out: List[InferenceRequest] = []
        with self._lock:
            skipped: List[InferenceRequest] = []
            while self._queue and len(out) < max_n:
                req = self._queue.popleft()
                if req.deadline_s > 0 and now >= req.deadline_s:
                    self._state[req.request_id] = DONE
                    self._shed_locked(SHED_DEADLINE)
                    continue
                if signature is None:
                    signature = req.signature
                if req.signature != signature:
                    skipped.append(req)
                    continue
                self._state[req.request_id] = INFLIGHT
                out.append(req)
            # incompatible signatures return to the head in order
            self._queue.extendleft(reversed(skipped))
            _TEL_DEPTH.set(len(self._queue))
        return out

    def complete(self, request_ids: Iterable[str]) -> None:
        """Mark responded ids ``done`` — after this a requeue of the
        same lease is a no-op (the exactly-once edge)."""
        with self._lock:
            n = 0
            for rid in request_ids:
                if self._state.get(rid) == INFLIGHT:
                    self._state[rid] = DONE
                    n += 1
            if n:
                _TEL_COMPLETED.inc(n)

    def requeue(self, reqs: Iterable[InferenceRequest]) -> int:
        """Re-enqueue a dead replica's leased requests — exactly once
        per lease: only ids currently ``inflight`` re-admit (front of
        the queue, preserving age order); ids past their requeue budget
        are shed instead.  Returns how many re-admitted."""
        with self._lock:
            readmitted: List[InferenceRequest] = []
            for req in reqs:
                if self._state.get(req.request_id) != INFLIGHT:
                    continue
                req.requeues += 1
                if req.requeues > self.max_requeues:
                    self._state[req.request_id] = DONE
                    self._shed_locked(SHED_REQUEUE_BUDGET)
                    continue
                self._state[req.request_id] = QUEUED
                readmitted.append(req)
            self._queue.extendleft(reversed(readmitted))
            if readmitted:
                _TEL_REQUEUED.inc(len(readmitted))
            _TEL_DEPTH.set(len(self._queue))
            return len(readmitted)

    # -- introspection ------------------------------------------------------

    def note_service_time(self, service_s: float) -> None:
        """Batcher feedback: fold one observed batch service time into
        the admission controller's EWMA estimate."""
        with self._lock:
            self._service_est_s = service_s if not self._service_est_s \
                else 0.8 * self._service_est_s + 0.2 * service_s

    @property
    def service_estimate_s(self) -> float:
        """Current EWMA batch-service estimate (seeded or observed)."""
        with self._lock:
            return self._service_est_s

    def __len__(self) -> int:
        with self._lock:
            return len(self._queue)

    @property
    def admitting(self) -> bool:
        with self._lock:
            return self._admitting

    def state_of(self, request_id: str) -> Optional[str]:
        with self._lock:
            return self._state.get(request_id)
