"""Multi-tenant admission: per-model queues behind weighted-fair
scheduling with SLO-classed overload shedding (a copy of
``horovod_tpu/serve/tenancy.py``, docs/serving.md).

One serving fleet hosts many models.  Each tenant model gets its own
:class:`~horovod_tpu_torch.serve.queue.AdmissionQueue` (so one tenant's
backlog cannot consume another's admission budget) and the
:class:`MultiTenantQueue` arbitrates *which* model's queue the batcher
drains next with smooth weighted round-robin — the deterministic
weighted-fair discipline with a provable starvation bound: among
backlogged tenants with total weight ``W``, a tenant of weight ``w``
is picked at least once in any window of ``ceil(W / w)`` consecutive
picks, and its long-run share of picks converges to ``w / W``
(pinned by test).

**SLO classes** map deadline tiers to shed priority under overload:

============  ==============  =========  =================================
class         deadline        shed tier  overload behavior
              budget (s)
============  ==============  =========  =================================
interactive   0.25            0          never overload-shed (only
                                         ``shed_full`` / ``shed_deadline``)
standard      2.0             1          shed when the fleet fill factor
                                         reaches midway between the
                                         overload watermark and full
batch         0 (none)        2          shed first, at the overload
                                         watermark itself
============  ==============  =========  =================================

The watermark is ``HOROVOD_SERVE_OVERLOAD_FRACTION`` (default 0.75) of
the fleet's total queue capacity; a class's deadline budget is applied
at submit when the request carries no deadline of its own, so the
tier→deadline mapping and the tier→shed-priority mapping stay one
table.  Overload sheds are *tenant-layer* verdicts
(``queue.SHED_OVERLOAD``, counted on ``hvd_serve_tenant_shed_total``)
— the per-model queue's own verdict vocabulary is untouched.

Seeded estimates: :meth:`MultiTenantQueue.add_model` seeds the
per-model queue's EWMA batch-service estimate from the cost model's
``plan_cost_s`` for the model's plan, so the *first* wave of
deadline-tiered requests is judged against a real estimate instead of
the unseeded zero that admitted guaranteed-late work until the first
batch completed.

:class:`FleetBatcher` is the engine loop over all of it: weighted-fair
pick → per-model executable hot-swap (``ExecutableCache`` keyed
``(model_id, signature, bucket)``) → atomic weight flip *between*
batches via the :class:`~horovod_tpu_torch.serve.refresh.WeightRefresher`,
with the weights buffer + fingerprint snapshotted once per batch so a
refresh can never produce a mixed-weights batch.

Fault site ``serve.tenant`` fires on every weighted-fair pick — a
``hang``/``raise`` there models a wedged arbiter (docs/faults.md).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from horovod_tpu_torch import faults, telemetry
from horovod_tpu_torch.runtime.config import _env_float
from horovod_tpu_torch.serve.batcher import _TEL_OCCUPANCY, ContinuousBatcher
from horovod_tpu_torch.serve.pool import ReplicaPool
from horovod_tpu_torch.serve.queue import (
    ADMITTED,
    SHED_OVERLOAD,
    AdmissionQueue,
)
from horovod_tpu_torch.serve.request import InferenceRequest, InferenceResponse

DEFAULT_OVERLOAD_FRACTION = 0.75

_TEL_TENANT_ADMITTED = telemetry.counter(
    "hvd_serve_tenant_admitted_total",
    "requests admitted per tenant model (model=)")
_TEL_TENANT_SHED = telemetry.counter(
    "hvd_serve_tenant_shed_total",
    "tenant-layer sheds (model=, reason=shed_overload|unknown_model)")
_TEL_TENANT_PICKS = telemetry.counter(
    "hvd_serve_tenant_picks_total",
    "weighted-fair scheduler picks per tenant model (model=)")
_TEL_TENANT_SHARE = telemetry.gauge(
    "hvd_serve_tenant_share",
    "observed fraction of scheduler picks per tenant model (model=)")


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """One deadline tier: the default deadline budget applied at
    submit and the shed priority under overload (higher tier sheds
    earlier; tier 0 is never overload-shed)."""

    name: str
    deadline_budget_s: float
    shed_tier: int


#: the closed class table (module docstring) — tier 0 must stay the
#: strictest deadline AND the last to shed, or overload would starve
#: exactly the traffic the fleet exists to protect
SLO_CLASSES: Dict[str, SLOClass] = {
    "interactive": SLOClass("interactive", 0.25, 0),
    "standard": SLOClass("standard", 2.0, 1),
    "batch": SLOClass("batch", 0.0, 2),
}
_MAX_TIER = max(c.shed_tier for c in SLO_CLASSES.values())


@dataclasses.dataclass
class TenantSpec:
    """One tenant model's registration: scheduling weight, SLO class,
    and its per-model admission queue."""

    model_id: str
    weight: float
    slo: SLOClass
    queue: AdmissionQueue


class MultiTenantQueue:
    """Per-model admission queues behind a smooth weighted round-robin
    arbiter (module docstring).

    Implements the same ``submit`` / ``take`` / ``complete`` /
    ``requeue`` / ``__len__`` surface as a single
    :class:`AdmissionQueue`, so :class:`~horovod_tpu_torch.serve.pool.
    ReplicaPool` plugs in unchanged — a dead replica's lease requeues
    into each request's *owning* model queue, preserving the
    exactly-once transition rule per model.
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 overload_fraction: Optional[float] = None):
        self._clock = clock
        self.overload_fraction = overload_fraction \
            if overload_fraction is not None \
            else _env_float("HOROVOD_SERVE_OVERLOAD_FRACTION",
                            DEFAULT_OVERLOAD_FRACTION)
        self._lock = threading.Lock()
        self._tenants: Dict[str, TenantSpec] = {}
        self._order: List[str] = []              # registration order
        self._current: Dict[str, float] = {}     # SWRR running credit
        self._owner: Dict[str, str] = {}         # request_id -> model
        self.pick_counts: Dict[str, int] = {}
        self._total_picks = 0

    # -- registration -------------------------------------------------------

    def add_model(self, model_id: str, weight: float = 1.0,
                  slo_class: str = "standard",
                  plan: Optional[Any] = None,
                  payload_bytes: float = 0.0,
                  depth: Optional[int] = None,
                  max_requeues: Optional[int] = None) -> TenantSpec:
        """Register a tenant model.  ``plan`` + ``payload_bytes`` seed
        the model queue's EWMA service estimate from the cost model
        (``plan_cost_s``) so first-wave deadline verdicts are real."""
        if weight <= 0:
            raise ValueError(f"tenant {model_id!r}: weight must be > 0")
        slo = SLO_CLASSES.get(slo_class)
        if slo is None:
            raise ValueError(
                f"tenant {model_id!r}: unknown SLO class {slo_class!r} "
                f"(have {sorted(SLO_CLASSES)})")
        est = None
        if plan is not None:
            from horovod_tpu_torch.analysis.cost_model import plan_cost_s

            est = plan_cost_s(plan, payload_bytes)
        spec = TenantSpec(
            model_id=model_id, weight=float(weight), slo=slo,
            queue=AdmissionQueue(depth=depth, max_requeues=max_requeues,
                                 clock=self._clock, service_est_s=est))
        with self._lock:
            if model_id in self._tenants:
                raise ValueError(f"tenant {model_id!r} already registered")
            self._tenants[model_id] = spec
            self._order.append(model_id)
            self._current[model_id] = 0.0
            self.pick_counts[model_id] = 0
        return spec

    def models(self) -> List[str]:
        with self._lock:
            return list(self._order)

    def queue_for(self, model_id: str) -> AdmissionQueue:
        with self._lock:
            return self._tenants[model_id].queue

    # -- admission ----------------------------------------------------------

    def _overload_threshold(self, tier: int) -> Optional[float]:
        """Fill factor at which ``tier`` sheds; None = never.  Higher
        tiers shed at the watermark, lower ones progressively closer
        to full, tier 0 never (module docstring table)."""
        if tier <= 0:
            return None
        f = self.overload_fraction
        return f + (1.0 - f) * (_MAX_TIER - tier) / _MAX_TIER

    def fill_factor(self) -> float:
        """Total queued work over total queue capacity, 0..1."""
        with self._lock:
            specs = list(self._tenants.values())
        cap = sum(s.queue.depth for s in specs)
        if not cap:
            return 0.0
        return sum(len(s.queue) for s in specs) / cap

    def submit(self, req: InferenceRequest) -> str:
        """Route one request to its model's queue; apply the SLO
        class's deadline budget when the request has none, and the
        class's overload shed priority when the fleet is past its
        watermark."""
        with self._lock:
            spec = self._tenants.get(req.model_id)
        if spec is None:
            _TEL_TENANT_SHED.inc(model=req.model_id or "?",
                                 reason="unknown_model")
            return SHED_OVERLOAD
        if req.deadline_s == 0 and spec.slo.deadline_budget_s > 0:
            req.deadline_s = self._clock() + spec.slo.deadline_budget_s
        threshold = self._overload_threshold(spec.slo.shed_tier)
        if threshold is not None and self.fill_factor() >= threshold:
            _TEL_TENANT_SHED.inc(model=req.model_id,
                                 reason=SHED_OVERLOAD)
            return SHED_OVERLOAD
        verdict = spec.queue.submit(req)
        if verdict == ADMITTED:
            with self._lock:
                self._owner[req.request_id] = req.model_id
            _TEL_TENANT_ADMITTED.inc(model=req.model_id)
        return verdict

    def stop_admitting(self) -> None:
        with self._lock:
            specs = list(self._tenants.values())
        for spec in specs:
            spec.queue.stop_admitting()

    # -- weighted-fair dequeue ----------------------------------------------

    def take_model(self, max_n: int
                   ) -> Tuple[Optional[str], List[InferenceRequest]]:
        """One smooth-weighted-round-robin pick over backlogged
        tenants, then lease up to ``max_n`` batch-compatible requests
        from the winner's queue.  Returns ``(None, [])`` when every
        queue is empty.  Deterministic: credits are pure arithmetic
        over the registration order, ties break on registration order.
        """
        faults.inject("serve.tenant")
        with self._lock:
            eligible = [m for m in self._order
                        if len(self._tenants[m].queue)]
            if not eligible:
                return None, []
            total_w = sum(self._tenants[m].weight for m in eligible)
            for m in eligible:
                self._current[m] += self._tenants[m].weight
            winner = max(eligible, key=lambda m: self._current[m])
            # max() keeps the first maximum → registration-order ties
            self._current[winner] -= total_w
            self.pick_counts[winner] += 1
            self._total_picks += 1
            picks = dict(self.pick_counts)
            total = self._total_picks
            queue = self._tenants[winner].queue
        _TEL_TENANT_PICKS.inc(model=winner)
        for m, n in picks.items():
            _TEL_TENANT_SHARE.set(n / total, model=m)
        return winner, queue.take(max_n)

    def take(self, max_n: int, signature=None) -> List[InferenceRequest]:
        """Single-queue compatibility shim (ReplicaPool never calls
        this, but code written against AdmissionQueue may)."""
        _, batch = self.take_model(max_n)
        return batch

    # -- completion / requeue (exactly-once, per owning model) --------------

    def complete(self, request_ids) -> None:
        groups: Dict[str, List[str]] = {}
        with self._lock:
            for rid in request_ids:
                owner = self._owner.get(rid)
                if owner is not None:
                    groups.setdefault(owner, []).append(rid)
            specs = {m: self._tenants[m] for m in groups}
        for m, rids in groups.items():
            specs[m].queue.complete(rids)

    def requeue(self, reqs) -> int:
        groups: Dict[str, List[InferenceRequest]] = {}
        with self._lock:
            for req in reqs:
                owner = self._owner.get(req.request_id, req.model_id)
                if owner in self._tenants:
                    groups.setdefault(owner, []).append(req)
            specs = {m: self._tenants[m] for m in groups}
        return sum(specs[m].queue.requeue(rs)
                   for m, rs in groups.items())

    def note_service_time(self, service_s: float,
                          model_id: Optional[str] = None) -> None:
        """Feed one observed batch service time back to the owning
        model's admission EWMA (all models when ``model_id`` is None —
        the single-queue shim path)."""
        with self._lock:
            specs = [self._tenants[model_id]] if model_id is not None \
                and model_id in self._tenants \
                else list(self._tenants.values())
        for spec in specs:
            spec.queue.note_service_time(service_s)

    # -- introspection ------------------------------------------------------

    def state_of(self, request_id: str) -> Optional[str]:
        with self._lock:
            owner = self._owner.get(request_id)
            spec = self._tenants.get(owner) if owner else None
        return spec.queue.state_of(request_id) if spec else None

    def __len__(self) -> int:
        with self._lock:
            specs = list(self._tenants.values())
        return sum(len(s.queue) for s in specs)

    @property
    def admitting(self) -> bool:
        with self._lock:
            specs = list(self._tenants.values())
        return any(s.queue.admitting for s in specs)


class FleetBatcher(ContinuousBatcher):
    """Engine loop for the fleet: weighted-fair pick → executable
    hot-swap per leased batch → atomic weight flip between batches.

    The weights buffer and its fingerprint are snapshotted ONCE before
    the batch executes; every request in the batch runs against that
    snapshot and every response carries its fingerprint — a refresh
    landing mid-batch waits for the next :meth:`step` (no mixed-weights
    batch, in-flight work completes on the old weights).
    """

    def __init__(self, queue: MultiTenantQueue, pool: ReplicaPool,
                 refresher=None, **kwargs):
        super().__init__(queue, pool, **kwargs)
        self._refresher = refresher

    def step(self) -> List[InferenceResponse]:
        faults.inject("serve.feed")
        replica = self._pool.pick()
        if replica is None:
            return []
        model_id, batch = self._queue.take_model(self.max_batch)
        if not batch:
            return []
        weights = weights_fp = None
        if self._refresher is not None:
            # flips land HERE, strictly between batches
            self._refresher.maybe_flip(model_id)
            weights, weights_fp = self._refresher.active(model_id)
        _TEL_OCCUPANCY.observe(float(len(batch)))
        t0 = self._clock()
        responses = self._pool.execute(
            replica, batch, model_id=model_id, weights=weights,
            weights_fp=weights_fp)
        if responses:
            self._queue.note_service_time(
                max(self._clock() - t0, 0.0), model_id)
            if self._on_response is not None:
                for resp in responses:
                    self._on_response(resp)
        return responses
