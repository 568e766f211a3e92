"""Plan-aware graceful degradation: keep training through capacity loss
by re-resolving the :class:`~horovod_tpu_torch.parallel.plan.ShardingPlan`
to the surviving world (a copy of ``horovod_tpu/elastic/degrade.py``).

When a host or card dies, the elastic driver asks a
:class:`DegradedPlanResolver` for the best plan the survivors can host.
Only the data extents move — ``dp`` shrinks first (replicas are
interchangeable), then ``fsdp`` (re-slices every parameter shard through
``Checkpointer.restore_sharded``); the model-parallel axes
(``pp``/``ep``/``sp``/``tp``) are load-bearing, so a loss that eats into
the model extent yields a **wait** decision with a
``HOROVOD_DEGRADE_WAIT_S`` deadline instead of a broken factorization.
Candidates are scored with :func:`~horovod_tpu_torch.analysis.cost_model.
plan_cost_s`, with per-replica compute scaled by the shrink factor (the
global batch is preserved through gradient accumulation, so fewer
replicas each do proportionally more work).

The :class:`DegradeController` holds the current plan across transitions
and drives the state machine::

    FULL --capacity loss--> (resolve) --feasible--> DEGRADED
      ^                         |
      |                         +--model extent lost--> WAITING
      +--capacity regained (next checkpoint boundary)--+

Attached to the port's elastic driver (``ElasticDriver.
set_degrade_controller``; the elastic launcher attaches one under
``HOROVOD_DEGRADE=1``), it re-resolves the plan whenever the driver
reassigns the world, and every worker of the new generation gets the plan
with its assignment and exports it as ``HOROVOD_PLAN`` (``elastic/
worker.py``), where the step reads it after ``reset``.  The workers then
restore their shards at the new data extent (:func:`reshard_restore`).

Fault sites: ``degrade.resolve`` (the verdict), ``degrade.reshard`` (the
restore), ``elastic.promote`` (the grow-back).

Knobs: ``HOROVOD_DEGRADE`` (:func:`enabled`), ``HOROVOD_DEGRADE_WAIT_S``,
``HOROVOD_DEGRADE_MIN_DATA_EXTENT``, ``HOROVOD_DEGRADE_PROMOTE``.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Callable, List, Optional, Tuple

from horovod_tpu_torch import faults, telemetry
from horovod_tpu_torch.parallel.plan import PlanLike, ShardingPlan, as_plan
from horovod_tpu_torch.utils import logging as hvd_logging

DEFAULT_WAIT_S = 300.0
DEFAULT_MIN_DATA_EXTENT = 1

ENV_DEGRADE = "HOROVOD_DEGRADE"
ENV_WAIT_S = "HOROVOD_DEGRADE_WAIT_S"
ENV_MIN_DATA_EXTENT = "HOROVOD_DEGRADE_MIN_DATA_EXTENT"
ENV_PROMOTE = "HOROVOD_DEGRADE_PROMOTE"

# degradation telemetry (the JAX package's DEGRADE_SERIES names)
_TEL_TRANSITIONS = telemetry.counter(
    "hvd_degrade_transitions_total",
    "plan transitions applied, labeled kind=shrink|promote")
_TEL_WAITS = telemetry.counter(
    "hvd_degrade_waits_total",
    "wait-for-capacity verdicts (model extent did not fit)")
_TEL_ACTIVE = telemetry.gauge(
    "hvd_degrade_active",
    "1 while training below the base plan's device count")
_TEL_DATA_EXTENT = telemetry.gauge(
    "hvd_degrade_data_extent",
    "current dp*fsdp extent (the axis degradation moves)")
_TEL_GRAD_ACCUM = telemetry.gauge(
    "hvd_degrade_grad_accum",
    "gradient-accumulation factor preserving the global batch")
_TEL_TRANSITION_S = telemetry.gauge(
    "hvd_degrade_transition_seconds",
    "wall-clock of the most recent degrade/promote transition")
_TEL_PROMOTED_STEP = telemetry.gauge(
    "hvd_degrade_promoted_step",
    "step at which the plan last grew back toward the base plan")


@dataclasses.dataclass(frozen=True)
class DegradeDecision:
    """One resolver verdict: what the surviving world should run.

    ``action`` is ``keep`` (current plan still fits), ``shrink`` /
    ``promote`` (move to ``plan``), or ``wait`` (the model extent
    itself lost capacity — ``plan`` is None and the caller should
    block up to ``wait_s`` for hosts to return).
    """

    action: str
    plan: Optional[ShardingPlan]
    cost_s: float
    reason: str
    wait_s: float = 0.0

    @property
    def plan_string(self) -> Optional[str]:
        return None if self.plan is None else self.plan.to_string()


def preserve_global_batch(global_batch: int, plan: ShardingPlan,
                          per_replica_batch: int) -> Tuple[int, int]:
    """Gradient-accumulation factor that keeps the optimizer's global
    batch constant across a plan change: ``(grad_accum, achieved)``
    with ``achieved = replicas * per_replica_batch * grad_accum >=
    global_batch`` (rounded up — a degraded world trains on at least
    the configured batch, never a silently smaller one, so the loss
    trajectory stays comparable; docs/elastic.md)."""
    if global_batch < 1 or per_replica_batch < 1:
        raise ValueError(
            f"global_batch and per_replica_batch must be >= 1, got "
            f"{global_batch} and {per_replica_batch}")
    replicas = (plan.dp or 1) * plan.fsdp
    grad_accum = max(1, math.ceil(
        global_batch / (replicas * per_replica_batch)))
    return grad_accum, replicas * per_replica_batch * grad_accum


class DegradedPlanResolver:
    """Enumerate + score the plans a shrunken world can host.

    Pure policy (stdlib + cost model only, no driver state): feasible
    candidates come from :meth:`ShardingPlan.degrade_candidates` (model
    extent fixed, dp shrinks before fsdp); the largest feasible world
    wins, with the cost model (compute stretched by the shrink factor)
    ranking the factorizations of that world.  Deterministic: equal
    costs fall back to the enumeration's preference order.
    """

    def __init__(self, base_plan: PlanLike, n_devices: int,
                 payload_bytes: float = 0.0,
                 n_dcn: int = 1, n_ici: int = 1,
                 compute_s: float = 0.0,
                 min_data_extent: int = DEFAULT_MIN_DATA_EXTENT,
                 wait_s: float = DEFAULT_WAIT_S):
        self.base = as_plan(base_plan).resolve(n_devices)
        self.payload_bytes = float(payload_bytes)
        self.n_dcn = int(n_dcn)
        self.n_ici = int(n_ici)
        self.compute_s = float(compute_s)
        self.min_data_extent = max(1, int(min_data_extent))
        self.wait_s = float(wait_s)

    @classmethod
    def from_env(cls, base_plan: PlanLike, n_devices: int,
                 **kwargs) -> "DegradedPlanResolver":
        kwargs.setdefault("wait_s", float(os.environ.get(
            ENV_WAIT_S, DEFAULT_WAIT_S)))
        kwargs.setdefault("min_data_extent", int(os.environ.get(
            ENV_MIN_DATA_EXTENT, DEFAULT_MIN_DATA_EXTENT)))
        return cls(base_plan, n_devices, **kwargs)

    def min_world(self) -> int:
        """Smallest device count a shrink can land on — below this the
        resolver can only wait."""
        return self.base.model_extent * self.min_data_extent

    def _cost(self, plan: ShardingPlan) -> float:
        from horovod_tpu_torch.analysis import cost_model

        # fewer data replicas each chew through more of the preserved
        # global batch: scale per-replica compute by the shrink factor
        # so the model prefers the largest feasible world
        base_data = (self.base.dp or 1) * self.base.fsdp
        data = (plan.dp or 1) * plan.fsdp
        return cost_model.plan_cost_s(
            plan.to_string(), self.payload_bytes,
            n_dcn=self.n_dcn, n_ici=self.n_ici,
            compute_s=self.compute_s * (base_data / data))

    def candidates(self, n_devices: int) -> List[ShardingPlan]:
        """Feasible plans for ``n_devices``, preference-ordered."""
        return [p for p in self.base.degrade_candidates(n_devices)
                if (p.dp or 1) * p.fsdp >= self.min_data_extent]

    def resolve(self, n_devices: int,
                current: Optional[ShardingPlan] = None
                ) -> DegradeDecision:
        """The best plan for ``n_devices`` surviving devices, relative
        to ``current`` (default: the base plan)."""
        faults.inject("degrade.resolve")
        current = self.base if current is None else current
        cands = self.candidates(n_devices)
        if not cands:
            axes = ", ".join(f"{ax}={getattr(self.base, ax)}"
                             for ax in self.base.model_axes) or "dp=1"
            _TEL_WAITS.inc()
            # ep is stateful in a way tp/sp are not: each ep rank holds
            # DISTINCT expert parameters, so a world below the expert
            # extent has no rank set that can host every expert — name
            # the axis so the operator knows which capacity to restore
            hint = ""
            if self.base.ep > 1:
                hint = (f" (ep={self.base.ep}: the survivors cannot "
                        f"host every expert shard — expert state is "
                        f"only reshardable across the data axes)")
            return DegradeDecision(
                action="wait", plan=None, cost_s=float("inf"),
                reason=(
                    f"{n_devices} surviving device(s) cannot host the "
                    f"load-bearing model extent "
                    f"{self.base.model_extent} ({axes}) at data extent "
                    f">= {self.min_data_extent} — waiting up to "
                    f"{self.wait_s:.0f}s for capacity to return"
                    f"{hint}"),
                wait_s=self.wait_s)
        # largest feasible world first (keeping capacity is never worse
        # — with compute_s=0 the cost model alone would price a
        # 1-replica world as "cheapest" because it has no exchange);
        # plan_cost_s then ranks the factorizations of that world
        # (dp-heavy vs fsdp-heavy splits), and the enumeration's
        # preference order (dp shrinks first) breaks exact cost ties
        scored = sorted(((-p.total, self._cost(p), i, p)
                         for i, p in enumerate(cands)),
                        key=lambda t: t[:3])
        _, cost, _, best = scored[0]
        if best.extents == current.extents:
            return DegradeDecision(
                action="keep", plan=best, cost_s=cost,
                reason=f"plan {best.to_string()} still fits "
                       f"{n_devices} device(s)")
        kind = "shrink" if best.total < current.total else "promote"
        return DegradeDecision(
            action=kind, plan=best, cost_s=cost,
            reason=(
                f"{kind} {current.to_string()} -> {best.to_string()} "
                f"for {n_devices} surviving device(s) "
                f"(cost {cost:.3g}s/step)"))


class DegradeController:
    """The stateful half: current plan, transition history, and the
    batch-preservation arithmetic, driven by the elastic driver (or a
    pure-sim harness — ``clock`` is injectable)."""

    def __init__(self, resolver: DegradedPlanResolver,
                 global_batch: int = 0,
                 per_replica_batch: int = 1,
                 promote: Optional[bool] = None,
                 clock: Callable[[], float] = time.monotonic):
        self._resolver = resolver
        self._current = resolver.base
        self._clock = clock
        self._global_batch = int(global_batch)
        self._per_replica_batch = max(1, int(per_replica_batch))
        if promote is None:
            promote = os.environ.get(ENV_PROMOTE, "1") != "0"
        self._promote = bool(promote)
        self.history: List[dict] = []
        self.promoted_step: Optional[int] = None
        self._publish()

    # -- views --------------------------------------------------------------

    @property
    def base_plan(self) -> ShardingPlan:
        return self._resolver.base

    @property
    def current_plan(self) -> ShardingPlan:
        return self._current

    @property
    def degraded(self) -> bool:
        return self._current.total < self._resolver.base.total

    @property
    def wait_s(self) -> float:
        return self._resolver.wait_s

    def min_world(self) -> int:
        return self._resolver.min_world()

    def grad_accum(self) -> int:
        """Accumulation factor the *current* plan needs to hold the
        configured global batch (1 when no global batch was given)."""
        if self._global_batch < 1:
            return 1
        return preserve_global_batch(
            self._global_batch, self._current, self._per_replica_batch)[0]

    # -- transitions --------------------------------------------------------

    def on_world_change(self, n_devices: int,
                        step: int = -1) -> DegradeDecision:
        """Resolve the new world size and apply the verdict.  Called by
        the driver under reassignment; ``keep``/``wait`` are no-ops on
        controller state (a wait leaves the current plan in place for
        the capacity that may return)."""
        decision = self._resolver.resolve(n_devices,
                                          current=self._current)
        if decision.action == "promote":
            faults.inject("elastic.promote")
            if not self._promote:
                return DegradeDecision(
                    action="keep", plan=self._current,
                    cost_s=decision.cost_s,
                    reason=f"{ENV_PROMOTE}=0 pins the degraded plan "
                           f"{self._current.to_string()}")
        if decision.action in ("shrink", "promote"):
            self._apply(decision, step)
        elif decision.action == "wait":
            hvd_logging.warning("degrade: %s", decision.reason)
        return decision

    def _apply(self, decision: DegradeDecision, step: int) -> None:
        t0 = self._clock()
        prev = self._current
        self._current = decision.plan
        transition_s = max(0.0, self._clock() - t0)
        entry = {
            "kind": decision.action,
            "from_plan": prev.to_string(),
            "to_plan": decision.plan.to_string(),
            "step": step,
            "cost_s": decision.cost_s,
            "grad_accum": self.grad_accum(),
            "transition_s": transition_s,
        }
        self.history.append(entry)
        if decision.action == "promote":
            self.promoted_step = step
            _TEL_PROMOTED_STEP.set(max(step, 0))
        _TEL_TRANSITIONS.inc(kind=decision.action)
        _TEL_TRANSITION_S.set(transition_s)
        self._publish()
        hvd_logging.warning(
            "degrade: %s %s -> %s at step %d (grad_accum=%d): %s",
            decision.action, entry["from_plan"], entry["to_plan"],
            step, entry["grad_accum"], decision.reason)

    def record_transition_s(self, seconds: float) -> None:
        """Stamp the measured wall-clock of the full drain->commit->
        reshard->ready transition over the bookkeeping-only default."""
        if self.history:
            self.history[-1]["transition_s"] = float(seconds)
        _TEL_TRANSITION_S.set(float(seconds))

    def _publish(self) -> None:
        _TEL_ACTIVE.set(1.0 if self.degraded else 0.0)
        _TEL_DATA_EXTENT.set((self._current.dp or 1) * self._current.fsdp)
        _TEL_GRAD_ACCUM.set(self.grad_accum())


def reshard_restore(checkpointer, target, shard_rank: int,
                    plan: ShardingPlan, step: Optional[int] = None):
    """The degrade transition's restore leg: re-slice the sharded
    checkpoint (error-feedback residuals included — they live in the
    sharded optimizer state) to ``plan``'s data extent, through the
    port's ``Checkpointer.restore_sharded``.  Chaos site ``degrade.reshard`` fires
    before any shard is read, so a fault plan can kill the transition
    at its most fragile point (docs/faults.md)."""
    faults.inject("degrade.reshard")
    shard_count = (plan.dp or 1) * plan.fsdp
    return checkpointer.restore_sharded(
        target, shard_rank, shard_count, step=step,
        plan=plan.to_string())


def enabled() -> bool:
    """True when ``HOROVOD_DEGRADE=1`` opts the job into plan-aware
    degradation (off by default: shrinking the world is a policy
    decision, not a safe universal default)."""
    return os.environ.get(ENV_DEGRADE, "0") == "1"
