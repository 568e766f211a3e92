"""HBM-budgeted plan search: the fastest *feasible* config (a copy of
``horovod_tpu/memory/planner.py``).

The plan-space autotuner picks the fastest (plan, schedule) point;
nothing guaranteed the winner *fits*.  This module closes that gap: :func:`search_memory_plans` walks the
(plan × remat policy × microbatch × offload) grid, prices each point
with the cost model's speed (:func:`~horovod_tpu_torch.analysis.cost_model.
plan_cost_s` stretched by the policy's recompute overhead) and memory
(:func:`~horovod_tpu_torch.analysis.cost_model.plan_memory_bytes`) twins,
and returns the fastest point whose predicted high-water fits the
``HOROVOD_HBM_BUDGET_BYTES`` budget.

Pure and deterministic — stdlib + the stdlib-only cost model, no
torch, no clock, no randomness: the same inputs produce the same
candidate bit-for-bit (ties break on the candidate tuple itself).  The
budget is ``budget_bytes``, else ``HOROVOD_HBM_BUDGET_BYTES``, else the
resolved hardware model's ``hbm_capacity_bytes`` (the JAX function
reads no knob: its callers pass the budget).  When *nothing* fits,
:class:`InfeasibleError` names the tightest axis — the dominant
component of the closest candidate — so the operator knows which knob
(model shards, optimizer offload, remat, microbatches) actually moves
the wall.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Sequence, Union

from horovod_tpu_torch.analysis import cost_model as CM

#: Fractional step-time penalty charged to an offloaded optimizer
#: stream — the share of the D2H/H2D transfer the double buffer fails
#: to hide under compute.  Under the honest roofline
#: (``cost_model.OFFLOAD_RESIDENT_FRACTION`` = 1.0: the engine
#: restores the full shard before the step, so streaming buys no
#: step-window high-water) an offload=True point is strictly
#: dominated — same memory, this penalty slower — and the search
#: never returns one.  The axis stays in the grid for callers that
#: force ``offload=(True,)`` (host parking for reasons other than the
#: step high-water) and for a future bucketed engine whose residency
#: fraction drops below 1.  A winner with ``offload_optimizer=True``
#: only streams if the caller also sets HOROVOD_OFFLOAD_OPTIMIZER=1
#: and wires a :class:`~horovod_tpu_torch.memory.offload.HostOffloadEngine`
#: into the loop — the plan does not enable the engine by itself.
OFFLOAD_STEP_PENALTY = 0.02

#: Default microbatch grid — powers of two up to the bench pipeline
#: probe's depth (``cost_model.PLAN_SCORE_MICROBATCHES``).
DEFAULT_MICROBATCHES = (1, 2, 4, 8)

#: Default policy grid: the non-offload remat tiers.  ``offload``
#: enters through the ``offload`` axis (optimizer-state streaming),
#: not the activation tier — activation offload needs a backend with
#: pinned-host space, which the pure-sim planner must not assume.
DEFAULT_REMAT_POLICIES = ("none", "dots", "full")


class InfeasibleError(ValueError):
    """No point of the search grid fits the budget.

    ``tightest_axis`` names the dominant memory component of the
    *closest* candidate (smallest predicted total) — the axis more
    budget, or a knob outside the searched grid, must address.
    """

    def __init__(self, message: str, tightest_axis: str,
                 closest: Optional["MemoryCandidate"] = None):
        super().__init__(message)
        self.tightest_axis = tightest_axis
        self.closest = closest


@dataclasses.dataclass(frozen=True)
class MemoryCandidate:
    """One scored point of the (plan × remat × microbatch × offload)
    grid."""

    plan: str
    remat_policy: str
    microbatches: int
    offload_optimizer: bool
    predicted_bytes: CM.MemoryBytes
    predicted_step_s: float

    @property
    def total_bytes(self) -> float:
        return self.predicted_bytes.total

    def summary(self) -> str:
        # an offload=on winner is only real once the caller enables the
        # streaming engine — say so wherever the candidate is printed
        off = "on [needs HOROVOD_OFFLOAD_OPTIMIZER=1]" \
            if self.offload_optimizer else "off"
        return (f"plan={self.plan} remat={self.remat_policy} "
                f"microbatches={self.microbatches} "
                f"offload={off} "
                f"-> {self.total_bytes / 1e9:.3f} GB, "
                f"{self.predicted_step_s * 1e3:.3f} ms/step")


def env_budget_bytes() -> Optional[float]:
    """``HOROVOD_HBM_BUDGET_BYTES`` as a float, or None when unset."""
    raw = os.environ.get("HOROVOD_HBM_BUDGET_BYTES")
    return float(raw) if raw not in (None, "") else None


def _plan_string(plan) -> str:
    if isinstance(plan, str):
        return plan
    if isinstance(plan, dict):
        ext = CM.parse_plan(plan)
        return ",".join(f"{k}={v}" for k, v in ext.items() if v > 1) \
            or "dp=1"
    to_string = getattr(plan, "to_string", None)
    if callable(to_string):        # parallel.plan.ShardingPlan
        return to_string()
    raise TypeError(f"plan must be a grammar string, extent dict or "
                    f"ShardingPlan, got {type(plan).__name__}")


def search_memory_plans(plans: Sequence[Union[str, Dict]], *,
                        param_bytes: float,
                        activation_bytes: float,
                        budget_bytes: Optional[float] = None,
                        hw: Optional[CM.HardwareModel] = None,
                        remat_policies: Sequence[str]
                        = DEFAULT_REMAT_POLICIES,
                        microbatches: Sequence[int]
                        = DEFAULT_MICROBATCHES,
                        offload: Sequence[bool] = (False, True),
                        optimizer_slots: int = 2,
                        shard_optimizer_states: bool = False,
                        exchange_bucket_bytes: Optional[float] = None,
                        compute_s: float = 0.0,
                        n_dcn: int = 1,
                        n_ici: int = 1
                        ) -> MemoryCandidate:
    """The fastest candidate whose predicted high-water fits.

    Speed: :func:`~horovod_tpu_torch.analysis.cost_model.plan_cost_s`
    (compute stretched by the pipeline bubble + serial exchange wire)
    × (1 + the policy's recompute overhead) × (1 +
    :data:`OFFLOAD_STEP_PENALTY` when streaming).  Memory:
    :func:`~horovod_tpu_torch.analysis.cost_model.plan_memory_bytes`.
    Gradients are the exchange payload, so ``param_bytes`` prices the
    wire too.

    Deterministic: candidates are scored in the caller's grid order
    and ties break on ``(step_s, plan, policy, microbatches,
    offload)`` — two runs over the same grid return the same object.
    Raises :class:`InfeasibleError` (naming the tightest axis) when
    nothing fits, and ``ValueError`` on an empty grid.

    A returned candidate with ``offload_optimizer=True`` describes a
    config that *assumes* optimizer-state streaming: applying it
    requires HOROVOD_OFFLOAD_OPTIMIZER=1 plus a
    :class:`~horovod_tpu_torch.memory.offload.HostOffloadEngine` in the
    training loop (``summary()`` flags this).  The search itself never
    flips that knob.
    """
    if not plans:
        raise ValueError("search_memory_plans needs at least one plan")
    if hw is None:
        # calibration artifact > preset knob > the card's preset > h100
        hw = CM.resolve_hardware_model()
    if budget_bytes is None:
        budget_bytes = env_budget_bytes()
    scored = []
    for plan in plans:
        ps = _plan_string(plan)
        for policy in remat_policies:
            for m in microbatches:
                for off in offload:
                    mem = CM.plan_memory_bytes(
                        ps, param_bytes=param_bytes,
                        activation_bytes=activation_bytes,
                        remat_policy=policy, microbatches=m,
                        optimizer_slots=optimizer_slots,
                        shard_optimizer_states=shard_optimizer_states,
                        offload_optimizer=off,
                        exchange_bucket_bytes=exchange_bucket_bytes)
                    step_s = CM.plan_cost_s(
                        ps, param_bytes, n_dcn=n_dcn, n_ici=n_ici,
                        compute_s=compute_s, microbatches=m, hw=hw)
                    step_s *= 1.0 + CM.REMAT_RECOMPUTE_OVERHEAD[policy]
                    if off:
                        step_s *= 1.0 + OFFLOAD_STEP_PENALTY
                    scored.append(MemoryCandidate(
                        plan=ps, remat_policy=policy, microbatches=int(m),
                        offload_optimizer=bool(off), predicted_bytes=mem,
                        predicted_step_s=step_s))
    feasible = [c for c in scored
                if CM.plan_fits(c.predicted_bytes, budget_bytes, hw)]
    key = lambda c: (c.predicted_step_s, c.plan, c.remat_policy,  # noqa: E731
                     c.microbatches, c.offload_optimizer)
    if feasible:
        return min(feasible, key=key)
    closest = min(scored, key=lambda c: (c.total_bytes,) + key(c))
    cap = budget_bytes if budget_bytes is not None \
        else hw.hbm_capacity_bytes
    axis = closest.predicted_bytes.tightest
    raise InfeasibleError(
        f"no (plan x remat x microbatch x offload) point fits the "
        f"{float(cap) / 1e9:.3f} GB budget: the closest candidate "
        f"({closest.summary()}) is dominated by its {axis} component "
        f"— tightest axis: {axis}", tightest_axis=axis, closest=closest)
