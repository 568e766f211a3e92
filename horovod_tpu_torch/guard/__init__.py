"""hvdguard: the training-state integrity plane (a copy of
``horovod_tpu/guard``, docs/guardian.md).

The elastic runtime recovers from failures that announce themselves —
dead processes, missed heartbeats, raised exceptions.  This package
covers the failures that don't:

**numerics guardian** (:mod:`~horovod_tpu_torch.guard.numerics`)
    per-step NaN/Inf + grad-norm-spike detection, enforced by the step
    (``DistributedTrainStep(guard=...)``): the global gradient norm is
    computed on the device once the exchange has finished and read before
    the update, so a poisoned update is never applied; policy:
    ``skip_step`` | ``rollback`` | ``abort``.

**replica-consistency checksums** (:mod:`~horovod_tpu_torch.guard.checksum`)
    every ``HOROVOD_GUARD_CHECK_INTERVAL`` steps, a per-rank parameter
    fingerprint (summed on the card for a card's tensors) and a majority
    vote across the data-parallel ranks — silent data corruption
    detected and *attributed* to a rank.

**rollback-and-replay** (:mod:`~horovod_tpu_torch.guard.rollback`)
    in-place restore of the pinned last-*verified* checkpoint of a
    :class:`~horovod_tpu_torch.elastic.TorchState` (no elastic generation
    bump), dataset rewound to the exact global sample, replay
    bit-identical to a fault-free run; a diverged-but-alive worker
    instead repairs from a healthy peer over RPC
    (:mod:`~horovod_tpu_torch.guard.repair`).

**preemption grace** (:mod:`~horovod_tpu_torch.guard.preempt`)
    SIGTERM → drain the in-flight step → priority checkpoint commit →
    planned-departure notice, so the driver skips quarantine and the
    HealthMonitor never counts the departure as a death.

Everything is opt-in behind ``HOROVOD_GUARD_*`` knobs and free when off:
the module-level :func:`check` hook is a single ``None`` test (same
contract as ``faults.inject``).  All signals flow through the telemetry
registry as ``hvd_guard_*`` series.

Typical wiring::

    state = hvd.elastic.TorchState(model, adamw, checkpointer=ckpt,
                                   checkpoint_every=2)
    guard = hvd.guard.TrainingGuard.from_config(
        cfg, state=state, gather_fn=hvd.guard.dist_gather_fn())
    step = hvd.DistributedTrainStep(loss_fn, opt, guard=guard)
    ...
    try:
        model, opt, loss = step(model, opt, batch)
        state.commit(); guard.note_commit()
        guard.check_replicas(state._commit_count, model.state_dict())
    except hvd.guard.GuardRollback:
        replayed = guard.rollback()
        # the model and optimizer are restored in place; rewind the
        # dataset and replay
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

from horovod_tpu_torch import faults
from horovod_tpu_torch.guard.checksum import (
    DivergenceReport,
    ReplicaChecker,
    compare,
    dist_gather_fn,
    fingerprint,
)
from horovod_tpu_torch.guard.numerics import (
    _TEL_ANOMALIES,
    POLICIES,
    GuardAbort,
    GuardAnomaly,
    GuardRollback,
    NumericsGuardian,
)
from horovod_tpu_torch.guard.preempt import PreemptionHandler
from horovod_tpu_torch.guard.repair import repair_from_peer
from horovod_tpu_torch.guard.rollback import RollbackManager

__all__ = [
    "DivergenceReport",
    "GuardAbort",
    "GuardAnomaly",
    "GuardRollback",
    "NumericsGuardian",
    "POLICIES",
    "PreemptionHandler",
    "ReplicaChecker",
    "RollbackManager",
    "TrainingGuard",
    "active_guard",
    "check",
    "clear_guard",
    "compare",
    "dist_gather_fn",
    "fingerprint",
    "repair_from_peer",
    "set_guard",
]


class TrainingGuard:
    """Composes the numerics guardian, the replica checker and (when a
    :class:`~horovod_tpu_torch.elastic.TorchState` is wired) the rollback
    manager into the one object the training loop talks to."""

    def __init__(self, policy: str = "rollback", check_interval: int = 10,
                 zscore: float = 6.0, warmup_steps: int = 10,
                 ema: float = 0.99,
                 gather_fn: Optional[Callable[[int], List[int]]] = None,
                 rollback: Optional[RollbackManager] = None):
        self.numerics = NumericsGuardian(policy=policy, zscore=zscore,
                                         warmup_steps=warmup_steps, ema=ema)
        self.checker = ReplicaChecker(check_interval, gather_fn)
        self.rollback_mgr = rollback

    @classmethod
    def from_config(cls, cfg: Any, gather_fn=None, state: Any = None,
                    dataset_state_fn=None) -> Optional["TrainingGuard"]:
        """Build from a :class:`runtime.config.Config`; returns None when
        ``HOROVOD_GUARD`` is off.  Passing ``state`` (a TorchState with a
        checkpointer) arms rollback-and-replay."""
        if not getattr(cfg, "guard_enabled", False):
            return None
        rb = None
        if state is not None:
            rb = RollbackManager(state, dataset_state_fn=dataset_state_fn)
        return cls(policy=cfg.guard_policy,
                   check_interval=cfg.guard_check_interval,
                   zscore=cfg.guard_zscore,
                   warmup_steps=cfg.guard_warmup_steps,
                   ema=cfg.guard_ema, gather_fn=gather_fn, rollback=rb)

    @property
    def policy(self) -> str:
        return self.numerics.policy

    # -- numerics guardian (DistributedTrainStep talks to these) -------

    def current_limit(self) -> float:
        return self.numerics.current_limit()

    def observe(self, gnorm: float, limit: Optional[float] = None) -> str:
        return self.numerics.observe(gnorm, limit=limit)

    # -- replica consistency -------------------------------------------

    def check_replicas(self, step: int, params: Any) -> Any:
        """Run the guard's chaos sites and, when the cadence is due, a
        replica-consistency vote.  Returns ``params`` (replaced by the
        ``corrupt`` action's perturbed copy when a chaos plan fires —
        the SDC injection point).  Raises :class:`GuardRollback` /
        :class:`GuardAbort` on a divergence verdict; divergence cannot
        be skipped — a diverged replica never rejoins by itself."""
        faults.inject("guard.check")
        corrupted = faults.inject("guard.params", value=params)
        if corrupted is not None:
            params = corrupted
        if self.checker.due(step):
            report = self.checker.check(step, params)
            if report is not None:
                _TEL_ANOMALIES.inc(kind="divergence")
                detail = f"rank {report.rank} diverged " \
                         f"(vote {report.fingerprints})"
                if self.policy == "abort":
                    raise GuardAbort("divergence", step=step, detail=detail)
                raise GuardRollback("divergence", step=step, detail=detail)
            if self.rollback_mgr is not None:
                self.rollback_mgr.note_verified(step)
        return params

    # -- rollback plumbing ---------------------------------------------

    def note_commit(self) -> None:
        if self.rollback_mgr is not None:
            self.rollback_mgr.note_commit()

    def rollback(self, reason: str = "anomaly") -> int:
        if self.rollback_mgr is None:
            raise RuntimeError("no RollbackManager wired — construct the "
                               "guard with rollback= or from_config(state=)")
        return self.rollback_mgr.rollback(reason=reason)


# -- module-level hook (mirrors faults.inject's zero-cost contract) ----

_active: Optional[TrainingGuard] = None


def set_guard(guard: Optional[TrainingGuard]) -> Optional[TrainingGuard]:
    """Install the process-wide guard (None to disarm); returns it."""
    global _active
    _active = guard
    return guard


def clear_guard() -> None:
    set_guard(None)


def active_guard() -> Optional[TrainingGuard]:
    return _active


def check(step: int, params: Any = None) -> Any:
    """Hot-loop hook: no-op (one global ``None`` test — pinned < 5µs)
    until :func:`set_guard` arms it, then
    :meth:`TrainingGuard.check_replicas`."""
    if _active is None:
        return None
    return _active.check_replicas(step, params)
