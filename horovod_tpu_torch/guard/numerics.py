"""Numerics guardian: NaN/Inf and grad-norm-spike detection (a copy of
``horovod_tpu/guard/numerics.py``).

The step half lives in ``DistributedTrainStep`` (``guard=`` kwarg): when
a guard is attached, the step reads the guardian's current spike *limit*,
computes the global gradient norm on the device once the exchange has
finished, reads it on the host, and runs the optimizer's update only when
the norm is finite and within the limit.  The JAX step decides inside its
compiled program; the port's eager step must know the verdict before the
update, so a poisoned update is never applied and the state it would
have changed (parameters, moments, step counters, error-feedback
residuals) stays as it was.

This module is the host half: :class:`NumericsGuardian` keeps an EMA
baseline of the *log* gradient norm (mean and variance), hands the step
its current limit (``exp(mean + zscore·std)``; ``inf`` during warmup),
and turns each observed norm into a verdict + policy reaction:

``skip_step``
    the step skipped the update and kept the old state — count it and move
    on (the reference world's "skip this batch" loss-scaling idiom);
``rollback``
    raise :class:`GuardRollback` so the training loop restores the
    last-good checkpoint and replays (docs/guardian.md);
``abort``
    raise :class:`GuardAbort` — stop the run, preserving the anomaly
    for a human.

Everything here is plain host float math: zero device traffic beyond
the one scalar the step reads.
"""

from __future__ import annotations

import math
from typing import Optional

from horovod_tpu_torch import telemetry

POLICIES = ("skip_step", "rollback", "abort")

# variance floor on the log-norm scale: a perfectly flat norm history
# must not make the limit collapse onto the mean (z·0.05 ≈ a 35% head
# room at the default z=6 — far below any real spike, far above noise)
_MIN_LOG_STD = 0.05
_LOG_EPS = 1e-30

_TEL_ANOMALIES = telemetry.counter(
    "hvd_guard_anomalies_total",
    "guardian anomaly verdicts by kind (nonfinite|spike|divergence)")
_TEL_SKIPPED = telemetry.counter(
    "hvd_guard_skipped_steps_total",
    "optimizer steps suppressed by the guarded step")
_TEL_GNORM = telemetry.gauge(
    "hvd_guard_grad_norm", "most recent guarded global gradient norm")


class GuardAnomaly(Exception):
    """Base of the guardian's policy exceptions."""

    def __init__(self, kind: str, step: Optional[int] = None,
                 detail: str = ""):
        msg = f"guard anomaly: {kind}"
        if step is not None:
            msg += f" at step {step}"
        if detail:
            msg += f" ({detail})"
        super().__init__(msg)
        self.kind = kind
        self.step = step
        self.detail = detail


class GuardRollback(GuardAnomaly):
    """Policy ``rollback``: restore the last-good checkpoint in place
    and replay — the catcher calls :meth:`TrainingGuard.rollback`."""


class GuardAbort(GuardAnomaly):
    """Policy ``abort``: stop the run, state preserved for diagnosis."""


class NumericsGuardian:
    """EMA z-score spike detector over the log gradient norm."""

    def __init__(self, policy: str = "rollback", zscore: float = 6.0,
                 warmup_steps: int = 10, ema: float = 0.99):
        if policy not in POLICIES:
            raise ValueError(f"guard policy must be one of {POLICIES}, "
                             f"got {policy!r}")
        if not 0.0 < ema < 1.0:
            raise ValueError(f"guard ema must be in (0, 1), got {ema}")
        self.policy = policy
        self.zscore = float(zscore)
        self.warmup_steps = max(int(warmup_steps), 1)
        self.ema = float(ema)
        # EMA of log-norm mean and second moment, with the usual
        # (1 - ema^n) bias correction so early estimates aren't pulled
        # toward the zero init
        self._m1 = 0.0
        self._m2 = 0.0
        self._n = 0
        self.last_verdict: Optional[str] = None
        self.last_gnorm: Optional[float] = None
        self.anomalies = 0

    @property
    def observed_steps(self) -> int:
        return self._n

    def _stats(self):
        corr = 1.0 - self.ema ** self._n
        mean = self._m1 / corr
        var = max(self._m2 / corr - mean * mean, 0.0)
        return mean, max(math.sqrt(var), _MIN_LOG_STD)

    def current_limit(self) -> float:
        """The spike threshold for the NEXT step — ``inf`` while the
        baseline warms up (nonfinite detection is always armed: the
        step checks ``isfinite`` regardless of the limit)."""
        if self._n < self.warmup_steps:
            return math.inf
        mean, std = self._stats()
        return math.exp(mean + self.zscore * std)

    def observe(self, gnorm: float,
                limit: Optional[float] = None) -> str:
        """Record one step's gradient norm against the limit the step
        actually ran with; returns the verdict and applies the policy
        (may raise :class:`GuardRollback` / :class:`GuardAbort`)."""
        if limit is None:
            limit = self.current_limit()
        self.last_gnorm = gnorm
        if telemetry.enabled() and math.isfinite(gnorm):
            _TEL_GNORM.set(gnorm)
        if not math.isfinite(gnorm):
            verdict = "nonfinite"
        elif gnorm > limit:
            verdict = "spike"
        else:
            verdict = "ok"
        self.last_verdict = verdict
        if verdict == "ok":
            # baseline updates on clean steps only: an anomaly must not
            # poison the statistics it is judged against
            ln = math.log(max(gnorm, _LOG_EPS))
            self._m1 = self.ema * self._m1 + (1.0 - self.ema) * ln
            self._m2 = self.ema * self._m2 + (1.0 - self.ema) * ln * ln
            self._n += 1
            return verdict
        self.anomalies += 1
        _TEL_ANOMALIES.inc(kind=verdict)
        if self.policy == "abort":
            raise GuardAbort(verdict, detail=f"grad_norm={gnorm!r}")
        if self.policy == "rollback":
            raise GuardRollback(verdict, detail=f"grad_norm={gnorm!r}")
        _TEL_SKIPPED.inc()    # skip_step: the step skipped the update
        return verdict
