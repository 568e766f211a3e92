"""Declarative parallelism plans (``horovod_tpu/parallel/plan.py``).

A :class:`ShardingPlan` names the parallel degree of every mesh axis
(``dp``/``pp``/``fsdp``/``ep``/``sp``/``tp``, the
:data:`~horovod_tpu_torch.parallel.mesh.AXIS_ORDER` axes) plus the
interleaved-1F1B virtual-stage count, parsed from the ``HOROVOD_PLAN``
grammar::

    HOROVOD_PLAN="dp=2,sp=2"          # 2-way data x 2-way sequence
    HOROVOD_PLAN="sp=4"               # dp absorbs what is left (here 1)

The port copies the parts that :class:`~horovod_tpu_torch.optim.train_step.
DistributedTrainStep` calls: the grammar, :meth:`resolve` against the
world size, the canonical :meth:`to_string`, the data and model axes, and
:func:`as_plan`, which the sharded checkpoint's plan stamp reads.  Standard
library only.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

#: mesh axes, outermost first (``parallel/mesh.AXIS_ORDER`` by value)
PLAN_AXES = ("dp", "pp", "fsdp", "ep", "sp", "tp")

#: grammar keys: the six mesh axes plus ``v`` (virtual pipeline stages)
PLAN_KEYS = PLAN_AXES + ("v",)


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """One parallelism plan: per-axis extents and the pipeline schedule.
    ``dp=None`` absorbs whatever rank count the other axes leave over,
    resolved by :meth:`resolve`."""

    dp: Optional[int] = None
    pp: int = 1
    fsdp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1
    virtual_stages: int = 1

    def __post_init__(self):
        for ax in PLAN_AXES:
            v = getattr(self, ax)
            if ax == "dp" and v is None:
                continue
            if not isinstance(v, int) or v < 1:
                raise ValueError(
                    f"plan axis {ax} must be a positive int, got {v!r}")
        if not isinstance(self.virtual_stages, int) \
                or self.virtual_stages < 1:
            raise ValueError(
                f"virtual_stages must be a positive int, got "
                f"{self.virtual_stages!r}")
        if self.virtual_stages > 1 and self.pp == 1:
            raise ValueError(
                f"v={self.virtual_stages} needs a pipeline axis: "
                f"virtual stages interleave over pp ranks, but pp=1")

    @classmethod
    def from_string(cls, text: str) -> "ShardingPlan":
        """Parse the ``HOROVOD_PLAN`` grammar: comma-separated
        ``axis=extent`` pairs, axes from :data:`PLAN_KEYS`."""
        if not isinstance(text, str) or not text.strip():
            raise ValueError(
                "empty plan: expected comma-separated axis=extent "
                f"pairs over {', '.join(PLAN_KEYS)} "
                f"(e.g. \"dp=4,tp=2\")")
        seen: Dict[str, int] = {}
        for item in text.split(","):
            item = item.strip()
            if not item:
                continue
            key, sep, val = item.partition("=")
            key = key.strip()
            if not sep or key not in PLAN_KEYS:
                raise ValueError(
                    f"bad plan term {item!r}: expected axis=extent "
                    f"with axis in {', '.join(PLAN_KEYS)}")
            if key in seen:
                raise ValueError(f"duplicate plan axis {key!r} in "
                                 f"{text!r}")
            try:
                extent = int(val.strip())
            except ValueError:
                raise ValueError(
                    f"bad plan extent {val.strip()!r} for axis "
                    f"{key!r}: expected a positive int") from None
            seen[key] = extent
        kwargs = {("virtual_stages" if k == "v" else k): v
                  for k, v in seen.items()}
        return cls(**kwargs)

    def resolve(self, n_devices: int) -> "ShardingPlan":
        """Concrete plan for ``n_devices`` ranks: infer ``dp`` when unset,
        verify the factorization covers the rank count exactly."""
        fixed = self.pp * self.fsdp * self.ep * self.sp * self.tp
        dp = self.dp
        if dp is None:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"cannot infer dp: {n_devices} devices not "
                    f"divisible by pp*fsdp*ep*sp*tp={fixed}")
            dp = n_devices // fixed
        if dp * fixed != n_devices:
            raise ValueError(
                f"plan {self.to_string(allow_unresolved=True)} covers "
                f"{dp * fixed} devices, not {n_devices}")
        return dataclasses.replace(self, dp=dp)

    def to_string(self, allow_unresolved: bool = False) -> str:
        """Canonical plan string: ``dp`` always, other axes only at extent
        > 1, in :data:`PLAN_AXES` order."""
        if self.dp is None and not allow_unresolved:
            raise ValueError(
                "plan has dp=None (unresolved): call resolve(n_devices) "
                "before using the canonical string")
        parts = [f"dp={'?' if self.dp is None else self.dp}"]
        parts += [f"{ax}={getattr(self, ax)}" for ax in PLAN_AXES[1:]
                  if getattr(self, ax) > 1]
        if self.virtual_stages > 1:
            parts.append(f"v={self.virtual_stages}")
        return ",".join(parts)

    @property
    def data_axes(self) -> Tuple[str, ...]:
        """Axes the gradient exchange and the batch's rows ride: dp/fsdp at
        extent > 1, or plain ``("dp",)``."""
        axes = tuple(ax for ax in ("dp", "fsdp")
                     if (getattr(self, ax) or 1) > 1)
        return axes or ("dp",)

    @property
    def model_axes(self) -> Tuple[str, ...]:
        """Model-parallel axes at extent > 1 (pp/ep/sp/tp); ``sp`` shards
        activations, not parameters, but a running job cannot change it."""
        return tuple(ax for ax in ("pp", "ep", "sp", "tp")
                     if getattr(self, ax) > 1)


def as_plan(plan) -> Optional[ShardingPlan]:
    """Coerce a plan argument: a grammar string parses, a
    :class:`ShardingPlan` passes through, None stays None."""
    if plan is None or isinstance(plan, ShardingPlan):
        return plan
    if isinstance(plan, str):
        return ShardingPlan.from_string(plan)
    raise TypeError(
        f"plan must be a ShardingPlan or a HOROVOD_PLAN string, got "
        f"{type(plan).__name__}")
