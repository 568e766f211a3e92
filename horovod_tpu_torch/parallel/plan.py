"""Declarative parallelism plans (``horovod_tpu/parallel/plan.py``).

A :class:`ShardingPlan` names the parallel degree of every mesh axis
(``dp``/``pp``/``fsdp``/``ep``/``sp``/``tp``, the
:data:`~horovod_tpu_torch.parallel.mesh.AXIS_ORDER` axes) plus the
interleaved-1F1B virtual-stage count, parsed from the ``HOROVOD_PLAN``
grammar::

    HOROVOD_PLAN="dp=2,sp=2"          # 2-way data x 2-way sequence
    HOROVOD_PLAN="sp=4"               # dp absorbs what is left (here 1)

The port copies the whole module: the grammar and :meth:`from_env`,
:meth:`resolve` against the world size, the canonical :meth:`to_string`,
the extents and the data and model axes, :meth:`degrade_candidates`,
:meth:`build_mesh` (the port's
:class:`~horovod_tpu_torch.parallel.mesh.ParallelMesh`, whose groups are
made collectively), :meth:`matches_mesh`, :func:`candidate_plans` and
:func:`as_plan`, which the sharded checkpoint's plan stamp reads.  Every
error is the JAX module's, word for word.  Standard library only
(``parallel/mesh`` is imported inside :meth:`build_mesh`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple, Union

#: mesh axes, outermost first (``parallel/mesh.AXIS_ORDER`` by value)
PLAN_AXES = ("dp", "pp", "fsdp", "ep", "sp", "tp")

#: grammar keys: the six mesh axes plus ``v`` (virtual pipeline stages)
PLAN_KEYS = PLAN_AXES + ("v",)

ENV_PLAN = "HOROVOD_PLAN"


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

    @classmethod
    def from_env(cls) -> Optional["ShardingPlan"]:
        """The ``HOROVOD_PLAN`` plan, or None when the knob is unset."""
        text = os.environ.get(ENV_PLAN)
        return cls.from_string(text) if text else None

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
    def total(self) -> int:
        """Rank count the plan covers (requires a resolved ``dp``)."""
        if self.dp is None:
            raise ValueError("plan has dp=None: call resolve(n_devices)")
        return self.dp * self.pp * self.fsdp * self.ep * self.sp * self.tp

    @property
    def extents(self) -> Dict[str, int]:
        """Axis → extent in :data:`PLAN_AXES` order (dp may be None)."""
        return {ax: getattr(self, ax) for ax in PLAN_AXES}

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

    @property
    def model_extent(self) -> int:
        """Product of the model-parallel extents, which a degrade
        transition must never change."""
        return self.pp * self.ep * self.sp * self.tp

    def degrade_candidates(self, n_devices: int
                           ) -> Tuple["ShardingPlan", ...]:
        """Feasible plans for ``n_devices`` surviving ranks, keeping every
        model-parallel extent (and the pipeline schedule) fixed: only
        ``dp' <= dp`` and ``fsdp' <= fsdp`` move, with ``dp' * fsdp' *
        model_extent <= n_devices``.  Best first: the largest surviving
        world, and among equal worlds the plan that shrinks ``dp`` (replicas
        are interchangeable) before one that shrinks ``fsdp`` (which
        re-slices every parameter shard).  Empty when even ``dp=1,fsdp=1``
        does not fit."""
        if self.dp is None:
            raise ValueError(
                "plan has dp=None (unresolved): call resolve(n_devices) "
                "before enumerating degrade candidates")
        model = self.model_extent
        out = []
        for dp in range(1, self.dp + 1):
            for fsdp in range(1, self.fsdp + 1):
                if dp * fsdp * model <= int(n_devices):
                    out.append(dataclasses.replace(self, dp=dp,
                                                   fsdp=fsdp))
        out.sort(key=lambda p: (-p.total, self.fsdp - p.fsdp,
                                self.dp - p.dp))
        return tuple(out)

    def build_mesh(self):
        """Lay the plan out over the ``hvd.init()`` world as a
        :class:`~horovod_tpu_torch.parallel.mesh.ParallelMesh`
        (:func:`~horovod_tpu_torch.parallel.mesh.make_parallel_mesh`:
        tp fastest-varying).  Collective: every rank calls it with the same
        plan."""
        from horovod_tpu_torch.parallel.mesh import make_parallel_mesh

        return make_parallel_mesh(dp=self.dp, pp=self.pp, fsdp=self.fsdp,
                                  ep=self.ep, sp=self.sp, tp=self.tp)

    def matches_mesh(self, mesh) -> bool:
        """True when ``mesh`` carries exactly this plan's factorization
        (every plan axis present at the plan's extent)."""
        shape = dict(mesh.shape)
        return all(shape.get(ax) == getattr(self, ax)
                   for ax in PLAN_AXES)


def candidate_plans(n_devices: int,
                    axes: Tuple[str, ...] = ("dp", "fsdp", "tp")
                    ) -> Tuple[ShardingPlan, ...]:
    """Every exact factorization of ``n_devices`` over ``axes``, dp-heaviest
    first, then lexicographic on the remaining extents.  ``axes`` must be
    plan axes; ``n_devices`` must be >= 1."""
    n = int(n_devices)
    if n < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    for ax in axes:
        if ax not in PLAN_AXES:
            raise ValueError(
                f"unknown plan axis {ax!r}: expected one of "
                f"{', '.join(PLAN_AXES)}")
    out = []

    def factor(remaining: int, idx: int, extents: Dict[str, int]):
        if idx == len(axes) - 1:
            out.append(ShardingPlan(**{**extents, axes[idx]: remaining}))
            return
        d = 1
        while d <= remaining:
            if remaining % d == 0:
                factor(remaining // d, idx + 1,
                       {**extents, axes[idx]: d})
            d += 1

    factor(n, 0, {})
    out.sort(key=lambda p: tuple(-getattr(p, ax) if ax == "dp"
                                 else getattr(p, ax) for ax in axes))
    return tuple(out)


PlanLike = Union[str, ShardingPlan]


def as_plan(plan: Optional[PlanLike]) -> Optional[ShardingPlan]:
    """Coerce a plan argument: a grammar string parses, a
    :class:`ShardingPlan` passes through, None stays None."""
    if plan is None or isinstance(plan, ShardingPlan):
        return plan
    if isinstance(plan, str):
        return ShardingPlan.from_string(plan)
    raise TypeError(
        f"plan must be a ShardingPlan or a HOROVOD_PLAN string, got "
        f"{type(plan).__name__}")
