"""Deterministic fault injection (``horovod_tpu/faults``).

A seeded :class:`FaultPlan` schedules named faults that fire through
explicit :func:`inject` hooks at the port's failure-relevant sites.  With
no plan active every hook is a near-zero-cost no-op (one global ``None``
check).

Sites instrumented in the port (grep ``faults.inject``):

==========================  =================================================
``data.feed``               prefetch feeder, once per source batch
``probe.connect``           NIC probe task's connect to the launcher's probe
                            driver, once per try under its RetryPolicy
==========================  =================================================

Typical use::

    plan = FaultPlan(seed=42, sim=True).add("data.feed", "raise",
                                            "OSError", at=3)
    faults.set_plan(plan)

or, for a launched job::

    HOROVOD_FAULT_PLAN="seed=42;data.feed@3:delay(0.5)"
"""

from horovod_tpu_torch.faults.plan import (
    FaultPlan,
    FaultSpec,
    WorkerCrash,
    active_plan,
    clear_plan,
    inject,
    load_env_plan,
    set_plan,
)

__all__ = [
    "FaultPlan",
    "FaultSpec",
    "WorkerCrash",
    "active_plan",
    "clear_plan",
    "inject",
    "load_env_plan",
    "set_plan",
]
