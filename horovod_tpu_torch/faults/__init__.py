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
``coordinator.connect``     an elastic worker's join of the driver's store,
                            once per try
``worker.commit``           elastic ``State.commit()``
``worker.heartbeat``        each heartbeat a worker sends the driver
``worker.register``         a worker's registration with the driver
``worker.rendezvous``       each poll for a new generation's assignment
``discovery.script``        each run of the host discovery script
``driver.discovery``        each pass of the driver's discovery loop
``driver.health``           each pass of the driver's health monitor
``checkpoint.write``        the checkpoint writer, before each write
``timeline.write``          the timeline's Python writer thread, once per
                            event
``stall.watch``             each pass of the stall inspector's watcher
``telemetry.export``        the metrics snapshot writer, once per export
                            pass
``guard.check``             each ``TrainingGuard.check_replicas``
``guard.params``            the same call, with the parameters as the
                            value: ``corrupt`` is the silent-data-corruption
                            fault the replica vote must catch
``guard.repair``            each peer-state fetch of a repair
``worker.preempt``          a preemption drain's finalize
``serve.batch``             a replica, before each batch
``serve.feed``              the batcher, at the top of each step
``serve.drain``             a replica's drain, once its lease is clear
``serve.tenant``            each weighted-fair pick of the fleet
``serve.refresh``           each weight flip, with the staged weights as the
                            value (``corrupt`` must be caught by the verify)
``serve.scale``             each autoscale poll
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
