"""Elastic (fault-tolerant, dynamic-world-size) training
(``horovod_tpu/elastic``).

Reference: ``horovod/common/elastic.py`` (framework-independent State and
retry loop), ``horovod/runner/elastic/`` (driver, discovery, registration,
rendezvous).  The semantics preserved exactly: ``state.sync()`` →
``train(state)`` → on ``HorovodInternalError`` restore to last commit / on
``HostsUpdatedInterrupt`` keep going → ``reset()`` → ``on_reset()`` →
retry.  ``reset()`` shuts the runtime down, joins the driver's store of
the new generation and makes the new world's process groups; objects
that hold the old world's groups are rebuilt in the reset callbacks.
Plan-aware degradation (:mod:`~horovod_tpu_torch.elastic.degrade`)
re-resolves the parallelism plan to the surviving world.
"""

from horovod_tpu_torch.elastic.degrade import (
    DegradeController,
    DegradeDecision,
    DegradedPlanResolver,
    preserve_global_batch,
)
from horovod_tpu_torch.elastic.state import ObjectState, State, TorchState, run
from horovod_tpu_torch.exceptions import (
    HorovodInternalError,
    HostsUpdatedInterrupt,
)

__all__ = [
    "State", "ObjectState", "TorchState", "run",
    "HorovodInternalError", "HostsUpdatedInterrupt",
    "DegradeController", "DegradeDecision", "DegradedPlanResolver",
    "preserve_global_batch",
]
