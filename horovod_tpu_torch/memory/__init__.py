"""The memory plane of the port (``horovod_tpu/memory``): how a plan
*fits* —

* ``memory/remat.py`` — the per-block ``none | dots | full | offload``
  remat tiers behind the models' ``remat``/``remat_policy`` and the
  ``HOROVOD_REMAT_POLICY`` knob, as ``torch.utils.checkpoint`` policies;
* ``memory/planner.py`` — the budgeted search over (plan × remat ×
  microbatch × offload), returning the fastest config whose predicted
  high-water fits ``HOROVOD_HBM_BUDGET_BYTES`` (default: the device's
  capacity in the resolved hardware model);
* ``memory/offload.py`` — double-buffered async host offload of
  optimizer state to pinned memory on a side stream (fault sites
  ``offload.d2h``/``offload.h2d``).

The JAX package's pure-sim ``memory/smoke.py`` is not ported:
``chip_smoke.py`` phase 18 drives the plane on the card.
"""

from horovod_tpu_torch.memory.offload import HostOffloadEngine
from horovod_tpu_torch.memory.planner import (
    InfeasibleError,
    MemoryCandidate,
    search_memory_plans,
)
from horovod_tpu_torch.memory.remat import (
    ENV_REMAT_POLICY,
    REMAT_POLICIES,
    remat_block,
    remat_fn,
    resolve_remat_policy,
)

__all__ = [
    "ENV_REMAT_POLICY",
    "HostOffloadEngine",
    "InfeasibleError",
    "MemoryCandidate",
    "REMAT_POLICIES",
    "remat_block",
    "remat_fn",
    "resolve_remat_policy",
    "search_memory_plans",
]
