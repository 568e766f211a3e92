"""hvdserve: the resilient serving plane on the elastic runtime (a copy of
``horovod_tpu/serve``, docs/serving.md).

The serving plane turns the runtime's substrate — the heartbeat/health
plane, quarantine-with-decay, deterministic fault injection, the
telemetry registry, the training-state guard's fingerprints — into a
request path that degrades gracefully instead of dropping or duplicating
work:

* :mod:`~horovod_tpu_torch.serve.request` — request/response records; the
  request id is the exactly-once token;
* :mod:`~horovod_tpu_torch.serve.queue` — bounded admission queue:
  deadline-aware shedding + backpressure at the front door, and the
  ``queued → inflight → done`` state machine that makes crash
  re-enqueue exactly-once;
* :mod:`~horovod_tpu_torch.serve.replica` — one serving slot with the
  SERVING → DRAINING → DEPARTED / DEAD lifecycle;
* :mod:`~horovod_tpu_torch.serve.batcher` — continuous batcher packing
  signature-compatible requests into bucketed executables
  (:class:`~horovod_tpu_torch.serve.batcher.ExecutableCache`, built over
  a ``torch.nn.Module`` by ``from_module``, or ahead of time through the
  compile cache's AOT store by ``from_exported``);
* :mod:`~horovod_tpu_torch.serve.pool` — replica pool: leases, crash
  recovery, graceful drain via the planned-departure path, and
  hysteresis-damped queue-depth scale signals
  (:class:`~horovod_tpu_torch.serve.pool.ElasticServeBridge`).

The fleet layer turns the one-model plane into a multi-tenant fleet:

* :mod:`~horovod_tpu_torch.serve.tenancy` — per-model admission queues
  behind a smooth-weighted-round-robin arbiter with SLO-classed
  overload shedding, plus the :class:`~horovod_tpu_torch.serve.tenancy.
  FleetBatcher` engine loop;
* :mod:`~horovod_tpu_torch.serve.refresh` — live weight refresh without
  drain: double-buffered staging through the host-offload engine, atomic
  between-batches flips, fingerprint verify with rollback + checkpoint
  quarantine;
* :mod:`~horovod_tpu_torch.serve.autoscale` — the closed loop over
  ``scale_signal()``: acquire / release (graceful drain) with cooldown,
  bounds and death repair.

Fault sites: ``serve.batch`` (replica crash mid-batch), ``serve.feed``
(queue-feeder hang), ``serve.drain`` (drain wedged past its window),
``serve.tenant`` (weighted-fair pick), ``serve.refresh`` (flip
attempt — ``corrupt`` must be caught by the fingerprint verify),
``serve.scale`` (autoscale poll).  Metrics: the ``hvd_serve_*`` series.
"""

from horovod_tpu_torch.serve.autoscale import AutoscaleController
from horovod_tpu_torch.serve.batcher import ContinuousBatcher, ExecutableCache
from horovod_tpu_torch.serve.pool import ElasticServeBridge, ReplicaPool
from horovod_tpu_torch.serve.queue import (
    ADMITTED,
    SHED_DEADLINE,
    SHED_DUPLICATE,
    SHED_FULL,
    SHED_OVERLOAD,
    SHED_REQUEUE_BUDGET,
    AdmissionQueue,
)
from horovod_tpu_torch.serve.refresh import WeightRefresher
from horovod_tpu_torch.serve.tenancy import (
    SLO_CLASSES,
    FleetBatcher,
    MultiTenantQueue,
    SLOClass,
    TenantSpec,
)
from horovod_tpu_torch.serve.replica import (
    DEAD,
    DEPARTED,
    DRAINING,
    SERVING,
    Replica,
)
from horovod_tpu_torch.serve.request import (
    InferenceRequest,
    InferenceResponse,
    payload_signature,
)

__all__ = [
    "ADMITTED", "SHED_DEADLINE", "SHED_DUPLICATE", "SHED_FULL",
    "SHED_OVERLOAD", "SHED_REQUEUE_BUDGET", "AdmissionQueue",
    "AutoscaleController", "ContinuousBatcher", "DEAD", "DEPARTED",
    "DRAINING", "ElasticServeBridge", "ExecutableCache",
    "FleetBatcher", "InferenceRequest", "InferenceResponse",
    "MultiTenantQueue", "Replica", "ReplicaPool", "SERVING",
    "SLOClass", "SLO_CLASSES", "TenantSpec", "WeightRefresher",
    "payload_signature",
]
