"""Request/response records for the serving plane (a copy of
``horovod_tpu/serve/request.py``, docs/serving.md).

A request enters the plane with a caller-chosen **request id** — the
exactly-once token every downstream guarantee hangs off: admission
dedups resubmissions of an id it already holds, the replica pool
leases ids to the replica executing them, and a dead replica's leased
ids are re-enqueued at most once (``AdmissionQueue.requeue``) so a
crash mid-batch can neither lose a response nor produce two.

The **signature** is the batch-compatibility key: requests sharing a
signature (same input shape/dtype, same model entry point) may be
packed into one executable call by the continuous batcher.  Use
:func:`payload_signature` for array-like payloads; a tensor's dtype reads
as torch names it (``torch.bfloat16``), so a signature is a key within
one package.

Under the fleet model (serve/tenancy.py) a request also names the
**model** it targets — the tenancy layer routes it to that model's
admission queue and the batcher hot-swaps the model's executable per
leased batch — and every response carries the **weights fingerprint**
(guard/checksum.py) of the exact parameter buffer that produced it,
so weight freshness after a live refresh (serve/refresh.py) is
verifiable end to end.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

#: queue states an admitted request id moves through (queue.py)
QUEUED = "queued"
INFLIGHT = "inflight"
DONE = "done"


def payload_signature(payload: Any) -> Tuple:
    """Batch-compatibility key for an array-like payload: ``(shape,
    dtype)`` when the payload exposes them, else its type name — two
    requests are packable iff their signatures compare equal."""
    shape = getattr(payload, "shape", None)
    dtype = getattr(payload, "dtype", None)
    if shape is not None:
        return (tuple(shape), str(dtype))
    return (type(payload).__name__,)


@dataclasses.dataclass
class InferenceRequest:
    """One unit of admitted work.

    ``deadline_s`` is an *absolute* clock reading (same clock the queue
    was built with); 0 means no deadline.  ``requeues`` counts crash
    re-executions — bounded by ``HOROVOD_SERVE_MAX_REQUEUES`` so a
    poison request that kills every replica it touches is eventually
    shed instead of cycling forever."""

    request_id: str
    payload: Any
    signature: Tuple = ()
    arrival_s: float = 0.0
    deadline_s: float = 0.0
    requeues: int = 0
    #: fleet routing key — which model's admission queue this request
    #: belongs to ("" = the single-model plane)
    model_id: str = ""

    def __post_init__(self) -> None:
        if not self.signature:
            self.signature = payload_signature(self.payload)


@dataclasses.dataclass
class InferenceResponse:
    """The completion record the batcher hands back: result plus the
    latency/provenance fields the SLO probe aggregates."""

    request_id: str
    result: Any
    replica: str = ""
    latency_s: float = 0.0
    requeues: int = 0
    error: Optional[str] = None
    #: fleet provenance: the model that served it and the fingerprint
    #: of the weights buffer the batch ran against (None on the
    #: single-model plane or when no refresher is wired)
    model_id: str = ""
    weights_fp: Optional[int] = None

    @property
    def ok(self) -> bool:
        return self.error is None
