"""One serving replica: executable wrapper + drain state machine (a copy
of ``horovod_tpu/serve/replica.py``).

A replica is a worker slot (``host:local_rank`` under the elastic
driver, or an in-process stand-in for tests) that executes batches.
Its lifecycle mirrors the training worker's (docs/serving.md drain
state machine)::

    SERVING ──begin_drain()──> DRAINING ──finish──> DEPARTED
       │                           │
       └── crash / drain timeout ──┴──────────────> DEAD

``DRAINING`` is the planned-departure path from guard/preempt.py
re-used for serving: the pool stops routing new batches here, in-flight
work finishes, and the departure notice (``PlannedDepartureRequest``)
tells the elastic driver the exit is graceful — no blacklist, no
quarantine, no sibling abort.  ``DEAD`` is the crash path: the pool
re-enqueues the replica's leased requests exactly once.

Fault sites (docs/faults.md): ``serve.batch`` fires before every batch
execution — a ``crash`` (sim → :class:`~horovod_tpu_torch.faults.WorkerCrash`)
models a replica dying mid-batch; ``serve.drain`` fires on the drain
path — a ``raise``/``hang`` models a drain that cannot complete inside
the grace window, which must fall back to the dead path.
"""

from __future__ import annotations

import time
from typing import Any, Callable, List, Optional, Sequence

from horovod_tpu_torch import faults, telemetry

SERVING = "serving"
DRAINING = "draining"
DEPARTED = "departed"
DEAD = "dead"

_TEL_BATCHES = telemetry.counter(
    "hvd_serve_batches_total", "batches executed (per replica label)")


class Replica:
    """One executable-serving slot.  ``executor`` maps a list of
    payloads to a list of results (the batcher packs/unpacks requests
    around it); it is typically an executor of the executable cache
    (batcher.py) or a plain callable in tests."""

    def __init__(self, name: str,
                 executor: Callable[[Sequence[Any]], List[Any]],
                 host: str = "", local_rank: int = 0,
                 clock: Callable[[], float] = time.monotonic):
        self.name = name
        self.executor = executor
        self.host = host or name
        self.local_rank = local_rank
        self._clock = clock
        self.state = SERVING
        self.batches = 0

    @property
    def serving(self) -> bool:
        return self.state == SERVING

    @property
    def alive(self) -> bool:
        return self.state in (SERVING, DRAINING)

    def run_batch(self, payloads: Sequence[Any],
                  model_id: Optional[str] = None,
                  weights: Any = None) -> List[Any]:
        """Execute one packed batch.  The ``serve.batch`` fault site
        fires first: a sim ``crash`` here raises
        :class:`~horovod_tpu_torch.faults.WorkerCrash` mid-batch, which the
        pool converts into the dead path (requeue the lease).

        Fleet callers pass ``model_id`` (the executable hot-swap key —
        serve/batcher.py ExecutableCache) and ``weights`` (the param
        buffer snapshotted once for the whole batch by the refresher's
        atomic flip discipline — serve/refresh.py); both are forwarded
        to the executor as keywords.  Single-model callers keep the
        bare ``executor(payloads)`` contract of the single-model plane."""
        faults.inject("serve.batch")
        if model_id is None:
            results = self.executor(payloads)
        else:
            results = self.executor(payloads, model_id=model_id,
                                    weights=weights)
        self.batches += 1
        _TEL_BATCHES.inc(replica=self.name)
        return results

    def begin_drain(self) -> None:
        """Stop accepting new batches; in-flight work continues.  The
        pool completes the drain once the lease clears
        (:meth:`ReplicaPool.drain`)."""
        if self.state == SERVING:
            self.state = DRAINING

    def __repr__(self) -> str:
        return f"Replica({self.name!r}, state={self.state})"
