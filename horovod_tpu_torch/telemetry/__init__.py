"""The runtime telemetry registry (``horovod_tpu/telemetry``).

One process-wide :class:`~horovod_tpu_torch.telemetry.registry.MetricsRegistry`
that the port's subsystems instrument unconditionally, at zero cost until
enabled.  The port has no exporter yet: read the values with
:func:`value` and :func:`snapshot`.

    from horovod_tpu_torch import telemetry
    _BATCHES = telemetry.counter("hvd_input_batches_total", "batches fed")
    _BATCHES.inc()
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from horovod_tpu_torch.telemetry.context import RunContext, run_context
from horovod_tpu_torch.telemetry.registry import (
    DEFAULT_SIZE_BUCKETS,
    DEFAULT_TIME_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    merge_counter_snapshots,
    series_key,
)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "DEFAULT_SIZE_BUCKETS", "DEFAULT_TIME_BUCKETS",
    "counter", "gauge", "histogram", "default_registry", "enabled",
    "enable", "disable", "reset", "value", "snapshot",
    "counters_snapshot", "merge_counter_snapshots", "series_key",
    "RunContext", "run_context", "WorkerMetricsStore", "worker_store",
]

_registry: Optional[MetricsRegistry] = None
_registry_lock = threading.Lock()
_worker_store: Optional["WorkerMetricsStore"] = None


class WorkerMetricsStore:
    """Driver-side per-worker counter snapshots, fed by the heartbeat
    piggyback (``HeartbeatRequest.metrics``) as the step counter rides
    it: no extra RPC, no extra thread (``horovod_tpu/telemetry/
    export.py``'s store; the port has no exporter, so no rendering)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._snapshots: Dict[str, Dict[str, float]] = {}

    def update(self, worker: str, counters: Dict[str, float]) -> None:
        if not isinstance(counters, dict):
            return
        clean = {str(k): float(v) for k, v in counters.items()
                 if isinstance(v, (int, float))}
        with self._lock:
            self._snapshots[worker] = clean

    def purge(self, keep) -> None:
        """Drop workers no longer assigned (as HealthMonitor.purge)."""
        keep = set(keep)
        with self._lock:
            self._snapshots = {w: s for w, s in self._snapshots.items()
                               if w in keep}

    def snapshots(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {w: dict(s) for w, s in self._snapshots.items()}


def worker_store() -> WorkerMetricsStore:
    """The process-wide per-worker aggregation store (driver side)."""
    global _worker_store
    if _worker_store is None:
        with _registry_lock:
            if _worker_store is None:
                _worker_store = WorkerMetricsStore()
    return _worker_store


def default_registry() -> MetricsRegistry:
    """THE process registry (created lazily, disabled by default, never
    replaced — cached metric handles stay valid forever)."""
    global _registry
    if _registry is None:
        with _registry_lock:
            if _registry is None:
                _registry = MetricsRegistry(enabled=False)
    return _registry


def enabled() -> bool:
    return _registry is not None and _registry.enabled


def enable() -> MetricsRegistry:
    reg = default_registry()
    reg.enable()
    return reg


def disable() -> None:
    if _registry is not None:
        _registry.disable()


def reset() -> None:
    """Zero every series (handles stay valid) — test/bench isolation."""
    if _registry is not None:
        _registry.reset_values()


def counter(name: str, help: str = "") -> Counter:
    return default_registry().counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return default_registry().gauge(name, help)


def histogram(name: str, help: str = "",
              buckets=DEFAULT_TIME_BUCKETS) -> Histogram:
    return default_registry().histogram(name, help, buckets=buckets)


def value(name: str, **labels) -> float:
    return default_registry().value(name, **labels)


def snapshot() -> Dict:
    return default_registry().snapshot()


def counters_snapshot() -> Dict[str, float]:
    return default_registry().counters_snapshot()
