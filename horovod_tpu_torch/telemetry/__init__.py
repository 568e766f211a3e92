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
]

_registry: Optional[MetricsRegistry] = None
_registry_lock = threading.Lock()


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
