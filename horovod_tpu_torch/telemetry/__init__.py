"""The unified runtime telemetry plane (``horovod_tpu/telemetry``).

One process-wide :class:`~horovod_tpu_torch.telemetry.registry.MetricsRegistry`
that every subsystem instruments unconditionally — input pipeline,
checkpointer, elastic driver/health plane, retry, faults, stall inspector
— at zero cost until enabled (the ``faults.inject`` contract: one
attribute load + branch per call).  Enabled, it feeds:

* a per-worker **Prometheus** text endpoint (``HOROVOD_METRICS_PORT``,
  0 = off; worker *i* binds ``port + i``), the driver's additionally
  serving per-worker counters aggregated off the heartbeat RPC;
* a periodic **JSONL snapshot log** (``HOROVOD_METRICS_LOG``,
  ``HOROVOD_METRICS_INTERVAL_S``);
* the **timeline**: registered gauges render as Chrome counter rows
  (``"ph":"C"``) under the collective spans.

A :class:`~horovod_tpu_torch.telemetry.context.RunContext` (run_id,
generation, step) is stamped onto metric snapshots, trace events and
log lines so the three planes correlate.

Typical use — instrumentation (handles are cheap to cache)::

    from horovod_tpu_torch import telemetry
    _BATCHES = telemetry.counter("hvd_input_batches_total", "batches fed")
    _BATCHES.inc()

and operation::

    HOROVOD_METRICS_PORT=9090 HOROVOD_METRICS_LOG=/tmp/run.metrics.jsonl \
        python -m horovod_tpu_torch.runner -np 4 python train.py
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional

from horovod_tpu_torch.telemetry.context import RunContext, run_context
from horovod_tpu_torch.telemetry.export import (
    SCHEMA_VERSION,
    SNAPSHOT_KIND,
    MetricsSnapshotWriter,
    PrometheusExporter,
    WorkerMetricsStore,
    render_prometheus,
    snapshot_line,
)
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
    "SCHEMA_VERSION", "SNAPSHOT_KIND",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "MetricsSnapshotWriter", "PrometheusExporter", "RunContext",
    "TelemetryRuntime", "WorkerMetricsStore",
    "DEFAULT_SIZE_BUCKETS", "DEFAULT_TIME_BUCKETS",
    "counter", "gauge", "histogram", "default_registry", "enabled",
    "enable", "disable", "reset", "value", "snapshot",
    "counters_snapshot", "bench_metrics", "merge_counter_snapshots",
    "render_prometheus", "run_context", "series_key", "snapshot_line",
    "start_from_config", "worker_store",
]

_registry: Optional[MetricsRegistry] = None
_registry_lock = threading.Lock()
_worker_store: Optional[WorkerMetricsStore] = None


def default_registry() -> MetricsRegistry:
    """THE process registry (created lazily, disabled by default, never
    replaced — cached metric handles stay valid forever)."""
    global _registry
    if _registry is None:
        with _registry_lock:
            if _registry is None:
                _registry = MetricsRegistry(enabled=False)
    return _registry


def worker_store() -> WorkerMetricsStore:
    """The process-wide per-worker aggregation store (driver side)."""
    global _worker_store
    if _worker_store is None:
        with _registry_lock:
            if _worker_store is None:
                _worker_store = WorkerMetricsStore()
    return _worker_store


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


def bench_metrics() -> Dict:
    """The block a benchmark folds into its JSON: schema stamp + final
    counters (the deterministic slice of the snapshot — gauges
    and duration histograms are run-dependent by nature)."""
    return {"schema_version": SCHEMA_VERSION,
            "counters": counters_snapshot()}


class TelemetryRuntime:
    """The exporters one ``init()`` started; ``shutdown()`` stops them
    (final JSONL snapshot included)."""

    def __init__(self, exporter: Optional[PrometheusExporter] = None,
                 writer: Optional[MetricsSnapshotWriter] = None):
        self.exporter = exporter
        self.writer = writer

    def shutdown(self) -> None:
        if self.writer is not None:
            self.writer.stop()
            self.writer = None
        if self.exporter is not None:
            self.exporter.stop()
            self.exporter = None


def start_from_config(config, process_rank: int = 0
                      ) -> Optional[TelemetryRuntime]:
    """Resolve the ``HOROVOD_METRICS*`` contract at ``init()`` time.

    Collection is enabled when ``HOROVOD_METRICS=1`` or when either
    exporter is configured (``HOROVOD_METRICS=0`` force-disables both
    collection and exporters).  Returns the running exporters, or None
    when telemetry stays off.
    """
    explicit = getattr(config, "metrics_enabled", None)
    port = int(getattr(config, "metrics_port", 0) or 0)
    log_path = getattr(config, "metrics_log", None)
    on = bool(port or log_path) if explicit is None else bool(explicit)
    if not on:
        return None
    reg = enable()
    run_context().update(
        run_id=getattr(config, "run_id", None),
        generation=int(os.environ.get("HOROVOD_ELASTIC_GENERATION", "0")
                       or 0))
    exporter = None
    writer = None
    if port:
        # per-worker endpoint: worker i binds port + i so co-hosted
        # workers never collide; scrape targets enumerate the range
        exporter = PrometheusExporter(reg, port + int(process_rank),
                                      store=worker_store())
        exporter.start()
    if log_path:
        if process_rank:
            log_path = f"{log_path}.{process_rank}"
        writer = MetricsSnapshotWriter(
            reg, log_path,
            interval_s=float(getattr(config, "metrics_interval_s", 10.0)))
        writer.start()
    return TelemetryRuntime(exporter, writer)
