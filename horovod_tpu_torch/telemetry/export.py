"""Metric exporters: Prometheus text endpoint + JSONL snapshot log (a
port of ``horovod_tpu/telemetry/export.py``).

Two consumers, two formats, one registry:

* :class:`PrometheusExporter` — a stdlib-only (``http.server``) HTTP
  endpoint serving the text exposition format on
  ``HOROVOD_METRICS_PORT`` (0 = off; per-worker — worker *i* binds
  ``port + i`` so one host's workers never collide).  The driver's
  endpoint additionally serves every worker's counters with a
  ``worker="host:local_rank"`` label, aggregated from the heartbeat
  piggyback (:class:`WorkerMetricsStore`).
* :class:`MetricsSnapshotWriter` — a periodic, ``schema_version``-
  stamped JSONL snapshot appended to ``HOROVOD_METRICS_LOG``; the
  machine-readable artifact of a run.

Export failure must never touch training: the writer loop carries the
``telemetry.export`` chaos site and degrades by
dropping the sample — counted in ``hvd_telemetry_export_errors_total``
— never by raising into the runtime.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

from horovod_tpu_torch import faults
from horovod_tpu_torch.telemetry import context as tel_context
from horovod_tpu_torch.telemetry.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    merge_counter_snapshots,
    series_key,
)
from horovod_tpu_torch.utils import logging as hvd_logging

SCHEMA_VERSION = 1
SNAPSHOT_KIND = "hvdtel_snapshot"


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def render_prometheus(registry: MetricsRegistry,
                      store: Optional["WorkerMetricsStore"] = None) -> str:
    """Text exposition (version 0.0.4) of every registered series;
    histograms render the standard cumulative ``_bucket{le=}``/
    ``_sum``/``_count`` triple from the internal per-bucket counts."""
    lines = []
    for m in registry.metrics():
        lines.append(f"# HELP {m.name} {m.help or m.name}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        for s in m.series():
            with s._lock:
                if isinstance(m, Histogram):
                    cum = 0
                    for bound, n in zip(m.buckets, s.counts):
                        cum += n
                        lines.append(_series_line(
                            m.name + "_bucket",
                            dict(s.labels, le=_fmt(bound)), cum))
                    cum += s.counts[-1]
                    lines.append(_series_line(
                        m.name + "_bucket", dict(s.labels, le="+Inf"), cum))
                    lines.append(_series_line(m.name + "_sum",
                                              s.labels, s.sum))
                    lines.append(_series_line(m.name + "_count",
                                              s.labels, s.count))
                else:
                    lines.append(_series_line(m.name, s.labels, s.value))
    if store is not None:
        lines.extend(store.render_lines())
    return "\n".join(lines) + "\n"


def _series_line(name: str, labels: Dict[str, str], value: float) -> str:
    if labels:
        inner = ",".join(f'{k}="{_escape(str(labels[k]))}"'
                         for k in sorted(labels))
        return f"{name}{{{inner}}} {_fmt(float(value))}"
    return f"{name} {_fmt(float(value))}"


def snapshot_line(registry: MetricsRegistry) -> Dict:
    """One JSONL snapshot record: schema stamp + run-context triple +
    the full value snapshot.  ``ts_unix`` is the only
    non-deterministic field for a seeded workload — determinism claims
    are over ``counters``."""
    line = {"schema_version": SCHEMA_VERSION, "kind": SNAPSHOT_KIND,
            "ts_unix": round(time.time(), 3)}
    line.update(tel_context.run_context().as_dict())
    line.update(registry.snapshot())
    return line


class _MetricsHandler(BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 - http.server API
        if self.path.split("?")[0] not in ("/", "/metrics"):
            self.send_error(404)
            return
        body = render_prometheus(self.server.hvd_registry,
                                 self.server.hvd_store).encode()
        self.send_response(200)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):  # silence per-request stderr noise
        pass


class PrometheusExporter:
    """Serve ``/metrics`` from a background thread; ``port=0`` binds an
    ephemeral port (tests), the runtime gate for "off" lives in
    :func:`horovod_tpu_torch.telemetry.start_from_config`."""

    def __init__(self, registry: MetricsRegistry, port: int,
                 host: str = "0.0.0.0",
                 store: Optional["WorkerMetricsStore"] = None):
        self._server = ThreadingHTTPServer((host, int(port)),
                                           _MetricsHandler)
        self._server.daemon_threads = True
        self._server.hvd_registry = registry
        self._server.hvd_store = store
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="hvd_torch_metrics_http")
        self._thread.start()
        hvd_logging.info("telemetry: Prometheus endpoint on :%d/metrics",
                         self.port)

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None


class WorkerMetricsStore:
    """Driver-side per-worker counter snapshots, fed by the heartbeat
    piggyback (``HeartbeatRequest.metrics``) exactly the way the step
    counter rides ``report_step`` — no extra RPC, no extra thread."""

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
        """Drop workers no longer assigned (mirrors HealthMonitor.purge)."""
        keep = set(keep)
        with self._lock:
            self._snapshots = {w: s for w, s in self._snapshots.items()
                               if w in keep}

    def snapshots(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {w: dict(s) for w, s in self._snapshots.items()}

    def merged(self) -> Dict[str, float]:
        """Counters summed across workers (exact: canonical series keys,
        monotone sums)."""
        return merge_counter_snapshots(self.snapshots().values())

    def render_lines(self):
        """Per-worker series with a ``worker`` label appended — what the
        driver's Prometheus endpoint serves on top of its own registry."""
        lines = []
        for worker, snap in sorted(self.snapshots().items()):
            for key, value in sorted(snap.items()):
                if key.endswith("}"):
                    line = (f'{key[:-1]},worker="{_escape(worker)}"}} '
                            f"{_fmt(value)}")
                else:
                    line = f'{key}{{worker="{_escape(worker)}"}} ' \
                           f"{_fmt(value)}"
                lines.append(line)
        return lines


class MetricsSnapshotWriter:
    """Periodic JSONL snapshot appender (``HOROVOD_METRICS_LOG``).

    One daemon thread, one append + flush per interval; a final
    snapshot is written at :meth:`stop` so short runs always leave at
    least one complete record.  The file is append-only JSONL: a crash
    mid-write loses at most the last line, and every complete line is
    independently parseable."""

    def __init__(self, registry: MetricsRegistry, path: str,
                 interval_s: float = 10.0):
        self._registry = registry
        self.path = path
        self.interval_s = max(float(interval_s), 0.05)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="hvd_torch_metrics_writer")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.write_now()

    def write_now(self) -> Optional[Dict]:
        """One guarded export pass: build + append a snapshot line.
        Failures (including the ``telemetry.export`` chaos site) drop
        the sample, bump ``hvd_telemetry_export_errors_total`` and
        return None — the export plane degrades, training never sees
        it."""
        try:
            # chaos hook: a raise/delay models a failing metrics sink
            # (full disk, dead NFS) — export must degrade, not propagate
            faults.inject("telemetry.export")
            line = snapshot_line(self._registry)
            with open(self.path, "a") as f:
                f.write(json.dumps(line, sort_keys=True) + "\n")
                f.flush()
            return line
        except Exception as e:  # noqa: BLE001 — export is best-effort
            self._registry.counter(
                "hvd_telemetry_export_errors_total",
                "metrics snapshot export failures").inc()
            hvd_logging.warning("telemetry: snapshot export failed: %s", e)
            return None

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
        self.write_now()      # final record: short runs still export
