"""The metrics registry: labeled Counter/Gauge/Histogram.

A copy of ``horovod_tpu/telemetry/registry.py``, which is framework-free.
Design constraints, in order:

* **zero-cost when disabled** — every ``inc``/``set``/``observe`` is one
  attribute load plus a branch when the registry is disabled (the same
  contract as :func:`horovod_tpu_torch.faults.inject`), so
  instrumentation can live on per-step and per-batch hot paths
  unconditionally;
* **lock-disciplined** — one lock per metric
  series guards its value, one registry lock guards creation; exact
  totals under the multi-thread hammer test, and no lock is ever held
  while calling into another subsystem (telemetry is a leaf: it never
  calls back into the runtime, so it cannot extend any lock-order
  cycle);
* **mergeable** — histograms use *fixed* bucket bounds chosen at
  creation, identical on every rank, so per-rank bucket counts sum
  sample-by-sample (:func:`merge_counter_snapshots`).

There is exactly ONE process-wide registry (``default_registry()``),
created lazily and never replaced — call sites may cache metric handles
forever.  Tests zero it with :meth:`MetricsRegistry.reset_values`.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# Fixed mergeable bucket families (seconds / bytes).  All ranks share
# these bounds, which is what makes cross-rank histogram merges exact.
DEFAULT_TIME_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 300.0)
DEFAULT_SIZE_BUCKETS: Tuple[float, ...] = (
    1024.0, 16384.0, 262144.0, 1048576.0, 4194304.0, 16777216.0,
    67108864.0, 268435456.0, 1073741824.0)


def series_key(name: str, labels: Dict[str, str]) -> str:
    """Canonical series identity: ``name`` or ``name{k="v",...}`` with
    labels sorted — the key the JSONL snapshot, the Prometheus renderer
    and the cross-rank merge all agree on."""
    if not labels:
        return name
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return f"{name}{{{inner}}}"


class _Series:
    """One (metric, label-set) time series."""

    __slots__ = ("labels", "_lock")

    def __init__(self, labels: Dict[str, str]):
        self.labels = labels
        self._lock = threading.Lock()


class _CounterSeries(_Series):
    __slots__ = ("value",)

    def __init__(self, labels):
        super().__init__(labels)
        self.value = 0.0


class _GaugeSeries(_Series):
    __slots__ = ("value",)

    def __init__(self, labels):
        super().__init__(labels)
        self.value = 0.0


class _HistogramSeries(_Series):
    __slots__ = ("counts", "sum", "count")

    def __init__(self, labels, n_buckets: int):
        super().__init__(labels)
        self.counts = [0] * n_buckets      # one per bound + overflow
        self.sum = 0.0
        self.count = 0


class Metric:
    """A named metric family; label sets create child series lazily.

    Call the value methods either directly (unlabeled series) or on the
    object ``labels(...)`` returns.  Handles are stable for the process
    lifetime — cache them on hot paths.
    """

    kind = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str,
                 help: str = ""):
        self._registry = registry
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._series: Dict[Tuple[Tuple[str, str], ...], _Series] = {}

    def _make_series(self, labels: Dict[str, str]) -> _Series:
        raise NotImplementedError

    def _get_series(self, labels: Dict[str, str]) -> _Series:
        key = tuple(sorted(labels.items()))
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._make_series(dict(labels))
                self._series[key] = s
            return s

    def labels(self, **labels: str) -> "_BoundMetric":
        """Bind a label set; the returned handle exposes the same value
        methods and is cheap to cache."""
        return _BoundMetric(self, self._get_series(
            {k: str(v) for k, v in labels.items()}))

    def series(self) -> List[_Series]:
        with self._lock:
            return list(self._series.values())

    def reset_values(self) -> None:
        for s in self.series():
            with s._lock:
                if isinstance(s, _HistogramSeries):
                    s.counts = [0] * len(s.counts)
                    s.sum = 0.0
                    s.count = 0
                else:
                    s.value = 0.0


class _BoundMetric:
    """A metric handle bound to one label set."""

    __slots__ = ("_metric", "_series")

    def __init__(self, metric: Metric, series: _Series):
        self._metric = metric
        self._series = series

    def inc(self, n: float = 1.0) -> None:
        if not self._metric._registry._enabled:
            return
        s = self._series
        with s._lock:
            s.value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    def set(self, v: float) -> None:
        if not self._metric._registry._enabled:
            return
        s = self._series
        with s._lock:
            s.value = float(v)

    def observe(self, v: float) -> None:
        if not self._metric._registry._enabled:
            return
        m = self._metric
        s = self._series
        i = bisect.bisect_left(m.buckets, v)
        with s._lock:
            s.counts[i] += 1
            s.sum += v
            s.count += 1

    @property
    def value(self) -> float:
        s = self._series
        with s._lock:
            return s.value


class Counter(Metric):
    """Monotonically-increasing count (events, bytes, errors)."""

    kind = "counter"

    def _make_series(self, labels):
        return _CounterSeries(labels)

    def inc(self, n: float = 1.0, **labels: str) -> None:
        if not self._registry._enabled:
            return
        (self.labels(**labels) if labels else self._unlabeled()).inc(n)

    def _unlabeled(self) -> _BoundMetric:
        return _BoundMetric(self, self._get_series({}))

    @property
    def value(self) -> float:
        """Unlabeled series value (0.0 if never incremented)."""
        return self._unlabeled().value


class Gauge(Metric):
    """Point-in-time value (queue depth, heartbeat age, generation)."""

    kind = "gauge"

    def _make_series(self, labels):
        return _GaugeSeries(labels)

    def set(self, v: float, **labels: str) -> None:
        if not self._registry._enabled:
            return
        (self.labels(**labels) if labels else self._unlabeled()).set(v)

    def inc(self, n: float = 1.0, **labels: str) -> None:
        if not self._registry._enabled:
            return
        (self.labels(**labels) if labels else self._unlabeled()).inc(n)

    def dec(self, n: float = 1.0, **labels: str) -> None:
        self.inc(-n, **labels)

    def _unlabeled(self) -> _BoundMetric:
        return _BoundMetric(self, self._get_series({}))

    @property
    def value(self) -> float:
        return self._unlabeled().value


class Histogram(Metric):
    """Distribution over fixed, mergeable buckets.

    ``buckets`` are the upper bounds of the finite buckets; one
    overflow (+Inf) bucket is implicit.  Counts are per-bucket (NOT
    cumulative) internally; the Prometheus renderer emits the standard
    cumulative ``_bucket{le=...}`` view.
    """

    kind = "histogram"

    def __init__(self, registry, name, help="",
                 buckets: Sequence[float] = DEFAULT_TIME_BUCKETS):
        super().__init__(registry, name, help)
        self.buckets: Tuple[float, ...] = tuple(sorted(float(b)
                                                       for b in buckets))
        if not self.buckets:
            raise ValueError(f"histogram {name!r} needs >= 1 bucket bound")

    def _make_series(self, labels):
        return _HistogramSeries(labels, len(self.buckets) + 1)

    def observe(self, v: float, **labels: str) -> None:
        if not self._registry._enabled:
            return
        (self.labels(**labels) if labels else self._unlabeled()).observe(v)

    def _unlabeled(self) -> _BoundMetric:
        return _BoundMetric(self, self._get_series({}))


class MetricsRegistry:
    """Process-wide metric family registry.

    ``enabled=False`` (the production default without the
    ``HOROVOD_METRICS*`` knobs) turns every value mutation into a
    near-free branch; creation/lookup still works so call sites can
    cache handles before the enable decision is made.
    """

    def __init__(self, enabled: bool = True):
        self._enabled = bool(enabled)
        self._lock = threading.Lock()
        self._metrics: Dict[str, Metric] = {}

    # -- lifecycle ----------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    def reset_values(self) -> None:
        """Zero every series (keep families + cached handles valid) —
        the test/bench isolation hook."""
        for m in self.metrics():
            m.reset_values()

    # -- creation -----------------------------------------------------------

    def _get_or_create(self, cls, name: str, help: str, **kw) -> Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(self, name, help, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_TIME_BUCKETS
                  ) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    # -- read side ----------------------------------------------------------

    def metrics(self) -> List[Metric]:
        with self._lock:
            return sorted(self._metrics.values(), key=lambda m: m.name)

    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    def value(self, name: str, **labels: str) -> float:
        """Current value of a counter/gauge series (0.0 when absent) —
        the read seam ``bench.py --chaos`` consumes."""
        m = self.get(name)
        if m is None or isinstance(m, Histogram):
            return 0.0
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with m._lock:
            s = m._series.get(key)
        if s is None:
            return 0.0
        with s._lock:
            return s.value

    def gauge_samples(self) -> List[Tuple[str, Dict[str, str], float]]:
        """``(name, labels, value)`` for every gauge series — the feed
        for the timeline's Chrome counter (``"ph":"C"``) events."""
        out = []
        for m in self.metrics():
            if not isinstance(m, Gauge):
                continue
            for s in m.series():
                with s._lock:
                    out.append((m.name, dict(s.labels), s.value))
        return out

    def snapshot(self) -> Dict:
        """JSON-able value snapshot: ``counters``/``gauges`` map series
        key → value; ``histograms`` map series key → bounds + per-bucket
        counts + sum/count.  Bounds ride every snapshot so merges can
        verify bucket compatibility."""
        counters: Dict[str, float] = {}
        gauges: Dict[str, float] = {}
        histograms: Dict[str, Dict] = {}
        for m in self.metrics():
            for s in m.series():
                key = series_key(m.name, s.labels)
                with s._lock:
                    if isinstance(m, Histogram):
                        histograms[key] = {
                            "bounds": list(m.buckets),
                            "counts": list(s.counts),
                            "sum": s.sum,
                            "count": s.count,
                        }
                    elif isinstance(m, Counter):
                        counters[key] = s.value
                    else:
                        gauges[key] = s.value
        return {"counters": counters, "gauges": gauges,
                "histograms": histograms}

    def counters_snapshot(self) -> Dict[str, float]:
        """Counters only — the compact payload that ranks exchange for
        aggregation (:func:`merge_counter_snapshots`)."""
        out: Dict[str, float] = {}
        for m in self.metrics():
            if not isinstance(m, Counter):
                continue
            for s in m.series():
                with s._lock:
                    out[series_key(m.name, s.labels)] = s.value
        return out


def merge_counter_snapshots(snaps: Iterable[Dict[str, float]]
                            ) -> Dict[str, float]:
    """Sum per-rank counter snapshots series-by-series — exact because
    counters are monotone sums and series keys are canonical."""
    out: Dict[str, float] = {}
    for snap in snaps:
        for k, v in snap.items():
            out[k] = out.get(k, 0.0) + v
    return out
