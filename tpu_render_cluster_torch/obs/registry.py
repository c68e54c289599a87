"""Dependency-free in-process metrics registry (the port's own copy).

The live counterpart of the frozen ``traces/`` dataclasses: counters,
gauges, and fixed-log-bucket histograms, all label-aware and thread-safe,
queryable at any point while a job runs. The paper's whole contribution is
*measured* cluster behavior; this registry is the substrate every layer
(master, worker, transport, render) reports into, replacing the ad-hoc
module-global counters that used to be sprinkled through the scheduler.

Design constraints:

- zero dependencies (stdlib only) so the worker process and the render
  backend can share it;
- one lock per registry (metric mutation is a dict update + float add —
  far below contention at cluster event rates, and a single lock keeps
  ``snapshot()`` consistent);
- histograms use FIXED log-scale bucket bounds shared by every process,
  so per-worker histograms shipped over the heartbeat wire
  (``to_wire``; the master's ``merge_wire``) merge bucket-by-bucket
  without resampling.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Iterable, Mapping

__all__ = [
    "MetricsRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "DEFAULT_BUCKETS",
    "log_buckets",
]


def log_buckets(
    start: float = 1e-4, stop: float = 1e3, per_decade: int = 3
) -> tuple[float, ...]:
    """Fixed log-scale bucket upper bounds from ``start`` to ``stop``.

    ``per_decade`` bounds per factor of 10, inclusive of both endpoints.
    The final +inf bucket is implicit (every histogram stores one extra
    overflow count).
    """
    lo = math.log10(start)
    hi = math.log10(stop)
    steps = round((hi - lo) * per_decade)
    return tuple(10.0 ** (lo + i / per_decade) for i in range(steps + 1))


# 100 µs .. 1000 s at 3 buckets/decade: covers WS round-trips, frame
# phases, and whole-job durations with one shared shape (22 bounds).
DEFAULT_BUCKETS = log_buckets(1e-4, 1e3, 3)


def _label_key(
    label_names: tuple[str, ...], labels: Mapping[str, Any]
) -> tuple[str, ...]:
    if set(labels) != set(label_names):
        raise ValueError(
            f"Expected labels {label_names}, got {tuple(sorted(labels))}"
        )
    return tuple(str(labels[name]) for name in label_names)


class _Metric:
    """Base: one named metric with zero or more label dimensions."""

    kind = "metric"

    def __init__(self, name: str, help: str, label_names: tuple[str, ...], lock):
        self.name = name
        self.help = help
        self.label_names = label_names
        self._lock = lock
        self._series: dict[tuple[str, ...], Any] = {}

    def _series_items(self) -> list[tuple[tuple[str, ...], Any]]:
        with self._lock:
            return list(self._series.items())


class Counter(_Metric):
    """Monotonically increasing float."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        if amount < 0:
            raise ValueError("Counters only go up.")
        key = _label_key(self.label_names, labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels: Any) -> float:
        key = _label_key(self.label_names, labels)
        with self._lock:
            return self._series.get(key, 0.0)


class Gauge(_Metric):
    """Point-in-time float; set/add from any thread."""

    kind = "gauge"

    def set(self, value: float, **labels: Any) -> None:
        key = _label_key(self.label_names, labels)
        with self._lock:
            self._series[key] = float(value)

    def add(self, amount: float, **labels: Any) -> None:
        key = _label_key(self.label_names, labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels: Any) -> float:
        key = _label_key(self.label_names, labels)
        with self._lock:
            return self._series.get(key, 0.0)


class _HistogramSeries:
    __slots__ = ("counts", "overflow", "count", "sum", "min", "max")

    def __init__(self, n_buckets: int) -> None:
        self.counts = [0] * n_buckets
        self.overflow = 0
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf


class Histogram(_Metric):
    """Fixed-bound histogram (log-scale by default) with sum/count/min/max."""

    kind = "histogram"

    def __init__(self, name, help, label_names, lock, buckets: tuple[float, ...]):
        super().__init__(name, help, label_names, lock)
        if list(buckets) != sorted(buckets):
            raise ValueError("Histogram bounds must be sorted ascending.")
        self.buckets = tuple(float(b) for b in buckets)

    def _series_items(self) -> list[tuple[tuple[str, ...], Any]]:
        # Histogram series are mutable; exports must copy their fields
        # under the lock or a concurrent observe() between counts[i] += 1
        # and count += 1 yields a snapshot where sum(buckets) != count.
        with self._lock:
            out = []
            for key, series in self._series.items():
                copy = _HistogramSeries(len(self.buckets))
                copy.counts = list(series.counts)
                copy.overflow = series.overflow
                copy.count = series.count
                copy.sum = series.sum
                copy.min = series.min
                copy.max = series.max
                out.append((key, copy))
            return out

    def observe(self, value: float, **labels: Any) -> None:
        value = float(value)
        key = _label_key(self.label_names, labels)
        with self._lock:
            series = self._series.get(key)
            if series is None:
                series = self._series[key] = _HistogramSeries(len(self.buckets))
            # First bound with value <= bound (linear scan: 22 bounds, and
            # observation rates are per-frame / per-message, not per-ray).
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    series.counts[i] += 1
                    break
            else:
                series.overflow += 1
            series.count += 1
            series.sum += value
            series.min = min(series.min, value)
            series.max = max(series.max, value)

    def series(self, **labels: Any) -> _HistogramSeries | None:
        key = _label_key(self.label_names, labels)
        with self._lock:
            return self._series.get(key)


class MetricsRegistry:
    """A named set of metrics; get-or-create accessors are idempotent."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    # -- get-or-create -------------------------------------------------------

    def _get_or_create(self, cls, name: str, help: str, labels, **kwargs):
        label_names = tuple(labels)
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls) or existing.label_names != label_names:
                    raise ValueError(
                        f"Metric {name!r} already registered as "
                        f"{existing.kind}{existing.label_names}"
                    )
                # Bucket shape is part of a histogram's identity: silently
                # returning one with different bounds would file the second
                # caller's observations into buckets it never asked for.
                buckets = kwargs.get("buckets")
                if buckets is not None and existing.buckets != tuple(
                    float(b) for b in buckets
                ):
                    raise ValueError(
                        f"Histogram {name!r} already registered with bounds "
                        f"{existing.buckets}"
                    )
                return existing
            metric = cls(name, help, label_names, self._lock, **kwargs)
            self._metrics[name] = metric
            return metric

    def counter(
        self, name: str, help: str = "", labels: Iterable[str] = ()
    ) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", labels: Iterable[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(
        self,
        name: str,
        help: str = "",
        labels: Iterable[str] = (),
        buckets: tuple[float, ...] = DEFAULT_BUCKETS,
    ) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels, buckets=buckets)

    # -- export --------------------------------------------------------------

    def snapshot(self) -> dict[str, Any]:
        """Full JSON-able view: one entry per metric, series keyed by labels."""
        with self._lock:
            metrics = list(self._metrics.values())
        out: dict[str, Any] = {}
        for metric in metrics:
            series_out = {}
            for key, value in metric._series_items():
                label_str = ",".join(
                    f"{n}={v}" for n, v in zip(metric.label_names, key)
                )
                if isinstance(value, _HistogramSeries):
                    series_out[label_str] = {
                        "count": value.count,
                        "sum": value.sum,
                        "min": value.min if value.count else None,
                        "max": value.max if value.count else None,
                        "bucket_counts": list(value.counts) + [value.overflow],
                    }
                else:
                    series_out[label_str] = value
            entry: dict[str, Any] = {
                "type": metric.kind,
                "help": metric.help,
                "labels": list(metric.label_names),
                "series": series_out,
            }
            if isinstance(metric, Histogram):
                entry["bucket_bounds"] = list(metric.buckets)
            out[metric.name] = entry
        return out

    # -- compact wire form (heartbeat payload) -------------------------------

    def to_wire(self) -> dict[str, Any]:
        """Compact form for the heartbeat's optional metrics payload.

        ``{"c": {...}, "g": {...}, "h": {...}}`` keyed by
        ``name|label=value,...``; histogram entries carry their bounds so
        the master can verify shape compatibility before merging.
        """
        with self._lock:
            metrics = list(self._metrics.values())
        counters: dict[str, float] = {}
        gauges: dict[str, float] = {}
        histograms: dict[str, dict[str, Any]] = {}
        for metric in metrics:
            for key, value in metric._series_items():
                label_str = ",".join(
                    f"{n}={v}" for n, v in zip(metric.label_names, key)
                )
                wire_key = f"{metric.name}|{label_str}" if label_str else metric.name
                if metric.kind == "counter":
                    counters[wire_key] = value
                elif metric.kind == "gauge":
                    gauges[wire_key] = value
                else:
                    histograms[wire_key] = {
                        "n": value.count,
                        "s": value.sum,
                        "min": value.min if value.count else None,
                        "max": value.max if value.count else None,
                        "le": list(metric.buckets),
                        "b": list(value.counts) + [value.overflow],
                    }
        return {"c": counters, "g": gauges, "h": histograms}

