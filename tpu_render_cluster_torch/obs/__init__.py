"""Worker observability: live metrics and span tracing (the port's own copy).

- ``registry`` — thread-safe counters / gauges / log-bucket histograms
  with labels; compact wire form for the heartbeat metrics payload.
- ``tracer`` — spans (wall-clock anchor + monotonic duration) exported as
  Chrome trace-event JSON, loadable in Perfetto / chrome://tracing.
- ``loopmon`` — the event-loop lag probe.
- ``snapshot`` — atomic JSON snapshots of a registry.

``get_registry()`` returns the process-global registry that process-scoped
subsystems (the render backend) feed; a worker process ships it on its
heartbeats. Reference:
``tpu_render_cluster/obs/__init__.py``.
"""

from __future__ import annotations

from tpu_render_cluster_torch.obs.loopmon import LoopLagMonitor
from tpu_render_cluster_torch.obs.registry import Gauge, MetricsRegistry
from tpu_render_cluster_torch.obs.snapshot import write_metrics_snapshot
from tpu_render_cluster_torch.obs.tracer import Tracer, export_chrome_trace

__all__ = [
    "LoopLagMonitor",
    "MetricsRegistry",
    "Tracer",
    "export_chrome_trace",
    "get_registry",
    "render_fps_gauge",
    "write_metrics_snapshot",
]

_global_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-global registry (the render backend, the worker)."""
    return _global_registry


def render_fps_gauge(registry: MetricsRegistry | None = None) -> Gauge:
    """The frames/s gauge the render backend feeds (one definition site, so
    its name and help cannot drift from the reference's)."""
    registry = registry if registry is not None else get_registry()
    return registry.gauge(
        "render_frames_per_second",
        "Instantaneous device throughput (1 / execute_seconds)",
    )
