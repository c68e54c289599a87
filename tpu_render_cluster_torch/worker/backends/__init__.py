"""Render backends of the port: ``torch-raytrace``, the GPU path tracer."""

from __future__ import annotations

from tpu_render_cluster_torch.worker.backends.base import RenderBackend

__all__ = ["RenderBackend"]
