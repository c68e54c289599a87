"""Render backends of the port: ``torch-raytrace``, the GPU path tracer, and
``mock``, the sleep-based fake renderer. Both emit the same 7-phase
``FrameRenderTime`` traces as the reference's backends."""

from __future__ import annotations

from tpu_render_cluster_torch.worker.backends.base import RenderBackend


def create_backend(name: str, **kwargs) -> RenderBackend:
    if name == "torch-raytrace":
        from tpu_render_cluster_torch.worker.backends.torch_raytrace import (
            TorchRaytraceBackend,
        )

        return TorchRaytraceBackend(**kwargs)
    if name == "mock":
        from tpu_render_cluster_torch.worker.backends.mock import MockBackend

        return MockBackend()
    raise ValueError(f"Unknown render backend: {name!r}")


__all__ = ["RenderBackend", "create_backend"]
