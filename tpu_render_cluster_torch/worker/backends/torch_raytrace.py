"""The ``torch-raytrace`` render backend: the path tracer on a CUDA GPU.

Counterpart of ``tpu_render_cluster/worker/backends/tpu_raytrace.py`` for
its whole-frame masked tier: each frame is one call of the cached frame
renderer (primary rays, one megakernel launch, sample mean, tonemap), for
sphere scenes and for mesh scenes within the mesh megakernel's bound. A
deeper mesh job (``03_physics-2-mesh``) raises ``NotImplementedError`` when
its renderer is built, in ``warm`` or before its first frame renders. It
emits the same 7-phase ``FrameRenderTime``:

- started_process/finished_loading: fetching (first: building) the cached
  renderer for the scene and config;
- started/finished_rendering: the frame on the device, ending after the
  copy of the pixels back to the host;
- file_saving: PNG/JPEG encode + atomic write;
- exited_process: after the output file is on disk.

Rendering runs in a thread (``asyncio.to_thread``) so a worker's heartbeats
and queue RPCs stay responsive while a frame renders. Tiles, local sharding,
wavefront and ray-pool execution wait for later slices of the port and
raise ``NotImplementedError`` instead of rendering anything in their place.
"""

from __future__ import annotations

import asyncio
import time
from pathlib import Path

import torch

from tpu_render_cluster_torch import resolve_device
from tpu_render_cluster_torch.jobs.models import BlenderJob
from tpu_render_cluster_torch.render.image_io import output_path_for_frame, write_image
from tpu_render_cluster_torch.render.integrator import fused_frame_renderer
from tpu_render_cluster_torch.render.scene import scene_for_job_name
from tpu_render_cluster_torch.traces.worker_trace import FrameRenderTime
from tpu_render_cluster_torch.utils.paths import parse_with_base_directory_prefix
from tpu_render_cluster_torch.worker.backends.base import RenderBackend

_LATER_SLICES = {
    "tile_size": "the tiles slice (ROADMAP.md, queue 1)",
    "sharding": "the multi-GPU slice (ROADMAP.md, queue 1)",
    "wavefront": "the wavefront slice (ROADMAP.md, queue 1)",
    "raypool": "the ray-pool slice (ROADMAP.md, queue 1)",
}


class TorchRaytraceBackend(RenderBackend):
    def __init__(
        self,
        *,
        width: int = 512,
        height: int = 512,
        samples: int = 8,
        max_bounces: int = 4,
        device: str | torch.device | None = None,
        base_directory: str | Path | None = None,
        tile_size: int | None = None,
        sharding: str | None = None,
        wavefront: str | None = None,
        raypool: str | None = None,
    ) -> None:
        requested = dict(
            tile_size=tile_size, sharding=sharding, wavefront=wavefront, raypool=raypool
        )
        for option, value in requested.items():
            if value is not None:
                raise NotImplementedError(
                    f"{option}={value!r} is not ported yet; it arrives with "
                    f"{_LATER_SLICES[option]}."
                )
        self.device = resolve_device(device)
        self.base_directory = Path(base_directory) if base_directory else None
        self.width = width
        self.height = height
        self.samples = samples
        self.max_bounces = max_bounces

    def _renderer(self, scene_name: str):
        return fused_frame_renderer(
            scene_name, self.width, self.height, self.samples, self.max_bounces,
            self.device,
        )

    def warm(self, scene_name: str) -> None:
        """Build the kernel and render one frame, outside any job window.

        Accepts job names as well as scene names, resolving them exactly
        like the render path does.
        """
        self._renderer(scene_for_job_name(scene_name))(1).cpu()

    async def render_frame(
        self, job: BlenderJob, frame_index: int, tile: int | None = None
    ) -> FrameRenderTime:
        return await asyncio.to_thread(self._render_sync, job, frame_index, tile)

    def _render_sync(
        self, job: BlenderJob, frame_index: int, tile: int | None = None
    ) -> FrameRenderTime:
        if tile is not None:
            raise NotImplementedError(
                f"Tile {tile} of job {job.job_name!r}: tiled work units are not "
                f"ported yet; they arrive with {_LATER_SLICES['tile_size']}."
            )
        started_process_at = time.time()
        renderer = self._renderer(scene_for_job_name(job.job_name))
        finished_loading_at = time.time()

        started_rendering_at = time.time()
        pixels = renderer(frame_index).cpu().numpy()  # waits for the device
        finished_rendering_at = time.time()

        file_saving_started_at = time.time()
        output_directory = parse_with_base_directory_prefix(
            job.output_directory_path, self.base_directory
        )
        path = output_path_for_frame(
            output_directory,
            job.output_file_name_format,
            job.output_file_format,
            frame_index,
        )
        write_image(path, pixels, job.output_file_format)
        file_saving_finished_at = time.time()
        return FrameRenderTime(
            started_process_at=started_process_at,
            finished_loading_at=finished_loading_at,
            started_rendering_at=started_rendering_at,
            finished_rendering_at=finished_rendering_at,
            file_saving_started_at=file_saving_started_at,
            file_saving_finished_at=file_saving_finished_at,
            exited_process_at=time.time(),
        )
