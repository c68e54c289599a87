"""The ``torch-raytrace`` render backend: the path tracer on a CUDA GPU.

Counterpart of ``tpu_render_cluster/worker/backends/tpu_raytrace.py`` for
whole frames, with two of its execution tiers:

- the masked tier: each frame is one call of the cached frame renderer
  (primary rays, the path trace, sample mean, tonemap). Sphere scenes and
  mesh scenes within the mesh megakernel's bound take one megakernel
  launch; deeper meshes (``03_physics-2-mesh``) take the per-bounce mesh
  kernel once per bounce, the rays re-sorted between bounces;
- the wavefront tier (``render/compaction.py``): per bounce the live rays
  are compacted, their count read back, and the per-bounce kernel
  relaunched over a bucket of them alone.

The ``wavefront`` option chooses between them as the reference's does:
``None`` or ``"auto"`` takes the wavefront for the scenes past the mesh
megakernel's bound, ``"off"`` never, ``"force"`` for every scene (sphere
scenes then through the per-bounce sphere kernel). Where the reference's
auto would pick its ray pool instead (a multi-frame queue of a deep-mesh
job), the port takes the wavefront until the ray-pool slice lands. The
tier is chosen once per scene. ``on_launch``, when given, is called with
each wavefront launch (``compaction.WavefrontLaunch``).

It emits the same 7-phase ``FrameRenderTime``:

- started_process/finished_loading: fetching (first: building) the cached
  renderer for the scene and config;
- started/finished_rendering: the frame on the device, ending after the
  copy of the pixels back to the host;
- file_saving: PNG/JPEG encode + atomic write;
- exited_process: after the output file is on disk.

Rendering runs in a thread (``asyncio.to_thread``) so a worker's heartbeats
and queue RPCs stay responsive while a frame renders. Tiles, local sharding
and ray-pool execution wait for later slices of the port and raise
``NotImplementedError`` instead of rendering anything in their place.
"""

from __future__ import annotations

import asyncio
import time
from pathlib import Path
from typing import Callable

import torch

from tpu_render_cluster_torch import resolve_device
from tpu_render_cluster_torch.jobs.models import BlenderJob
from tpu_render_cluster_torch.render.image_io import output_path_for_frame, write_image
from tpu_render_cluster_torch.render.compaction import (
    WAVEFRONT_MODES,
    WavefrontLaunch,
    render_frame_wavefront,
    wavefront_active,
)
from tpu_render_cluster_torch.render.integrator import fused_frame_renderer, tonemap
from tpu_render_cluster_torch.render.scene import scene_for_job_name
from tpu_render_cluster_torch.traces.worker_trace import FrameRenderTime
from tpu_render_cluster_torch.utils.paths import parse_with_base_directory_prefix
from tpu_render_cluster_torch.worker.backends.base import RenderBackend

_LATER_SLICES = {
    "tile_size": "the tiles slice (ROADMAP.md, queue 1)",
    "sharding": "the multi-GPU slice (ROADMAP.md, queue 1)",
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
        on_launch: Callable[[WavefrontLaunch], None] | None = None,
    ) -> None:
        requested = dict(tile_size=tile_size, sharding=sharding, raypool=raypool)
        for option, value in requested.items():
            if value is not None:
                raise NotImplementedError(
                    f"{option}={value!r} is not ported yet; it arrives with "
                    f"{_LATER_SLICES[option]}."
                )
        if wavefront is not None and wavefront not in WAVEFRONT_MODES:
            raise ValueError(f"wavefront={wavefront!r} is not one of {WAVEFRONT_MODES}")
        self.wavefront = wavefront
        self.on_launch = on_launch
        self.device = resolve_device(device)
        self.base_directory = Path(base_directory) if base_directory else None
        self.width = width
        self.height = height
        self.samples = samples
        self.max_bounces = max_bounces

    def _renderer(self, scene_name: str):
        """``frame -> uint8 [H, W, 3]`` on the device, through the tier the
        ``wavefront`` option picks for this scene."""
        if not wavefront_active(scene_name, mode=self.wavefront):
            return fused_frame_renderer(
                scene_name, self.width, self.height, self.samples, self.max_bounces,
                self.device,
            )

        def render(frame: int):
            return tonemap(
                render_frame_wavefront(
                    scene_name, frame, width=self.width, height=self.height,
                    samples=self.samples, max_bounces=self.max_bounces, device=self.device,
                    on_launch=self.on_launch,
                )
            )

        return render

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
