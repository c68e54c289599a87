"""The ``torch-raytrace`` render backend: the path tracer on a CUDA GPU.

Counterpart of ``tpu_render_cluster/worker/backends/tpu_raytrace.py`` for
whole frames, with four of its execution tiers:

- the masked tier: each frame is one call of the cached frame renderer
  (primary rays, the path trace, sample mean, tonemap). Sphere scenes and
  mesh scenes within the mesh megakernel's bound take one megakernel
  launch; deeper meshes (``03_physics-2-mesh``) take the per-bounce mesh
  kernel once per bounce, the rays re-sorted between bounces;
- the wavefront tier (``render/compaction.py``): per bounce the live rays
  are compacted, their count read back, and the per-bounce kernel
  relaunched over a bucket of them alone;
- the ray-pool tier (``render/raypool.py``): the frame asked for and the
  next frames of the same job still queued on this worker render together
  in one pool window, one pool-kernel launch per iteration and no host
  read inside it. The frames rendered ahead wait, linear, in a cache
  bounded at 64 MB, and their own requests only tonemap and save them;
- the per-bounce scan tier (``bounce_scan=True``, the reference's tier
  with Pallas off, ``TRC_PALLAS=0``): each frame through the cached frame
  renderer's per-sample branch, one ``_shade_bounce`` per bounce around
  four unit-kernel launches. It takes neither the wavefront nor the pool,
  whatever their options say, as the reference takes neither without
  Pallas. With ``per_instance=True`` as well, its two mesh queries walk the
  instances one by one, the reference's own structure there: one launch of
  the single-BVH unit kernels per instance (a check path; it claims no
  speed).

Otherwise the ``raypool`` and ``wavefront`` options choose as the
reference's do.
``raypool``: ``None`` or ``"auto"`` pools a deep-mesh job's frame when the
worker's queue hint (``note_upcoming_frames``, which the worker queue calls
before each frame) names at least one more frame of the job, ``"off"``
never, ``"force"`` every frame. Otherwise ``wavefront``: ``None`` or
``"auto"`` takes the wavefront for the scenes past the mesh megakernel's
bound, ``"off"`` never, ``"force"`` for every scene (sphere scenes then
through the per-bounce sphere kernel). ``on_launch``, when given, is
called with each wavefront launch (``compaction.WavefrontLaunch``),
``on_iteration`` with each pool launch (``raypool.PoolLaunch``).
``use_tlas`` goes to every mesh tier but the scan: ``None``, the
reference's default, walks the instances of a field of more than
``kernels.TLAS_LEAF`` through the two-level (TLAS) variant of the mesh
kernels, ``False`` through the flat instance sweep (the reference reads
this choice from ``TRC_TLAS``).

It emits the same 7-phase ``FrameRenderTime``:

- started_process/finished_loading: fetching (first: building) the cached
  renderer for the scene and config;
- started/finished_rendering: the frame on the device, ending after the
  copy of the pixels back to the host;
- file_saving: PNG/JPEG encode + atomic write;
- exited_process: after the output file is on disk.

A frame served from the pool's cache spends its render phase on the
tonemap and the copy back; the window's device time was spent in the
render phase of the frame that started it.

Rendering runs in a thread (``asyncio.to_thread``) so a worker's heartbeats
and queue RPCs stay responsive while a frame renders. Tiles and local
sharding wait for later slices of the port and raise
``NotImplementedError`` instead of rendering anything in their place.
"""

from __future__ import annotations

import asyncio
import collections
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
from tpu_render_cluster_torch.render.raypool import (
    RAYPOOL_FRAMES,
    RAYPOOL_MODES,
    PoolLaunch,
    PoolStats,
    raypool_active,
    render_batch_raypool,
)
from tpu_render_cluster_torch.render.scene import scene_for_job_name
from tpu_render_cluster_torch.traces.worker_trace import FrameRenderTime
from tpu_render_cluster_torch.utils.paths import parse_with_base_directory_prefix
from tpu_render_cluster_torch.worker.backends.base import RenderBackend

_LATER_SLICES = {
    "tile_size": "the tiles slice (ROADMAP.md, queue 1)",
    "sharding": "the multi-GPU slice (ROADMAP.md, queue 1)",
}


class TorchRaytraceBackend(RenderBackend):
    # A bound on stale entries, not a working set: the frames of a window
    # are asked for within the window, so what pushes the cache past this
    # is frames rendered ahead and then stolen or removed.
    _RAYPOOL_CACHE_MAX_BYTES = 64 * 1024 * 1024

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
        on_iteration: Callable[[PoolLaunch], None] | None = None,
        bounce_scan: bool = False,
        per_instance: bool = False,
        use_tlas: bool | None = None,
    ) -> None:
        requested = dict(tile_size=tile_size, sharding=sharding)
        for option, value in requested.items():
            if value is not None:
                raise NotImplementedError(
                    f"{option}={value!r} is not ported yet; it arrives with "
                    f"{_LATER_SLICES[option]}."
                )
        if wavefront is not None and wavefront not in WAVEFRONT_MODES:
            raise ValueError(f"wavefront={wavefront!r} is not one of {WAVEFRONT_MODES}")
        if raypool is not None and raypool not in RAYPOOL_MODES:
            raise ValueError(f"raypool={raypool!r} is not one of {RAYPOOL_MODES}")
        self.wavefront = wavefront
        self.raypool = raypool
        if per_instance and not bounce_scan:
            raise ValueError("per_instance=True needs bounce_scan=True")
        self.bounce_scan = bool(bounce_scan)
        self.per_instance = bool(per_instance)
        self.use_tlas = None if use_tlas is None else bool(use_tlas)
        self.on_launch = on_launch
        self.on_iteration = on_iteration
        # job name -> the frames of the job still queued on this worker.
        self._upcoming: dict[str, tuple[int, ...]] = {}
        # (job name, frame) -> linear image a pool window rendered ahead.
        self._raypool_cache: dict[tuple[str, int], torch.Tensor] = {}
        # The last pool windows' statistics, until the port's obs registry
        # carries them.
        self.pool_stats: collections.deque[PoolStats] = collections.deque(maxlen=64)
        self.device = resolve_device(device)
        self.base_directory = Path(base_directory) if base_directory else None
        self.width = width
        self.height = height
        self.samples = samples
        self.max_bounces = max_bounces

    def _renderer(self, scene_name: str):
        """``frame -> uint8 [H, W, 3]`` on the device, through the bounce
        scan or else the tier the ``wavefront`` option picks for this scene."""
        if self.bounce_scan or not wavefront_active(scene_name, mode=self.wavefront):
            return fused_frame_renderer(
                scene_name, self.width, self.height, self.samples, self.max_bounces,
                self.device, bounce_scan=self.bounce_scan, per_instance=self.per_instance,
                use_tlas=self.use_tlas,
            )

        def render(frame: int):
            return tonemap(
                render_frame_wavefront(
                    scene_name, frame, width=self.width, height=self.height,
                    samples=self.samples, max_bounces=self.max_bounces, device=self.device,
                    on_launch=self.on_launch, use_tlas=self.use_tlas,
                )
            )

        return render

    def note_upcoming_frames(self, job: BlenderJob, units) -> None:
        """The worker queue's hint: the units of ``job`` still queued on this
        worker, i.e. what a pool window may render ahead. Units are read by
        their ``frame_index`` and ``tile`` attributes (the queue's work
        units) or given as bare frame indices; tiled units are left to the
        tiles slice. An empty hint drops the job."""
        frames = tuple(
            unit if isinstance(unit, int) else unit.frame_index
            for unit in units
            if isinstance(unit, int) or getattr(unit, "tile", None) is None
        )
        if frames:
            self._upcoming[job.job_name] = frames
        else:
            self._upcoming.pop(job.job_name, None)

    def warm(self, scene_name: str) -> None:
        """Build the kernels and render one frame through each tier the
        scene may take, outside any job window: the pool (where a queue
        would choose it) and the per-frame tier, which renders a job's last
        frame.

        Accepts job names as well as scene names, resolving them exactly
        like the render path does.
        """
        scene_name = scene_for_job_name(scene_name)
        if self._pools(scene_name, frames_ahead=1):
            self._render_window(scene_name, [1])[0].cpu()
        self._renderer(scene_name)(1).cpu()

    def _pools(self, scene_name: str, *, frames_ahead: int) -> bool:
        """Whether a frame with ``frames_ahead`` of its job queued behind it
        renders in a pool window (never under the bounce scan)."""
        return not self.bounce_scan and raypool_active(
            scene_name, mode=self.raypool, frames_ahead=frames_ahead
        )

    def _render_window(self, scene_name: str, frames: list[int]) -> list[torch.Tensor]:
        images, stats = render_batch_raypool(
            scene_name, frames, width=self.width, height=self.height, samples=self.samples,
            max_bounces=self.max_bounces, frame_cap=len(frames), device=self.device,
            on_iteration=self.on_iteration, use_tlas=self.use_tlas,
        )
        self.pool_stats.extend(stats)
        return images

    def _trim_raypool_cache(self) -> None:
        """Drop the oldest rendered-ahead frames past the byte bound."""
        excess = sum(
            image.numel() * image.element_size() for image in self._raypool_cache.values()
        ) - self._RAYPOOL_CACHE_MAX_BYTES
        while self._raypool_cache and excess > 0:
            victim = self._raypool_cache.pop(next(iter(self._raypool_cache)))
            excess -= victim.numel() * victim.element_size()

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
        scene_name = scene_for_job_name(job.job_name)
        cached = self._raypool_cache.pop((job.job_name, frame_index), None)
        # A pool window: this frame and the job's next frames queued here,
        # all this worker's own work, so nothing is rendered speculatively.
        upcoming = [
            frame
            for frame in self._upcoming.get(job.job_name, ())
            if frame != frame_index and (job.job_name, frame) not in self._raypool_cache
        ]
        use_raypool = cached is None and self._pools(scene_name, frames_ahead=len(upcoming))
        renderer = None
        if cached is None and not use_raypool:
            renderer = self._renderer(scene_name)
        finished_loading_at = time.time()

        started_rendering_at = time.time()
        if cached is not None:
            display = tonemap(cached)
        elif use_raypool:
            window = [frame_index] + upcoming[:RAYPOOL_FRAMES - 1]
            images = self._render_window(scene_name, window)
            for ahead, image in zip(window[1:], images[1:]):
                self._raypool_cache[(job.job_name, ahead)] = image
            self._trim_raypool_cache()
            display = tonemap(images[0])
        else:
            display = renderer(frame_index)
        pixels = display.cpu().numpy()  # waits for the device
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
