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
  in one pool window (at most ``raypool.raypool_frame_cap()`` frames, the
  ``TRC_RAYPOOL_FRAMES`` tier; its width ``TRC_RAYPOOL_WIDTH``, as the
  reference's), one pool-kernel launch per iteration and no host
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
``use_tlas``, ``quant``, ``bvh_builder`` and ``bvh_wide`` are the BVH
tiers, each ``None`` by default, which takes its environment tier as the
reference's worker does (``TRC_TLAS``, ``TRC_BVH_QUANT``,
``TRC_BVH_BUILDER``, ``TRC_BVH_WIDE``; ``integrator.resolve_bvh_config``),
resolved once per renderer or pool window, never per launch. ``use_tlas``
(default on) walks the instances of a field of more than a TLAS leaf
through the two-level (TLAS) variant of the mesh kernels, ``False`` through
the flat instance sweep; ``quant`` 1 or 2 reads quantized node tables (the
masked tier's images bit for bit the fp32 ones; the wavefront and the pool
then carry bf16 throughput); the builder and width shape the BLAS. The
TLAS tiers are environment tiers alone, as the reference worker's:
``TRC_TLAS_LEAF`` (instances a TLAS leaf, 1 to 16) and ``TRC_TLAS_BLOCK``
(the TLAS kernels' packet, 128, 256, 512 or 1,024 lanes) resolve beside the
BVH tiers (``integrator.resolve_tlas_config``) into the same renderer keys;
a launch at a packet other than 256 counts as ``..._tlas[p128]`` etc. The
scan takes the build tiers only.

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

A tiled work unit ``(frame, tile)`` (a job with a ``tiles`` grid) is
rendered on its tile's pixels only (``jobs.tiles.tile_bounds``), through
the region path of the tier the frame would take: the pool's region mode
(a window of the same tile of the job's queued frames; the cache is keyed
by job, frame and tile), ``render_region_wavefront``, or
``integrator.render_frame_region`` (the masked tier, and the scan with
``bounce_scan``). Each traces the whole frame's rays and random numbers
restricted to the tile, so the master's stitched frame equals the untiled
one (the scan's regions: statistically, as in the reference). A tile is
written as ``output_path_for_tile``, always PNG.

``sharding`` (``"tile"`` or ``"spp"``, default None) splits each whole
frame over the worker's mesh, every local card and, in a multi-host group
(``parallel.mesh.initialize_multihost``), the other processes' cards:
``parallel.sharded_render.render_frame_sharded``, tile bands or sample
subsets, each shard through the masked tier of its scene. As in the
reference, the wavefront and the ray pool are off under sharding, and a
tiled unit ``(frame, tile)`` bypasses it (the unit is already sub-frame
work) through the masked region path. The mesh is every local card, so
under sharding ``device`` may name only ``cuda`` or ``cpu``.

Rendering runs in a thread (``asyncio.to_thread``) so a worker's heartbeats
and queue RPCs stay responsive while a frame renders.
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
from tpu_render_cluster_torch.jobs.tiles import WorkUnit, tile_bounds
from tpu_render_cluster_torch.obs import get_registry, render_fps_gauge
from tpu_render_cluster_torch.parallel.sharded_render import MODES as SHARDING_MODES
from tpu_render_cluster_torch.parallel.sharded_render import render_frame_sharded
from tpu_render_cluster_torch.render.compaction import (
    WAVEFRONT_MODES,
    WavefrontLaunch,
    render_frame_wavefront,
    render_region_wavefront,
    wavefront_active,
)
from tpu_render_cluster_torch.render.image_io import (
    output_path_for_frame,
    output_path_for_tile,
    write_image,
)
from tpu_render_cluster_torch.render.integrator import (
    fused_frame_renderer,
    fused_region_renderer,
    resolve_bvh_config,
    tonemap,
)
from tpu_render_cluster_torch.render.raypool import (
    RAYPOOL_MODES,
    PoolLaunch,
    PoolStats,
    raypool_active,
    raypool_frame_cap,
    render_batch_raypool,
)
from tpu_render_cluster_torch.render.scene import scene_for_job_name
from tpu_render_cluster_torch.traces.worker_trace import FrameRenderTime
from tpu_render_cluster_torch.utils.paths import parse_with_base_directory_prefix
from tpu_render_cluster_torch.worker.backends.base import RenderBackend


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
        quant: int | None = None,
        bvh_builder: str | None = None,
        bvh_wide: int | None = None,
    ) -> None:
        if sharding is not None and sharding not in SHARDING_MODES:
            raise ValueError(f"sharding={sharding!r} is not one of {SHARDING_MODES} or None")
        if sharding is not None and device is not None and torch.device(device).index is not None:
            raise ValueError(
                f"sharding={sharding!r} renders on every local card: device={device!r} "
                "may name only 'cuda' or 'cpu'"
            )
        self.sharding = sharding
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
        self.quant = None if quant is None else int(quant)
        self.bvh_builder = bvh_builder
        self.bvh_wide = None if bvh_wide is None else int(bvh_wide)
        self.on_launch = on_launch
        self.on_iteration = on_iteration
        # Stored as the reference stores it; the backend does not read it.
        self.tile_size = tile_size
        # job name -> the work units of the job still queued on this worker.
        self._upcoming: dict[str, tuple[WorkUnit, ...]] = {}
        # (job name, frame, tile) -> linear image a pool window rendered ahead.
        self._raypool_cache: dict[tuple[str, int, int | None], torch.Tensor] = {}
        # The last pool windows' statistics (the reference also feeds them
        # to its obs registry, ``_emit_batch_obs``; the port does not yet).
        self.pool_stats: collections.deque[PoolStats] = collections.deque(maxlen=64)
        self.device = resolve_device(device)
        self.base_directory = Path(base_directory) if base_directory else None
        self.width = width
        self.height = height
        self.samples = samples
        self.max_bounces = max_bounces

    def tiers(self) -> dict:
        """The BVH tiers this backend renders with, resolved now
        (``integrator.resolve_bvh_config``: an option left None takes the
        environment's): ``use_tlas``, ``quant``, ``builder``, ``wide``."""
        return dict(zip(
            ("use_tlas", "quant", "builder", "wide"),
            resolve_bvh_config(self.use_tlas, self.quant, self.bvh_builder, self.bvh_wide),
        ))

    def _renderer(self, scene_name: str, region: tuple[int, int, int, int] | None = None):
        """``frame -> uint8 [H, W, 3]`` on the device (a region's [th, tw,
        3]), through the bounce scan or else the tier the ``wavefront``
        option picks for this scene (never under sharding); the BVH tiers
        resolved once, here, and the TLAS tiers by the renderer."""
        tiers = self.tiers()
        masked = (
            self.bounce_scan or self.sharding is not None
            or not wavefront_active(scene_name, mode=self.wavefront)
        )
        if masked and region is None:
            return fused_frame_renderer(
                scene_name, self.width, self.height, self.samples, self.max_bounces,
                self.device, bounce_scan=self.bounce_scan, per_instance=self.per_instance,
                **tiers,
            )
        if masked:
            y0, x0, tile_height, tile_width = region
            render_region = fused_region_renderer(
                scene_name, self.width, self.height, tile_height, tile_width, self.samples,
                self.max_bounces, self.device, bounce_scan=self.bounce_scan,
                per_instance=self.per_instance, **tiers,
            )
            return lambda frame: tonemap(render_region(frame, y0, x0))
        options = dict(
            width=self.width, height=self.height, samples=self.samples,
            max_bounces=self.max_bounces, device=self.device, on_launch=self.on_launch,
            **tiers,
        )
        if region is None:
            return lambda frame: tonemap(render_frame_wavefront(scene_name, frame, **options))
        y0, x0, tile_height, tile_width = region
        return lambda frame: tonemap(
            render_region_wavefront(
                scene_name, frame, y0=y0, x0=x0, tile_height=tile_height,
                tile_width=tile_width, **options,
            )
        )

    def note_upcoming_frames(self, job: BlenderJob, units) -> None:
        """The worker queue's hint: the units of ``job`` still queued on this
        worker, i.e. what a pool window may render ahead (for a tiled job:
        the same tile of other frames). Units are read by their
        ``frame_index`` and ``tile`` attributes (the queue's work units, of
        either package) or given as bare frame indices, whole frames. An
        empty hint drops the job."""
        if units:
            self._upcoming[job.job_name] = tuple(
                WorkUnit(unit) if isinstance(unit, int)
                else WorkUnit(unit.frame_index, getattr(unit, "tile", None))
                for unit in units
            )
        else:
            self._upcoming.pop(job.job_name, None)

    def warm(self, scene_name: str) -> None:
        """Build the kernels and render one frame through each tier the
        scene may take, outside any job window: the pool (where a queue
        would choose it) and the per-frame tier, which renders a job's last
        frame; under sharding one sharded frame.

        Accepts job names as well as scene names, resolving them exactly
        like the render path does.
        """
        scene_name = scene_for_job_name(scene_name)
        if self.sharding is not None:
            self._render_sharded(scene_name, 1).cpu()
            return
        if self._pools(scene_name, frames_ahead=1):
            self._render_window(scene_name, [1])[0].cpu()
        self._renderer(scene_name)(1).cpu()

    def _pools(self, scene_name: str, *, frames_ahead: int) -> bool:
        """Whether a frame with ``frames_ahead`` of its job queued behind it
        renders in a pool window (never under the bounce scan or sharding)."""
        return not self.bounce_scan and self.sharding is None and raypool_active(
            scene_name, mode=self.raypool, frames_ahead=frames_ahead
        )

    def _render_sharded(self, scene_name: str, frame_index: int) -> torch.Tensor:
        """One whole frame over the mesh (``render_frame_sharded``), linear."""
        return render_frame_sharded(
            scene_name, frame_index, width=self.width, height=self.height,
            samples=self.samples, max_bounces=self.max_bounces, mode=self.sharding,
            device=self.device, bounce_scan=self.bounce_scan, per_instance=self.per_instance,
            **self.tiers(),
        )

    def _render_window(
        self, scene_name: str, frames: list[int], region: tuple[int, int, int, int] | None = None
    ) -> list[torch.Tensor]:
        # The window's cap is the environment's (the node format's degrade
        # rule counts it, as the reference's); ``frames`` hold at most that.
        images, stats = render_batch_raypool(
            scene_name, frames, width=self.width, height=self.height, samples=self.samples,
            max_bounces=self.max_bounces, device=self.device,
            on_iteration=self.on_iteration, region=region, **self.tiers(),
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

    @staticmethod
    def _observe_render_obs(
        *, compile_seconds: float, execute_seconds: float, from_cache: bool = False
    ) -> None:
        """Feed the process-global obs registry (one GPU per process), as the
        reference's backend does (``tpu_raytrace._observe_render_obs``).

        ``render_compile_seconds`` is the loading phase (fetching, or first
        building, the renderer); ``render_execute_seconds`` the render phase
        (device time and the copy back). A frame served from the pool's
        cache only counts as a cache hit: its device time was spent in the
        window that rendered it ahead.
        """
        registry = get_registry()
        registry.histogram(
            "render_compile_seconds",
            "Per-frame compiled-renderer fetch/build (the 'loading' phase)",
        ).observe(max(0.0, compile_seconds))
        if from_cache:
            registry.counter(
                "render_raypool_cache_hits_total",
                "Frames served from the ray-pool rendered-ahead cache",
            ).inc()
            return
        registry.histogram(
            "render_execute_seconds",
            "Per-frame device render + readback (block-until-ready fenced)",
        ).observe(max(0.0, execute_seconds))
        if execute_seconds > 0:
            render_fps_gauge(registry).set(1.0 / execute_seconds)

    async def render_frame(
        self, job: BlenderJob, frame_index: int, tile: int | None = None
    ) -> FrameRenderTime:
        return await asyncio.to_thread(self._render_sync, job, frame_index, tile)

    def _render_sync(
        self, job: BlenderJob, frame_index: int, tile: int | None = None
    ) -> FrameRenderTime:
        started_process_at = time.time()
        scene_name = scene_for_job_name(job.job_name)
        region = None
        if tile is not None:
            if job.tile_grid is None:
                raise RuntimeError(
                    f"Tile {tile} requested but job {job.job_name!r} carries no tile grid."
                )
            region = tile_bounds(tile, job.tile_grid, width=self.width, height=self.height)
        cached = self._raypool_cache.pop((job.job_name, frame_index, tile), None)
        # A pool window: this unit and the job's next frames of the same
        # tile queued here, all this worker's own work, so nothing is
        # rendered speculatively.
        upcoming = [
            unit.frame_index
            for unit in self._upcoming.get(job.job_name, ())
            if unit.tile == tile
            and unit.frame_index != frame_index
            and (job.job_name, unit.frame_index, tile) not in self._raypool_cache
        ]
        use_raypool = cached is None and self._pools(scene_name, frames_ahead=len(upcoming))
        use_sharded = self.sharding is not None and region is None
        renderer = None
        if cached is None and not use_raypool and not use_sharded:
            renderer = self._renderer(scene_name, region)
        finished_loading_at = time.time()

        started_rendering_at = time.time()
        if cached is not None:
            display = tonemap(cached)
        elif use_sharded:
            display = tonemap(self._render_sharded(scene_name, frame_index))
        elif use_raypool:
            # The reference's window (tpu_raytrace.py:371): this unit and at
            # most cap - 1 queued ones.
            window = [frame_index] + upcoming[:raypool_frame_cap() - 1]
            images = self._render_window(scene_name, window, region)
            for ahead, image in zip(window[1:], images[1:]):
                self._raypool_cache[(job.job_name, ahead, tile)] = image
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
        if tile is None:
            path = output_path_for_frame(
                output_directory, job.output_file_name_format, job.output_file_format,
                frame_index,
            )
        else:
            # One file per tile, always PNG; the master's assembler stitches
            # the grid into the frame file in the job's format.
            path = output_path_for_tile(
                output_directory, job.output_file_name_format, job.output_file_format,
                frame_index, tile, job.tile_grid,
            )
        write_image(path, pixels, "PNG" if tile is not None else job.output_file_format)
        file_saving_finished_at = time.time()
        self._observe_render_obs(
            compile_seconds=finished_loading_at - started_process_at,
            execute_seconds=finished_rendering_at - started_rendering_at,
            from_cache=cached is not None,
        )
        return FrameRenderTime(
            started_process_at=started_process_at,
            finished_loading_at=finished_loading_at,
            started_rendering_at=started_rendering_at,
            finished_rendering_at=finished_rendering_at,
            file_saving_started_at=file_saving_started_at,
            file_saving_finished_at=file_saving_finished_at,
            exited_process_at=time.time(),
        )
