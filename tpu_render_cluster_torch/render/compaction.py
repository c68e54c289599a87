"""Wavefront path tracing: active-ray compaction and bucketed relaunch.

Port of ``tpu_render_cluster/render/compaction.py``'s host-driven tier.
The masked loops march every lane through every bounce; this driver, after
each bounce, compacts the live rays to the front, reads the live count back
(one device sync per bounce), rounds it up to a bucket of a power-of-two
ladder, and relaunches the per-bounce kernel over the bucket alone.
Radiance scatters back through the carried original lane ids, which also
key the kernels' RNG, so a ray's stream is the one it has in the masked
loop or the megakernel, and the images agree ray for ray. A region (one
tile of a frame, ``render_region_wavefront``) carries its rays' whole-frame
lanes beside the local ones, as the RNG counters, so a stitched grid of
regions equals the whole-frame wavefront image.

Sphere scenes compact with a stable partition (the sphere kernel culls no
packets); mesh scenes with a coherence sort whose dead flag parks the dead
lanes at the tail, so one gather buys both the partition and packet
coherence: under the mesh kernels' TLAS variant (the default) a stable
argsort of the key column the previous launch wrote (bounce 0:
``kernels.initial_mesh_sort_keys``), under the flat variant the
integrator's ``ray_sort_key`` with its ``[R, K]`` broadphase each bounce.

The reference's occupancy gauges, survival histograms and per-bounce spans
come with the port of its ``obs`` package. Until then a caller may pass
``on_launch`` to see each launch: its bounce, live count, bucket and input
state.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch

from tpu_render_cluster_torch import resolve_device
from tpu_render_cluster_torch.render import kernels
from tpu_render_cluster_torch.render.camera import scene_camera
from tpu_render_cluster_torch.render.integrator import (
    _ray_sort_order,
    frame_rays_and_seed,
    region_rays_and_seed,
    resolve_bvh_config,
    resolve_tlas_config,
)
from tpu_render_cluster_torch.render.mesh import MeshSet, scene_mesh_set
from tpu_render_cluster_torch.render.scene import Scene, build_scene

# The bucket quantum of sphere scenes: the per-bounce kernels' thread block.
BUCKET_BLOCK = 256
# The flat mesh variant's quantum: the reference's ray block (BVH_BLOCK_R);
# the TLAS variant's is its packet (the resolved TRC_TLAS_BLOCK tier).
FLAT_MESH_BUCKET_BLOCK = 1024


class WavefrontLaunch(NamedTuple):
    """One bounce's launch: its ``live`` rays padded with dead ones to
    ``bucket`` lanes, and the kernel's inputs (the compacted state)."""

    bounce: int
    live: int
    bucket: int
    state: tuple  # (origins, directions, throughput, alive, lane: the RNG counters)


def bucket_for(live: int, cap: int, block: int) -> int:
    """Smallest power-of-two multiple of ``block`` >= ``live``, <= ``cap``."""
    size = block
    while size < live:
        size *= 2
    return min(size, cap)


def compaction_order(alive: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable partition through prefix sums: (perm, live) with
    ``x[perm]`` holding the alive lanes in their order, then the dead ones
    in theirs; ``live`` stays on the device."""
    alive_i = alive.to(torch.int64)
    live = alive_i.sum()
    front = torch.cumsum(alive_i, 0) - 1
    back = live + torch.cumsum(1 - alive_i, 0) - 1
    n = alive.shape[0]
    perm = torch.empty(n, dtype=torch.int64, device=alive.device)
    perm[torch.where(alive, front, back)] = torch.arange(n, device=alive.device)
    return perm, live


def compact(origins, directions, throughput, alive, lane, mesh, keys=None):
    """The state reordered (live lanes first) by one packed gather, and the
    device count of live lanes. ``keys`` (the TLAS variant's key column):
    the order is their stable argsort (the reference's
    ``_compact_mesh_keyed``). ``throughput`` is carried as it comes: [R, 3]
    float32, or the quantized tiers' [R, 2] bf16 words
    (``kernels.pack_throughput_bf16``), one column fewer in the gather."""
    if keys is not None:
        order = torch.argsort(keys, stable=True)
        live = alive.sum()
    elif mesh is None:
        order, live = compaction_order(alive)
    else:
        order = _ray_sort_order(origins, directions, alive, mesh)
        live = alive.sum()
    packed = torch.cat([origins, directions, throughput], dim=1)[order]
    return (
        packed[:, 0:3], packed[:, 3:6], packed[:, 6:], alive[order], lane[order], live
    )


def trace_paths_wavefront(
    scene: Scene,
    origins: torch.Tensor,
    directions: torch.Tensor,
    seed: int,
    *,
    max_bounces: int,
    mesh: MeshSet | None = None,
    on_launch: Callable[[WavefrontLaunch], None] | None = None,
    use_tlas: bool | None = None,
    rng_lanes: torch.Tensor | None = None,
    quant: int | None = None,
) -> torch.Tensor:
    """Trace one sample per ray, wavefront-style; radiance [R, 3].

    Per bounce: compact, read the live count, round it up to a bucket,
    launch ``kernels.mesh_bounce`` (or ``sphere_bounce`` without a mesh)
    over the bucket, and add the contribution into each ray's original
    lane. An all-dead wavefront ends the loop. ``on_launch``, when given,
    is called with each launch before it runs. ``use_tlas`` (None:
    ``kernels.use_tlas_for`` at the mesh's leaf) picks the mesh kernel's
    variant and, with it, the compaction's key and the bucket quantum (the
    TLAS kernel's packet, the ``TRC_TLAS_BLOCK`` tier, else
    ``FLAT_MESH_BUCKET_BLOCK``; the reference's ``compaction.py:345-352``). ``rng_lanes`` (int32 [R]): each
    ray's RNG counter (a region's whole-frame lanes): each launch's
    ``lane`` argument is ``rng_lanes`` at the carried lanes, which the
    radiance still scatters to. ``use_tlas`` and ``quant`` left None take
    their environment tiers (``integrator.resolve_bvh_config``), the packet
    is the environment's (``resolve_tlas_config``); at
    ``quant`` 1 or 2 the mesh kernel reads quantized node tables and the
    throughput column travels between launches as bf16 words
    (``kernels.pack_throughput_bf16``: packed after each launch, unpacked
    before the next), the reference's packed carried state.
    """
    use_tlas, quant, _, _ = resolve_bvh_config(use_tlas, quant)
    _, tlas_block = resolve_tlas_config()
    n0 = origins.shape[0]
    device = origins.device
    radiance = torch.zeros((n0, 3), dtype=torch.float32, device=device)
    throughput = torch.ones((n0, 3), dtype=torch.float32, device=device)
    if quant:
        throughput = kernels.pack_throughput_bf16(throughput)
    alive = torch.ones((n0,), dtype=torch.bool, device=device)
    lane = torch.arange(n0, dtype=torch.int32, device=device)
    tlas = mesh is not None and kernels.use_tlas_for(
        mesh.instances.translation.shape[0], use_tlas, kernels.mesh_leaf(mesh)
    )
    if mesh is None:
        block = BUCKET_BLOCK
    else:
        block = tlas_block if tlas else FLAT_MESH_BUCKET_BLOCK
    keys = kernels.initial_mesh_sort_keys(mesh, origins, directions, alive) if tlas else None
    for bounce in range(max_bounces):
        origins, directions, throughput, alive, lane, live_dev = compact(
            origins, directions, throughput, alive, lane, mesh, keys
        )
        live = int(live_dev)  # the one device sync of the bounce
        if live == 0:
            break
        bucket = bucket_for(live, cap=origins.shape[0], block=block)
        lane = lane[:bucket]
        thr = throughput[:bucket]
        state = (
            origins[:bucket], directions[:bucket],
            kernels.unpack_throughput_bf16(thr) if quant else thr, alive[:bucket],
            lane if rng_lanes is None else rng_lanes[lane],
        )
        if on_launch is not None:
            on_launch(WavefrontLaunch(bounce, live, bucket, state))
        if mesh is None:
            step = kernels.sphere_bounce(
                scene, *state, live, seed, bounce, total_bounces=max_bounces
            )
        else:
            step = kernels.mesh_bounce(
                scene, mesh, *state, live, seed, bounce, total_bounces=max_bounces,
                use_tlas=tlas, quant=quant, tlas_block=tlas_block,
            )
        origins, directions, throughput, alive = (
            step.origins, step.directions, step.throughput, step.alive
        )
        if quant:
            throughput = kernels.pack_throughput_bf16(throughput)
        keys = step.key
        radiance.index_add_(0, lane.to(torch.int64), step.contribution)
    return radiance


def render_frame_wavefront(
    scene_name: str,
    frame_index: int,
    *,
    width: int = 512,
    height: int = 512,
    samples: int = 8,
    max_bounces: int = 4,
    device: str | torch.device | None = None,
    on_launch: Callable[[WavefrontLaunch], None] | None = None,
    use_tlas: bool | None = None,
    quant: int | None = None,
    builder: str | None = None,
    wide: int | None = None,
) -> torch.Tensor:
    """Render one frame through the wavefront driver; [H, W, 3] linear
    radiance on ``device`` (CUDA unless ``cpu`` is asked for). The same
    rays and trace seed as ``integrator.render_frame``; the BVH tiers (None:
    the environment's) and the TLAS packet as for ``trace_paths_wavefront``,
    the build ``builder`` and ``wide`` and the environment's TLAS leaf to
    ``scene_mesh_set``."""
    device = resolve_device(device)
    use_tlas, quant, builder, wide = resolve_bvh_config(use_tlas, quant, builder, wide)
    tlas_leaf, _ = resolve_tlas_config()
    scene = build_scene(scene_name, frame_index, device)
    camera = scene_camera(scene_name, frame_index, device)
    origins, directions, seed = frame_rays_and_seed(
        camera, frame_index, width=width, height=height, samples=samples
    )
    radiance = trace_paths_wavefront(
        scene, origins, directions, seed, max_bounces=max_bounces,
        mesh=scene_mesh_set(scene_name, frame_index, builder, wide, device, tlas_leaf),
        on_launch=on_launch, use_tlas=use_tlas, quant=quant,
    )
    return radiance.reshape(samples, height * width, 3).mean(dim=0).reshape(height, width, 3)


def render_region_wavefront(
    scene_name: str,
    frame_index: int,
    *,
    y0: int,
    x0: int,
    tile_height: int,
    tile_width: int,
    width: int = 512,
    height: int = 512,
    samples: int = 8,
    max_bounces: int = 4,
    device: str | torch.device | None = None,
    on_launch: Callable[[WavefrontLaunch], None] | None = None,
    use_tlas: bool | None = None,
    quant: int | None = None,
    builder: str | None = None,
    wide: int | None = None,
) -> torch.Tensor:
    """Render one region of a frame through the wavefront driver;
    [tile_height, tile_width, 3] linear radiance on ``device``: the region's
    rays with their whole-frame lanes as RNG counters
    (``integrator.region_rays_and_seed``), so a stitched grid of regions
    equals ``render_frame_wavefront``'s image; the BVH and TLAS tiers as
    there."""
    device = resolve_device(device)
    use_tlas, quant, builder, wide = resolve_bvh_config(use_tlas, quant, builder, wide)
    tlas_leaf, _ = resolve_tlas_config()
    scene = build_scene(scene_name, frame_index, device)
    camera = scene_camera(scene_name, frame_index, device)
    origins, directions, lanes, seed = region_rays_and_seed(
        camera, frame_index, width=width, height=height, samples=samples, y0=y0, x0=x0,
        tile_height=tile_height, tile_width=tile_width,
    )
    radiance = trace_paths_wavefront(
        scene, origins, directions, seed, max_bounces=max_bounces,
        mesh=scene_mesh_set(scene_name, frame_index, builder, wide, device, tlas_leaf),
        on_launch=on_launch, use_tlas=use_tlas, rng_lanes=lanes, quant=quant,
    )
    n = tile_height * tile_width
    return radiance.reshape(samples, n, 3).mean(dim=0).reshape(tile_height, tile_width, 3)


def wavefront_eligible(mesh: MeshSet | None) -> bool:
    """The auto tier's rule: the deep-walk mesh scenes, those past the mesh
    megakernel's bound, where masked dead lanes still pay for walks."""
    return mesh is not None and not kernels.mesh_megakernel_eligible(mesh)


WAVEFRONT_MODES = ("auto", "off", "force")


@functools.lru_cache(maxsize=64)
def wavefront_active(scene_name: str, *, mode: str | None = None) -> bool:
    """Whether the wavefront driver renders this scene: ``off`` never,
    ``force`` always (sphere scenes through the per-bounce sphere kernel),
    ``auto`` (or None) for the scenes ``wavefront_eligible`` picks. A
    scene's BVH and instance count do not change with the frame, so the
    choice is made once per scene and mode."""
    mode = "auto" if mode is None else mode
    if mode not in WAVEFRONT_MODES:
        raise ValueError(f"wavefront mode {mode!r} is not one of {WAVEFRONT_MODES}")
    if mode != "auto":
        return mode == "force"
    return wavefront_eligible(scene_mesh_set(scene_name, 1))
