"""Whole-frame path tracing: primary rays, the kernels, tonemapping.

Port of the masked tier of ``tpu_render_cluster/render/integrator.py`` for
whole frames of the sphere and mesh scenes. A frame's samples ride the ray
axis (the reference's flattened-samples branch of ``render_tile``): every
sample's jittered camera rays are traced together, then averaged per pixel
and tonemapped. ``trace_paths`` dispatches as the reference does: sphere
scenes and shallow meshes take ONE launch of a path-trace megakernel; a
deep mesh (past the mesh megakernel's walk bound) takes the per-bounce
mesh kernel once per bounce, the rays re-sorted by a coherence key between
bounces (``_ray_sort_order``), dead lanes at the tail.

RNG: the jitter and the kernel's trace seed derive from the reference's
``jax.random`` key schedule, reproduced bit for bit by ``render/rng.py``.
The keys are a handful of words and are derived on the host; only the
bulk jitter bits are drawn on the render device.
"""

from __future__ import annotations

import functools

import torch

from tpu_render_cluster_torch import resolve_device
from tpu_render_cluster_torch.render import kernels, rng
from tpu_render_cluster_torch.render.camera import Camera, camera_rays, scene_camera
from tpu_render_cluster_torch.render.mesh import MeshSet, scene_mesh_set
from tpu_render_cluster_torch.render.scene import Scene, build_scene

_TILES_SLICE = "tiled rendering arrives with the tiles slice of the port (ROADMAP.md, queue 1)"


def _int32(value) -> int:
    """``jnp.asarray(value).astype(int32)`` of a frame index or offset."""
    return int(torch.as_tensor(value, dtype=torch.float32).to(torch.int32))


def tile_base_key(frame, y0, x0) -> torch.Tensor:
    """The (frame, y0, x0)-derived RNG root every tile render uses."""
    key = rng.fold_in(rng.PRNGKey(917), _int32(frame))
    key = rng.fold_in(key, int(y0))
    return rng.fold_in(key, int(x0))


def tile_trace_key(base_key: torch.Tensor) -> torch.Tensor:
    """The path-trace key for a tile (sample index -1 = the trace stream,
    disjoint from every per-sample jitter stream)."""
    return rng.fold_in(base_key, -1)


def trace_seed(key: torch.Tensor) -> int:
    """The int32 seed of the megakernel's counter PCG: the key's last word."""
    return int(rng.as_int32(rng.key_data(key).reshape(-1)[-1]))


def sample_jitter_rays(
    camera: Camera, key, *, width, height, y0, x0, tile_height, tile_width
):
    """One sample's jittered primary rays for a tile (``key`` may carry a
    leading batch of sample keys; the rays then carry it too)."""
    jitter_key = rng.split(key)[..., 0, :]
    jitter = rng.uniform(
        jitter_key.to(camera.origin.device), (tile_height * tile_width, 2)
    )
    return camera_rays(
        camera, width, height, y0=y0, x0=x0,
        tile_height=tile_height, tile_width=tile_width, jitter=jitter,
    )


def flat_sample_rays(
    camera: Camera, base_key, *, width, height, y0, x0, tile_height,
    tile_width, samples,
):
    """All samples' rays flattened onto the ray axis ([S * n, 3] x 2),
    sample-major: ray ``s * n + pixel``."""
    n = tile_height * tile_width
    sample_keys = rng.fold_in(base_key, torch.arange(samples))
    origins, directions = sample_jitter_rays(
        camera, sample_keys, width=width, height=height, y0=y0, x0=x0,
        tile_height=tile_height, tile_width=tile_width,
    )
    return (
        origins.reshape(samples * n, 3).contiguous(),
        directions.reshape(samples * n, 3),
    )


def frame_rays_and_seed(camera: Camera, frame, *, width, height, samples):
    """A full frame's flattened primary rays + its kernel trace seed."""
    base_key = tile_base_key(frame, 0, 0)
    origins, directions = flat_sample_rays(
        camera, base_key, width=width, height=height, y0=0, x0=0,
        tile_height=height, tile_width=width, samples=samples,
    )
    return origins, directions, trace_seed(tile_trace_key(base_key))


def ray_sort_key(
    origins: torch.Tensor,
    directions: torch.Tensor,
    alive: torch.Tensor,
    mesh: MeshSet | None = None,
) -> torch.Tensor:
    """The reference's coherence key of each ray ([R] int64 holding the
    uint32 key; torch's CPU lacks uint32 operations): direction octant in
    bits 0-2, the 5-bit-per-axis Morton cell of ``origin + direction`` in
    bits 3-17, the ray's first-entered instance (``instance_entry_candidates``,
    K for none, clamped to 13 bits) in bits 18-30, and the dead flag in bit
    31, so sorting by it puts every dead lane after every live one."""
    candidate = torch.zeros(origins.shape[0], dtype=torch.int64, device=origins.device)
    if mesh is not None:
        table = kernels.instance_operands(mesh)
        candidate = kernels.instance_entry_candidates(
            origins, directions, table[:, 13:16], table[:, 16:19]
        )
    point = origins + directions
    lo = point.min(dim=0).values
    span = torch.clamp_min(point.max(dim=0).values - lo, 1e-6)
    cell = ((point - lo) / span * 31.999).to(torch.int64)  # 5 bits per axis

    def part1by2(v):  # spread 5 bits to every third position
        v = (v | (v << 8)) & 0x0300F
        v = (v | (v << 4)) & 0x030C3
        return (v | (v << 2)) & 0x09249

    morton = part1by2(cell[:, 0]) | (part1by2(cell[:, 1]) << 1) | (part1by2(cell[:, 2]) << 2)
    octant = (
        (directions[:, 0] > 0).to(torch.int64)
        | ((directions[:, 1] > 0).to(torch.int64) << 1)
        | ((directions[:, 2] > 0).to(torch.int64) << 2)
    )
    dead = (~alive).to(torch.int64) << 31
    return (torch.clamp_max(candidate, 0x1FFF) << 18) | (morton << 3) | octant | dead


def _ray_sort_order(origins, directions, alive, mesh=None) -> torch.Tensor:
    """The permutation that sorts the rays by ``ray_sort_key``, stably (as
    ``jnp.argsort``): rays of a packet then mostly want the same instance
    first and share an origin cell and octant, and dead lanes go last."""
    return torch.argsort(ray_sort_key(origins, directions, alive, mesh), stable=True)


def trace_paths(
    scene: Scene,
    origins: torch.Tensor,
    directions: torch.Tensor,
    seed: int,
    *,
    max_bounces: int,
    mesh: MeshSet | None = None,
) -> torch.Tensor:
    """Trace one sample per ray through the whole bounce loop; radiance
    [R, 3]. The reference's dispatch: no mesh -> the sphere megakernel; a
    mesh within the walk bound -> the mesh megakernel; a deeper mesh ->
    the per-bounce mesh kernel under the masked deep loop."""
    if mesh is None:
        return kernels.trace_paths_fused(
            scene, origins, directions, seed, max_bounces=max_bounces
        )
    if kernels.mesh_megakernel_eligible(mesh):
        return kernels.trace_paths_fused_mesh(
            scene, mesh, origins, directions, seed, max_bounces=max_bounces
        )
    return _trace_paths_deep(scene, mesh, origins, directions, seed, max_bounces)


def _trace_paths_deep(scene, mesh, origins, directions, seed, max_bounces):
    """The reference's masked deep loop: per bounce, re-sort the rays by the
    coherence key (dead lanes to the tail) with ONE packed [n, 12] gather
    of the travelling state, count the live lanes, and launch the
    per-bounce kernel over every lane; the carried original lane is the RNG
    counter and, at the end, unsorts the radiance. The live count stays on
    the device: the loop never waits for the card."""
    n = origins.shape[0]
    device = origins.device
    throughput = torch.ones((n, 3), dtype=torch.float32, device=device)
    radiance = torch.zeros((n, 3), dtype=torch.float32, device=device)
    alive = torch.ones((n,), dtype=torch.bool, device=device)
    lane = torch.arange(n, dtype=torch.int32, device=device)
    for bounce in range(max_bounces):
        order = _ray_sort_order(origins, directions, alive, mesh)
        packed = torch.cat([origins, directions, throughput, radiance], dim=1)[order]
        origins, directions = packed[:, 0:3], packed[:, 3:6]
        throughput, radiance = packed[:, 6:9], packed[:, 9:12]
        alive, lane = alive[order], lane[order]
        live = alive.sum(dtype=torch.int32)
        step = kernels.mesh_bounce(
            scene, mesh, origins, directions, throughput, alive, lane, live, seed, bounce,
            total_bounces=max_bounces,
        )
        origins, directions, throughput, alive = (
            step.origins, step.directions, step.throughput, step.alive
        )
        radiance = radiance + step.contribution
    return torch.zeros_like(radiance).index_copy_(0, lane.to(torch.int64), radiance)


def render_tile(
    scene: Scene,
    camera: Camera,
    frame,
    y0: int,
    x0: int,
    *,
    width: int,
    height: int,
    tile_height: int,
    tile_width: int,
    samples: int = 8,
    max_bounces: int = 4,
    mesh: MeshSet | None = None,
) -> torch.Tensor:
    """Render a tile; returns [tile_height, tile_width, 3] linear radiance.

    The reference's flattened-samples branch: the RNG key derives from
    (frame, y0, x0, sample), all samples are traced in one launch and
    averaged per pixel.
    """
    n = tile_height * tile_width
    base_key = tile_base_key(frame, y0, x0)
    origins, directions = flat_sample_rays(
        camera, base_key, width=width, height=height, y0=y0, x0=x0,
        tile_height=tile_height, tile_width=tile_width, samples=samples,
    )
    radiance = trace_paths(
        scene, origins, directions, trace_seed(tile_trace_key(base_key)),
        max_bounces=max_bounces, mesh=mesh,
    )
    image = radiance.reshape(samples, n, 3).mean(dim=0)
    return image.reshape(tile_height, tile_width, 3)


def render_frame(
    scene_name: str,
    frame_index: int,
    *,
    width: int = 512,
    height: int = 512,
    samples: int = 8,
    max_bounces: int = 4,
    tile_size: int | None = None,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """Render a whole frame; returns [H, W, 3] linear radiance on ``device``."""
    if tile_size is not None:
        raise NotImplementedError(f"tile_size={tile_size}: {_TILES_SLICE}.")
    device = resolve_device(device)
    scene = build_scene(scene_name, frame_index, device)
    camera = scene_camera(scene_name, frame_index, device)
    return render_tile(
        scene, camera, frame_index, 0, 0,
        width=width, height=height, tile_height=height, tile_width=width,
        samples=samples, max_bounces=max_bounces,
        mesh=scene_mesh_set(scene_name, frame_index, device=device),
    )


def tonemap(image: torch.Tensor) -> torch.Tensor:
    """Linear -> display: Reinhard + gamma 2.2, uint8."""
    mapped = image / (1.0 + image)
    srgb = torch.pow(torch.clamp(mapped, 0.0, 1.0), 1.0 / 2.2)
    return (srgb * 255.0 + 0.5).to(torch.uint8)


@functools.lru_cache(maxsize=32)
def _fused_frame_renderer(
    scene_name: str, width: int, height: int, samples: int, max_bounces: int,
    device: torch.device,
):
    def render(frame: int) -> torch.Tensor:
        scene = build_scene(scene_name, frame, device)
        camera = scene_camera(scene_name, frame, device)
        linear = render_tile(
            scene, camera, frame, 0, 0,
            width=width, height=height, tile_height=height, tile_width=width,
            samples=samples, max_bounces=max_bounces,
            mesh=scene_mesh_set(scene_name, frame, device=device),
        )
        return tonemap(linear)

    return render


def fused_frame_renderer(
    scene_name: str,
    width: int,
    height: int,
    samples: int,
    max_bounces: int,
    device: str | torch.device | None = None,
):
    """A cached ``frame -> uint8 [H, W, 3]`` callable for one scene/config.

    The image stays on ``device``: the caller copies it back when it needs
    the pixels. The device resolves here (CUDA unless ``cpu`` is asked
    for) and is part of the cache key.
    """
    return _fused_frame_renderer(
        scene_name, width, height, samples, max_bounces, resolve_device(device)
    )
