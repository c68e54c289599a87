"""Whole-frame path tracing: primary rays, the megakernel, tonemapping.

Port of the masked megakernel tier of ``tpu_render_cluster/render/
integrator.py`` for whole frames of the sphere scenes and of the mesh
scenes whose mesh fits the mesh megakernel. A frame's samples ride the ray
axis (the reference's flattened-samples branch of ``render_tile``): every
sample's jittered camera rays are traced in ONE launch of a path-trace
megakernel (``trace_paths`` picks which), then averaged per pixel and
tonemapped.

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
_DEEP_MESH_SLICE = (
    "its BVH nodes x instances exceed the mesh megakernel's bound "
    f"({kernels.MESH_MEGAKERNEL_MAX_WALK}); deep mesh scenes take the per-bounce "
    "mesh kernel, which arrives with the deep-mesh slice of the port (ROADMAP.md, queue 1)"
)


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


def check_mesh_supported(mesh: MeshSet | None) -> None:
    """Raise ``NotImplementedError`` for a mesh the ported kernels cannot
    trace yet (beyond the mesh megakernel's walk bound)."""
    if mesh is not None and not kernels.mesh_megakernel_eligible(mesh):
        nodes, instances = mesh.bvh.skip.shape[0], mesh.instances.translation.shape[0]
        raise NotImplementedError(
            f"A mesh of {nodes} BVH nodes x {instances} instances: {_DEEP_MESH_SLICE}."
        )


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
    mesh within the walk bound -> the mesh megakernel; a deeper mesh
    raises ``NotImplementedError`` (its kernel is not ported yet)."""
    if mesh is None:
        return kernels.trace_paths_fused(
            scene, origins, directions, seed, max_bounces=max_bounces
        )
    check_mesh_supported(mesh)
    return kernels.trace_paths_fused_mesh(
        scene, mesh, origins, directions, seed, max_bounces=max_bounces
    )


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
    # A mesh's BVH and instance count are the same in every frame: a mesh
    # the ported kernels cannot trace fails here, before any frame renders.
    check_mesh_supported(scene_mesh_set(scene_name, 0, device=device))

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
    for) and is part of the cache key. A mesh scene beyond the mesh
    megakernel's bound raises ``NotImplementedError`` here.
    """
    return _fused_frame_renderer(
        scene_name, width, height, samples, max_bounces, resolve_device(device)
    )
