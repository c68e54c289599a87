"""Whole-frame path tracing: primary rays, the megakernel, tonemapping.

Port of the masked megakernel tier of ``tpu_render_cluster/render/
integrator.py`` for sphere scenes and whole frames. A frame's samples ride
the ray axis (the reference's flattened-samples branch of ``render_tile``):
every sample's jittered camera rays are traced in ONE launch of the
path-trace megakernel, then averaged per pixel and tonemapped.

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
from tpu_render_cluster_torch.render.scene import Scene, build_scene

_TILES_SLICE = "tiled rendering arrives with the tiles slice of the port (ROADMAP.md, slice 2)"


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
    radiance = kernels.trace_paths_fused(
        scene, origins, directions, trace_seed(tile_trace_key(base_key)),
        max_bounces=max_bounces,
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
