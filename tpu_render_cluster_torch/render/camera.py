"""Pinhole camera: frame-animated orbit, pixel-grid ray generation.

Port of ``tpu_render_cluster/render/camera.py``; float32 throughout, in the
reference's order of operations. A camera is computed on the host and copied
to the render device (``scene.on_device``), so the card's rays start from
the CPU's camera bit for bit; the rays themselves are computed on the
device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from tpu_render_cluster_torch.render.fp32 import dot3, fma
from tpu_render_cluster_torch.render.fp32 import sqrt as fp32_sqrt
from tpu_render_cluster_torch.render.scene import on_device

_F32 = torch.float32


class Camera(NamedTuple):
    origin: torch.Tensor  # [3]
    forward: torch.Tensor  # [3] unit
    right: torch.Tensor  # [3] unit
    up: torch.Tensor  # [3] unit
    tan_half_fov: torch.Tensor  # scalar


def _norm(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis, summed x + y + z in that order."""
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2])


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack(
        [
            a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0],
        ]
    )


def look_at_camera(origin, target, *, fov_degrees: float = 45.0, device="cpu") -> Camera:
    """The camera at ``origin`` looking at ``target``, on ``device``
    (computed on the host)."""
    return on_device(_look_at_on(origin, target, fov_degrees, "cpu"), device)


def _look_at_on(origin, target, fov_degrees: float, device) -> Camera:
    origin = torch.as_tensor(origin, dtype=_F32, device=device)
    target = torch.as_tensor(target, dtype=_F32, device=device)
    forward = target - origin
    forward = forward / _norm(forward)
    world_up = torch.tensor([0.0, 1.0, 0.0], dtype=_F32, device=device)
    right = _cross(forward, world_up)
    right = right / _norm(right)
    up = _cross(right, forward)
    fov = torch.tensor(fov_degrees, dtype=_F32, device=device)
    radians = fov * torch.tensor(math.pi / 180.0, dtype=_F32, device=device)
    tan_half_fov = torch.tan(radians / 2.0)
    return Camera(origin, forward, right, up, tan_half_fov)


def scene_camera(scene_name: str, frame, device="cpu") -> Camera:
    """Default camera per scene family; orbits slowly for animation scenes.
    Computed on the host and copied to ``device``."""
    return on_device(scene_camera_on(scene_name, frame, "cpu"), device)


def scene_camera_on(scene_name: str, frame, device) -> Camera:
    """``scene_camera``'s arithmetic carried out on ``device`` itself."""
    frame = torch.as_tensor(frame, dtype=_F32, device=device)
    if scene_name == "01_simple-animation":
        angle = frame * (2.0 * math.pi / 600.0)
        origin = torch.stack(
            [
                9.0 * torch.cos(angle),
                torch.tensor(4.5, dtype=_F32, device=device),
                9.0 * torch.sin(angle),
            ]
        )
        return _look_at_on(origin, [0.0, 0.8, 0.0], 45.0, device)
    if scene_name.startswith(("02_physics", "03_physics-2")):
        return _look_at_on([10.0, 6.0, 10.0], [0.0, 1.0, 0.0], 45.0, device)
    # 04_very-simple: fixed three-quarter view of the grid.
    return _look_at_on([8.0, 6.5, 8.0], [0.0, 0.4, 0.0], 45.0, device)


def camera_from_arrays(arrays: dict[str, np.ndarray], device) -> Camera:
    """A ``Camera`` from named arrays, e.g. a reference camera's fields."""
    return Camera(
        **{
            field: torch.as_tensor(np.array(arrays[field], dtype=np.float32), device=device)
            for field in Camera._fields
        }
    )


def camera_rays(
    camera: Camera,
    width: int,
    height: int,
    *,
    y0: int = 0,
    x0: int = 0,
    tile_height: int | None = None,
    tile_width: int | None = None,
    jitter: torch.Tensor | None = None,
):
    """Ray origins/directions for a pixel tile.

    Returns (origins [..., h*w, 3], directions [..., h*w, 3]). ``jitter`` is
    an optional ``[..., h*w, 2]`` in [0, 1) for stratified anti-aliasing;
    leading dimensions (one per sample) carry through to the rays.
    """
    device = camera.origin.device
    h = tile_height if tile_height is not None else height
    w = tile_width if tile_width is not None else width
    ys = torch.arange(h, dtype=_F32, device=device) + float(y0)
    xs = torch.arange(w, dtype=_F32, device=device) + float(x0)
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    px = px.reshape(-1)
    py = py.reshape(-1)
    if jitter is None:
        off_x = 0.5
        off_y = 0.5
    else:
        off_x = jitter[..., 0]
        off_y = jitter[..., 1]
    aspect = width / height
    # The reference's compiled renderer divides by the constant width and
    # height as a multiplication by their float32 reciprocals.
    inv_width = float(np.float32(1.0) / np.float32(width))
    inv_height = float(np.float32(1.0) / np.float32(height))
    ndc_x = ((px + off_x) * inv_width * 2.0 - 1.0) * aspect * camera.tan_half_fov
    ndc_y = (1.0 - (py + off_y) * inv_height * 2.0) * camera.tan_half_fov
    directions = fma(
        ndc_y[..., None], camera.up, fma(ndc_x[..., None], camera.right, camera.forward)
    )
    directions = directions / fp32_sqrt(dot3(directions, directions))[..., None]
    origins = camera.origin.expand(directions.shape)
    return origins, directions
