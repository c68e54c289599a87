"""Ray-scene intersection for the per-bounce scan renderer.

Port of ``tpu_render_cluster/render/geometry.py``. Its two sphere queries
are the unit kernels of ``render/kernels.py``, which callers call directly:
``kernels.intersect_spheres`` (the reference's ``intersect_spheres``, the
TPU's ``_nearest_hit``) and ``kernels.occluded_spheres`` (``occluded_sun``,
``_any_hit``), launched for CUDA tensors and run as their plain versions for
CPU tensors. The ground plane, the checker albedo and the sky are plain
tensor code, as the reference leaves them to XLA outside any kernel.
"""

from __future__ import annotations

import torch

from tpu_render_cluster_torch.render import kernels
from tpu_render_cluster_torch.render.fp32 import dot3
from tpu_render_cluster_torch.render.scene import Scene

INF = kernels.INF
EPS = kernels.EPS


def intersect_plane(origins: torch.Tensor, directions: torch.Tensor) -> torch.Tensor:
    """Ground plane y = 0: t [R], INF when parallel or behind."""
    denom = directions[:, 1]
    parallel = torch.abs(denom) < 1e-8
    t = -origins[:, 1] / torch.where(parallel, 1e-8, denom)
    return torch.where((t > EPS) & ~parallel, t, INF)


def intersect_scene(scene: Scene, origins: torch.Tensor, directions: torch.Tensor):
    """Nearest hit among the spheres and the ground plane: (t [R], sphere
    index [R], is_plane [R] bool)."""
    t_sphere, sphere_index = kernels.intersect_spheres(scene, origins, directions)
    t_plane = intersect_plane(origins, directions)
    return torch.minimum(t_sphere, t_plane), sphere_index, t_plane < t_sphere


def occluded(scene: Scene, origins: torch.Tensor, directions: torch.Tensor, max_t) -> torch.Tensor:
    """Bounded shadow query: some sphere hit before ``max_t`` (the plane is
    excluded: the sun is always above it). The scan does not call it; it is
    kept beside ``intersect_scene`` as the reference's geometry module has
    it."""
    t_sphere, _ = kernels.intersect_spheres(scene, origins, directions)
    return t_sphere < max_t


def checker_albedo(scene: Scene, points: torch.Tensor) -> torch.Tensor:
    """Checkerboard albedo [R, 3] of plane hit points [R, 3]."""
    checker = torch.remainder(
        torch.floor(points[:, 0]).to(torch.int32) + torch.floor(points[:, 2]).to(torch.int32), 2
    )
    return torch.where(checker[:, None] == 0, scene.plane_albedo_a, scene.plane_albedo_b)


def sky_color(scene: Scene, directions: torch.Tensor) -> torch.Tensor:
    """Vertical-gradient sky with a visible sun disc, [R, 3]."""
    blend = torch.clamp(directions[:, 1], 0.0, 1.0)[:, None]
    base = (1.0 - blend) * scene.sky_horizon + blend * scene.sky_zenith
    sun_cos = dot3(directions, scene.sun_direction)
    sun_disc = torch.where(sun_cos > 0.9995, 40.0, 0.0)[:, None]
    return base + sun_disc * scene.sun_color / 40.0 * 8.0
