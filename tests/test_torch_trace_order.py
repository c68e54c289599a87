"""Row 1's radiance does not depend on the order its rays are traced in.

The sphere megakernel (``csrc/trace_fused.cu`` and its lane mode) runs
persistent blocks whose threads take the next unstarted ray whenever their
path ends, so which thread traces a ray, and when, depends on the other
rays. That is sound only because a ray's radiance depends on nothing but
its origin, direction, lane (its RNG counter), the seed and the scene.
These tests hold the plain version to it: permuting the rays together with
their lanes permutes the radiance, bit for bit, on a 04_very-simple and an
03_physics-2 frame (128 padded spheres), at 1 and 4 bounces, with the rays
reversed, shuffled from a numpy seed, or interleaved across warps (ray i
of each warp of 32 beside ray i of the others).
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from tpu_render_cluster_torch.render import integrator, kernels
from tpu_render_cluster_torch.render.scene import build_scene

WIDTH, HEIGHT, SAMPLES = 32, 24, 2  # 1,536 rays: 48 warps of 32


@functools.lru_cache(maxsize=None)
def _frame(name: str):
    scene = build_scene(name, 7, "cpu")
    origins, directions, seed = integrator.frame_rays_and_seed(
        integrator.scene_camera(name, 7, "cpu"), 7, width=WIDTH, height=HEIGHT, samples=SAMPLES
    )
    return scene, origins, directions, seed


def _order(kind: str, rays: int) -> torch.Tensor:
    if kind == "reversed":
        return torch.arange(rays - 1, -1, -1)
    if kind == "random":
        return torch.from_numpy(np.random.default_rng(13).permutation(rays))
    assert kind == "warp-interleaved" and rays % 32 == 0
    return torch.arange(rays).view(32, rays // 32).t().reshape(-1)


@pytest.mark.parametrize("kind", ["reversed", "random", "warp-interleaved"])
@pytest.mark.parametrize("max_bounces", [1, 4])
@pytest.mark.parametrize("name", ["04_very-simple", "03_physics-2"])
def test_permuted_rays_with_their_lanes_permute_the_radiance(name, max_bounces, kind):
    scene, origins, directions, seed = _frame(name)
    rays = origins.shape[0]
    order = _order(kind, rays)
    assert sorted(order.tolist()) == list(range(rays)) and not torch.equal(
        order, torch.arange(rays)
    )
    positional = kernels.trace_paths_fused_reference(
        scene, origins, directions, seed, max_bounces=max_bounces
    )
    permuted = kernels.trace_paths_fused_reference(
        scene, origins[order], directions[order], seed, max_bounces=max_bounces,
        lane=order.to(torch.int32),
    )
    assert torch.equal(permuted, positional[order])
    # The paths are not trivial: some rays bounce, some escape.
    assert (positional > 0).any() and not torch.equal(positional, positional[order])
