"""The path-trace megakernel's plain version against the reference's Pallas
kernel (the CUDA kernel itself is held against the plain version on a GPU
by tests/test_torch_kernels_cuda.py).

The reference runs ``pallas_kernels.trace_paths_fused`` in interpret mode
on the CPU, as the JAX package's own kernel tests do. Inputs travel across
as numpy arrays (``scene_from_arrays``).

Tolerances, per ray over its three channels, rtol = atol = 1e-4:
- 1 bounce: every ray. The radiance is sky, emission and the sun's direct
  term at the primary hit; the plain version rounds as the reference does
  (render/fp32.py), so only last-bit differences of library functions
  remain.
- 4 bounces: at least 99.9% of rays. A path tracer is chaotic: a one-ulp
  difference (cos, sin) at a grazing bounce can send a path elsewhere.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_render_cluster.render import camera as ref_camera
from tpu_render_cluster.render import integrator as ref_integrator
from tpu_render_cluster.render import pallas_kernels as ref_kernels
from tpu_render_cluster.render import scene as ref_scene
from tpu_render_cluster_torch.render import kernels, scene as port_scene

N_RAYS = 3001  # a multiple of no block size (4096, 1024, 256, 8)


def _u32_sweep() -> np.ndarray:
    edges = [0, 1, 255, 256, 2**24 - 1, 2**24, 2**31 - 1, 2**31, 2**31 + 1, 2**32 - 2, 2**32 - 1]
    stride = np.arange(0, 2**32, 2**32 // 4099, dtype=np.uint64)
    return np.unique(np.concatenate([np.array(edges, np.uint64), stride])).astype(np.uint32)


def test_pcg_hash_bit_exact():
    words = _u32_sweep()
    assert (words >= 2**31).sum() > 1000
    expected = np.asarray(ref_kernels._pcg_hash(jnp.asarray(words)))
    got = kernels.pcg_hash(torch.from_numpy(words.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), expected)
    assert got.min() >= 0 and got.max() < 2**32


def test_uniform_from_hash_bit_exact():
    words = _u32_sweep()
    expected = np.asarray(ref_kernels._uniform_from_hash(jnp.asarray(words)))
    got = kernels.uniform_from_hash(torch.from_numpy(words.astype(np.int64))).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, expected)


def _random_rays(seed: int):
    rng = np.random.default_rng(seed)
    origins = (rng.normal(size=(N_RAYS, 3)) * 4.0 + [0.0, 3.0, 8.0]).astype(np.float32)
    directions = rng.normal(size=(N_RAYS, 3))
    directions = (directions / np.linalg.norm(directions, axis=1, keepdims=True)).astype(np.float32)
    return origins, directions


@functools.lru_cache(maxsize=None)
def _camera_rays(name: str):
    """Jittered primary rays of frame 7 (41 x 23 pixels x 3 samples)."""
    camera = ref_camera.scene_camera(name, 7)
    origins, directions, _ = ref_integrator.frame_rays_and_seed(
        camera, jnp.float32(7), width=41, height=23, samples=3
    )
    return np.array(origins), np.array(directions)


CASES = [
    # (scene, ray source, seed): camera rays with a negative seed, random
    # rays with a positive one; 03_physics-2 has 128 padded spheres.
    ("04_very-simple", "camera", -1136603641),
    ("04_very-simple", "random", 82102972),
    ("03_physics-2", "camera", -7),
    ("03_physics-2", "random", 1321130979),
]


@pytest.mark.parametrize("max_bounces", [1, 4])
@pytest.mark.parametrize("name,rays,seed", CASES)
def test_plain_version_matches_pallas_interpret(name, rays, seed, max_bounces):
    ref = ref_scene.build_scene(name, 7)
    scene = port_scene.scene_from_arrays({k: np.asarray(v) for k, v in ref._asdict().items()}, "cpu")
    origins, directions = _random_rays(3) if rays == "random" else _camera_rays(name)
    expected = np.asarray(
        ref_kernels.trace_paths_fused(
            ref, jnp.asarray(origins), jnp.asarray(directions), jnp.int32(seed),
            max_bounces=max_bounces,
        )
    )
    got = kernels.trace_paths_fused_reference(
        scene, torch.from_numpy(origins), torch.from_numpy(directions), seed,
        max_bounces=max_bounces, chunk_rays=1024,
    ).numpy()
    assert got.shape == expected.shape and np.isfinite(got).all()
    close = np.isclose(got, expected, rtol=1e-4, atol=1e-4).all(axis=1)
    if max_bounces == 1:
        assert close.all(), np.abs(got - expected).max()
    else:
        assert close.mean() >= 0.999, close.mean()
    assert got.max() > 0.1  # the rays see something


def test_wrapper_routes_cpu_tensors_to_the_plain_version():
    scene = port_scene.build_scene("04_very-simple", 1, "cpu")
    origins, directions = _random_rays(4)
    kernels.reset_counts()
    out = kernels.trace_paths_fused(
        scene, torch.from_numpy(origins), torch.from_numpy(directions), 5, max_bounces=2
    )
    assert out.shape == (N_RAYS, 3)
    assert kernels.counts == {
        "trace_fused": 0, "trace_fused_reference": 1,
        "trace_fused_mesh": 0, "trace_fused_mesh_reference": 0,
        "sphere_bounce": 0, "sphere_bounce_reference": 0,
        "mesh_bounce": 0, "mesh_bounce_reference": 0,
        "pool_sphere_bounce": 0, "pool_sphere_bounce_reference": 0,
        "pool_mesh_bounce": 0, "pool_mesh_bounce_reference": 0,
        "intersect_spheres": 0, "intersect_spheres_reference": 0,
        "occluded_spheres": 0, "occluded_spheres_reference": 0,
        "intersect_instances": 0, "intersect_instances_reference": 0,
        "occluded_instances": 0, "occluded_instances_reference": 0,
        "intersect_mesh": 0, "intersect_mesh_reference": 0,
        "occluded_mesh": 0, "occluded_mesh_reference": 0,
        "trace_fused_mesh_tlas": 0, "trace_fused_mesh_tlas_reference": 0,
        "mesh_bounce_tlas": 0, "mesh_bounce_tlas_reference": 0,
        "pool_mesh_bounce_tlas": 0, "pool_mesh_bounce_tlas_reference": 0,
        "trace_fused_lanes": 0, "trace_fused_lanes_reference": 0,
        "packet_octants": 0, "packet_octants_reference": 0,
        "mesh_entry_keys": 0, "mesh_entry_keys_reference": 0,
    }


def test_plain_version_chunking_changes_nothing():
    scene = port_scene.build_scene("03_physics-2", 30, "cpu")
    origins, directions = (torch.from_numpy(a) for a in _random_rays(6))
    whole = kernels.trace_paths_fused_reference(scene, origins, directions, -3, max_bounces=4)
    chunked = kernels.trace_paths_fused_reference(
        scene, origins, directions, -3, max_bounces=4, chunk_rays=333
    )
    torch.testing.assert_close(chunked, whole, rtol=0, atol=0)


def test_plain_version_counts_the_work_it_needs():
    scene = port_scene.build_scene("04_very-simple", 1, "cpu")
    origins, directions = (torch.from_numpy(a) for a in _camera_rays("04_very-simple"))
    stats: dict = {}
    kernels.trace_paths_fused_reference(scene, origins, directions, 9, max_bounces=4, stats=stats)
    rays = origins.shape[0]
    assert stats["spheres"] == 64
    assert rays <= stats["alive_lane_bounces"] <= 4 * rays
    assert 0 < stats["hit_lane_bounces"] <= stats["alive_lane_bounces"]
    assert 0 < stats["shadow_sphere_tests"] <= 64 * stats["hit_lane_bounces"]


def test_too_many_spheres_raise():
    scene = port_scene.build_scene("03_physics-2", 1, "cpu")
    big = scene._replace(
        centers=torch.zeros((136, 3)), radii=torch.ones(136),
        albedo=torch.zeros((136, 3)), emission=torch.zeros((136, 3)),
    )
    origins, directions = (torch.from_numpy(a) for a in _random_rays(1))
    with pytest.raises(ValueError, match="at most 128"):
        kernels.trace_paths_fused(big, origins, directions, 1, max_bounces=1)


def test_mismatched_devices_and_shapes_raise():
    scene = port_scene.build_scene("04_very-simple", 1, "cpu")
    with pytest.raises(ValueError, match=r"\[R, 3\]"):
        kernels.trace_paths_fused(scene, torch.zeros((4, 3)), torch.zeros((5, 3)), 1, max_bounces=1)
    with pytest.raises(TypeError, match="float32"):
        kernels.trace_paths_fused(
            scene, torch.zeros((4, 3), dtype=torch.float64), torch.zeros((4, 3)), 1, max_bounces=1
        )
