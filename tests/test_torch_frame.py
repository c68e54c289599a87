"""Whole frames: the port's ``fused_frame_renderer`` on the CPU against the
JAX package's, with its Pallas megakernel in interpret mode.

Tolerance: at least 99.5% of uint8 channel values within +-1, and image
means within 0.5. Both renderers trace the same rays with the same random
numbers; what remains is last-bit rounding (the reference builds the scene
inside one compiled program, and library cos/sin differ in the last bit),
which moves a few chaotic paths and the odd pixel across a uint8 step.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import tpu_render_cluster_torch
from tpu_render_cluster_torch.render import camera as port_camera
from tpu_render_cluster_torch.render import integrator as port_integrator
from tpu_render_cluster_torch.render import kernels
from tpu_render_cluster_torch.render import scene as port_scene

WIDTH, HEIGHT, SAMPLES, BOUNCES = 32, 24, 2, 4


@pytest.fixture
def reference_renderer(monkeypatch):
    """The JAX frame renderer with the Pallas megakernel forced on."""
    from tpu_render_cluster.render.integrator import fused_frame_renderer

    monkeypatch.setenv("TRC_PALLAS", "1")
    jax.clear_caches()  # the env var is read at trace time
    fused_frame_renderer.cache_clear()
    yield fused_frame_renderer
    jax.clear_caches()
    fused_frame_renderer.cache_clear()


def assert_images_match(got: np.ndarray, expected: np.ndarray) -> None:
    assert got.shape == expected.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int32) - expected.astype(np.int32))
    assert (diff <= 1).mean() >= 0.995, (diff <= 1).mean()
    assert abs(got.mean() - expected.mean()) <= 0.5


@pytest.mark.parametrize("frame", [1, 5])
@pytest.mark.parametrize("name", ["04_very-simple", "01_simple-animation"])
def test_frame_matches_reference(reference_renderer, name, frame):
    expected = np.asarray(reference_renderer(name, WIDTH, HEIGHT, SAMPLES, BOUNCES)(frame))
    kernels.reset_counts()
    render = port_integrator.fused_frame_renderer(name, WIDTH, HEIGHT, SAMPLES, BOUNCES, "cpu")
    got = render(frame)
    assert got.shape == (HEIGHT, WIDTH, 3) and got.device.type == "cpu"
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
    assert_images_match(got.numpy(), expected)
    assert got.numpy().std() > 5.0


def test_renderer_is_cached_per_config():
    a = port_integrator.fused_frame_renderer("04_very-simple", 8, 8, 1, 1, "cpu")
    b = port_integrator.fused_frame_renderer("04_very-simple", 8, 8, 1, 1, torch.device("cpu"))
    c = port_integrator.fused_frame_renderer("04_very-simple", 8, 8, 1, 2, "cpu")
    assert a is b and a is not c


def test_render_frame_whole_frame_only():
    """A whole frame, and with ``tile_size`` the reference's local tiling:
    one ``render_tile`` per square (its own RNG root), concatenated."""
    linear = port_integrator.render_frame(
        "02_physics", 3, width=12, height=10, samples=1, max_bounces=2, device="cpu"
    )
    assert linear.shape == (10, 12, 3) and torch.isfinite(linear).all()
    tiled = port_integrator.render_frame(
        "02_physics", 3, width=12, height=10, samples=1, max_bounces=2, tile_size=4, device="cpu"
    )
    assert tiled.shape == (10, 12, 3) and torch.isfinite(tiled).all()
    scene = port_scene.build_scene("02_physics", 3, "cpu")
    camera = port_camera.scene_camera("02_physics", 3, "cpu")
    edge = port_integrator.render_tile(
        scene, camera, 3, 8, 4, width=12, height=10, tile_height=2, tile_width=4, samples=1,
        max_bounces=2,
    )
    assert torch.equal(tiled[8:10, 4:8], edge)


def test_tonemap_matches_reference():
    from tpu_render_cluster.render.integrator import tonemap as ref_tonemap

    linear = np.random.default_rng(2).gamma(0.7, 1.5, size=(16, 16, 3)).astype(np.float32)
    expected = np.asarray(ref_tonemap(linear))
    got = port_integrator.tonemap(torch.from_numpy(linear)).numpy()
    assert (np.abs(got.astype(int) - expected.astype(int)) <= 1).all()


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tpu_render_cluster_torch.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpu_render_cluster_torch.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_integrator.fused_frame_renderer("04_very-simple", 8, 8, 1, 1)
    with pytest.raises(ValueError, match="Unsupported device"):
        tpu_render_cluster_torch.resolve_device("meta")
