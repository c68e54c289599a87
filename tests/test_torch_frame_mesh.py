"""Whole frames of the mesh scenes: the port's renderers on the CPU against
the JAX package's, with its Pallas mesh kernels in interpret mode (the
megakernel for 02_physics-mesh, the per-bounce kernel under its deep loop
for 03_physics-2-mesh).

Tolerance as in tests/test_torch_frame.py: at least 99.5% of uint8 channel
values within +-1, and image means within 0.5. Both renderers trace the
same rays with the same random numbers through the same physics.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_frame import assert_images_match
from tpu_render_cluster_torch.render import integrator as port_integrator
from tpu_render_cluster_torch.render import kernels

WIDTH, HEIGHT, SAMPLES, BOUNCES = 32, 24, 2, 4


@pytest.fixture
def reference_renderer(monkeypatch):
    """The JAX frame renderer with the Pallas megakernels forced on."""
    from tpu_render_cluster.render.integrator import fused_frame_renderer

    monkeypatch.setenv("TRC_PALLAS", "1")
    jax.clear_caches()  # the env var is read at trace time
    fused_frame_renderer.cache_clear()
    yield fused_frame_renderer
    jax.clear_caches()
    fused_frame_renderer.cache_clear()


def test_mesh_frames_match_reference(reference_renderer):
    name = "02_physics-mesh"
    reference = reference_renderer(name, WIDTH, HEIGHT, SAMPLES, BOUNCES)
    render = port_integrator.fused_frame_renderer(name, WIDTH, HEIGHT, SAMPLES, BOUNCES, "cpu")
    for frame in (1, 30):
        expected = np.asarray(reference(frame))
        kernels.reset_counts()
        got = render(frame)
        assert got.shape == (HEIGHT, WIDTH, 3) and got.device.type == "cpu"
        assert kernels.counts == {
            "trace_fused": 0, "trace_fused_reference": 0,
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
            "trace_fused_mesh_tlas": 0, "trace_fused_mesh_tlas_reference": 1,
            "mesh_bounce_tlas": 0, "mesh_bounce_tlas_reference": 0,
            "pool_mesh_bounce_tlas": 0, "pool_mesh_bounce_tlas_reference": 0,
            "trace_fused_lanes": 0, "trace_fused_lanes_reference": 0,
            "packet_octants": 0, "packet_octants_reference": 0,
            "mesh_entry_keys": 0, "mesh_entry_keys_reference": 0,
        }
        assert_images_match(got.numpy(), expected)
        assert got.numpy().std() > 5.0


def test_deep_mesh_renderer_names_its_slice():
    """The deep mesh scene, past the mesh megakernel's bound, renders
    through the per-bounce mesh kernel once per bounce (the deep-mesh
    slice), by default its TLAS variant, with ``use_tlas=False`` the flat
    one, to the same image; tests/test_torch_wavefront.py holds its frames
    against the reference."""
    kernels.reset_counts()
    image = port_integrator.fused_frame_renderer("03_physics-2-mesh", 8, 8, 1, 2, "cpu")(2)
    assert image.shape == (8, 8, 3) and image.dtype == torch.uint8
    assert kernels.counts == {k: 2 * (k == "mesh_bounce_tlas_reference") for k in kernels.counts}
    linear = port_integrator.render_frame(
        "03_physics-2-mesh", 2, width=8, height=8, samples=1, max_bounces=2, device="cpu"
    )
    assert torch.equal(port_integrator.tonemap(linear), image)
    kernels.reset_counts()
    flat = port_integrator.fused_frame_renderer(
        "03_physics-2-mesh", 8, 8, 1, 2, "cpu", use_tlas=False
    )(2)
    assert kernels.counts == {k: 2 * (k == "mesh_bounce_reference") for k in kernels.counts}
    assert torch.equal(flat, image)


def test_deep_mesh_frame_matches_reference(reference_renderer):
    """03_physics-2-mesh frame 30 at 16x16 x 2 spp through the port's
    masked deep loop, against the reference's ``render_frame`` (its TLAS
    default tier)."""
    from tpu_render_cluster.render import integrator as ref_integrator

    kwargs = dict(width=16, height=16, samples=2, max_bounces=4)
    expected = np.asarray(
        ref_integrator.tonemap(ref_integrator.render_frame("03_physics-2-mesh", 30, **kwargs))
    )
    kernels.reset_counts()
    got = port_integrator.tonemap(
        port_integrator.render_frame("03_physics-2-mesh", 30, device="cpu", **kwargs)
    )
    assert kernels.counts["mesh_bounce_tlas_reference"] == 4
    assert_images_match(got.numpy(), expected)
    assert got.numpy().std() > 5.0


def test_render_frame_of_a_mesh_scene():
    kernels.reset_counts()
    linear = port_integrator.render_frame(
        "02_physics-mesh", 40, width=12, height=10, samples=1, max_bounces=2, device="cpu"
    )
    assert linear.shape == (10, 12, 3) and torch.isfinite(linear).all()
    assert kernels.counts["trace_fused_mesh_tlas_reference"] == 1
