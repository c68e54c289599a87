"""The sphere unit kernels' plain versions (``kernels.intersect_spheres`` and
``kernels.occluded_spheres``) and the port's ``render/geometry.py`` against
the JAX package (the CUDA kernels themselves are held against the plain
versions on a GPU by tests/test_torch_kernels_cuda.py).

The reference runs ``intersect_spheres_pallas`` and ``occluded_pallas`` in
interpret mode (``TRC_PALLAS=1``) and its XLA twins, ``geometry``'s jnp
branches (``TRC_PALLAS=0``), on the CPU, on every scene of ``SCENE_NAMES``
with three ray sets: 513 random rays (not a multiple of any block), a camera
grid and rays that miss every sphere. Inputs travel across as numpy arrays.

Tolerances: against the interpret-mode kernels, bit-equal (the plain
versions round as the TPU kernels do). Against the XLA twins, the
reference's own (tests/test_pallas_kernels.py): t within rtol 2e-5 / atol
2e-4, on every ray but a budget of max(1, round(0.001 R)) grazing rays, each
of which must equal the TPU kernel's own t (the twin rounds its sphere dots
through a matrix product, and a grazing ray's root is ill-conditioned: on
02_physics's camera rays the TPU kernel itself lies past that tolerance from
its twin on one ray); the index equal on every ray that hits, the any-hit
equal on every ray.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_render_cluster.render import camera as ref_camera
from tpu_render_cluster.render import geometry as ref_geometry
from tpu_render_cluster.render import scene as ref_scene
from tpu_render_cluster_torch.render import geometry, kernels
from tpu_render_cluster_torch.render import scene as port_scene

FRAME = 7
SOURCES = ("random", "camera", "miss")


@functools.lru_cache(maxsize=None)
def _scenes(name: str):
    scene = ref_scene.build_scene(name, FRAME)
    port = port_scene.scene_from_arrays({k: np.asarray(v) for k, v in scene._asdict().items()}, "cpu")
    return scene, port


@functools.lru_cache(maxsize=None)
def _rays(name: str, source: str) -> tuple[np.ndarray, np.ndarray]:
    if source == "random":
        rng = np.random.default_rng(3)
        origins = rng.normal(size=(513, 3)) * 4.0 + [0.0, 3.0, 8.0]
        directions = rng.normal(size=(513, 3))
        directions /= np.linalg.norm(directions, axis=1, keepdims=True)
        return origins.astype(np.float32), directions.astype(np.float32)
    if source == "camera":
        camera = ref_camera.scene_camera(name, FRAME)
        origins, directions = ref_camera.camera_rays(
            camera, 24, 20, y0=0, x0=0, tile_height=20, tile_width=24,
            jitter=jnp.full((24 * 20, 2), 0.5, jnp.float32),
        )
        return np.array(origins), np.array(directions)
    # Straight up from above every sphere: nothing to hit.
    origins = np.tile(np.array([[0.5, 40.0, -0.25]], np.float32), (64, 1))
    directions = np.tile(np.array([[0.0, 1.0, 0.0]], np.float32), (64, 1))
    return origins, directions


@pytest.mark.parametrize("pallas", [True, False], ids=["pallas", "xla"])
@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("name", ref_scene.SCENE_NAMES)
def test_sphere_unit_kernels_match_reference(monkeypatch, name, source, pallas):
    scene, port = _scenes(name)
    origins, directions = _rays(name, source)
    monkeypatch.setenv("TRC_PALLAS", "1" if pallas else "0")
    o, d = jnp.asarray(origins), jnp.asarray(directions)
    t_ref, index_ref = (np.asarray(a) for a in ref_geometry.intersect_spheres(scene, o, d))
    shadow_ref = np.asarray(ref_geometry.occluded_sun(scene, o, d))

    kernels.reset_counts()
    t, index = kernels.intersect_spheres(port, torch.from_numpy(origins), torch.from_numpy(directions))
    shadow = kernels.occluded_spheres(port, torch.from_numpy(origins), torch.from_numpy(directions))
    assert kernels.counts == {
        k: int(k in ("intersect_spheres_reference", "occluded_spheres_reference"))
        for k in kernels.counts
    }
    assert t.dtype == torch.float32 and index.dtype == torch.int32 and shadow.dtype == torch.bool
    hit = t_ref < 1e29
    np.testing.assert_array_equal(index.numpy()[hit], index_ref[hit])
    np.testing.assert_array_equal(shadow.numpy(), shadow_ref)
    if pallas:  # the TPU kernels' own rounding
        np.testing.assert_array_equal(t.numpy(), t_ref)
        np.testing.assert_array_equal(index.numpy(), index_ref)
    else:
        grazing = np.flatnonzero(~np.isclose(t.numpy(), t_ref, rtol=2e-5, atol=2e-4))
        assert grazing.size <= max(1, round(0.001 * t_ref.size)), grazing
        if grazing.size:
            monkeypatch.setenv("TRC_PALLAS", "1")
            t_tpu, _ = ref_geometry.intersect_spheres(scene, o, d)
            np.testing.assert_array_equal(t.numpy()[grazing], np.asarray(t_tpu)[grazing])
    if source == "miss":
        assert not hit.any() and (index.numpy() == 0).all() and not shadow.numpy().any()
    else:
        assert hit.any()


@pytest.mark.parametrize("name", ["04_very-simple", "03_physics-2-mesh"])
def test_geometry_helpers_match_reference(monkeypatch, name):
    """The plane, the scene hit, the bounded shadow query, the checker
    albedo and the sky, against the reference's XLA functions."""
    monkeypatch.setenv("TRC_PALLAS", "0")
    scene, port = _scenes(name)
    origins, directions = _rays(name, "camera")
    o, d = jnp.asarray(origins), jnp.asarray(directions)
    po, pd = torch.from_numpy(origins), torch.from_numpy(directions)

    np.testing.assert_array_equal(
        geometry.intersect_plane(po, pd).numpy(), np.asarray(ref_geometry.intersect_plane(o, d))
    )
    t, index, is_plane = geometry.intersect_scene(port, po, pd)
    t_ref, index_ref, is_plane_ref = (np.asarray(a) for a in ref_geometry.intersect_scene(scene, o, d))
    np.testing.assert_allclose(t.numpy(), t_ref, rtol=2e-5, atol=2e-4)  # no grazing ray here
    np.testing.assert_array_equal(is_plane.numpy(), is_plane_ref)
    np.testing.assert_array_equal(index.numpy()[t_ref < 1e29], index_ref[t_ref < 1e29])
    max_t = np.float32(12.0)
    np.testing.assert_array_equal(
        geometry.occluded(port, po, pd, float(max_t)).numpy(),
        np.asarray(ref_geometry.occluded(scene, o, d, max_t)),
    )
    points = origins + directions * np.minimum(t_ref, 50.0)[:, None]
    np.testing.assert_array_equal(
        geometry.checker_albedo(port, torch.from_numpy(points)).numpy(),
        np.asarray(ref_geometry.checker_albedo(scene, jnp.asarray(points))),
    )
    sky = geometry.sky_color(port, pd).numpy()
    np.testing.assert_allclose(sky, np.asarray(ref_geometry.sky_color(scene, d)), rtol=1e-6, atol=1e-6)
    # Some ray sees the sun disc: directions straight at the sun.
    sun = np.asarray(scene.sun_direction)[None, :].repeat(4, axis=0)
    np.testing.assert_allclose(
        geometry.sky_color(port, torch.from_numpy(sun)).numpy(),
        np.asarray(ref_geometry.sky_color(scene, jnp.asarray(sun))), rtol=1e-6, atol=1e-6,
    )


def test_unit_wrappers_check_their_inputs():
    _, port = _scenes("04_very-simple")
    origins, directions = (torch.from_numpy(a) for a in _rays("04_very-simple", "random"))
    with pytest.raises(TypeError, match="float32"):
        kernels.intersect_spheres(port, origins.double(), directions)
    with pytest.raises(ValueError, match=r"\[R, 3\]"):
        kernels.occluded_spheres(port, origins[:, :2], directions)
    with pytest.raises(ValueError, match="Unsupported device"):
        kernels.intersect_spheres(
            port._replace(centers=port.centers.to("meta")), origins.to("meta"), directions.to("meta")
        )


def test_plain_sphere_versions_count_their_work():
    _, port = _scenes("04_very-simple")
    origins, directions = (torch.from_numpy(a) for a in _rays("04_very-simple", "camera"))
    stats: dict = {}
    kernels.intersect_spheres_reference(port, origins, directions, stats=stats)
    assert stats == {"spheres": 64, "rays": origins.shape[0]}
    stats = {}
    hit = kernels.occluded_spheres_reference(port, origins, directions, stats=stats)
    assert stats["spheres"] == 64 and stats["rays"] == origins.shape[0]
    # A ray that hits tests up to its first occluder; one that misses, all.
    assert hit.sum() <= stats["sphere_tests"] <= 64 * origins.shape[0]
    assert stats["sphere_tests"] > 64 * int((~hit).sum())


def test_chunking_changes_nothing():
    _, port = _scenes("03_physics-2")
    origins, directions = (torch.from_numpy(a) for a in _rays("03_physics-2", "random"))
    whole = kernels.intersect_spheres_reference(port, origins, directions)
    chunked = kernels.intersect_spheres_reference(port, origins, directions, chunk_rays=100)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)
    assert torch.equal(
        kernels.occluded_spheres_reference(port, origins, directions),
        kernels.occluded_spheres_reference(port, origins, directions, chunk_rays=100),
    )
