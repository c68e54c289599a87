"""The port's scenes and cameras against the JAX package's.

Tolerance: rtol = atol = 1e-6. Both sides evaluate the same float32
expressions; transcendental functions (sin, cos, log, pow) of the two
libraries may differ in the last bit, which is below 1e-6 relative.
"""

from __future__ import annotations

import tomllib
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_render_cluster.render import camera as ref_camera
from tpu_render_cluster.render import scene as ref_scene
from tpu_render_cluster_torch.render import camera as port_camera
from tpu_render_cluster_torch.render import scene as port_scene

REPO = Path(__file__).resolve().parent.parent
SPHERE_SCENES = ("04_very-simple", "01_simple-animation", "02_physics", "03_physics-2")
FRAMES = (0, 1, 37, 240)


def _assert_fields_close(port, ref):
    assert port._fields == ref._fields
    for field in ref._fields:
        expected = np.asarray(getattr(ref, field))
        got = getattr(port, field).numpy()
        assert got.shape == expected.shape, field
        assert got.dtype == np.float32, field
        np.testing.assert_allclose(got, expected, rtol=1e-6, atol=1e-6, err_msg=field)


@pytest.mark.parametrize("frame", FRAMES)
@pytest.mark.parametrize("name", SPHERE_SCENES)
def test_scene_matches_reference(name, frame):
    _assert_fields_close(
        port_scene.build_scene(name, frame, "cpu"), ref_scene.build_scene(name, frame)
    )


@pytest.mark.parametrize("frame", FRAMES)
@pytest.mark.parametrize("name", SPHERE_SCENES)
def test_camera_matches_reference(name, frame):
    _assert_fields_close(
        port_camera.scene_camera(name, frame, "cpu"), ref_camera.scene_camera(name, frame)
    )


def test_camera_rays_match_reference():
    ref_cam = ref_camera.scene_camera("01_simple-animation", 37)
    port_cam = port_camera.camera_from_arrays(
        {k: np.asarray(v) for k, v in ref_cam._asdict().items()}, "cpu"
    )
    jitter = np.random.default_rng(5).random((6 * 10, 2), dtype=np.float32)
    ref_o, ref_d = ref_camera.camera_rays(
        ref_cam, 20, 16, y0=4, x0=8, tile_height=6, tile_width=10, jitter=jitter
    )
    port_o, port_d = port_camera.camera_rays(
        port_cam, 20, 16, y0=4, x0=8, tile_height=6, tile_width=10,
        jitter=torch.from_numpy(jitter),
    )
    np.testing.assert_allclose(port_o.numpy(), np.asarray(ref_o), rtol=0, atol=1e-6)
    np.testing.assert_allclose(port_d.numpy(), np.asarray(ref_d), rtol=0, atol=1e-6)


def test_scene_from_arrays_round_trip():
    ref = ref_scene.build_scene("03_physics-2", 12)
    port = port_scene.scene_from_arrays({k: np.asarray(v) for k, v in ref._asdict().items()}, "cpu")
    for field in ref._fields:
        np.testing.assert_array_equal(getattr(port, field).numpy(), np.asarray(getattr(ref, field)))


@pytest.mark.parametrize("name", port_scene.MESH_SCENE_NAMES)
def test_mesh_scenes_name_their_slice(name):
    """Both mesh scenes build; the one whose mesh is past the mesh
    megakernel's bound goes to the deep-mesh slice's per-bounce tiers, as
    in the reference."""
    from tpu_render_cluster.render import mesh as ref_mesh
    from tpu_render_cluster.render import pallas_kernels as ref_kernels
    from tpu_render_cluster_torch.render.compaction import wavefront_eligible
    from tpu_render_cluster_torch.render.kernels import mesh_megakernel_eligible
    from tpu_render_cluster_torch.render.mesh import scene_mesh_set

    port_scene.build_scene(name, 1, "cpu")
    mesh = scene_mesh_set(name, 1)
    reference = ref_mesh.scene_mesh_set(name, 1, "sah", 4)
    assert mesh_megakernel_eligible(mesh) == ref_kernels.mesh_megakernel_eligible(reference)
    assert mesh_megakernel_eligible(mesh) == (name == "02_physics-mesh")
    assert wavefront_eligible(mesh) == ref_kernels.wavefront_eligible(reference)


def _job_names() -> list[str]:
    names = []
    for path in sorted(REPO.glob("blender-projects/*/*.toml")):
        with path.open("rb") as f:
            names.append(tomllib.load(f)["job_name"])
    return names


def test_scene_for_job_name_agrees_on_every_job_file():
    names = _job_names()
    assert len(names) > 40
    extra = ["02_physics-mesh_x", "03ph2_demo", "unknown-job"]
    for name in names + extra:
        assert port_scene.scene_for_job_name(name) == ref_scene.scene_for_job_name(name), name
