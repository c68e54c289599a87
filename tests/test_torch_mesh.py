"""The port's mesh geometry against the JAX package's: the BVH build, the
mesh scenes' instances and spheres, and the instance table the mesh kernel
reads.

Tolerances:
- BVH tables: exact, array for array (same numpy build on the same
  float32 vertices), octant re-threadings included.
- Instances, rotations, scene arrays, instance table: rtol = atol = 1e-6
  (the same float32 expressions; sin, cos and log of the two libraries may
  differ in the last bit).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tpu_render_cluster.render import mesh as ref_mesh
from tpu_render_cluster.render import pallas_kernels as ref_kernels
from tpu_render_cluster.render import scene as ref_scene
from tpu_render_cluster_torch.render import kernels
from tpu_render_cluster_torch.render import mesh as port_mesh
from tpu_render_cluster_torch.render import scene as port_scene

MESH_SCENES = port_scene.MESH_SCENE_NAMES
FRAMES = (0, 30, 77)


def _close(got: torch.Tensor, expected) -> None:
    expected = np.asarray(expected)
    assert got.dtype == torch.float32 and tuple(got.shape) == expected.shape
    np.testing.assert_allclose(got.numpy(), expected, rtol=1e-6, atol=1e-6)


def reference_mesh_arrays(mesh_set) -> tuple[dict, dict]:
    """A reference MeshSet as the numpy dicts ``mesh_from_arrays`` takes."""
    bvh = {f: np.asarray(getattr(mesh_set.bvh, f)) for f in ref_mesh.MeshBVH._fields[:-1]}
    if mesh_set.bvh.octant is not None:
        bvh["octant"] = {f: np.asarray(v) for f, v in mesh_set.bvh.octant._asdict().items()}
    instances = {f: np.asarray(v) for f, v in mesh_set.instances._asdict().items()}
    return bvh, instances


@pytest.mark.parametrize("wide", [1, 4])
@pytest.mark.parametrize("builder", ["sah", "median"])
@pytest.mark.parametrize("kind", ["box", "icosphere"])
def test_bvh_build_equals_reference(kind, builder, wide):
    geometry = ref_mesh.make_box() if kind == "box" else ref_mesh.make_icosphere(2)
    expected = ref_mesh.build_bvh(*geometry, builder=builder, wide=wide)
    got = port_mesh.cached_mesh_bvh(kind, builder, wide)
    for field in ref_mesh.MeshBVH._fields[:-1]:
        want = np.asarray(getattr(expected, field))
        have = getattr(got, field).numpy()
        assert have.dtype == want.dtype and have.shape == want.shape, field
        np.testing.assert_array_equal(have, want, err_msg=field)
    assert (got.octant is None) == (expected.octant is None) == (builder == "median")
    if got.octant is not None:
        for field in ref_mesh.OctantTables._fields:
            np.testing.assert_array_equal(
                getattr(got.octant, field).numpy(), np.asarray(getattr(expected.octant, field)),
                err_msg=field,
            )


def test_procedural_meshes_equal_reference():
    for port_make, ref_make in ((port_mesh.make_box, ref_mesh.make_box),
                                (port_mesh.make_icosphere, ref_mesh.make_icosphere)):
        for got, want in zip(port_make(), ref_make()):
            np.testing.assert_array_equal(got, want)


def test_bvh_cache_keys_every_build_parameter():
    a = port_mesh.cached_mesh_bvh("icosphere", "sah", 4)
    assert port_mesh.cached_mesh_bvh("icosphere", "sah", 4, torch.device("cpu")) is a
    assert port_mesh.cached_mesh_bvh("icosphere", "sah", 1) is not a
    assert port_mesh.cached_mesh_bvh("icosphere", "median", 4) is not a
    port_mesh._geometry_cache.clear()
    rebuilt = port_mesh.cached_mesh_bvh("icosphere", "sah", 4)
    assert rebuilt is not a and torch.equal(rebuilt.skip, a.skip)
    with pytest.raises(ValueError, match="mesh kind"):
        port_mesh.cached_mesh_bvh("teapot")
    with pytest.raises(ValueError, match="builder"):
        port_mesh.build_bvh(*port_mesh.make_box(), builder="lbvh")


@pytest.mark.parametrize("frame", FRAMES)
@pytest.mark.parametrize("name", MESH_SCENES)
def test_mesh_instances_match_reference(name, frame):
    expected = ref_scene.build_mesh_instances(name, frame)
    got = port_scene.build_mesh_instances(name, frame, "cpu")
    assert got._fields == expected._fields
    for field in expected._fields:
        _close(getattr(got, field), getattr(expected, field))
    assert port_scene.mesh_kind_for_scene(name) == ref_scene.mesh_kind_for_scene(name)


@pytest.mark.parametrize("frame", FRAMES)
@pytest.mark.parametrize("name", MESH_SCENES)
def test_mesh_scene_spheres_match_reference(name, frame):
    expected = ref_scene.build_scene(name, frame)
    got = port_scene.build_scene(name, frame, "cpu")
    for field in expected._fields:
        _close(getattr(got, field), getattr(expected, field))


def test_sphere_scenes_have_no_mesh():
    for name in ("04_very-simple", "03_physics-2"):
        assert port_scene.build_mesh_instances(name, 3) is None
        assert port_mesh.scene_mesh_set(name, 3) is None


def test_rotation_y_matches_reference():
    angles = np.linspace(-7.0, 7.0, 41, dtype=np.float32)
    _close(port_mesh.rotation_y(torch.from_numpy(angles)), ref_mesh.rotation_y(angles))


@pytest.mark.parametrize("frame", FRAMES)
@pytest.mark.parametrize("name", MESH_SCENES)
def test_instance_table_matches_reference(name, frame):
    expected_set = ref_mesh.scene_mesh_set(name, frame, "sah", 4)
    expected = ref_kernels._instance_table(
        expected_set.instances.rotation, expected_set.instances.translation,
        expected_set.instances.scale, expected_set.bvh.bounds_min,
        expected_set.bvh.bounds_max, expected_set.instances.albedo,
    )
    got = kernels.instance_table(port_mesh.scene_mesh_set(name, frame))
    _close(got, expected)
    # Fed the reference's own arrays, the table agrees bit for bit.
    fed = port_mesh.mesh_from_arrays(*reference_mesh_arrays(expected_set), "cpu")
    np.testing.assert_array_equal(kernels.instance_table(fed).numpy(), np.asarray(expected))


def test_mesh_from_arrays_round_trip():
    expected = ref_mesh.scene_mesh_set("03_physics-2-mesh", 12, "sah", 4)
    got = port_mesh.mesh_from_arrays(*reference_mesh_arrays(expected), "cpu")
    for field in ref_mesh.MeshBVH._fields[:-1]:
        np.testing.assert_array_equal(getattr(got.bvh, field).numpy(),
                                      np.asarray(getattr(expected.bvh, field)))
    for field in ref_mesh.OctantTables._fields:
        np.testing.assert_array_equal(getattr(got.bvh.octant, field).numpy(),
                                      np.asarray(getattr(expected.bvh.octant, field)))
    for field in ref_mesh.MeshInstances._fields:
        np.testing.assert_array_equal(getattr(got.instances, field).numpy(),
                                      np.asarray(getattr(expected.instances, field)))


@pytest.mark.parametrize("name", MESH_SCENES)
def test_megakernel_eligibility_matches_reference(name):
    expected = ref_kernels.mesh_megakernel_eligible(ref_mesh.scene_mesh_set(name, 5, "sah", 4))
    assert kernels.mesh_megakernel_eligible(port_mesh.scene_mesh_set(name, 5)) == expected
    assert expected == (name == "02_physics-mesh")
    assert kernels.MESH_MEGAKERNEL_MAX_WALK == ref_kernels.MESH_MEGAKERNEL_MAX_WALK
