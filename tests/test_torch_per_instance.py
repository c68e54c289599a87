"""The scan renderer's per-instance mesh queries (``per_instance=True``:
``mesh.intersect_instances`` / ``mesh.occluded_instances`` as a scan over the
instances, one single-BVH walk per instance) against the JAX package's own
branch with Pallas off (``TRC_PALLAS`` unset: its ``lax.scan`` of
``intersect_bvh_packet`` / ``occluded_bvh_packet``), compiled with
``jax.jit`` as its scan renderer compiles it; and against the port's own
instanced branch (rows 7 and 8). The walks run through their plain versions
here (CPU tensors).

Inputs: the very arguments the port's scan passes to the two queries at
bounces 0 and 1 of 24x24 frames of 03_physics-2-mesh and 02_physics-mesh
(recorded from ``integrator.trace_paths_scan``): rays seeded with the
sphere/plane t, dead lanes parked at 1e7 heading up, shadow rays with their
``already`` lanes.

Tolerances:
- ``_rays_to_object_space``, the per-instance normal transform and the
  facing flip: bit for bit against the reference's, jitted on the CPU, on
  every instance of both mesh scenes;
- the queries: t within rtol = atol = 1e-4 on every ray; the normal (1e-4)
  and albedo on every hit ray, and the any-hit on every ray, but an
  exact-tie budget of max(1, round(0.001 R)) rays;
- the two port branches: t bit-equal on every ray; the ids they imply (the
  albedo) and the any-hit equal but on exact ties between instances, which
  are counted and held under the same budget; normals within 1e-5 (the
  instanced branch rounds its normal transform without FMAs).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_mesh import reference_mesh_arrays
from tpu_render_cluster.render import mesh as ref_mesh
from tpu_render_cluster_torch.render import integrator, kernels
from tpu_render_cluster_torch.render import mesh as port_mesh
from tpu_render_cluster_torch.render import scene as port_scene
from tpu_render_cluster_torch.render.camera import scene_camera

MESH_SCENES = ("03_physics-2-mesh", "02_physics-mesh")
FRAME, SIDE = 30, 24


def _budget(rays: int) -> int:
    return max(1, round(0.001 * rays))


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


@pytest.fixture
def xla_reference(monkeypatch):
    """The reference with Pallas off; compiled programs dropped before and
    after, since the switch is read when a function is traced."""
    monkeypatch.delenv("TRC_PALLAS", raising=False)
    jax.clear_caches()
    yield
    jax.clear_caches()


@functools.lru_cache(maxsize=None)
def _mesh_sets(name: str):
    """(reference MeshSet, the port's on the CPU with the same arrays)."""
    mesh_set = ref_mesh.scene_mesh_set(name, FRAME, "sah", 4)
    return mesh_set, port_mesh.mesh_from_arrays(*reference_mesh_arrays(mesh_set), "cpu")


@functools.lru_cache(maxsize=None)
def _scan_queries(name: str):
    """The arguments of the port scan's instance queries at bounces 0 and 1
    of one 24x24 sample: [(origins, directions, init_t)], [(origins,
    directions, already)], numpy."""
    _, port = _mesh_sets(name)
    scene = port_scene.build_scene(name, FRAME, "cpu")
    key = integrator.rng.fold_in(integrator.tile_base_key(FRAME, 0, 0), 1)
    origins, directions = integrator.sample_jitter_rays(
        scene_camera(name, FRAME, "cpu"), key, width=SIDE, height=SIDE, y0=0, x0=0,
        tile_height=SIDE, tile_width=SIDE,
    )
    nearest, shadow = [], []

    def record_nearest(mesh, o, d, init_t, per_instance):
        nearest.append(tuple(a.numpy().copy() for a in (o, d, init_t)))
        return port_mesh.intersect_instances(mesh, o, d, init_t)

    def record_shadow(mesh, o, d, already, per_instance):
        shadow.append(tuple(a.numpy().copy() for a in (o, d, already)))
        return port_mesh.occluded_instances(mesh, o, d, already)

    patch = pytest.MonkeyPatch()
    patch.setattr(integrator, "intersect_instances", record_nearest)
    patch.setattr(integrator, "occluded_instances", record_shadow)
    try:
        integrator.trace_paths_scan(
            scene, origins, directions, integrator.rng.split(key)[1], max_bounces=2, mesh=port,
        )
    finally:
        patch.undo()
    assert len(nearest) == len(shadow) == 2
    return nearest, shadow


def _torch(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("name", MESH_SCENES)
def test_rays_to_object_space_is_bit_equal(name):
    """Every instance's object-space rays, normals and the facing test,
    against the reference's expressions jitted on the CPU."""
    ref_set, port = _mesh_sets(name)
    origins, directions, _ = _scan_queries(name)[0][0]
    rng = np.random.default_rng(3)
    normals = rng.normal(size=origins.shape).astype(np.float32)
    to_object = jax.jit(ref_mesh._rays_to_object_space)
    to_world = jax.jit(ref_mesh._normals_to_world)
    for k in range(port.instances.translation.shape[0]):
        want_o, want_d = to_object(ref_set.instances, k, origins, directions)
        got_o, got_d = port_mesh._rays_to_object_space(port.instances, k, *_torch(origins, directions))
        np.testing.assert_array_equal(_bits(got_o.numpy()), _bits(want_o), err_msg=f"origins, {k}")
        np.testing.assert_array_equal(_bits(got_d.numpy()), _bits(want_d), err_msg=f"directions, {k}")
        want_n = to_world(ref_set.instances.rotation[k], normals)
        got_n = port_mesh._normal_to_world(port.instances.rotation[k], torch.from_numpy(normals))
        np.testing.assert_array_equal(_bits(got_n.numpy()), _bits(want_n), err_msg=f"normals, {k}")
    # The facing test sums as jnp.sum reduces (not as a written-out dot).
    want = np.asarray(jax.jit(lambda n, d: jnp.sum(n * d, axis=-1))(normals, directions))
    n, d = _torch(normals, directions)
    got = port_mesh.fma(n[:, 2], d[:, 2], port_mesh.fma(n[:, 1], d[:, 1], n[:, 0] * d[:, 0]))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("bounce", [0, 1])
@pytest.mark.parametrize("name", MESH_SCENES)
def test_per_instance_queries_match_reference_scan(xla_reference, name, bounce):
    ref_set, port = _mesh_sets(name)
    nearest, shadow = _scan_queries(name)
    origins, directions, init_t = nearest[bounce]
    want_t, want_n, want_a = (
        np.asarray(a)
        for a in jax.jit(ref_mesh.intersect_instances)(
            ref_set.bvh, ref_set.instances, origins, directions, init_t
        )
    )
    kernels.reset_counts()
    t, normal, albedo = (
        a.numpy()
        for a in port_mesh.intersect_instances(
            port, *_torch(origins, directions), init_t=torch.from_numpy(init_t), per_instance=True
        )
    )
    k = port.instances.translation.shape[0]
    assert kernels.counts == {n: k * (n == "intersect_mesh_reference") for n in kernels.counts}
    np.testing.assert_allclose(t, want_t, rtol=1e-4, atol=1e-4)
    hit = want_t < init_t
    differ = hit & (
        ~np.isclose(normal, want_n, rtol=1e-4, atol=1e-4).all(axis=1) | (albedo != want_a).any(axis=1)
    )
    assert differ.sum() <= _budget(t.size), np.flatnonzero(differ)
    assert hit.sum() > 10 and (~hit).sum() > 10
    # Misses keep a zero normal and albedo; every hit's normal faces its ray.
    assert (normal[~hit] == 0).all() and (albedo[~hit] == 0).all()
    assert ((normal[hit] * directions[hit]).sum(axis=1) < 0).all()
    parked = origins[:, 0] == 1e7
    assert parked.any() == (bounce == 1) and not hit[parked].any()

    origins, directions, already = shadow[bounce]
    want = np.asarray(
        jax.jit(ref_mesh.occluded_instances)(ref_set.bvh, ref_set.instances, origins, directions, already)
    )
    kernels.reset_counts()
    got = port_mesh.occluded_instances(
        port, *_torch(origins, directions), already=torch.from_numpy(already), per_instance=True
    ).numpy()
    assert kernels.counts == {n: k * (n == "occluded_mesh_reference") for n in kernels.counts}
    assert (got != want).sum() <= _budget(got.size), np.flatnonzero(got != want)
    assert got[already].all() and got[~already].any() and not got[~already].all()


@pytest.mark.parametrize("bounce", [0, 1])
@pytest.mark.parametrize("name", MESH_SCENES)
def test_per_instance_branch_matches_instanced_branch(name, bounce):
    """The port's two branches on the same rays: the same transform and
    walk per instance, so t to the bit; the winner may differ only where
    two instances tie exactly, counted here."""
    _, port = _mesh_sets(name)
    nearest, shadow = _scan_queries(name)
    origins, directions, init_t = _torch(*nearest[bounce])
    each = port_mesh.intersect_instances(port, origins, directions, init_t, per_instance=True)
    one = port_mesh.intersect_instances(port, origins, directions, init_t)
    np.testing.assert_array_equal(_bits(each[0].numpy()), _bits(one[0].numpy()))
    ties = (each[2] != one[2]).any(dim=1)
    assert int(ties.sum()) <= _budget(origins.shape[0]), ties.nonzero()
    close = torch.isclose(each[1], one[1], rtol=1e-5, atol=1e-5).all(dim=1)
    assert bool((close | ties).all())
    o, d, already = _torch(*shadow[bounce])
    apart = port_mesh.occluded_instances(port, o, d, already, per_instance=True) != \
        port_mesh.occluded_instances(port, o, d, already)
    assert int(apart.sum()) <= _budget(o.shape[0])


def test_scan_launches_one_walk_per_instance():
    """On the CPU the per-instance scan calls each single-BVH plain version
    K times per sample and bounce, the sphere queries once, and nothing
    else: no instanced query, no kernel."""
    name, bounces, samples = "03_physics-2-mesh", 2, 2
    kernels.reset_counts()
    integrator.render_frame(
        name, 3, width=8, height=6, samples=samples, max_bounces=bounces, device="cpu",
        bounce_scan=True, per_instance=True,
    )
    steps = samples * bounces
    k = 48
    assert kernels.counts == {
        n: {
            "intersect_mesh_reference": k * steps, "occluded_mesh_reference": k * steps,
            "intersect_spheres_reference": steps, "occluded_spheres_reference": steps,
        }.get(n, 0)
        for n in kernels.counts
    }


def test_per_instance_needs_the_bounce_scan(tmp_path):
    from tpu_render_cluster_torch.worker.backends.torch_raytrace import TorchRaytraceBackend

    with pytest.raises(ValueError, match="bounce_scan"):
        integrator.render_frame("03_physics-2-mesh", 1, width=4, height=4, device="cpu", per_instance=True)
    with pytest.raises(ValueError, match="bounce_scan"):
        integrator.fused_frame_renderer("03_physics-2-mesh", 4, 4, 1, 1, "cpu", per_instance=True)
    with pytest.raises(ValueError, match="bounce_scan"):
        TorchRaytraceBackend(device="cpu", base_directory=tmp_path, per_instance=True)
    each = integrator.fused_frame_renderer(
        "03_physics-2-mesh", 4, 4, 1, 1, "cpu", bounce_scan=True, per_instance=True
    )
    assert each is integrator.fused_frame_renderer(
        "03_physics-2-mesh", 4, 4, 1, 1, "cpu", bounce_scan=True, per_instance=True
    )
    assert each is not integrator.fused_frame_renderer(
        "03_physics-2-mesh", 4, 4, 1, 1, "cpu", bounce_scan=True
    )
