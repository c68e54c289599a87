"""The instanced unit kernels' plain versions (``kernels.intersect_instances``
and ``kernels.occluded_instances``) and the port's ``mesh.intersect_instances``
/ ``mesh.occluded_instances`` against the JAX package (the CUDA kernels
themselves are held against the plain versions on a GPU by
tests/test_torch_kernels_cuda.py).

The reference runs ``intersect_instances_pallas`` / ``occluded_instances_pallas``
in interpret mode (``TRC_PALLAS=1``: one launch, then the normal and albedo
gathers) and its XLA branch (``TRC_PALLAS=0``: a ``lax.scan`` of per-instance
packet walks), after tests/test_mesh.py. Two setups: 03_physics-2-mesh's 48
icospheres seen from frame 30's camera (a grid with seeded jitter, and rays
toward points around the instances), and five boxes of random rotation,
scale and albedo under random rays toward them. Each covers a
seeded ``init_t`` (seeds that the mesh beats, seeds that beat the mesh -- a
seeded miss, which must keep a zero normal and albedo -- and seeds on rays
that miss every instance), ``already`` lanes, and dead lanes parked as the
scan renderer parks them (origin 1e7, heading up).

Tolerances, as tests/test_mesh.py's: t within rtol = atol = 1e-4 on every
ray; the triangle row, instance, normal (1e-4) and albedo equal on every hit
ray but an exact-tie budget of max(1, round(0.001 R)) rays (a ray through a
shared edge may take either face, and the walks visit instances in other
orders); the any-hit equal on every ray but the same budget.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_mesh import reference_mesh_arrays
from tpu_render_cluster.render import camera as ref_camera
from tpu_render_cluster.render import mesh as ref_mesh
from tpu_render_cluster.render import pallas_kernels as ref_kernels
from tpu_render_cluster_torch.render import kernels
from tpu_render_cluster_torch.render import mesh as port_mesh

INF = 1e30
SETUPS = ("03_physics-2-mesh", "boxes")


def _budget(rays: int) -> int:
    return max(1, round(0.001 * rays))


@functools.lru_cache(maxsize=None)
def _setup(name: str):
    """(reference MeshSet, port MeshSet, origins, directions, init_t, already,
    dead), all numpy but the mesh sets."""
    rng = np.random.default_rng(17)
    if name == "boxes":
        k = 5
        mesh_set = ref_mesh.MeshSet(
            bvh=ref_mesh.cached_mesh_bvh("box"),
            instances=ref_mesh.MeshInstances(
                rotation=ref_mesh.rotation_y(
                    jnp.asarray(rng.uniform(0, 2 * np.pi, size=k).astype(np.float32))
                ).astype(jnp.float32),
                translation=jnp.asarray(rng.uniform(-2, 2, size=(k, 3)).astype(np.float32)),
                albedo=jnp.asarray(rng.uniform(0.2, 1.0, size=(k, 3)).astype(np.float32)),
                scale=jnp.asarray(rng.uniform(0.5, 1.5, size=k).astype(np.float32)),
            ),
        )
        rays = 480
        origins = (rng.normal(size=(rays, 3)) * 0.8 + [0.0, 0.0, -6.0]).astype(np.float32)
        targets = np.asarray(mesh_set.instances.translation)[rng.integers(0, k, size=rays)]
        directions = targets + rng.normal(size=(rays, 3)) * 0.6 - origins
    else:
        mesh_set = ref_mesh.scene_mesh_set(name, 30, "sah", 4)
        camera = ref_camera.scene_camera(name, 30)
        o, d = ref_camera.camera_rays(
            camera, 24, 10, y0=0, x0=0, tile_height=10, tile_width=24,
            jitter=jnp.asarray(rng.random((24 * 10, 2), dtype=np.float32)),
        )
        # Half the rays from the camera grid, half from the camera toward
        # points around the instances.
        toward = np.asarray(mesh_set.instances.translation)[rng.integers(0, 48, size=240)]
        toward = toward + rng.normal(size=(240, 3)) * 0.4
        origins = np.concatenate([np.array(o), np.repeat(np.array(o)[:1], 240, axis=0)])
        directions = np.concatenate([np.array(d), toward - origins[240:]])
        rays = origins.shape[0]
    directions = (directions / np.linalg.norm(directions, axis=1, keepdims=True)).astype(np.float32)

    # The unseeded nearest hit, to place the seeds around it.
    t_free = np.asarray(
        ref_kernels.intersect_instances_pallas(
            mesh_set.bvh, mesh_set.instances, jnp.asarray(origins), jnp.asarray(directions)
        )[0]
    )
    hits = t_free < 1e29
    assert hits.sum() > rays // 5, "the rays must hit instances"
    draw = rng.random(rays)
    init_t = np.full(rays, INF, np.float32)
    init_t[hits & (draw < 0.3)] = t_free[hits & (draw < 0.3)] * 0.9  # seeded misses
    init_t[hits & (draw > 0.6)] = t_free[hits & (draw > 0.6)] * 1.1  # the mesh wins
    init_t[~hits & (draw < 0.5)] = rng.uniform(5.0, 20.0, size=(~hits & (draw < 0.5)).sum())
    dead = rng.random(rays) < 0.1
    origins[dead] = 1e7
    directions[dead] = [0.0, 1.0, 0.0]
    init_t[dead] = INF
    already = (rng.random(rays) < 0.2) | dead
    port = port_mesh.mesh_from_arrays(*reference_mesh_arrays(mesh_set), "cpu")
    return mesh_set, port, origins, directions, init_t.astype(np.float32), already, dead


@functools.lru_cache(maxsize=None)
def _reference(name: str, pallas: bool):
    """The reference's mesh-level nearest hit (t, normal, albedo) and any-hit
    on the setup, under its Pallas or its XLA branch."""
    import os

    mesh_set, _, origins, directions, init_t, already, _ = _setup(name)
    prior = os.environ.get("TRC_PALLAS")
    os.environ["TRC_PALLAS"] = "1" if pallas else "0"
    try:
        o, d = jnp.asarray(origins), jnp.asarray(directions)
        nearest = ref_mesh.intersect_instances(
            mesh_set.bvh, mesh_set.instances, o, d, init_t=jnp.asarray(init_t)
        )
        occluded = ref_mesh.occluded_instances(
            mesh_set.bvh, mesh_set.instances, o, d, already=jnp.asarray(already)
        )
    finally:
        if prior is None:
            del os.environ["TRC_PALLAS"]
        else:
            os.environ["TRC_PALLAS"] = prior
    return tuple(np.asarray(a) for a in nearest), np.asarray(occluded)


def _port_inputs(name: str):
    _, port, origins, directions, init_t, already, _ = _setup(name)
    return (
        port, torch.from_numpy(origins), torch.from_numpy(directions), torch.from_numpy(init_t),
        torch.from_numpy(already),
    )


@pytest.mark.parametrize("name", SETUPS)
def test_instanced_kernel_rows_match_pallas(name):
    """The plain version's raw outputs (t, triangle row, instance) against
    the interpret-mode kernel's: the row indexes the BVH's tables as the
    reference's ``start + local`` does."""
    mesh_set, _, origins, directions, init_t, _, dead = _setup(name)
    t_ref, tri_ref, inst_ref = (
        np.asarray(a)
        for a in ref_kernels.intersect_instances_pallas(
            mesh_set.bvh, mesh_set.instances, jnp.asarray(origins), jnp.asarray(directions),
            jnp.asarray(init_t),
        )
    )
    port, o, d, seed, _ = _port_inputs(name)
    kernels.reset_counts()
    t, tri, inst = kernels.intersect_instances(port, o, d, seed)
    assert kernels.counts == {
        k: int(k == "intersect_instances_reference") for k in kernels.counts
    }
    assert t.dtype == torch.float32 and tri.dtype == torch.int32 and inst.dtype == torch.int32
    t, tri, inst = t.numpy(), tri.numpy(), inst.numpy()
    np.testing.assert_allclose(t, t_ref, rtol=1e-4, atol=1e-4)
    hit = t_ref < init_t
    assert hit.sum() > 20 and (~hit).sum() > 20
    differ = hit & ((tri != tri_ref) | (inst != inst_ref))
    assert differ.sum() <= _budget(t.size), np.flatnonzero(differ)
    # A miss returns the seed itself, and row and instance 0.
    np.testing.assert_array_equal(t[~hit], init_t[~hit])
    assert (tri[~hit] == 0).all() and (inst[~hit] == 0).all()
    assert not hit[dead].any()


@pytest.mark.parametrize("pallas", [True, False], ids=["pallas", "xla"])
@pytest.mark.parametrize("name", SETUPS)
def test_intersect_instances_matches_reference(name, pallas):
    (t_ref, normal_ref, albedo_ref), _ = _reference(name, pallas)
    _, _, _, _, init_t, _, _ = _setup(name)
    port, o, d, seed, _ = _port_inputs(name)
    kernels.reset_counts()
    t, normal, albedo = (a.numpy() for a in port_mesh.intersect_instances(port, o, d, init_t=seed))
    assert kernels.counts["intersect_instances_reference"] == 1
    np.testing.assert_allclose(t, t_ref, rtol=1e-4, atol=1e-4)
    hit = t_ref < init_t
    differ = hit & (
        ~np.isclose(normal, normal_ref, rtol=1e-4, atol=1e-4).all(axis=1)
        | (albedo != albedo_ref).any(axis=1)
    )
    assert differ.sum() <= _budget(t.size), np.flatnonzero(differ)
    # Misses, seeded ones included, keep a zero normal and albedo.
    assert (normal[~hit] == 0).all() and (albedo[~hit] == 0).all()
    assert (normal_ref[~hit] == 0).all() and (albedo_ref[~hit] == 0).all()
    # Every normal faces its ray.
    assert ((normal[hit] * d.numpy()[hit]).sum(axis=1) < 0).all()


@pytest.mark.parametrize("pallas", [True, False], ids=["pallas", "xla"])
@pytest.mark.parametrize("name", SETUPS)
def test_occluded_instances_matches_reference(name, pallas):
    _, expected = _reference(name, pallas)
    _, _, _, _, _, already, dead = _setup(name)
    port, o, d, _, lanes_already = _port_inputs(name)
    kernels.reset_counts()
    got = port_mesh.occluded_instances(port, o, d, already=lanes_already).numpy()
    assert kernels.counts == {
        k: int(k == "occluded_instances_reference") for k in kernels.counts
    }
    assert got[already].all()
    assert (got != expected).sum() <= _budget(got.size), np.flatnonzero(got != expected)
    assert got[~already].any() and not got[~already].all()
    # Without the mask the parked dead lanes miss every instance.
    free = port_mesh.occluded_instances(port, o, d).numpy()
    assert not free[dead].any()


def test_plain_instance_versions_count_their_work():
    port, o, d, seed, already = _port_inputs("03_physics-2-mesh")
    stats: dict = {}
    kernels.intersect_instances_reference(port, o, d, seed, stats=stats)
    assert stats["instances"] == 48 and stats["broadphase_rays"] == o.shape[0]
    assert stats["world_aabb_tests"] == 48 * o.shape[0]
    assert 0 < stats["instance_walks"] <= stats["world_aabb_tests"]
    assert stats["node_tests"] >= stats["instance_walks"] and stats["triangle_tests"] > 0
    shadow: dict = {}
    kernels.occluded_instances_reference(port, o, d, already, stats=shadow)
    assert shadow["broadphase_rays"] == int((~already).sum())
    assert shadow["world_aabb_tests"] <= 48 * shadow["broadphase_rays"]


def test_instance_wrappers_check_their_inputs():
    port, o, d, seed, already = _port_inputs("boxes")
    with pytest.raises(ValueError, match="init_t must be torch.float32"):
        kernels.intersect_instances(port, o, d, seed.double())
    with pytest.raises(ValueError, match="already must be torch.bool"):
        kernels.occluded_instances(port, o, d, already[:-1])
    with pytest.raises(TypeError, match="float32"):
        kernels.occluded_instances(port, o.double(), d, already)
