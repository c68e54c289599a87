"""The mesh megakernel's plain version against the JAX package's mesh
kernels, and the kernel library's build digest (the CUDA kernel itself is
held against the plain version on a GPU by tests/test_torch_kernels_cuda.py).

The reference runs ``pallas_kernels.trace_paths_fused_mesh`` in interpret
mode on the CPU, in both of its instance-walk variants (flat and TLAS) with
full-precision node tables. Inputs travel across as numpy arrays.

Tolerances, per ray over its three channels, rtol = atol = 1e-4:
- 1 bounce: every ray, except an edge-tie budget of max(1, round(0.001 R))
  rays: a ray through the shared edge of two triangles may take either
  face's normal. Both sides walk the octant-ordered node tables of their
  packets' votes (the scene's sah BVH carries them), so an exact tie goes
  the same way on both; the budget stays for the rounding at an edge.
- 4 bounces: at least 99.9% of rays (a path tracer is chaotic).

The deep tree (03_physics-2-mesh's icosphere, 39 nodes x 48 instances, past
the megakernel's dispatch bound) is held against the reference's XLA twin
(``integrator.trace_paths`` with ``TRC_PALLAS=0``) at 1 bounce, with the
budget of tests/test_mesh_megakernel.py: at most max(1, round(0.001 R))
rays beyond 2e-3 and a mean absolute error below 1e-4.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_mesh import reference_mesh_arrays
from tpu_render_cluster.render import camera as ref_camera
from tpu_render_cluster.render import integrator as ref_integrator
from tpu_render_cluster.render import mesh as ref_mesh
from tpu_render_cluster.render import pallas_kernels as ref_kernels
from tpu_render_cluster.render import scene as ref_scene
from tpu_render_cluster_torch.render import _build, integrator, kernels
from tpu_render_cluster_torch.render import mesh as port_mesh
from tpu_render_cluster_torch.render import scene as port_scene

SCENE, FRAME = "02_physics-mesh", 30


@functools.lru_cache(maxsize=None)
def _inputs(name: str, frame: int):
    """(reference scene, reference mesh set, port scene, port mesh)."""
    scene = ref_scene.build_scene(name, frame)
    mesh_set = ref_mesh.scene_mesh_set(name, frame, "sah", 4)
    port = port_scene.scene_from_arrays({k: np.asarray(v) for k, v in scene._asdict().items()}, "cpu")
    return scene, mesh_set, port, port_mesh.mesh_from_arrays(*reference_mesh_arrays(mesh_set), "cpu")


@functools.lru_cache(maxsize=None)
def _rays(source: str):
    """Camera rays of frame 30 (40 x 24 pixels x 2 samples) with the
    frame's trace seed, or 1,000 random rays with a fixed seed."""
    if source == "camera":
        camera = ref_camera.scene_camera(SCENE, FRAME)
        origins, directions, seed = ref_integrator.frame_rays_and_seed(
            camera, jnp.float32(FRAME), width=40, height=24, samples=2
        )
        return np.array(origins), np.array(directions), int(seed)
    rng = np.random.default_rng(3)
    origins = (rng.normal(size=(1000, 3)) * 3.0 + [0.0, 2.0, 0.0]).astype(np.float32)
    directions = rng.normal(size=(1000, 3))
    directions = (directions / np.linalg.norm(directions, axis=1, keepdims=True)).astype(np.float32)
    return origins, directions, 1321130979


@pytest.fixture
def pallas_on(monkeypatch):
    monkeypatch.setenv("TRC_PALLAS", "1")


@pytest.mark.parametrize(
    "source,use_tlas,max_bounces",
    [("camera", False, 1), ("camera", True, 1), ("camera", False, 4), ("camera", True, 4),
     ("random", False, 1), ("random", True, 4)],
)
def test_plain_version_matches_pallas_interpret(pallas_on, source, use_tlas, max_bounces):
    scene, mesh_set, port, port_mesh_set = _inputs(SCENE, FRAME)
    origins, directions, seed = _rays(source)
    expected = np.asarray(
        ref_kernels.trace_paths_fused_mesh(
            scene, mesh_set, jnp.asarray(origins), jnp.asarray(directions), jnp.int32(seed),
            max_bounces=max_bounces, use_tlas=use_tlas, quant=0,
        )
    )
    got = kernels.trace_paths_fused_mesh_reference(
        port, port_mesh_set, torch.from_numpy(origins), torch.from_numpy(directions), seed,
        max_bounces=max_bounces, use_tlas=use_tlas,
    ).numpy()
    assert got.shape == expected.shape and np.isfinite(got).all()
    close = np.isclose(got, expected, rtol=1e-4, atol=1e-4).all(axis=1)
    if max_bounces == 1:
        assert (~close).sum() <= max(1, round(0.001 * close.size)), np.abs(got - expected).max()
    else:
        assert close.mean() >= 0.999, close.mean()
    assert got.max() > 0.1


def test_plain_version_walks_the_deep_tree_like_the_xla_twin(monkeypatch):
    name = "03_physics-2-mesh"
    scene, mesh_set, port, port_mesh_set = _inputs(name, FRAME)
    assert not ref_kernels.mesh_megakernel_eligible(mesh_set)
    side = 24
    jitter = np.random.default_rng(11).random((side * side, 2), dtype=np.float32)
    origins, directions = ref_camera.camera_rays(
        ref_camera.scene_camera(name, FRAME), side, side, y0=0, x0=0,
        tile_height=side, tile_width=side, jitter=jnp.asarray(jitter),
    )
    monkeypatch.setenv("TRC_PALLAS", "0")
    jax.clear_caches()
    expected = np.asarray(
        ref_integrator.trace_paths(
            scene, origins, directions, jax.random.PRNGKey(3), max_bounces=1, mesh=mesh_set
        )
    )
    jax.clear_caches()
    stats: dict = {}
    got = kernels.trace_paths_fused_mesh_reference(
        port, port_mesh_set, torch.from_numpy(np.array(origins)),
        torch.from_numpy(np.array(directions)), 3, max_bounces=1, stats=stats,
    ).numpy()
    lane_diff = np.abs(got - expected).max(axis=1)
    budget = max(1, round(0.001 * lane_diff.size))
    assert int((lane_diff > 2e-3).sum()) <= budget
    assert float(np.abs(got - expected).mean()) < 1e-4
    # The walk went deep: more node tests than instance walks entered.
    assert stats["node_tests"] > 2 * stats["instance_walks"] > 0


def test_plain_version_counts_the_mesh_work():
    _, _, port, port_mesh_set = _inputs(SCENE, FRAME)
    origins, directions, seed = _rays("camera")
    stats: dict = {}
    kernels.trace_paths_fused_mesh_reference(
        port, port_mesh_set, torch.from_numpy(origins), torch.from_numpy(directions), seed,
        max_bounces=4, use_tlas=False, stats=stats,
    )
    k = port_mesh_set.instances.translation.shape[0]
    rays = origins.shape[0]
    # 12 spheres; the 4 pad slots of the 16-slot table are not counted.
    assert stats["spheres"] == 12
    assert rays <= stats["alive_lane_bounces"] <= 4 * rays
    # Every alive lane-bounce tests every instance's world box once; shadow
    # rays test at most every instance.
    nearest_tests = k * stats["alive_lane_bounces"]
    assert nearest_tests < stats["world_aabb_tests"] <= nearest_tests + k * stats["hit_lane_bounces"]
    # Each of those searches starts once: every alive lane's nearest ray,
    # and the shadow rays that no sphere blocks.
    assert stats["instances"] == k
    searches = stats["broadphase_rays"]
    assert stats["alive_lane_bounces"] < searches <= stats["alive_lane_bounces"] + stats["hit_lane_bounces"]
    assert stats["world_aabb_tests"] <= k * searches
    # One node (the box's root leaf): one slab test per instance walk.
    assert 0 < stats["node_tests"] == stats["instance_walks"]
    assert 0 < stats["triangle_tests"] <= 12 * stats["node_tests"]


def test_plain_version_chunking_changes_nothing():
    _, _, port, port_mesh_set = _inputs(SCENE, FRAME)
    origins, directions, seed = _rays("random")
    origins, directions = torch.from_numpy(origins), torch.from_numpy(directions)
    origins, directions = origins[:400], directions[:400]
    whole = kernels.trace_paths_fused_mesh_reference(
        port, port_mesh_set, origins, directions, seed, max_bounces=2
    )
    chunked = kernels.trace_paths_fused_mesh_reference(
        port, port_mesh_set, origins, directions, seed, max_bounces=2, chunk_rays=133
    )
    torch.testing.assert_close(chunked, whole, rtol=0, atol=0)


def test_wrapper_routes_cpu_tensors_to_the_plain_version():
    scene = port_scene.build_scene(SCENE, 2, "cpu")
    mesh = port_mesh.scene_mesh_set(SCENE, 2)
    origins, directions, _ = _rays("random")
    kernels.reset_counts()
    out = kernels.trace_paths_fused_mesh(
        scene, mesh, torch.from_numpy(origins), torch.from_numpy(directions), 5, max_bounces=2
    )
    assert out.shape == (origins.shape[0], 3)
    flat = kernels.trace_paths_fused_mesh(
        scene, mesh, torch.from_numpy(origins), torch.from_numpy(directions), 5, max_bounces=2,
        use_tlas=False,
    )
    torch.testing.assert_close(flat, out, rtol=0, atol=0)
    assert kernels.counts == {
        "trace_fused": 0, "trace_fused_reference": 0,
        "trace_fused_mesh": 0, "trace_fused_mesh_reference": 1,
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


def test_bvh_tables_are_packed_once_per_bvh():
    """The kernel's BVH layout is packed on a BVH's first launch and reused
    by every later frame's mesh set, which shares the cached BVH."""
    bvh = port_mesh.scene_mesh_set(SCENE, 2).bvh
    triangles, bounds, links = kernels._bvh_operands(bvh)
    assert port_mesh.scene_mesh_set(SCENE, 3).bvh is bvh
    again = kernels._bvh_operands(port_mesh.scene_mesh_set(SCENE, 3).bvh)
    assert all(a is b for a, b in zip(again, (triangles, bounds, links)))
    assert triangles.shape == (bvh.v0.shape[0], 16) and triangles.dtype == torch.float32
    torch.testing.assert_close(triangles[:, 4:7], bvh.e1, rtol=0, atol=0)
    torch.testing.assert_close(triangles[:, 12:15], bvh.normal, rtol=0, atol=0)
    torch.testing.assert_close(bounds[:, 4:7], bvh.bounds_max, rtol=0, atol=0)
    assert links.dtype == torch.int32
    assert links[:, :3].tolist() == torch.stack([bvh.skip, bvh.first, bvh.count], dim=1).tolist()
    # Another BVH (equal tables, another object) gets its own packing.
    copy = port_mesh.MeshBVH(*(t.clone() for t in bvh[:-1]), octant=bvh.octant)
    assert kernels._bvh_operands(copy)[0] is not triangles
    # A frame's instance table and sphere operands: once per frame's
    # objects, which every bounce of the frame shares.
    mesh_set = port_mesh.scene_mesh_set(SCENE, 2)
    table = kernels.instance_operands(mesh_set)
    assert kernels.instance_operands(mesh_set) is table
    torch.testing.assert_close(table, kernels.instance_table(mesh_set), rtol=0, atol=0)
    assert kernels.instance_operands(port_mesh.scene_mesh_set(SCENE, 2)) is not table
    scene = port_scene.build_scene(SCENE, 2, "cpu")
    spheres, params = kernels._sphere_operands(scene)
    assert all(a is b for a, b in zip(kernels._sphere_operands(scene), (spheres, params)))


def test_trace_paths_dispatches_like_the_reference():
    origins, directions = (torch.from_numpy(a[:64]) for a in _rays("random")[:2])
    sphere_scene = port_scene.build_scene("02_physics", 2, "cpu")
    kernels.reset_counts()
    integrator.trace_paths(sphere_scene, origins, directions, 7, max_bounces=1)
    assert kernels.counts["trace_fused_reference"] == 1
    mesh_scene = port_scene.build_scene(SCENE, 2, "cpu")
    integrator.trace_paths(
        mesh_scene, origins, directions, 7, max_bounces=1,
        mesh=port_mesh.scene_mesh_set(SCENE, 2),
    )
    assert kernels.counts["trace_fused_mesh_tlas_reference"] == 1
    deep = port_mesh.scene_mesh_set("03_physics-2-mesh", 2)
    assert not kernels.mesh_megakernel_eligible(deep)
    integrator.trace_paths(
        port_scene.build_scene("03_physics-2-mesh", 2, "cpu"), origins, directions, 7,
        max_bounces=2, mesh=deep,
    )
    assert kernels.counts["trace_fused_mesh_tlas_reference"] == 1
    assert kernels.counts["mesh_bounce_tlas_reference"] == 2  # once per bounce
    # use_tlas=False: the flat kernels, at the same dispatch.
    integrator.trace_paths(
        port_scene.build_scene("03_physics-2-mesh", 2, "cpu"), origins, directions, 7,
        max_bounces=2, mesh=deep, use_tlas=False,
    )
    assert kernels.counts["mesh_bounce_reference"] == 2


def test_mesh_and_rays_must_share_a_device():
    scene = port_scene.build_scene(SCENE, 2, "cpu")
    mesh = port_mesh.scene_mesh_set(SCENE, 2)
    moved = mesh._replace(instances=mesh.instances._replace(scale=mesh.instances.scale.to("meta")))
    with pytest.raises(ValueError, match="share one device"):
        kernels.trace_paths_fused_mesh(
            scene, moved, torch.zeros((4, 3)), torch.ones((4, 3)), 1, max_bounces=1
        )


def test_build_digest_covers_shared_headers(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for path in _build.CSRC_DIR.glob("*.cu*"):
        (csrc / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", csrc / "build")
    assert _build.sources() == [
        "intersect_instances", "intersect_mesh", "intersect_spheres", "mesh_bounce",
        "mesh_bounce_tlas", "mesh_entry_keys", "occluded_instances", "occluded_mesh",
        "occluded_spheres", "packet_octants", "pool_mesh_bounce", "pool_mesh_bounce_tlas",
        "pool_sphere_bounce", "sphere_bounce", "trace_fused", "trace_fused_lanes",
        "trace_fused_mesh", "trace_fused_mesh_tlas",
    ]
    before = {name: _build.library_path(name) for name in _build.sources()}
    header = csrc / "path_common.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {name: _build.library_path(name) for name in _build.sources()}
    assert all(before[name] != after[name] for name in before)
    assert all(path.parent == csrc / "build" for path in after.values())
    # A new header changes the digest too; the library names stay stable
    # while nothing changes.
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build.library_path("trace_fused") not in (before["trace_fused"], after["trace_fused"])
    assert _build.library_path("trace_fused") == _build.library_path("trace_fused")
