"""The octant-ordered walk on a GPU: the six ordered launches of rows 3, 4
and 6 (TLAS and flat) and the walk's two passes against their plain
PyTorch versions, bit for bit, and the scan's unit kernels (rows 7-10) on
the canonical order whatever the BVH carries.

Needs a CUDA GPU and nvcc (the kernels have no CPU mode); skipped elsewhere.
Imports no jax: ``python -m pytest -q -m cuda tests/test_torch_octant_cuda.py``.

Tolerance: none. The scenes' BVHs are ``sah`` builds with octant tables,
so the wrappers take the ordered walk (the reference's default); on every
lane the outputs equal the plain version's to the bit: a megakernel's
radiance, a bounce's five state outputs, alive and (TLAS) key, the packet
votes (``packet_votes``) and the ordered key pass (``entry_keys``). Inputs:
frame 30 of 02_physics-mesh and of 03_physics-2-mesh (its icosphere BVH
called directly through the megakernels, past the dispatch bound), camera
rays and 1,000 random ones (no multiple of a packet: the last packet votes
with pad rays), every launch of a deep wavefront frame and of a 2-frame
pool window.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tpu_render_cluster_torch.render import compaction, integrator, kernels, raypool
from tpu_render_cluster_torch.render.mesh import MeshSet, scene_mesh_set
from tpu_render_cluster_torch.render.scene import build_scene

pytestmark = pytest.mark.cuda

MESH, DEEP = "02_physics-mesh", "03_physics-2-mesh"
BOUNCES = 4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc: the kernel has no CPU mode")
    return torch.device("cuda")


def _canonical(mesh: MeshSet) -> MeshSet:
    """The same mesh with a BVH without its octant tables."""
    return mesh._replace(bvh=mesh.bvh._replace(octant=None))


def _assert_equal(got, expected, what: str) -> None:
    for name, have, want in zip(got._fields, got, expected):
        assert torch.equal(have, want), f"{what}: {name} differs on {int((have != want).sum())} values"


def _rays(name: str, source: str, device):
    if source == "camera":
        return integrator.frame_rays_and_seed(
            integrator.scene_camera(name, 30, device), 30, width=64, height=48, samples=2
        )
    rng = np.random.default_rng(3)
    origins = (rng.normal(size=(1000, 3)) * 3.0 + [0.0, 2.0, 0.0]).astype(np.float32)
    directions = rng.normal(size=(1000, 3))
    directions = (directions / np.linalg.norm(directions, axis=1, keepdims=True)).astype(np.float32)
    return torch.from_numpy(origins).to(device), torch.from_numpy(directions).to(device), 77


@pytest.mark.parametrize("source", ["camera", "random"])
@pytest.mark.parametrize("use_tlas", [True, False], ids=["tlas", "flat"])
@pytest.mark.parametrize("name", [MESH, DEEP])
def test_cuda_ordered_megakernel_matches_plain_version(cuda_device, name, use_tlas, source):
    scene = build_scene(name, 30, cuda_device)
    mesh = scene_mesh_set(name, 30, device=cuda_device)
    assert kernels.walks_ordered(mesh.bvh)
    origins, directions, seed = _rays(name, source, cuda_device)
    kernels.reset_counts()
    got = kernels.trace_paths_fused_mesh(
        scene, mesh, origins, directions, seed, max_bounces=BOUNCES, use_tlas=use_tlas
    )
    torch.cuda.synchronize()
    kernel = "trace_fused_mesh_tlas" if use_tlas else "trace_fused_mesh"
    assert kernels.counts == {k: int(k == kernel) for k in kernels.counts}
    expected = kernels.trace_paths_fused_mesh_reference(
        scene, mesh, origins, directions, seed, max_bounces=BOUNCES, use_tlas=use_tlas
    )
    assert torch.isfinite(got).all() and got.max() > 0.05
    assert torch.equal(got, expected), f"{int((got != expected).any(dim=1).sum())} rays differ"


@pytest.mark.parametrize("use_tlas", [True, False], ids=["tlas", "flat"])
def test_cuda_ordered_bounce_and_its_passes_match_plain_versions(cuda_device, use_tlas):
    """Every launch of a deep wavefront frame: the bounce (with its vote
    pass and, TLAS, its key pass) bit for bit, and each pass alone."""
    scene = build_scene(DEEP, 30, cuda_device)
    mesh = scene_mesh_set(DEEP, 30, device=cuda_device)
    origins, directions, seed = integrator.frame_rays_and_seed(
        integrator.scene_camera(DEEP, 30, cuda_device), 30, width=64, height=48, samples=2
    )
    launches: list = []
    compaction.trace_paths_wavefront(
        scene, origins, directions, seed, max_bounces=BOUNCES, mesh=mesh,
        on_launch=launches.append, use_tlas=use_tlas,
    )
    assert len(launches) == BOUNCES and launches[-1].live < launches[-1].bucket
    kernel = "mesh_bounce_tlas" if use_tlas else "mesh_bounce"
    block = kernels.TLAS_BLOCK_R if use_tlas else kernels.BVH_BLOCK_R
    table = kernels.tlas_frame(mesh).slots if use_tlas else kernels.instance_table(mesh)
    for launch in launches:
        args = (*launch.state, launch.live, seed, launch.bounce)
        kernels.reset_counts()
        got = kernels.mesh_bounce(scene, mesh, *args, total_bounces=BOUNCES, use_tlas=use_tlas)
        torch.cuda.synchronize()
        assert kernels.counts == {
            k: int(k in kernels.launch_names(kernel)) for k in kernels.counts
        }
        expected = kernels.mesh_bounce_reference(
            scene, mesh, *args, total_bounces=BOUNCES, use_tlas=use_tlas
        )
        _assert_equal(got, expected, f"bounce {launch.bounce}")
        votes = kernels.packet_votes(launch.state[1], table, launch.live, block=block,
                                     world=use_tlas)
        plain = kernels.packet_votes_reference(launch.state[1], table, launch.live, block=block,
                                               world=use_tlas)
        for have, want in zip(votes, plain):
            assert (have is None) == (want is None)
            assert have is None or torch.equal(have, want)
        if use_tlas:
            keys = kernels.entry_keys(mesh, got.origins, got.directions, got.alive, launch.live,
                                      launch.bounce, total_bounces=BOUNCES)
            assert torch.equal(keys, got.key)
            assert torch.equal(keys, kernels.entry_keys_reference(
                mesh, got.origins, got.directions, got.alive, launch.live, launch.bounce,
                total_bounces=BOUNCES,
            ))


@pytest.mark.parametrize("use_tlas", [True, False], ids=["tlas", "flat"])
def test_cuda_ordered_pool_matches_plain_version(cuda_device, use_tlas):
    """Every launch of a 2-frame pool window, bit for bit."""
    window = raypool.PoolWindow(
        DEEP, [30, 31], width=32, height=24, samples=2, max_bounces=BOUNCES, pool_width=2048,
        device=cuda_device, use_tlas=use_tlas,
    )
    launches: list = []
    state = window.initial_state()
    while bool(window.more(state)):
        state = window.iteration(state, len(launches), launches.append)
    assert len(launches) >= 4
    for launch in launches:
        live = int(launch.live)
        got = kernels.pool_mesh_bounce(window.ops, *launch.state, live, total_bounces=BOUNCES,
                                       use_tlas=use_tlas)
        expected = kernels.pool_mesh_bounce_reference(
            window.ops, *launch.state, live, total_bounces=BOUNCES, use_tlas=use_tlas
        )
        _assert_equal(got, expected, f"pool launch {launch.iteration}")


def test_cuda_canonical_walk_without_octant_tables(cuda_device):
    """A BVH without octant tables takes the canonical kernels: no pass is
    launched, and each launch equals the canonical plain version."""
    scene = build_scene(DEEP, 30, cuda_device)
    mesh = _canonical(scene_mesh_set(DEEP, 30, device=cuda_device))
    assert not kernels.walks_ordered(mesh.bvh)
    origins, directions, seed = integrator.frame_rays_and_seed(
        integrator.scene_camera(DEEP, 30, cuda_device), 30, width=32, height=24, samples=2
    )
    launches: list = []
    kernels.reset_counts()
    compaction.trace_paths_wavefront(
        scene, origins, directions, seed, max_bounces=BOUNCES, mesh=mesh,
        on_launch=launches.append,
    )
    assert kernels.counts == {
        k: len(launches) * (k == "mesh_bounce_tlas") for k in kernels.counts
    }
    launch = launches[1]
    args = (*launch.state, launch.live, seed, launch.bounce)
    got = kernels.mesh_bounce(scene, mesh, *args, total_bounces=BOUNCES)
    _assert_equal(got, kernels.mesh_bounce_reference(scene, mesh, *args, total_bounces=BOUNCES),
                  "canonical bounce")
    radiance = kernels.trace_paths_fused_mesh(scene, mesh, origins, directions, seed,
                                              max_bounces=BOUNCES)
    plain = kernels.trace_paths_fused_mesh_reference(scene, mesh, origins, directions, seed,
                                                     max_bounces=BOUNCES)
    assert torch.isclose(radiance, plain, rtol=1e-4, atol=1e-4).all(dim=1).float().mean() >= 0.999


def test_cuda_unit_kernels_walk_the_canonical_order(cuda_device):
    """Rows 7-10 read no octant table, as their reference kernels: on the
    same rays a BVH with octant tables and one without give the same bits,
    and the canonical plain versions' results."""
    mesh = scene_mesh_set(DEEP, 30, device=cuda_device)
    canonical = _canonical(mesh)
    origins, directions, _ = integrator.frame_rays_and_seed(
        integrator.scene_camera(DEEP, 30, cuda_device), 30, width=64, height=48, samples=1
    )
    rays = origins.shape[0]
    init_t = torch.full((rays,), kernels.INF, device=cuda_device)
    already = torch.zeros(rays, dtype=torch.bool, device=cuda_device)
    already[::3] = True
    for m in (mesh, canonical):
        kernels.reset_counts()
        nearest = kernels.intersect_instances(m, origins, directions, init_t)
        shadow = kernels.occluded_instances(m, origins, directions, already)
        assert kernels.counts["packet_octants"] == 0
        if m is mesh:
            first = (nearest, shadow)
        else:
            for have, want in zip((*nearest, shadow), (*first[0], first[1])):
                assert torch.equal(have, want)
    plain = kernels.intersect_instances_reference(canonical, origins, directions, init_t)
    for have, want in zip(first[0], plain):
        assert torch.equal(have, want)
    assert torch.equal(first[1], kernels.occluded_instances_reference(
        canonical, origins, directions, already
    ))
    row = kernels.instance_table(mesh)[0]
    lo = kernels._to_object(row, origins, shift=True)
    ld = kernels._to_object(row, directions, shift=False)
    t, tri = kernels.intersect_mesh(mesh.bvh, lo, ld, init_t)
    t0, tri0 = kernels.intersect_mesh(canonical.bvh, lo, ld, init_t)
    assert torch.equal(t, t0) and torch.equal(tri, tri0)
    hit = kernels.occluded_mesh(mesh.bvh, lo, ld, already)
    assert torch.equal(hit, kernels.occluded_mesh(canonical.bvh, lo, ld, already))
    assert torch.equal(hit, kernels.occluded_mesh_reference(canonical.bvh, lo, ld, already))
