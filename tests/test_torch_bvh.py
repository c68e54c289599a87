"""Rows 9 and 10 of the port, the single-BVH unit kernels' plain versions
(``kernels.intersect_mesh`` / ``kernels.occluded_mesh`` on CPU tensors, which
run ``intersect_mesh_reference`` / ``occluded_mesh_reference``), against the
JAX package: its Pallas kernels ``intersect_bvh_pallas`` /
``occluded_bvh_pallas`` in interpret mode, its XLA walks
``intersect_bvh_packet`` / ``occluded_bvh_packet``, and brute force (the
port's and the reference's ``intersect_triangles_brute``). The CUDA kernels
themselves are held against the plain versions on a GPU by
tests/test_torch_bvh_cuda.py.

Inputs: the box and icosphere BVHs (equal array for array on both sides,
tests/test_torch_mesh.py), rays built as tests/test_mesh.py's ``_rays(n,
seed)`` builds them from numpy: unseeded; seeded, some seeds below the ray's
hit (a seeded miss, which must return the seed and row 0), some above, some
on rays that miss; ``already`` none, all and random; rays parked at 1e7
heading up, as the scan renderer parks its dead lanes.

Tolerances, as tests/test_mesh.py's: t within rtol = atol = 1e-4 against
Pallas and XLA and 1e-5 against brute force, on every ray; the triangle row
equal on every hit ray and the any-hit equal on every ray, each but an
edge-tie budget of max(1, round(0.001 R)) rays (a ray through an edge shared
by two triangles may take either).
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_render_cluster.render import mesh as ref_mesh
from tpu_render_cluster.render import pallas_kernels as ref_kernels
from tpu_render_cluster_torch.render import kernels
from tpu_render_cluster_torch.render import mesh as port_mesh

INF = 1e30
RAYS = 512
KINDS = ("box", "icosphere")


def _budget(rays: int) -> int:
    return max(1, round(0.001 * rays))


@functools.lru_cache(maxsize=None)
def _rays(kind: str, seed: int):
    """tests/test_mesh.py's rays (spread 0.3 around +z from z = -3), the
    brute-force hit, seeds around it and an ``already`` mask, all numpy."""
    rng = np.random.default_rng(seed)
    origins = rng.normal(size=(RAYS, 3)).astype(np.float32) * 0.3
    origins[:, 2] -= 3.0
    directions = np.array([0.0, 0.0, 1.0], np.float32) + rng.normal(
        size=(RAYS, 3)
    ).astype(np.float32) * 0.3
    directions = (directions / np.linalg.norm(directions, axis=1, keepdims=True)).astype(np.float32)
    bvh = ref_mesh.cached_mesh_bvh(kind)
    t_brute = np.asarray(
        ref_mesh.intersect_triangles_brute(bvh, jnp.asarray(origins), jnp.asarray(directions))[0]
    )
    hits = t_brute < 1e29
    assert hits.sum() > 20 and (~hits).sum() > 20, "the rays must hit and miss the mesh"
    draw = rng.random(RAYS)
    init_t = np.full(RAYS, INF, np.float32)
    init_t[hits & (draw < 0.35)] = t_brute[hits & (draw < 0.35)] * 0.9  # seeded misses
    init_t[hits & (draw > 0.65)] = t_brute[hits & (draw > 0.65)] * 1.1  # the mesh wins
    init_t[~hits & (draw < 0.5)] = rng.uniform(2.0, 9.0, size=(~hits & (draw < 0.5)).sum())
    already = rng.random(RAYS) < 0.3
    return origins, directions, init_t.astype(np.float32), already


def _port_bvh(kind: str):
    return port_mesh.cached_mesh_bvh(kind)


def _port_nearest(kind, origins, directions, init_t):
    t, row = kernels.intersect_mesh(
        _port_bvh(kind), torch.from_numpy(origins), torch.from_numpy(directions),
        torch.from_numpy(init_t),
    )
    assert t.dtype == torch.float32 and row.dtype == torch.int32
    return t.numpy(), row.numpy()


def _assert_nearest(t, row, t_ref, row_ref, seed, tol):
    np.testing.assert_allclose(t, t_ref, rtol=tol, atol=tol)
    hit = t_ref < seed
    differ = hit & (row != row_ref)
    assert differ.sum() <= _budget(t.size), np.flatnonzero(differ)
    # A miss returns the seed itself and row 0.
    np.testing.assert_array_equal(t[~hit], seed[~hit])
    assert (row[~hit] == 0).all()


@pytest.mark.parametrize("seeded", [False, True], ids=["unseeded", "seeded"])
@pytest.mark.parametrize("kind", KINDS)
def test_nearest_matches_pallas_and_xla(kind, seeded):
    origins, directions, init_t, _ = _rays(kind, 0)
    seed = init_t if seeded else np.full(RAYS, INF, np.float32)
    bvh = ref_mesh.cached_mesh_bvh(kind)
    o, d, s = jnp.asarray(origins), jnp.asarray(directions), jnp.asarray(seed)
    kernels.reset_counts()
    t, row = _port_nearest(kind, origins, directions, seed)
    assert kernels.counts == {k: int(k == "intersect_mesh_reference") for k in kernels.counts}
    for walk in (ref_kernels.intersect_bvh_pallas, ref_mesh.intersect_bvh_packet):
        t_ref, row_ref = (np.asarray(a) for a in walk(bvh, o, d, s))
        _assert_nearest(t, row, t_ref, row_ref, seed, 1e-4)
    hit = t < seed
    assert hit.sum() > 20 and (~hit).sum() > 20
    if seeded:  # seeds below the hit return the seed, seeds above lose to it
        assert ((init_t < INF) & ~hit).sum() > 20 and ((init_t < INF) & hit).sum() > 20


@pytest.mark.parametrize("seeded", [False, True], ids=["unseeded", "seeded"])
@pytest.mark.parametrize("kind", KINDS)
def test_nearest_matches_brute_force(kind, seeded):
    """Against both sides' brute force, the seed applied as a strict <."""
    origins, directions, init_t, _ = _rays(kind, 1)
    seed = init_t if seeded else np.full(RAYS, INF, np.float32)
    t, row = _port_nearest(kind, origins, directions, seed)
    bvh = ref_mesh.cached_mesh_bvh(kind)
    oracles = (
        ref_mesh.intersect_triangles_brute(bvh, jnp.asarray(origins), jnp.asarray(directions)),
        port_mesh.intersect_triangles_brute(
            _port_bvh(kind), torch.from_numpy(origins), torch.from_numpy(directions)
        ),
    )
    for t_brute, row_brute in oracles:
        t_brute, row_brute = np.asarray(t_brute), np.asarray(row_brute)
        beats = t_brute < seed
        _assert_nearest(
            t, row, np.where(beats, t_brute, seed), np.where(beats, row_brute, 0), seed, 1e-5
        )


@pytest.mark.parametrize("kind", KINDS)
def test_port_brute_force_matches_reference(kind):
    origins, directions, _, _ = _rays(kind, 2)
    t_ref, row_ref = (
        np.asarray(a)
        for a in ref_mesh.intersect_triangles_brute(
            ref_mesh.cached_mesh_bvh(kind), jnp.asarray(origins), jnp.asarray(directions)
        )
    )
    t, row = port_mesh.intersect_triangles_brute(
        _port_bvh(kind), torch.from_numpy(origins), torch.from_numpy(directions)
    )
    assert t.dtype == torch.float32 and row.dtype == torch.int32
    np.testing.assert_allclose(t.numpy(), t_ref, rtol=1e-5, atol=1e-5)
    hit = t_ref < 1e29
    assert ((row.numpy() != row_ref) & hit).sum() <= _budget(RAYS)
    assert (t.numpy()[~hit] == INF).all() and (row.numpy()[~hit] == 0).all()


@pytest.mark.parametrize("mask", ["none", "all", "random"])
@pytest.mark.parametrize("kind", KINDS)
def test_anyhit_matches_pallas_xla_and_brute(kind, mask):
    origins, directions, _, random_mask = _rays(kind, 3)
    already = {
        "none": np.zeros(RAYS, bool), "all": np.ones(RAYS, bool), "random": random_mask,
    }[mask]
    bvh = ref_mesh.cached_mesh_bvh(kind)
    o, d, a = jnp.asarray(origins), jnp.asarray(directions), jnp.asarray(already)
    kernels.reset_counts()
    got = kernels.occluded_mesh(
        _port_bvh(kind), torch.from_numpy(origins), torch.from_numpy(directions),
        torch.from_numpy(already),
    )
    assert kernels.counts == {k: int(k == "occluded_mesh_reference") for k in kernels.counts}
    assert got.dtype == torch.bool
    got = got.numpy()
    t_brute = np.asarray(ref_mesh.intersect_triangles_brute(bvh, o, d)[0])
    expected = [
        np.asarray(ref_kernels.occluded_bvh_pallas(bvh, o, d, a)),
        np.asarray(ref_mesh.occluded_bvh_packet(bvh, o, d, a)),
        already | (t_brute < 1e29),
    ]
    for want in expected:
        assert (got != want).sum() <= _budget(RAYS), np.flatnonzero(got != want)
    assert got[already].all()
    if mask != "all":
        assert got[~already].any() and not got[~already].all()


@pytest.mark.parametrize("kind", KINDS)
def test_parked_rays_miss(kind):
    """The scan's dead lanes, at 1e7 heading up: the seed and row 0 back,
    not occluded, as the Pallas kernel answers."""
    bvh = ref_mesh.cached_mesh_bvh(kind)
    origins = np.full((64, 3), 1e7, np.float32)
    directions = np.tile(np.array([0.0, 1.0, 0.0], np.float32), (64, 1))
    seed = np.where(np.arange(64) % 2 == 0, INF, 5.0).astype(np.float32)
    t, row = _port_nearest(kind, origins, directions, seed)
    t_ref, row_ref = (
        np.asarray(a)
        for a in ref_kernels.intersect_bvh_pallas(
            bvh, jnp.asarray(origins), jnp.asarray(directions), jnp.asarray(seed)
        )
    )
    np.testing.assert_array_equal(t, seed)
    np.testing.assert_array_equal(t_ref, seed)
    assert (row == 0).all() and (row_ref == 0).all()
    none = np.zeros(64, bool)
    got = kernels.occluded_mesh(
        _port_bvh(kind), torch.from_numpy(origins), torch.from_numpy(directions),
        torch.from_numpy(none),
    ).numpy()
    ref = np.asarray(
        ref_kernels.occluded_bvh_pallas(bvh, jnp.asarray(origins), jnp.asarray(directions), jnp.asarray(none))
    )
    assert not got.any() and not ref.any()


def test_plain_bvh_versions_count_their_work():
    origins, directions, init_t, already = _rays("icosphere", 0)
    bvh = _port_bvh("icosphere")
    o, d = torch.from_numpy(origins), torch.from_numpy(directions)
    unseeded: dict = {}
    kernels.intersect_mesh_reference(bvh, o, d, torch.full((RAYS,), INF), stats=unseeded)
    assert unseeded["rays"] == RAYS
    assert RAYS <= unseeded["node_tests"] <= RAYS * bvh.skip.shape[0]
    assert 0 < unseeded["triangle_tests"] <= RAYS * int(bvh.count.sum())
    seeded: dict = {}
    kernels.intersect_mesh_reference(bvh, o, d, torch.from_numpy(init_t), stats=seeded)
    assert seeded["node_tests"] < unseeded["node_tests"]  # the seeds cull nodes
    shadow: dict = {}
    kernels.occluded_mesh_reference(bvh, o, d, torch.from_numpy(already), stats=shadow)
    assert shadow["rays"] == RAYS and shadow["walking_rays"] == int((~already).sum())
    assert shadow["node_tests"] <= unseeded["node_tests"]


def test_bvh_wrappers_check_their_inputs():
    origins, directions, init_t, already = _rays("box", 0)
    bvh = _port_bvh("box")
    o, d = torch.from_numpy(origins), torch.from_numpy(directions)
    with pytest.raises(ValueError, match="init_t must be torch.float32"):
        kernels.intersect_mesh(bvh, o, d, torch.from_numpy(init_t).double())
    with pytest.raises(ValueError, match="already must be torch.bool"):
        kernels.occluded_mesh(bvh, o, d, torch.from_numpy(already)[:-1])
    with pytest.raises(TypeError, match="float32"):
        kernels.occluded_mesh(bvh, o.double(), d, torch.from_numpy(already))
    with pytest.raises(ValueError, match="origins and directions"):
        kernels.intersect_mesh(bvh, o[:, :2], d, torch.from_numpy(init_t))
