"""The octant-ordered walk of rows 3, 4 and 6: the packet vote, and the
plain versions against the JAX package's kernels with the octant tables on
(its default on every ``sah`` BVH).

The reference runs with ``TRC_PALLAS=1`` (its kernels in interpret mode).
Fields as tests/test_torch_tlas_bounce.py builds them over the deep scene's
icosphere BVH (random-48, overlapping-8: eight equal instances, whose exact
ties the walk order decides), with its octant tables; inputs made with
numpy from seeds. Each launch is 300 rays, no multiple of a packet, so the
last packet votes with the reference's pad rays, and a bounce launch holds
a dead tail past its live count.

Tolerances (those of the files named):
- a bounce, TLAS and flat, on a sorted state with random throughput,
  permuted lanes, dead lanes and a dead tail (tests/test_torch_mesh_bounce.py):
  per ray over the three channels of each of the contribution, origin,
  direction and throughput rtol = atol = 1e-4, every ray but an edge-tie
  budget of max(1, round(0.001 R)), alive exact within the same budget;
  the TLAS key (tests/test_torch_tlas_bounce.py) equal to the bit on every
  live lane, and on dead lanes outside the candidate bits [18:24);
- the megakernel (tests/test_torch_kernels_mesh.py): rtol = atol = 1e-4
  per ray, at 2 bounces on at least 99.9% of rays;
- the pool bounce (tests/test_torch_raypool.py): rtol = atol = 1e-4 per
  lane but an edge-tie budget of max(1, round(0.001 P)), alive within the
  same budget, the TLAS key as above on the lanes that agree.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_mesh import reference_mesh_arrays
from tests.test_torch_raypool import _mixed_state, _port_ops, _reference_ops
from tests.test_torch_tlas_bounce import DEEP, _assert_keys, _field, _scene
from tpu_render_cluster.render import mesh as ref_mesh
from tpu_render_cluster.render import pallas_kernels as ref_kernels
from tpu_render_cluster_torch.render import kernels
from tpu_render_cluster_torch.render import mesh as port_mesh

RAYS, LIVE, SEED, TOTAL_BOUNCES = 300, 280, 4321, 4


@pytest.fixture
def pallas_on(monkeypatch):
    monkeypatch.setenv("TRC_PALLAS", "1")


# -- the vote -----------------------------------------------------------------


def _dirs(rows) -> torch.Tensor:
    return torch.tensor(rows, dtype=torch.float32)


@pytest.mark.parametrize(
    "case,rows,block,expected",
    [
        # three of four lanes with x > 0, y and z all negative
        ("strict majority", [[1, -1, -1], [1, -1, -1], [1, -1, -1], [-1, -1, -1]], 4, [1]),
        # two of four: a tie sets no bit
        ("exact half", [[1, 1, 1], [1, 1, 1], [-1, -1, -1], [-1, -1, -1]], 4, [0]),
        # 0.0 and -0.0 are not positive: one positive x of four, y of 0.0s
        ("signed zeros", [[0.0, 0.0, -0.0], [-0.0, -0.0, 0.0], [0.0, 0.0, 1.0], [1.0, 0.0, 1.0]],
         4, [0]),
        # the last packet: one lane of its own and three pad rays (0, 1, 0)
        ("padded last packet", [[1, -1, 1]] * 4 + [[1, -1, 1]], 4, [5, 2]),
    ],
)
def test_packet_vote(case, rows, block, expected):
    got = kernels.packet_octants(_dirs(rows), block)
    assert got.tolist() == expected, case


def test_the_vote_counts_every_lane_of_its_packet():
    """Lanes vote in launch order, packet by packet, a padded tail as the
    reference's pad rays: 600 lanes in packets of 256."""
    rng = np.random.default_rng(3)
    dirs = torch.from_numpy(rng.normal(size=(600, 3)).astype(np.float32))
    got = kernels.packet_octants(dirs, 256)
    padded = torch.cat([dirs, torch.tensor([[0.0, 1.0, 0.0]]).expand(168, 3)])
    for p in range(3):
        positive = (padded[256 * p:256 * (p + 1)] > 0).sum(dim=0)
        want = sum(1 << a for a in range(3) if 2 * int(positive[a]) > 256)
        assert int(got[p]) == want


def test_instance_vote_is_the_walks_object_space():
    """Per instance the directions vote in its object space, turned as the
    walk turns them (R^T d / s through the fp32 FMA chain), pads included:
    a half turn about y flips x and z."""
    mesh = _field("random-12")[1]
    table = kernels.instance_table(mesh)
    flip = table[0].clone()
    flip[0:9] = torch.tensor([-1.0, 0, 0, 0, 1, 0, 0, 0, -1])
    flip[12] = 0.5
    rows = [[1, 1, 1]] * 3 + [[-1, 1, 1]]
    got = kernels.packet_instance_octants(_dirs(rows), torch.stack([flip, table[1]]), 4)
    assert got.shape == (1, 2) and int(got[0, 0]) == 2
    direct = kernels._to_object(table[1], _dirs(rows), shift=False)
    assert int(got[0, 1]) == int(kernels.packet_octants(direct, 4)[0])


def test_vote_passes_plain_versions_zero_the_packets_past_the_live_count():
    mesh = _field("random-12")[1]
    rng = np.random.default_rng(5)
    dirs = torch.from_numpy(rng.normal(size=(600, 3)).astype(np.float32))
    table = kernels.tlas_frame(mesh).slots
    kernels.reset_counts()
    world, rows = kernels.packet_votes(dirs, table, 300, block=256)
    assert kernels.counts["packet_octants_reference"] == 1
    assert world.dtype == rows.dtype == torch.uint8 and rows.shape == (3, 12)
    assert torch.equal(world[:2], kernels.packet_octants(dirs, 256)[:2].to(torch.uint8))
    assert torch.equal(rows[:2], kernels.packet_instance_octants(dirs, table, 256)[:2]
                       .to(torch.uint8))
    assert int(world[2]) == 0 and not rows[2].any()


# -- the plain rows against the reference, octant tables on -------------------


@functools.lru_cache(maxsize=None)
def _ordered_field(field: str):
    """(reference MeshSet with its octant tables, port MeshSet)."""
    mesh_set = _field(field)[0]._replace(bvh=ref_mesh.cached_mesh_bvh("icosphere", "sah", 4))
    assert mesh_set.bvh.octant is not None
    return mesh_set, port_mesh.mesh_from_arrays(*reference_mesh_arrays(mesh_set), "cpu")


@functools.lru_cache(maxsize=None)
def _bounce_state(seed: int = 41):
    """300 rays above the field aimed down, the first LIVE alive and a dead
    tail past it (the wavefront's sorted launch)."""
    rng = np.random.default_rng(seed)
    origins = rng.uniform(-5, 5, (RAYS, 3)).astype(np.float32)
    origins[:, 1] = rng.uniform(0.5, 6.0, RAYS).astype(np.float32)
    directions = rng.normal(size=(RAYS, 3)).astype(np.float32)
    directions[:, 1] -= 1.0
    directions /= np.linalg.norm(directions, axis=1, keepdims=True)
    throughput = rng.uniform(0.2, 1.0, (RAYS, 3)).astype(np.float32)
    alive = np.arange(RAYS) < LIVE
    alive[rng.choice(LIVE, 20, replace=False)] = False  # dead lanes inside the live prefix
    lane = rng.permutation(RAYS).astype(np.int32)
    return origins, directions.astype(np.float32), throughput, alive, lane


def _bounce_pair(field: str, use_tlas: bool, bounce: int):
    mesh_set, mesh = _ordered_field(field)
    state = _bounce_state()
    expected = [None if a is None else np.asarray(a) for a in ref_kernels.mesh_bounce_pallas(
        _scene()[0], mesh_set, *(jnp.asarray(a) for a in state[:4]), jnp.int32(SEED), bounce,
        total_bounces=TOTAL_BOUNCES, lane=jnp.asarray(state[4]), live_count=jnp.int32(LIVE),
        use_tlas=use_tlas, quant=0,
    )]
    got = kernels.mesh_bounce(
        _scene()[1], mesh, *(torch.from_numpy(a) for a in state), LIVE, SEED, bounce,
        total_bounces=TOTAL_BOUNCES, use_tlas=use_tlas,
    )
    return got, expected


@pytest.mark.parametrize("use_tlas", [True, False], ids=["tlas", "flat"])
@pytest.mark.parametrize("field", ["random-48", "overlapping-8"])
def test_bounce_matches_the_ordered_reference(pallas_on, field, use_tlas):
    """Row 4 at bounce 1 of 4 on a launch of two TLAS packets (the second
    padded) with dead lanes and a dead tail."""
    kernels.reset_counts()
    got, expected = _bounce_pair(field, use_tlas, 1)
    name = "mesh_bounce_tlas_reference" if use_tlas else "mesh_bounce_reference"
    assert kernels.counts[name] == 1
    close = np.ones(RAYS, bool)
    for have, want in zip(got[:4], expected[:4]):
        close &= np.isclose(have.numpy(), want, rtol=1e-4, atol=1e-4).all(axis=1)
    budget = max(1, round(0.001 * RAYS))
    assert (~close).sum() <= budget and (got.alive.numpy() != expected[4]).sum() <= budget
    alive = got.alive.numpy()
    assert 0 < alive[:LIVE].sum() < LIVE and not alive[LIVE:].any()
    if use_tlas:
        _assert_keys(got.key.numpy(), expected[5], alive)


def test_the_order_decides_the_overlapping_fields_candidates(pallas_on):
    """On eight equal boxes every entry ties: the candidate is the slot the
    entry walk meets first, which the packet's octant table decides. The
    ordered port agrees with the reference on every live lane, the
    canonical walk does not."""
    got, expected = _bounce_pair("overlapping-8", True, 1)
    canonical_mesh = _field("overlapping-8")[1]
    state = _bounce_state()
    canonical = kernels.mesh_bounce(
        _scene()[1], canonical_mesh, *(torch.from_numpy(a) for a in state), LIVE, SEED, 1,
        total_bounces=TOTAL_BOUNCES, use_tlas=True,
    )
    alive = got.alive.numpy()
    assert (got.key.numpy()[alive] == expected[5][alive]).all()
    assert (canonical.key.numpy()[alive] != expected[5][alive]).any()
    # The same state either way: the eight instances are one.
    for have, want in zip(got[:5], canonical[:5]):
        assert torch.equal(have, want)


def test_entry_keys_plain_version_is_the_bounces_key(pallas_on):
    got, _ = _bounce_pair("random-48", True, 1)
    mesh = _ordered_field("random-48")[1]
    kernels.reset_counts()
    keys = kernels.entry_keys(mesh, got.origins, got.directions, got.alive, LIVE, 1,
                              total_bounces=TOTAL_BOUNCES)
    assert kernels.counts["mesh_entry_keys_reference"] == 1
    assert torch.equal(keys, got.key)
    with pytest.raises(ValueError, match="octant tables"):
        kernels.entry_keys(_field("random-48")[1], got.origins, got.directions, got.alive, LIVE,
                           1, total_bounces=TOTAL_BOUNCES)


@pytest.mark.parametrize("use_tlas", [True, False], ids=["tlas", "flat"])
def test_megakernel_matches_the_ordered_reference(pallas_on, use_tlas):
    """Row 3 on the deep icosphere field (called directly: past the
    dispatch bound), 300 rays (a padded last packet), 2 bounces."""
    mesh_set, mesh = _ordered_field("random-48")
    origins, directions = _bounce_state(7)[:2]
    expected = np.asarray(ref_kernels.trace_paths_fused_mesh(
        _scene()[0], mesh_set, jnp.asarray(origins), jnp.asarray(directions), jnp.int32(SEED),
        max_bounces=2, use_tlas=use_tlas, quant=0,
    ))
    got = kernels.trace_paths_fused_mesh_reference(
        _scene()[1], mesh, torch.from_numpy(origins), torch.from_numpy(directions), SEED,
        max_bounces=2, use_tlas=use_tlas,
    ).numpy()
    assert got.shape == expected.shape and np.isfinite(got).all()
    close = np.isclose(got, expected, rtol=1e-4, atol=1e-4).all(axis=1)
    assert close.mean() >= 0.999, close.mean()
    assert got.max() > 0.05


@pytest.mark.parametrize("use_tlas", [True, False], ids=["tlas", "flat"])
def test_pool_bounce_matches_the_ordered_reference(pallas_on, use_tlas):
    """Row 6 on a mixed pool state of two frames: the BLAS ordered, the
    TLAS and the key's entry walk canonical, as the reference's pool."""
    frames = (30, 31)
    state, live = _mixed_state(DEEP, frames)
    ref_ops = _reference_ops(DEEP, frames)
    assert ref_ops.octant is not None
    args = [jnp.asarray(a) for a in state] + [jnp.int32(live)]
    expected = [None if a is None else np.asarray(a) for a in ref_kernels.pool_mesh_bounce(
        ref_ops, *args, total_bounces=TOTAL_BOUNCES, use_tlas=use_tlas, quant=0
    )]
    ops = _port_ops(DEEP, frames)
    assert ops.meshes[0].bvh.octant is not None
    got = kernels.pool_mesh_bounce(
        ops, *(torch.from_numpy(a) for a in state), live, total_bounces=TOTAL_BOUNCES,
        use_tlas=use_tlas,
    )
    pool = state[0].shape[0]
    close = np.ones(pool, bool)
    for have, want in zip(got[:4], expected[:4]):
        close &= np.isclose(have.numpy(), want, rtol=1e-4, atol=1e-4).all(axis=1)
    budget = max(1, round(0.001 * pool))
    assert (~close).sum() <= budget and (got.alive.numpy() != expected[4]).sum() <= budget
    if use_tlas:
        agree = close & (got.alive.numpy() == expected[4])
        alive = got.alive.numpy() & agree
        _assert_keys(got.key.numpy()[agree], expected[5][agree], alive[agree])
