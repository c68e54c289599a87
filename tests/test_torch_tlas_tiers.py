"""The reference's TLAS tiers in the port: ``TRC_TLAS_LEAF`` (instances a
TLAS leaf) and ``TRC_TLAS_BLOCK`` (the TLAS kernels' packet), and the pool's
``TRC_RAYPOOL_FRAMES`` and ``TRC_RAYPOOL_WIDTH``, against the JAX package on
the CPU: the resolvers over a grid of environments, and row 4 TLAS with its
vote and key passes (row 3: tests/test_torch_tlas_tiers_fused.py; row 6 and
the pool's windows: tests/test_torch_pool_tiers.py; frames and the worker:
tests/test_torch_tlas_tiers_frames.py).

The reference runs with ``TRC_PALLAS=1`` (its kernels in interpret mode) and
reads both TLAS tiers from the environment inside its wrappers; the port
takes the leaf with the MeshSet (``MeshSet.tlas_leaf``) and the packet as
the wrappers' ``tlas_block``. Inputs are made with numpy from seeds, on the
fields of tests/test_torch_tlas_bounce.py (random-12, random-48, and a
2-instance field that takes the TLAS only at leaf 1). ``CASES`` spread the
widths 128, 512 and 1,024 and the leaves 1, 8 and 16 over both walk orders
(the sah BVH's octant tables, or none: the canonical walk) and node formats
0 and 1, each value of each more than once.

Launches: row 4 TLAS takes one bounce of 256 rays at packets of up to 256
lanes, and of ``launch_rays(P)`` = 2P + 44 at 512 and 1,024 (two whole
packets and a ragged third), so a launch of several packets, its packet
index and its votes across packets are held at every width.

Tolerances, row 4 TLAS: the five state outputs within atol 1e-6 on every
ray of a 256-ray launch (tests/test_torch_tlas_bounce.py's), and within
atol 1e-4 (the tolerance on rays of rows 3 and 6) on every ray of the wider
launches: on those rays one lane of random-48 carries a difference of
1.5e-5 in its new origin and direction, the same lane at the default
packet (256) as at 512 (a rounding of the hit point in the port's and the
reference's walks, not of the width); the key equal to the bit on every live lane, and on dead
lanes outside the candidate bits (the TPU lets a dead lane of a partly live
block pick up a packet-mate's candidate; the port keys every dead lane with
K); the key pass on the launch's outputs equal to the launch's key column
to the bit. The resolvers: equal.
"""

from __future__ import annotations

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_tlas_bounce import SEED, TOTAL_BOUNCES, _assert_keys, _field, _scene
from tpu_render_cluster.render import pallas_kernels as ref_kernels
from tpu_render_cluster.render import raypool as ref_raypool
from tpu_render_cluster_torch.render import integrator, kernels, raypool
from tpu_render_cluster_torch.render import mesh as port_mesh

TIERS = ("TRC_TLAS", "TRC_TLAS_LEAF", "TRC_TLAS_BLOCK", "TRC_RAYPOOL_FRAMES", "TRC_RAYPOOL_WIDTH")
# The grid of environment values: unset, 0, negatives, past the clamps,
# between powers of two, and junk.
VALUES = (None, "0", "-3", "1", "2", "7", "16", "17", "100", "128", "300", "512", "700",
          "1024", "5000", "x")


@pytest.fixture
def clean_tiers(monkeypatch):
    for name in TIERS:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def _set(monkeypatch, name, value):
    if value is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, value)


# -- the resolvers ---------------------------------------------------------------


@pytest.mark.parametrize("value", VALUES)
def test_tlas_resolvers_are_the_references(clean_tiers, value):
    """``TRC_TLAS_LEAF`` and ``TRC_TLAS_BLOCK`` at one grid value each (and
    ``TRC_TLAS`` on and off): the leaf, the packet and the TLAS decision for
    fields of 1 to 48 instances equal the reference's."""
    for name, flag in itertools.product(("TRC_TLAS_LEAF", "TRC_TLAS_BLOCK"), (None, "0")):
        _set(clean_tiers, "TRC_TLAS_LEAF", None)
        _set(clean_tiers, "TRC_TLAS_BLOCK", None)
        _set(clean_tiers, name, value)
        _set(clean_tiers, "TRC_TLAS", flag)
        leaf, block = integrator.resolve_tlas_config()
        assert leaf == kernels.tlas_leaf_size() == ref_kernels.tlas_leaf_size(), (name, value)
        assert block == kernels.tlas_block_r() == ref_kernels.tlas_block_r(), (name, value)
        assert block in kernels.TLAS_PACKETS
        for k, use_tlas in itertools.product((1, 2, 4, 5, 8, 9, 12, 16, 17, 48),
                                             (None, True, False)):
            resolved = integrator.resolve_bvh_config(use_tlas)[0]
            assert kernels.use_tlas_for(k, resolved, leaf) == ref_kernels.use_tlas_for(
                k, use_tlas), (name, value, flag, k, use_tlas)


@pytest.mark.parametrize("value", VALUES)
def test_pool_resolvers_are_the_references(clean_tiers, value):
    """``TRC_RAYPOOL_FRAMES`` and ``TRC_RAYPOOL_WIDTH`` at one grid value
    each: the window's frame cap and the pool's width (the mesh and sphere
    scenes' 1,024-lane block) for frames of 1 to 2,097,152 rays."""
    _set(clean_tiers, "TRC_RAYPOOL_FRAMES", value)
    assert raypool.raypool_frame_cap() == ref_raypool.raypool_frame_cap()
    _set(clean_tiers, "TRC_RAYPOOL_FRAMES", None)
    _set(clean_tiers, "TRC_RAYPOOL_WIDTH", value)
    for rays in (1, 144, 1024, 3000, 65536, 2_097_152):
        assert raypool.raypool_width(rays) == ref_raypool.raypool_width(
            rays, ref_kernels.BVH_BLOCK_R), (value, rays)


def test_unset_tiers_are_the_defaults(clean_tiers):
    assert integrator.resolve_tlas_config() == (4, 256) == (kernels.TLAS_LEAF,
                                                            kernels.TLAS_BLOCK_R)
    assert raypool.raypool_frame_cap() == 8
    assert raypool.raypool_width(2_097_152) == 65536 and raypool.raypool_width(3000) == 3072


@pytest.mark.parametrize("leaf,block", [(0, None), (17, None), (None, 300), (None, 64),
                                        (None, 2048)])
def test_an_explicit_tier_the_kernels_do_not_take_raises(clean_tiers, leaf, block):
    """A given leaf or packet is taken as it is: outside [1, 16] or
    ``TLAS_PACKETS`` it raises, never rounds (the environment's values
    snap, as the reference's)."""
    with pytest.raises(ValueError):
        integrator.resolve_tlas_config(leaf, block)


def test_a_wrapper_raises_for_a_packet_it_is_not_built_for():
    _, mesh = _field("random-48", True)
    origins, directions = (torch.from_numpy(a) for a in _rays(64))
    state = (torch.ones((64, 3)), torch.ones(64, dtype=torch.bool),
             torch.arange(64, dtype=torch.int32), 64, SEED, 0)
    for block in (300, 64, 2048):
        with pytest.raises(ValueError, match="TLAS packet"):
            kernels.mesh_bounce(_scene()[1], mesh, origins, directions, *state,
                                total_bounces=TOTAL_BOUNCES, tlas_block=block)
        with pytest.raises(ValueError, match="TLAS packet"):
            kernels.trace_paths_fused_mesh(_scene()[1], mesh, origins, directions, SEED,
                                           max_bounces=1, tlas_block=block)
    with pytest.raises(ValueError, match="TLAS leaf"):
        kernels.mesh_bounce(_scene()[1], mesh._replace(tlas_leaf=17), origins, directions,
                            *state, total_bounces=TOTAL_BOUNCES)


def test_counts_name_the_packet():
    assert kernels.packet_name("mesh_bounce_tlas", 256) == "mesh_bounce_tlas"
    assert kernels.packet_name("mesh_bounce_tlas[q1]", 128) == "mesh_bounce_tlas[q1][p128]"
    assert kernels.launch_names("mesh_bounce_tlas", True, 1, 1024) == (
        "mesh_bounce_tlas[q1][p1024]", "packet_octants[p1024]", "mesh_entry_keys[q1][p1024]")
    assert kernels.launch_names("mesh_bounce", True, 0, 128) == ("mesh_bounce", "packet_octants")


# -- the kernels' plain versions against the reference's kernels ----------------

# (field, packet, leaf, ordered, node format): every width and leaf twice,
# across both orders and formats 0 and 1; every other case (rows 3 and 6
# take one half each) still holds each width, leaf, order and format.
CASES = [
    ("random-48", 128, 4, True, 0),
    ("random-12", 128, 4, False, 1),
    ("random-48", 512, 4, False, 0),
    ("random-12", 512, 4, True, 1),
    ("random-48", 1024, 4, True, 1),
    ("random-12", 1024, 4, False, 0),
    ("random-12", 256, 1, False, 1),
    ("leaf1-2", 256, 1, True, 0),
    ("random-12", 256, 8, True, 0),
    ("random-48", 256, 8, False, 1),
    ("random-48", 256, 16, False, 0),
    ("random-48", 256, 16, True, 1),
]
CASE_IDS = [f"{f}-p{p}-leaf{leaf}-{'ordered' if o else 'canonical'}-q{q}"
            for f, p, leaf, o, q in CASES]


@pytest.fixture
def tiers_env(monkeypatch, request):
    """The reference's environment of a case: ``TRC_PALLAS=1`` and its leaf
    and packet."""
    field, packet, leaf, ordered, quant = request.param
    monkeypatch.setenv("TRC_PALLAS", "1")
    monkeypatch.setenv("TRC_TLAS_BLOCK", str(packet))
    monkeypatch.setenv("TRC_TLAS_LEAF", str(leaf))
    monkeypatch.delenv("TRC_TLAS", raising=False)
    return request.param


def _rays(count: int, seed: int = 29):
    """tests/test_torch_tlas_bounce.py's ray recipe at ``count`` rays:
    origins above the field, directions biased downward."""
    rng = np.random.default_rng(seed)
    origins = rng.uniform(-5, 5, (count, 3)).astype(np.float32)
    origins[:, 1] = rng.uniform(0.5, 6.0, count).astype(np.float32)
    directions = rng.normal(size=(count, 3)).astype(np.float32)
    directions[:, 1] -= 1.0
    directions /= np.linalg.norm(directions, axis=1, keepdims=True)
    return origins, directions.astype(np.float32)


def launch_rays(packet: int, narrow: int) -> int:
    """A parity launch's rays at ``packet``: ``narrow`` at packets of up to
    256 lanes, else two whole packets and a ragged 44-lane third."""
    return narrow if packet <= 256 else 2 * packet + 44


def _meshes(field: str, ordered: bool, leaf: int):
    mesh_set, mesh = _field(field, ordered)
    return mesh_set, mesh._replace(tlas_leaf=leaf)


@pytest.mark.parametrize("tiers_env", CASES, ids=CASE_IDS, indirect=True)
def test_row4_tlas_and_its_passes_match_the_reference(tiers_env):
    field, packet, leaf, ordered, quant = tiers_env
    mesh_set, mesh = _meshes(field, ordered, leaf)
    rays = launch_rays(packet, 256)
    origins, directions = _rays(rays)
    expected = [np.asarray(a) for a in ref_kernels.mesh_bounce_pallas(
        _scene()[0], mesh_set, jnp.asarray(origins), jnp.asarray(directions),
        jnp.ones((rays, 3), jnp.float32), jnp.ones((rays,), bool), jnp.int32(SEED), 0,
        total_bounces=TOTAL_BOUNCES, live_count=jnp.int32(rays), use_tlas=True, quant=quant,
    )]
    kernels.reset_counts()
    hits: list = []
    got = kernels.mesh_bounce(
        _scene()[1], mesh, torch.from_numpy(origins), torch.from_numpy(directions),
        torch.ones((rays, 3)), torch.ones(rays, dtype=torch.bool),
        torch.arange(rays, dtype=torch.int32), rays, SEED, 0, total_bounces=TOTAL_BOUNCES,
        quant=quant, tlas_block=packet, _hits=hits,
    )
    name = kernels.packet_name(kernels.quant_name("mesh_bounce_tlas_reference", quant), packet)
    assert kernels.counts.get(name) == 1, kernels.counts
    labels = ("contribution", "origins", "directions", "throughput", "alive")
    atol = 1e-6 if rays == 256 else 1e-4
    for label, have, want in zip(labels, got[:5], expected[:5]):
        np.testing.assert_allclose(have.numpy(), want, rtol=0, atol=atol, err_msg=label)
    alive = got.alive.numpy()
    assert 0 < alive.sum() < rays
    _assert_keys(got.key.numpy(), expected[5], alive)
    if ordered:
        # The vote over the launch's packets and the key pass, each equal to
        # the plain bounce's own.
        slots = kernels.tlas_frame(mesh).slots
        world, rows = kernels.packet_votes(torch.from_numpy(directions), slots, rays,
                                           block=packet)
        assert world.shape == (-(-rays // packet),)
        assert rows.shape == (world.shape[0], slots.shape[0])
        keys = kernels.entry_keys(mesh, got.origins, got.directions, got.alive, rays, 0,
                                  total_bounces=TOTAL_BOUNCES, quant=quant,
                                  hits=hits[0] if quant else None, tlas_block=packet)
        assert torch.equal(keys, got.key)


@pytest.mark.parametrize("leaf", [1, 4, 8, 16])
def test_the_tlas_operands_follow_the_leaf(leaf):
    """A frame's TLAS at leaf L: the reference's topology of the K slots,
    its node count, links and the degrade rule's counts."""
    _, mesh = _field("random-48", True)
    mesh = mesh._replace(tlas_leaf=leaf)
    topology = port_mesh.cached_tlas_topology(48, leaf)
    frame = kernels.tlas_frame_on_host(mesh)
    assert frame.node_bounds.shape[0] == len(topology.skip)
    assert max(topology.count) <= leaf
    links = kernels.tlas_links(48, 2, torch.device("cpu"), leaf)
    assert links.shape == (2 * len(topology.skip), 4)
    assert kernels._tlas_counts(48, 8, leaf) == (8 * len(topology.skip), 8 * 48, leaf)
    assert kernels.use_tlas_for(48, None, leaf) and not kernels.use_tlas_for(leaf, None, leaf)
