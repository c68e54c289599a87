"""The TLAS variants' plain versions against the JAX package's TLAS kernels,
and the port's TLAS tiers against its flat ones.

The reference runs with ``TRC_PALLAS=1`` (its kernels in interpret mode).
Its TLAS kernels walk the octant-ordered node tables when the BVH carries
them (its default), and so does the port: each kernel-level case runs
both ways, on the BVH with its octant tables ("ordered") and on the same
BVH without them (the canonical variant of both sides). Per ray the two
orders change no result but exact ties; a tie between two slots' entry
distances (the overlapping field's) changes the key's candidate, which each
side then picks by the same order. Fields, as tests/test_tlas.py builds
them over the deep scene's icosphere BVH: random-12, random-48,
overlapping-8 (eight equal instances) and a 2-instance field walked with
TLAS leaves of one instance; 256 rays aimed down into the field. Inputs are
made with numpy from seeds.

Tolerances:
- a bounce, port against reference: the five state outputs within atol
  1e-6 on every ray; the key equal to the bit on every live lane, and on
  dead lanes outside the candidate bits [18:24) (the TPU lets a dead lane
  of a partly live block pick up a packet-mate's candidate; the port keys
  every dead lane with K); on the last bounce equal on every lane;
- the port's TLAS bounce against its flat one: equal to the bit;
- the pool bounce (row 6) against the reference's on a mixed pool state:
  tests/test_torch_raypool.py's tolerance (rtol = atol = 1e-4 per lane but
  an edge-tie budget of max(1, round(0.001 P))), the key as above;
- frames: the masked deep loop and the wavefront, TLAS against flat, equal
  to the bit; against the reference's TLAS render and pool, the image bound
  of tests/test_raypool.py (at most max(1, round(0.001 n)) pixels off by
  more than 2e-3, mean absolute error below 1e-4); the pool's statistics
  equal, the launched lanes in the TLAS block of 256 included.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_mesh import reference_mesh_arrays
from tests.test_torch_raypool import (
    MESH_BATCH,
    _assert_images_equivalent,
    _mixed_state,
    _port_ops,
    _reference_ops,
    _reference_pool,
    _window_inputs,
)
from tpu_render_cluster.render import integrator as ref_integrator
from tpu_render_cluster.render import mesh as ref_mesh
from tpu_render_cluster.render import pallas_kernels as ref_kernels
from tpu_render_cluster.render import scene as ref_scene
from tpu_render_cluster_torch.render import compaction, integrator, kernels, raypool
from tpu_render_cluster_torch.render import mesh as port_mesh
from tpu_render_cluster_torch.render import scene as port_scene

DEEP = "03_physics-2-mesh"
RAYS, SEED, TOTAL_BOUNCES = 256, 1234, 4
FIELDS = ["random-12", "random-48", "overlapping-8", "leaf1-2"]
CANDIDATE_BITS = 0x3F << 18


@pytest.fixture
def pallas_on(monkeypatch):
    monkeypatch.setenv("TRC_PALLAS", "1")


@pytest.fixture
def field_leaf(monkeypatch, request):
    """The TLAS leaf of the field (one instance for leaf1-2), on both sides."""
    if request.param == "leaf1-2":
        monkeypatch.setenv("TRC_TLAS_LEAF", "1")
        monkeypatch.setattr(kernels, "TLAS_LEAF", 1)
    return request.param


@functools.lru_cache(maxsize=None)
def _field(field: str, ordered: bool = False):
    """(reference MeshSet, port MeshSet): the BVH without its octant tables
    (the canonical node order), or with them (``ordered``)."""
    if field == "overlapping-8":
        k = 8
        rotation = np.tile(np.eye(3, dtype=np.float32), (k, 1, 1))
        translation = np.tile(np.array([[0.5, 1.0, -0.25]], np.float32), (k, 1))
        albedo = np.tile(np.array([[0.6, 0.5, 0.4]], np.float32), (k, 1))
        scale = np.ones(k, np.float32)
    else:
        seed, k = {"random-12": (11, 12), "random-48": (13, 48), "leaf1-2": (19, 2)}[field]
        rng = np.random.default_rng(seed)
        rotation = np.asarray(jax.vmap(ref_mesh.rotation_y)(
            jnp.asarray(rng.uniform(0, 2 * np.pi, k).astype(np.float32))
        ))
        translation = rng.uniform(-4, 4, (k, 3)).astype(np.float32)
        albedo = rng.uniform(0.2, 0.9, (k, 3)).astype(np.float32)
        scale = rng.uniform(0.4, 1.2, k).astype(np.float32)
    bvh = ref_mesh.cached_mesh_bvh("icosphere", "sah", 4)
    if not ordered:
        bvh = bvh._replace(octant=None)
    mesh_set = ref_mesh.MeshSet(
        bvh=bvh,
        instances=ref_mesh.MeshInstances(
            rotation=jnp.asarray(rotation), translation=jnp.asarray(translation),
            albedo=jnp.asarray(albedo), scale=jnp.asarray(scale),
        ),
    )
    return mesh_set, port_mesh.mesh_from_arrays(*reference_mesh_arrays(mesh_set), "cpu")


@functools.lru_cache(maxsize=None)
def _scene():
    scene = ref_scene.build_scene(DEEP, 5)
    return scene, port_scene.scene_from_arrays(
        {k: np.asarray(v) for k, v in scene._asdict().items()}, "cpu"
    )


def _state(seed: int = 29):
    """tests/test_tlas.py's ray state: origins above the field, directions
    biased downward, so walks hit instances and fire shadow rays."""
    rng = np.random.default_rng(seed)
    origins = rng.uniform(-5, 5, (RAYS, 3)).astype(np.float32)
    origins[:, 1] = rng.uniform(0.5, 6.0, RAYS).astype(np.float32)
    directions = rng.normal(size=(RAYS, 3)).astype(np.float32)
    directions[:, 1] -= 1.0
    directions /= np.linalg.norm(directions, axis=1, keepdims=True)
    return origins, directions.astype(np.float32)


def _reference_bounce(field: str, bounce: int, ordered: bool = False):
    mesh_set, _ = _field(field, ordered)
    origins, directions = _state()
    out = ref_kernels.mesh_bounce_pallas(
        _scene()[0], mesh_set, jnp.asarray(origins), jnp.asarray(directions),
        jnp.ones((RAYS, 3), jnp.float32), jnp.ones((RAYS,), bool), jnp.int32(SEED), bounce,
        total_bounces=TOTAL_BOUNCES, live_count=jnp.int32(RAYS), use_tlas=True, quant=0,
    )
    return [np.asarray(a) for a in out]


def _port_bounce(field: str, bounce: int, use_tlas: bool, ordered: bool = False):
    _, mesh = _field(field, ordered)
    origins, directions = (torch.from_numpy(a) for a in _state())
    return kernels.mesh_bounce(
        _scene()[1], mesh, origins, directions, torch.ones((RAYS, 3)),
        torch.ones(RAYS, dtype=torch.bool), torch.arange(RAYS, dtype=torch.int32), RAYS, SEED,
        bounce, total_bounces=TOTAL_BOUNCES, use_tlas=use_tlas,
    )


def _assert_keys(got: np.ndarray, expected: np.ndarray, alive: np.ndarray) -> None:
    np.testing.assert_array_equal(got[alive], expected[alive])
    np.testing.assert_array_equal(got[~alive] & ~CANDIDATE_BITS, expected[~alive] & ~CANDIDATE_BITS)


@pytest.mark.parametrize("ordered", [False, True], ids=["canonical", "ordered"])
@pytest.mark.parametrize("field_leaf", FIELDS, indirect=True)
def test_tlas_bounce_matches_the_reference_and_the_flat_bounce(pallas_on, field_leaf, ordered):
    field = field_leaf
    expected = _reference_bounce(field, 0, ordered)
    kernels.reset_counts()
    got = _port_bounce(field, 0, True, ordered)
    assert kernels.counts["mesh_bounce_tlas_reference"] == 1
    labels = ("contribution", "origins", "directions", "throughput", "alive")
    for label, have, want in zip(labels, got[:5], expected[:5]):
        np.testing.assert_allclose(have.numpy(), want, rtol=0, atol=1e-6, err_msg=label)
    alive = got.alive.numpy()
    assert 0 < alive.sum() < RAYS  # some paths escape, some go on
    _assert_keys(got.key.numpy(), expected[5], alive)
    # Dead lanes key with the sentinel K, live ones with a slot or K.
    k = _field(field)[1].instances.translation.shape[0]
    candidate = (got.key >> 18) & 63
    assert (candidate[~got.alive] == k).all() and (candidate <= k).all()
    # The twin outside the kernel (the lowest slot wins an entry tie): the
    # same key on the live lanes, but the ties the ordered walk meets in
    # another slot order.
    tlas = kernels.tlas_frame(_field(field)[1])
    twin = kernels.mesh_sort_keys(
        got.origins, got.directions, got.alive, tlas.key_window,
        candidate=kernels.instance_entry_candidates(
            got.origins, got.directions, tlas.slots[:, 13:16], tlas.slots[:, 16:19]
        ),
    )
    if not ordered or field != "overlapping-8":
        assert torch.equal(twin[got.alive], got.key[got.alive])
    # The port's flat bounce: the same state to the bit, and no key.
    flat = _port_bounce(field, 0, False, ordered)
    assert flat.key is None
    for have, want in zip(got[:5], flat):
        assert torch.equal(have, want)


def test_last_bounce_keys_every_lane_with_the_sentinel(pallas_on):
    expected = _reference_bounce("random-12", TOTAL_BOUNCES - 1)
    got = _port_bounce("random-12", TOTAL_BOUNCES - 1, True)
    np.testing.assert_array_equal(got.key.numpy(), expected[5])
    assert (((got.key >> 18) & 63) == 12).all()


def test_tlas_plain_version_counts_its_walks():
    """The TLAS walk's work counters: node tests, the leaves' world-box
    tests (below the flat sweep's K per search) and the entry walk's."""
    _, mesh = _field("random-48")
    origins, directions = (torch.from_numpy(a) for a in _state())
    stats: dict = {}
    kernels.mesh_bounce_reference(
        _scene()[1], mesh, origins, directions, torch.ones((RAYS, 3)),
        torch.ones(RAYS, dtype=torch.bool), torch.arange(RAYS, dtype=torch.int32), RAYS, SEED, 0,
        total_bounces=TOTAL_BOUNCES, use_tlas=True, stats=stats,
    )
    assert stats["instances"] == 48
    searches = stats["broadphase_rays"]
    assert RAYS <= searches <= 2 * RAYS
    assert 0 < stats["tlas_node_tests"] and 0 < stats["world_aabb_tests"] < 48 * searches
    assert 0 < stats["entry_rays"] <= RAYS and stats["entry_tests"] > 0
    assert stats["instance_walks"] <= stats["world_aabb_tests"]


@pytest.mark.parametrize("ordered", [False, True], ids=["canonical", "ordered"])
def test_pool_tlas_bounce_matches_the_reference(pallas_on, ordered):
    """One row 6 launch on a mixed pool state (two frames at every bounce,
    dead lanes inside the live prefix and a dead tail), with its key; the
    ordered pool orders its BLAS walks alone, as the reference's."""
    frames = (30, 31)
    state, live = _mixed_state(DEEP, frames)
    ref_ops = _reference_ops(DEEP, frames)
    ops = _port_ops(DEEP, frames)
    if not ordered:
        ref_ops = ref_ops._replace(octant=None)
        _, _, port_scenes, port_meshes = _window_inputs(DEEP, frames)
        ops = kernels.pool_mesh_operands(
            port_scenes, [m._replace(bvh=m.bvh._replace(octant=None)) for m in port_meshes]
        )
    args = [jnp.asarray(a) for a in state] + [jnp.int32(live)]
    expected = [np.asarray(a) for a in ref_kernels.pool_mesh_bounce(
        ref_ops, *args, total_bounces=TOTAL_BOUNCES, use_tlas=True, quant=0
    )]
    kernels.reset_counts()
    got = kernels.pool_mesh_bounce(
        ops, *(torch.from_numpy(a) for a in state), live, total_bounces=TOTAL_BOUNCES
    )
    assert kernels.counts["pool_mesh_bounce_tlas_reference"] == 1
    pool = state[0].shape[0]
    close = np.ones(pool, bool)
    for have, want in zip(got[:4], expected[:4]):
        close &= np.isclose(have.numpy(), want, rtol=1e-4, atol=1e-4).all(axis=1)
    budget = max(1, round(0.001 * pool))
    assert (~close).sum() <= budget and (got.alive.numpy() != expected[4]).sum() <= budget
    agree = close & (got.alive.numpy() == expected[4])
    alive = got.alive.numpy() & agree
    _assert_keys(got.key.numpy()[agree], expected[5][agree], alive[agree])
    fid = torch.from_numpy(state[5]).to(torch.int32)
    assert torch.equal((got.key >> 24) & 31, fid)
    # The flat pool bounce: the same state to the bit.
    flat = kernels.pool_mesh_bounce(
        ops, *(torch.from_numpy(a) for a in state), live, total_bounces=TOTAL_BOUNCES,
        use_tlas=False,
    )
    for have, want in zip(got[:5], flat):
        assert torch.equal(have, want)


@functools.lru_cache(maxsize=None)
def _port_frames(use_tlas: bool):
    kwargs = dict(width=12, height=12, samples=1, max_bounces=2, device="cpu")
    kernels.reset_counts()
    masked = integrator.render_frame(DEEP, 30, use_tlas=use_tlas, **kwargs)
    wavefront = compaction.render_frame_wavefront(DEEP, 30, use_tlas=use_tlas, **kwargs)
    return masked, wavefront, dict(kernels.counts)


def test_masked_and_wavefront_frames_tlas_equal_flat_and_the_reference(pallas_on):
    masked, wavefront, launched = _port_frames(True)
    assert launched["mesh_bounce_tlas_reference"] >= 4 and launched["mesh_bounce_reference"] == 0
    flat_masked, flat_wavefront, flat_launched = _port_frames(False)
    assert flat_launched["mesh_bounce_tlas_reference"] == 0
    assert torch.equal(masked, flat_masked) and torch.equal(wavefront, flat_wavefront)
    assert torch.equal(masked, wavefront)
    expected = np.asarray(ref_integrator.render_frame(
        DEEP, 30, width=12, height=12, samples=1, max_bounces=2
    ))
    _assert_images_equivalent(masked.numpy(), expected)
    assert masked.max() > 0.05


def test_tlas_pool_matches_the_reference_tlas_pool():
    """The [30, 31] pool at the TLAS default on both sides: the images and
    every statistic, the launched lanes in 256-lane blocks included."""
    name, frames, kwargs = MESH_BATCH
    expected, recorded = _reference_pool(name, frames, kwargs, None)
    images, stats = raypool.render_batch_raypool(name, list(frames), device="cpu", **dict(kwargs))
    for out, ref in zip(images, expected):
        _assert_images_equivalent(out.numpy(), ref)
    (iterations, served, refilled, live_sum, launched_sum, occ_log, refill_log), = recorded
    got = stats[0]
    assert got.iterations == int(iterations)
    assert got.served == int(served) and got.refilled == int(refilled)
    assert got.live_sum == int(live_sum) and got.launched_sum == int(launched_sum)
    assert got.refill_log == refill_log[:got.iterations].tolist()
    np.testing.assert_allclose(got.occ_log, occ_log[:got.iterations], rtol=1e-6)
    flat_images, flat_stats = raypool.render_batch_raypool(
        name, list(frames), device="cpu", use_tlas=False, **dict(kwargs)
    )
    for out, flat in zip(images, flat_images):
        assert torch.equal(out, flat)
    assert flat_stats[0].live_sum == got.live_sum
