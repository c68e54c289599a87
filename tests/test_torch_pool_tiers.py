"""The ray pool at the reference's TLAS and pool tiers, against the JAX
package on the CPU: row 6 TLAS (the pool kernel's two-level walk) at other
packets and leaves, and whole pool windows at ``TRC_TLAS_BLOCK=128``,
``TRC_TLAS_LEAF`` 1 and 16, ``TRC_RAYPOOL_FRAMES=3`` (a 5-frame batch:
windows of 3 and 2) and a non-default ``TRC_RAYPOOL_WIDTH``.

The reference runs with ``TRC_PALLAS=1`` (interpret mode), its jit caches
cleared around each environment. Tolerances, the existing ones:
- row 6 TLAS on a mixed 2-frame pool launch of 1,024 lanes, 800 of them
  live, and at packets of 512 and 1,024 of 4,096 lanes, 2P + 44 of them
  live (two whole packets and a ragged third; a pool is whole packets);
  the cases of tests/test_torch_tlas_tiers.py, every other one: rtol = atol = 1e-4 per
  lane but an edge-tie budget of max(1, round(0.001 P)), the key equal to
  the bit on the live lanes within it and outside the candidate bits on the
  dead ones, its frame-id bits each lane's frame (tests/test_torch_tlas_bounce.py);
- pool windows: each image within tests/test_raypool.py's bound (at most
  max(1, round(0.001 n)) pixels off by more than 2e-3, mean absolute error
  below 1e-4); every window's statistics (iterations, served, refilled,
  live and launched lanes, the refill log) equal, the occupancy log within
  rtol 1e-6; as many windows as the reference's.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_raypool import (
    _assert_images_equivalent,
    _mixed_state,
    _reference_ops,
    _window_inputs,
)
from tests.test_torch_tlas_bounce import DEEP, TOTAL_BOUNCES, _assert_keys
from tests.test_torch_tlas_tiers import CASE_IDS, CASES, tiers_env  # noqa: F401
from tpu_render_cluster.render import pallas_kernels as ref_kernels
from tpu_render_cluster.render import raypool as ref_raypool
from tpu_render_cluster_torch.render import kernels, raypool


@pytest.mark.parametrize("tiers_env", CASES[1::2], ids=CASE_IDS[1::2], indirect=True)
def test_row6_tlas_matches_the_reference(tiers_env):
    """One pool launch of a 2-frame window of the deep scene (its 48
    instances at the case's leaf; the field names the node format's and
    order's partner case), its key with the frame id."""
    _, packet, leaf, ordered, quant = tiers_env
    frames = (30, 31)
    # From 512 lanes on, a pool of whole packets (a square: the camera
    # rays' grid) whose live prefix holds two of them and a ragged third.
    wide = packet >= 512
    state, live = _mixed_state(DEEP, frames, 4096 if wide else 1024,
                               2 * packet + 44 if wide else 800)
    ref_ops = _reference_ops(DEEP, frames)
    _, _, port_scenes, port_meshes = _window_inputs(DEEP, frames)
    meshes = [m._replace(tlas_leaf=leaf) for m in port_meshes]
    if not ordered:
        ref_ops = ref_ops._replace(octant=None)
        meshes = [m._replace(bvh=m.bvh._replace(octant=None)) for m in meshes]
    ops = kernels.pool_mesh_operands(port_scenes, meshes)
    args = [jnp.asarray(a) for a in state] + [jnp.int32(live)]
    expected = [np.asarray(a) for a in ref_kernels.pool_mesh_bounce(
        ref_ops, *args, total_bounces=TOTAL_BOUNCES, use_tlas=True, tlas_leaf=leaf,
        tlas_block=packet, quant=quant,
    )]
    kernels.reset_counts()
    got = kernels.pool_mesh_bounce(ops, *(torch.from_numpy(a) for a in state), live,
                                   total_bounces=TOTAL_BOUNCES, quant=quant, tlas_block=packet)
    name = kernels.packet_name(kernels.quant_name("pool_mesh_bounce_tlas_reference", quant),
                               packet)
    assert kernels.counts.get(name) == 1, kernels.counts
    pool = state[0].shape[0]
    close = np.ones(pool, bool)
    for have, want in zip(got[:4], expected[:4]):
        close &= np.isclose(have.numpy(), want, rtol=1e-4, atol=1e-4).all(axis=1)
    budget = max(1, round(0.001 * pool))
    assert (~close).sum() <= budget and (got.alive.numpy() != expected[4]).sum() <= budget
    agree = close & (got.alive.numpy() == expected[4])
    alive = got.alive.numpy() & agree
    _assert_keys(got.key.numpy()[agree], expected[5][agree], alive[agree])
    assert torch.equal((got.key >> 24) & 31, torch.from_numpy(state[5]).to(torch.int32))


SIZE = (("width", 12), ("height", 12), ("samples", 1), ("max_bounces", 2))
# (environment, frames): the TLAS tiers on a 2-frame window, the frame cap
# on a 5-frame batch, the pool's width on 2 frames of 144 rays each.
POOLS = {
    "block-128": ({"TRC_TLAS_BLOCK": "128"}, (30, 31)),
    "leaf-1": ({"TRC_TLAS_LEAF": "1"}, (30, 31)),
    "leaf-16": ({"TRC_TLAS_LEAF": "16"}, (30, 31)),
    "frames-3": ({"TRC_RAYPOOL_FRAMES": "3"}, (30, 31, 32, 33, 34)),
    "width-2048": ({"TRC_RAYPOOL_WIDTH": "2048", "TRC_TLAS_BLOCK": "512"}, (30, 31)),
}


@pytest.fixture
def pool_env(monkeypatch, request):
    env, frames = POOLS[request.param]
    for name in ("TRC_TLAS", "TRC_TLAS_LEAF", "TRC_TLAS_BLOCK", "TRC_RAYPOOL_FRAMES",
                 "TRC_RAYPOOL_WIDTH"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("TRC_PALLAS", "1")
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    jax.clear_caches()
    yield env, frames
    jax.clear_caches()


def _reference_windows(frames):
    """The reference's ``render_batch_raypool`` in the current environment:
    (images, each window's statistics as numpy)."""
    jitted = ref_raypool._raypool_batch
    recorded = []

    def recording(*args, **kw):
        images, stats = jitted(*args, **kw)
        recorded.append(tuple(np.asarray(s) for s in stats))
        return images, stats

    ref_raypool._raypool_batch = recording
    try:
        images = ref_raypool.render_batch_raypool(DEEP, list(frames), **dict(SIZE))
    finally:
        ref_raypool._raypool_batch = jitted
    return [np.asarray(image) for image in images], recorded


@pytest.mark.parametrize("pool_env", list(POOLS), indirect=True)
def test_pool_windows_at_the_tiers_match_the_reference(pool_env):
    env, frames = pool_env
    expected, recorded = _reference_windows(frames)
    kernels.reset_counts()
    images, stats = raypool.render_batch_raypool(DEEP, list(frames), device="cpu", **dict(SIZE))
    packet = int(env.get("TRC_TLAS_BLOCK", kernels.TLAS_BLOCK_R))
    assert kernels.counts.get(kernels.packet_name("pool_mesh_bounce_tlas_reference", packet), 0) > 0
    assert len(stats) == len(recorded) == -(-len(frames) // raypool.raypool_frame_cap())
    for out, ref in zip(images, expected):
        _assert_images_equivalent(out.numpy(), ref)
    for got, window in zip(stats, recorded):
        iterations, served, refilled, live_sum, launched_sum, occ_log, refill_log = window
        assert got.iterations == int(iterations)
        assert got.served == int(served) and got.refilled == int(refilled)
        assert got.live_sum == int(live_sum) and got.launched_sum == int(launched_sum)
        assert got.refill_log == refill_log[:got.iterations].tolist()
        np.testing.assert_allclose(got.occ_log, occ_log[:got.iterations], rtol=1e-6)
    if "TRC_RAYPOOL_WIDTH" in env:
        assert max(stats[0].occ_log) <= 1.0 and stats[0].live_sum > 0
