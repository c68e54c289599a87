"""The packet vote of a pool launch, for the frames its lanes carry.

A pool launch stacks the window's frames' instance rows frame-major, and a
lane of frame f reads only its frame's rows, so ``packet_votes(...,
frames=)`` votes a packet's rows of the frames its lanes below the launch's
lane count carry and writes 0 for the others. Held here, in its plain
version: every row of a carried frame equals the all-rows vote, every other
row is 0 (a packet straddling two frames, frame ids outside the window, the
ragged last packet, packets past the live count); the plain pool bounce,
which takes these votes, gives the bits it gives with every row voted; and
it matches the JAX package's pool kernel (``TRC_PALLAS=1``, interpret mode)
on a launch of sorted lanes whose packets carry one, two or three frames, at
tests/test_torch_raypool.py's tolerance (rtol = atol = 1e-4 per lane but an
edge-tie budget of max(1, round(0.001 P)), alive within the same budget,
the TLAS key as tests/test_torch_tlas_bounce.py holds it on the lanes that
agree). Inputs are made with numpy from seeds.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_raypool import _mixed_state, _port_ops, _reference_ops
from tests.test_torch_tlas_bounce import DEEP, _assert_keys, _field
from tpu_render_cluster.render import pallas_kernels as ref_kernels
from tpu_render_cluster_torch.render import kernels

BLOCK, PER_FRAME, FRAMES = 256, 3, 4  # the random-12 field's slots as 4 frames of 3 rows
TOTAL_BOUNCES = 4


@pytest.fixture
def pallas_on(monkeypatch):
    monkeypatch.setenv("TRC_PALLAS", "1")


def _launch(rays: int, fid: np.ndarray, seed: int = 7):
    rng = np.random.default_rng(seed)
    directions = torch.from_numpy(rng.normal(size=(rays, 3)).astype(np.float32))
    table = kernels.tlas_frame(_field("random-12")[1]).slots
    assert table.shape[0] == PER_FRAME * FRAMES
    return directions, table, torch.from_numpy(fid.astype(np.int32))


def _straddle():
    fid = np.zeros(512, np.int64)
    fid[200:] = 1  # packet 0 carries frames 0 and 1, packet 1 frame 1
    return 512, fid, 512


def _outside():
    fid = np.full(512, 2)
    fid[::7] = -1  # ids outside the window count for none
    fid[3::11] = FRAMES
    fid[256:] = np.where(np.arange(256) % 2, 9, -3)  # packet 1: no frame at all
    return 512, fid, 512


def _ragged():
    rng = np.random.default_rng(3)
    return 600, rng.integers(0, FRAMES, 600), 600  # the last packet: 88 lanes and pads


def _past_live():
    rng = np.random.default_rng(4)
    return 900, rng.integers(0, FRAMES, 900), 300  # packets 2 and 3 walked by no kernel


@pytest.mark.parametrize("case", [_straddle, _outside, _ragged, _past_live],
                         ids=["straddle", "outside", "ragged", "past-live"])
def test_frame_votes_are_the_all_rows_votes_on_carried_frames(case):
    rays, fid, live = case()
    directions, table, frames = _launch(rays, fid)
    kernels.reset_counts()
    world, rows = kernels.packet_votes(directions, table, live, block=BLOCK, world=False,
                                       frames=frames, per_frame=PER_FRAME)
    assert world is None and kernels.counts["packet_octants_reference"] == 1
    _, every = kernels.packet_votes_reference(directions, table, live, block=BLOCK, world=False)
    packets = -(-rays // BLOCK)
    assert rows.shape == every.shape == (packets, PER_FRAME * FRAMES) and rows.dtype == torch.uint8
    for p in range(packets):
        lanes = fid[p * BLOCK:(p + 1) * BLOCK]
        carried = {int(f) for f in lanes if 0 <= f < FRAMES}
        for k in range(table.shape[0]):
            want = int(every[p, k]) if k // PER_FRAME in carried and p * BLOCK < live else 0
            assert int(rows[p, k]) == want, (p, k)
    assert torch.equal(kernels.carried_frames(frames, BLOCK, FRAMES).sum(dim=1),
                       torch.tensor([len({int(f) for f in fid[p * BLOCK:(p + 1) * BLOCK]
                                          if 0 <= f < FRAMES}) for p in range(packets)]))


def test_frame_votes_check_their_arguments():
    directions, table, frames = _launch(300, np.zeros(300))
    with pytest.raises(ValueError, match="one id a lane"):
        kernels.packet_votes(directions, table, 300, block=BLOCK, frames=frames[:10],
                             per_frame=PER_FRAME)
    with pytest.raises(ValueError, match="must divide"):
        kernels.packet_votes(directions, table, 300, block=BLOCK, frames=frames, per_frame=5)
    wide = table[:1].expand(33, 22)
    with pytest.raises(ValueError, match="at most 32"):
        kernels.packet_votes(directions, wide, 300, block=BLOCK, frames=frames, per_frame=1)


def _sorted_state(frames: tuple, outside: bool = False):
    """tests/test_torch_raypool.py's mixed state with its live lanes sorted
    by frame, as the pool's key sorts them, so that its four packets of 256
    carry one, two or three frames; with ``outside``, lanes of the dead
    tail past the live count carry ids outside the window."""
    state, live = _mixed_state(DEEP, frames)
    order = np.concatenate([np.argsort(state[5][:live], kind="stable"),
                            np.arange(live, state[0].shape[0])])
    state = tuple(a[order] for a in state)
    if outside:
        state[5][live + 1::3] = len(frames) + 2
        state[5][live::5] = -1
    return state, live


def test_pool_bounce_on_frame_votes_is_the_bounce_on_every_rows_votes(monkeypatch):
    """The plain pool bounce takes the frame votes; with every row voted
    instead its walks give the same bits."""
    frames = (30, 31, 32)
    state, live = _sorted_state(frames, outside=True)
    ops = _port_ops(DEEP, frames)
    args = [torch.from_numpy(a) for a in state]
    got = kernels.pool_mesh_bounce(ops, *args, live, total_bounces=TOTAL_BOUNCES, use_tlas=True)
    carried = kernels.carried_frames(args[5], BLOCK, len(frames)).sum(dim=1)
    assert sorted(set(carried.tolist())) == [1, 2, 3]  # packets of one, two and three frames
    votes = kernels._votes
    monkeypatch.setattr(kernels, "_votes", lambda *a: votes(*a[:6], None, None))
    every = kernels.pool_mesh_bounce(ops, *args, live, total_bounces=TOTAL_BOUNCES, use_tlas=True)
    for name, have, want in zip(got._fields, got, every):
        assert torch.equal(have, want), name


def test_pool_bounce_on_frame_votes_matches_the_reference(pallas_on):
    """Row 6 TLAS, plain, on the sorted launch against the reference's pool
    kernel (ordered BLAS, canonical TLAS)."""
    frames = (30, 31, 32)
    state, live = _sorted_state(frames)
    ref_ops = _reference_ops(DEEP, frames)
    assert ref_ops.octant is not None
    expected = [None if a is None else np.asarray(a) for a in ref_kernels.pool_mesh_bounce(
        ref_ops, *[jnp.asarray(a) for a in state], jnp.int32(live), total_bounces=TOTAL_BOUNCES,
        use_tlas=True, quant=0,
    )]
    got = kernels.pool_mesh_bounce(_port_ops(DEEP, frames), *(torch.from_numpy(a) for a in state),
                                   live, total_bounces=TOTAL_BOUNCES, use_tlas=True)
    pool = state[0].shape[0]
    close = np.ones(pool, bool)
    for have, want in zip(got[:4], expected[:4]):
        close &= np.isclose(have.numpy(), want, rtol=1e-4, atol=1e-4).all(axis=1)
    budget = max(1, round(0.001 * pool))
    assert (~close).sum() <= budget and (got.alive.numpy() != expected[4]).sum() <= budget
    agree = close & (got.alive.numpy() == expected[4])
    alive = got.alive.numpy() & agree
    _assert_keys(got.key.numpy()[agree], expected[5][agree], alive[agree])
