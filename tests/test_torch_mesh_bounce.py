"""The per-bounce kernels' plain versions, the coherence sort and the
instance broadphase against the JAX package (the CUDA kernels themselves
are held against the plain versions on a GPU by
tests/test_torch_kernels_cuda.py).

The reference runs ``mesh_bounce_pallas`` (flat instance variant,
full-precision node tables) and ``sphere_bounce_pallas`` in interpret mode
on the CPU. Inputs are made with numpy from a seed and travel across as
numpy arrays. Each bounce is compared on a sorted state as its callers
feed it: a permuted lane row (the RNG counters), the live lanes first and
a dead tail at and past ``live_count``.

Tolerance, per ray over the three channels of each of the contribution,
origin, direction and throughput, rtol = atol = 1e-4: every ray but an
edge-tie budget of max(1, round(0.001 R)) (a ray through the shared edge
of two triangles may take either face's normal), and ``alive`` exact
within the same budget. The sort permutation and the broadphase are
compared exactly.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_kernels_mesh import _inputs as _mesh_inputs
from tpu_render_cluster.render import camera as ref_camera
from tpu_render_cluster.render import integrator as ref_integrator
from tpu_render_cluster.render import pallas_kernels as ref_kernels
from tpu_render_cluster.render import scene as ref_scene
from tpu_render_cluster_torch.render import integrator, kernels
from tpu_render_cluster_torch.render import scene as port_scene

DEEP, FRAME = "03_physics-2-mesh", 30
SIDE, SAMPLES = 16, 2  # 512 rays
BOUNCES = 4
SEED = -1136603641


@pytest.fixture
def pallas_on(monkeypatch):
    """The reference's Pallas kernels; its ``trace_paths`` reads the
    switch at each call (it is not jitted)."""
    monkeypatch.setenv("TRC_PALLAS", "1")


@functools.lru_cache(maxsize=None)
def camera_rays(name: str) -> tuple[np.ndarray, np.ndarray]:
    """Frame 30's camera rays, SIDE x SIDE pixels x SAMPLES, with seeded
    random jitter (no ray lands on a checker edge of the plane)."""
    camera = ref_camera.scene_camera(name, FRAME)
    rng = np.random.default_rng(11)
    rays = [
        ref_camera.camera_rays(
            camera, SIDE, SIDE, y0=0, x0=0, tile_height=SIDE, tile_width=SIDE,
            jitter=jnp.asarray(rng.random((SIDE * SIDE, 2), dtype=np.float32)),
        )
        for _ in range(SAMPLES)
    ]
    return (
        np.concatenate([np.asarray(o) for o, _ in rays]),
        np.concatenate([np.asarray(d) for _, d in rays]),
    )


@functools.lru_cache(maxsize=None)
def _sphere_inputs(name: str):
    scene = ref_scene.build_scene(name, FRAME)
    port = port_scene.scene_from_arrays({k: np.asarray(v) for k, v in scene._asdict().items()}, "cpu")
    return scene, None, port, None


def _reference_bounce(scene, mesh_set, state, live, bounce):
    """The reference kernel on numpy state (o, d, thr, alive, lane)."""
    o, d, thr, alive, lane = (jnp.asarray(a) for a in state)
    args = dict(total_bounces=BOUNCES, lane=lane, live_count=jnp.int32(live))
    if mesh_set is None:
        out = ref_kernels.sphere_bounce_pallas(
            scene, o, d, thr, alive, jnp.int32(SEED), bounce, **args
        )
    else:
        out = ref_kernels.mesh_bounce_pallas(
            scene, mesh_set, o, d, thr, alive, jnp.int32(SEED), bounce,
            use_tlas=False, quant=0, **args,
        )[:5]
    return tuple(np.asarray(a) for a in out)


@functools.lru_cache(maxsize=None)
def sorted_state(name: str, bounce: int):
    """The path state before ``bounce``: the camera rays advanced through
    the reference's own earlier bounces, then permuted at random, a tenth
    of the lanes killed at bounce 0, and the live lanes partitioned to the
    front (stably). Returns ((o, d, thr, alive, lane), live)."""
    inputs = _mesh_inputs(name, FRAME) if name == DEEP else _sphere_inputs(name)
    origins, directions = camera_rays(name)
    rays = origins.shape[0]
    state = (
        origins, directions, np.ones((rays, 3), np.float32), np.ones(rays, bool),
        np.arange(rays, dtype=np.int32),
    )
    for earlier in range(bounce):
        out = _reference_bounce(inputs[0], inputs[1], state, rays, earlier)
        state = (out[1], out[2], out[3], out[4], state[4])
    rng = np.random.default_rng(100 + bounce)
    state = tuple(a[rng.permutation(rays)] for a in state)
    if bounce == 0:
        state = (*state[:3], state[3] & (rng.random(rays) >= 0.1), state[4])
    order = np.argsort(~state[3], kind="stable")
    state = tuple(a[order] for a in state)
    return state, int(state[3].sum())


def _assert_bounce_matches(got, expected):
    rays = expected[0].shape[0]
    budget = max(1, round(0.001 * rays))
    close = np.ones(rays, bool)
    for have, want in zip(got[:4], expected[:4]):
        assert have.shape == want.shape and np.isfinite(have).all()
        close &= np.isclose(have, want, rtol=1e-4, atol=1e-4).all(axis=1)
    assert (~close).sum() <= budget, np.flatnonzero(~close)
    assert (got[4] != expected[4]).sum() <= budget


@pytest.mark.parametrize("bounce", [0, 2])
@pytest.mark.parametrize("name", [DEEP, "04_very-simple"])
def test_bounce_plain_version_matches_pallas_interpret(pallas_on, name, bounce):
    scene, mesh_set, port, port_mesh = (
        _mesh_inputs(name, FRAME) if name == DEEP else _sphere_inputs(name)
    )
    state, live = sorted_state(name, bounce)
    rays = state[0].shape[0]
    assert 0 < live < rays and not state[3][live:].any()
    assert (state[4] != np.arange(rays)).any()  # lanes are permuted
    expected = _reference_bounce(scene, mesh_set, state, live, bounce)
    tensors = [torch.from_numpy(a) for a in state]
    kernels.reset_counts()
    if mesh_set is None:
        out = kernels.sphere_bounce(port, *tensors, live, SEED, bounce, total_bounces=BOUNCES)
    else:
        out = kernels.mesh_bounce(
            port, port_mesh, *tensors, live, SEED, bounce, total_bounces=BOUNCES, use_tlas=False
        )
    name_called = "sphere_bounce_reference" if mesh_set is None else "mesh_bounce_reference"
    assert kernels.counts == {k: int(k == name_called) for k in kernels.counts}
    got = tuple(a.numpy() for a in out)
    _assert_bounce_matches(got, expected)
    # Dead lanes, and lanes past the live count, pass through unchanged.
    dead = ~state[3]
    assert (got[0][dead] == 0.0).all()
    for have, before in zip(got[1:4], state[:3]):
        np.testing.assert_array_equal(have[dead], before[dead])
    assert got[0][:live].max() > 0.05  # the live lanes see something


def check_deep_loop(*, max_bounces: int, use_tlas):
    """The port's deep loop against the reference's ``trace_paths`` on
    the deep scene's camera rays (``TRC_PALLAS=1`` set by the caller), both
    at the instance walk ``use_tlas`` (None: each one's default, TLAS)."""
    scene, mesh_set, port, port_mesh = _mesh_inputs(DEEP, FRAME)
    origins, directions = camera_rays(DEEP)
    key = jax.random.PRNGKey(3)
    expected = np.asarray(
        ref_integrator.trace_paths(
            scene, jnp.asarray(origins), jnp.asarray(directions), key,
            max_bounces=max_bounces, mesh=mesh_set, use_tlas=use_tlas, quant=0,
        )
    )
    kernels.reset_counts()
    got = integrator.trace_paths(
        port, torch.from_numpy(origins), torch.from_numpy(directions),
        int(ref_integrator.trace_seed(key)), max_bounces=max_bounces, mesh=port_mesh,
        use_tlas=use_tlas,
    ).numpy()
    plain = "mesh_bounce_reference" if use_tlas is False else "mesh_bounce_tlas_reference"
    assert kernels.counts == {k: (max_bounces if k == plain else 0) for k in kernels.counts}
    assert got.shape == expected.shape and np.isfinite(got).all()
    close = np.isclose(got, expected, rtol=1e-4, atol=1e-4).all(axis=1)
    if max_bounces == 1:
        assert (~close).sum() <= max(1, round(0.001 * close.size)), np.flatnonzero(~close)
    else:
        assert close.mean() >= 0.999, close.mean()
    assert got.max() > 0.1


@pytest.mark.parametrize("max_bounces", [1, 4])
def test_deep_loop_matches_the_reference_flat_walk(pallas_on, max_bounces):
    """The masked deep loop of ``integrator.trace_paths`` against the
    reference's with its flat instance walk (``use_tlas=False``)."""
    check_deep_loop(max_bounces=max_bounces, use_tlas=False)


def test_bounce_state_is_validated():
    port = _sphere_inputs("04_very-simple")[2]
    state, live = sorted_state("04_very-simple", 0)
    o, d, thr, alive, lane = (torch.from_numpy(a) for a in state)
    with pytest.raises(ValueError, match="lane must be int32"):
        kernels.sphere_bounce(port, o, d, thr, alive, lane.long(), live, 1, 0, total_bounces=4)
    with pytest.raises(ValueError, match="alive must be bool"):
        kernels.sphere_bounce(port, o, d, thr, alive.float(), lane, live, 1, 0, total_bounces=4)
    with pytest.raises(ValueError, match="bounce 4"):
        kernels.sphere_bounce(port, o, d, thr, alive, lane, live, 1, 4, total_bounces=4)


@pytest.mark.parametrize("bounce", [0, 2])
@pytest.mark.parametrize("with_mesh", [True, False])
def test_sort_order_equals_the_reference(pallas_on, with_mesh, bounce):
    """The coherence key's stable argsort is the reference's permutation,
    on primary rays (one shared origin) and on scattered bounce-2 rays
    with a dead tail."""
    _, mesh_set, _, port_mesh = _mesh_inputs(DEEP, FRAME)
    state, _ = sorted_state(DEEP, bounce)
    o, d, _, alive, _ = state
    expected = np.asarray(
        ref_integrator._ray_sort_order(
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(alive),
            mesh=mesh_set if with_mesh else None,
        )
    )
    got = integrator._ray_sort_order(
        torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(alive),
        port_mesh if with_mesh else None,
    )
    np.testing.assert_array_equal(got.numpy(), expected)
    key = integrator.ray_sort_key(
        torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(alive),
        port_mesh if with_mesh else None,
    )
    assert key.dtype == torch.int64 and 0 <= key.min() and key.max() < 2**32
    assert ((key >> 31) == torch.from_numpy(~alive).long()).all()


def test_instance_entry_candidates_bit_identical():
    """The chunked [R, K] broadphase against the reference's, on random
    rays around the deep scene's 48 instances, incl. axis-aligned
    directions and rays that overlap no instance."""
    _, mesh_set, _, port_mesh = _mesh_inputs(DEEP, FRAME)
    table = kernels.instance_table(port_mesh)
    lo_w, hi_w = table[:, 13:16].contiguous(), table[:, 16:19].contiguous()
    rng = np.random.default_rng(5)
    rays = 300
    origins = (rng.normal(size=(rays, 3)) * 4.0 + [0.0, 2.0, 0.0]).astype(np.float32)
    directions = rng.normal(size=(rays, 3)).astype(np.float32)
    # Half the rays aim near a random instance's world box.
    centers = (0.5 * (lo_w + hi_w)).numpy()[rng.integers(0, lo_w.shape[0], rays // 2)]
    directions[rays // 2:] = centers + rng.normal(size=centers.shape) * 0.3 - origins[rays // 2:]
    directions[:20, :2] = 0.0  # straight up or down
    directions[20:40] = [0.0, 1.0, 0.0]
    origins[20:40, 1] = 50.0  # above everything, looking up: no overlap
    directions /= np.linalg.norm(directions, axis=1, keepdims=True)
    expected = np.asarray(
        ref_kernels.instance_entry_candidates(
            jnp.asarray(origins), jnp.asarray(directions), jnp.asarray(lo_w.numpy()),
            jnp.asarray(hi_w.numpy()),
        )
    )
    got = kernels.instance_entry_candidates(
        torch.from_numpy(origins), torch.from_numpy(directions), lo_w, hi_w, chunk_rays=37
    )
    np.testing.assert_array_equal(got.numpy(), expected)
    k = lo_w.shape[0]
    assert k == 48 and (got == k).sum() >= 20 and (got < k).sum() > 50
    np.testing.assert_array_equal(
        np.asarray(ref_kernels._instance_table(
            mesh_set.instances.rotation, mesh_set.instances.translation,
            mesh_set.instances.scale, mesh_set.bvh.bounds_min, mesh_set.bvh.bounds_max,
        ))[:, 13:19],
        table[:, 13:19].numpy(),
    )
