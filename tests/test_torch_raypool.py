"""The port's device ray pool (``render/raypool.py``, kernel rows 5 and 6)
against the JAX package's (``tpu_render_cluster/render/raypool.py``), and
against the port's own per-frame tiers.

The reference runs with ``TRC_PALLAS=1``: its pool kernels in interpret
mode, as its own tests (tests/test_raypool.py) run them, at their sizes.
Its renders are made once per file (cached). Inputs of the kernel-level
checks are made with numpy from a seed and travel across as numpy arrays.

Tolerances:
- a pool bounce (the plain versions of ``pool_sphere_bounce`` and
  ``pool_mesh_bounce`` against the reference's kernels, flat variant):
  per lane over the three channels of each of the contribution, origin,
  direction and throughput, rtol = atol = 1e-4, every lane but an edge-tie
  budget of max(1, round(0.001 P)) (a ray through the shared edge of two
  triangles may take either face's normal), ``alive`` exact within the same
  budget;
- whole pool renders against the reference's: its own image bound
  (``_assert_images_equivalent``: at most max(1, round(0.001 n)) pixels
  off by more than 2e-3, mean absolute error below 1e-4), against its TLAS
  default and its flat tier (``TRC_TLAS=0``), whose radiance per lane is
  the same, ties aside;
- the pool's statistics that depend only on the paths' lifetimes
  (iterations, served, refilled, live lanes summed, the refill log):
  equal;
- the port's pool against its masked deep loop and its wavefronts, a batch
  against solo pools, chunked windows against one window: equal to the
  bit. Per lane all run the same plain bounce on the same state with the
  same lane, seed and bounce, a lane not launched adds exactly zero, and
  each lane sums its bounces in the same order.
"""

from __future__ import annotations

import asyncio
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_torch_backend import _job
from tests.test_torch_mesh import reference_mesh_arrays
from tpu_render_cluster.harness.local import run_local_job
from tpu_render_cluster.jobs.models import DistributionStrategy
from tpu_render_cluster.jobs.tiles import WorkUnit
from tpu_render_cluster.render import camera as ref_camera
from tpu_render_cluster.render import mesh as ref_mesh
from tpu_render_cluster.render import pallas_kernels as ref_kernels
from tpu_render_cluster.render import raypool as ref_raypool
from tpu_render_cluster.render import scene as ref_scene
from tpu_render_cluster_torch.render import compaction, integrator, kernels, raypool
from tpu_render_cluster_torch.render import mesh as port_mesh
from tpu_render_cluster_torch.render import scene as port_scene
from tpu_render_cluster_torch.worker.backends.torch_raytrace import TorchRaytraceBackend

DEEP, SPHERES = "03_physics-2-mesh", "04_very-simple"
SPHERE_BATCH = (SPHERES, (30, 31, 32), (("width", 16), ("height", 16), ("samples", 2), ("max_bounces", 3)))
MESH_BATCH = (DEEP, (30, 31), (("width", 12), ("height", 12), ("samples", 1), ("max_bounces", 2)))
TOTAL_BOUNCES = 4


def _assert_images_equivalent(out, ref, *, mae_bound=1e-4):
    """tests/test_raypool.py's bound."""
    lane_diff = np.abs(out - ref).max(axis=-1).ravel()
    n_diverged = int((lane_diff > 2e-3).sum())
    budget = max(1, round(0.001 * lane_diff.size))
    assert n_diverged <= budget, f"{n_diverged}/{lane_diff.size} lanes diverge (budget {budget})"
    mean_abs_error = float(np.abs(out - ref).mean())
    assert mean_abs_error < mae_bound, f"MAE = {mean_abs_error:.2e}"


class _reference_env:
    """``TRC_PALLAS=1`` and the TLAS tier (None: the default) for one
    reference call, with fresh jit caches on both sides."""

    def __init__(self, tlas: bool | None):
        self.env = {"TRC_PALLAS": "1", "TRC_TLAS": None if tlas is None else str(int(tlas))}

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.env}
        for key, value in self.env.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        jax.clear_caches()

    def __exit__(self, *exc):
        for key, value in self.saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        jax.clear_caches()


@functools.lru_cache(maxsize=None)
def _reference_pool(name: str, frames: tuple, kwargs: tuple, tlas: bool | None):
    """The reference's ``render_batch_raypool``: (images, the stats tuple of
    each window's ``_raypool_batch`` as numpy)."""
    jitted = ref_raypool._raypool_batch
    recorded = []

    def recording(*args, **kw):
        images, stats = jitted(*args, **kw)
        recorded.append(tuple(np.asarray(s) for s in stats))
        return images, stats

    with _reference_env(tlas):
        ref_raypool._raypool_batch = recording
        try:
            images = ref_raypool.render_batch_raypool(name, list(frames), **dict(kwargs))
        finally:
            ref_raypool._raypool_batch = jitted
    return [np.asarray(image) for image in images], recorded


@functools.lru_cache(maxsize=None)
def _port_pool(name: str, frames: tuple, kwargs: tuple, frame_cap: int = 8):
    images, stats = raypool.render_batch_raypool(
        name, list(frames), device="cpu", frame_cap=frame_cap, **dict(kwargs)
    )
    return [image.numpy() for image in images], stats


# -- (a) the pool kernels' plain versions against the reference's kernels ----


@functools.lru_cache(maxsize=None)
def _window_inputs(name: str, frames: tuple):
    """(reference scenes, reference mesh sets, port scenes, port meshes) of
    the window's frames, the port's made from the reference's arrays."""
    scenes = [ref_scene.build_scene(name, f) for f in frames]
    port_scenes = [
        port_scene.scene_from_arrays({k: np.asarray(v) for k, v in s._asdict().items()}, "cpu")
        for s in scenes
    ]
    if ref_scene.mesh_kind_for_scene(name) is None:
        return scenes, None, port_scenes, None
    mesh_sets = [ref_mesh.scene_mesh_set(name, f, "sah", 4) for f in frames]
    port_meshes = [
        port_mesh.mesh_from_arrays(*reference_mesh_arrays(m), "cpu") for m in mesh_sets
    ]
    return scenes, mesh_sets, port_scenes, port_meshes


def _reference_ops(name: str, frames: tuple):
    """The reference's stacked operands, built as its ``_raypool_batch``
    builds them."""
    scenes, mesh_sets, _, _ = _window_inputs(name, frames)
    n = scenes[0].radii.shape[0]
    stack = lambda field: jnp.concatenate([getattr(s, field) for s in scenes])  # noqa: E731
    spheres = ref_kernels.pool_sphere_operands(
        stack("centers"), stack("radii"), stack("albedo"), stack("emission"),
        jnp.repeat(jnp.arange(len(frames), dtype=jnp.int32), n),
        scenes[0].sun_direction, scenes[0].sun_color, scenes[0].sky_horizon,
        scenes[0].sky_zenith, scenes[0].plane_albedo_a, scenes[0].plane_albedo_b,
    )
    if mesh_sets is None:
        return spheres
    k = mesh_sets[0].instances.translation.shape[0]
    bvh = mesh_sets[0].bvh
    inst = lambda field: jnp.concatenate([getattr(m.instances, field) for m in mesh_sets])  # noqa: E731
    return ref_kernels.PoolMeshOperands(
        spheres=spheres, sun_direction=scenes[0].sun_direction,
        rotation=inst("rotation"), translation=inst("translation"), scale=inst("scale"),
        inst_albedo=inst("albedo"), ifid=jnp.repeat(jnp.arange(len(frames), dtype=jnp.int32), k),
        k_per_frame=k, v0=bvh.v0, e1=bvh.e1, e2=bvh.e2, normal=bvh.normal,
        bounds_min=bvh.bounds_min, bounds_max=bvh.bounds_max, skip=bvh.skip,
        first=bvh.first, count=bvh.count, octant=bvh.octant,
    )


def _port_ops(name: str, frames: tuple):
    _, _, port_scenes, port_meshes = _window_inputs(name, frames)
    if port_meshes is None:
        return kernels.pool_sphere_operands(port_scenes)
    return kernels.pool_mesh_operands(port_scenes, port_meshes)


def _mixed_state(name: str, frames: tuple, pool: int = 1024, live: int = 800):
    """A pool state as the pool feeds a launch, made with numpy from a seed:
    lanes of every frame of the window at every bounce, with the frame's
    camera rays or rays from random points above the ground, random
    throughput, unique lanes, per-frame seeds, some dead lanes inside the
    live prefix and a dead tail past ``live``. Returns (state, live)."""
    rng = np.random.default_rng(17)
    fid = rng.integers(0, len(frames), pool).astype(np.int32)
    side = int(np.sqrt(pool))
    camera_rays = [
        ref_camera.camera_rays(
            ref_camera.scene_camera(name, f), side, side, y0=0, x0=0, tile_height=side,
            tile_width=side, jitter=jnp.asarray(rng.random((side * side, 2), dtype=np.float32)),
        )
        for f in frames
    ]
    origins = np.stack([np.asarray(camera_rays[f][0])[i] for i, f in enumerate(fid)])
    directions = np.stack([np.asarray(camera_rays[f][1])[i] for i, f in enumerate(fid)])
    scattered = rng.random(pool) < 0.5
    points = np.stack(
        [rng.uniform(-5, 5, pool), rng.uniform(0.05, 4.0, pool), rng.uniform(-5, 5, pool)], axis=1
    )
    turned = rng.normal(size=(pool, 3))
    turned /= np.linalg.norm(turned, axis=1, keepdims=True)
    origins = np.where(scattered[:, None], points, origins).astype(np.float32)
    directions = np.where(scattered[:, None], turned, directions).astype(np.float32)
    throughput = rng.uniform(0.2, 1.0, (pool, 3)).astype(np.float32)
    alive = (np.arange(pool) < live) & (rng.random(pool) >= 0.05)
    lane = rng.permutation(4 * pool)[:pool].astype(np.int32)
    seeds = rng.integers(-(2**31), 2**31, len(frames)).astype(np.int32)
    bounce = rng.integers(0, TOTAL_BOUNCES, pool).astype(np.int32)
    return (origins, directions, throughput, alive, lane, fid, seeds[fid], bounce), live


@pytest.mark.parametrize("name,frames", [(SPHERES, (30, 31, 32)), (DEEP, (30, 31))])
def test_pool_bounce_plain_version_matches_pallas_interpret(name, frames):
    state, live = _mixed_state(name, frames)
    pool = state[0].shape[0]
    assert len(np.unique(state[5][:live])) == len(frames)
    assert len(np.unique(state[7][:live])) == TOTAL_BOUNCES
    ref_ops = _reference_ops(name, frames)
    args = [jnp.asarray(a) for a in state] + [jnp.int32(live)]
    if name == DEEP:
        expected = ref_kernels.pool_mesh_bounce(
            ref_ops, *args, total_bounces=TOTAL_BOUNCES, use_tlas=False, quant=0
        )[:5]
        wrapper = kernels.pool_mesh_bounce
    else:
        expected = ref_kernels.pool_sphere_bounce(ref_ops, *args, total_bounces=TOTAL_BOUNCES)
        wrapper = kernels.pool_sphere_bounce
    expected = [np.asarray(a) for a in expected]
    ops = _port_ops(name, frames)
    kernels.reset_counts()
    options = {"use_tlas": False} if name == DEEP else {}  # the reference's flat kernel
    got = wrapper(
        ops, *(torch.from_numpy(a) for a in state), live, total_bounces=TOTAL_BOUNCES, **options
    )
    called = f"{wrapper.__name__}_reference"
    assert kernels.counts == {k: int(k == called) for k in kernels.counts}
    got = [a.numpy() for a in got]
    budget = max(1, round(0.001 * pool))
    close = np.ones(pool, bool)
    for have, want in zip(got[:4], expected[:4]):
        assert have.shape == want.shape and np.isfinite(have).all()
        close &= np.isclose(have, want, rtol=1e-4, atol=1e-4).all(axis=1)
    assert (~close).sum() <= budget, np.flatnonzero(~close)
    assert (got[4] != expected[4]).sum() <= budget
    # Dead lanes, and lanes past the live count, pass through unchanged.
    dead = ~state[3]
    assert (got[0][dead] == 0.0).all() and not got[4][live:].any()
    for have, before in zip(got[1:4], state[:3]):
        np.testing.assert_array_equal(have[dead], before[dead])
    assert got[0][:live].max() > 0.05


# -- (b) the stacked operands -------------------------------------------------


@pytest.mark.parametrize("name,frames", [(SPHERES, (30, 31, 32)), (DEEP, (30, 31))])
def test_stacked_operands_equal_the_reference(name, frames):
    ref_ops = _reference_ops(name, frames)
    ops = _port_ops(name, frames)
    spheres_ref = ref_ops.spheres if isinstance(ref_ops, ref_kernels.PoolMeshOperands) else ref_ops
    spheres = ops.spheres if isinstance(ops, kernels.PoolMeshOperands) else ops
    rows = spheres.spheres.numpy()
    n = spheres.per_frame
    assert rows.shape == (len(frames) * n, 16) and n % 8 == 0
    sfid = np.asarray(spheres_ref.sfid)[:, 0]
    real = sfid >= 0
    # Frame f's rows are [f N, (f + 1) N) in both (the reference's count
    # pads to 8 at each frame too).
    np.testing.assert_array_equal(sfid[real], np.repeat(np.arange(len(frames)), n))
    columns = {
        (0, 3): np.asarray(spheres_ref.c_t).T, (3, 4): np.asarray(spheres_ref.r2),
        (4, 5): np.asarray(spheres_ref.csq), (5, 6): np.asarray(spheres_ref.dc_sun),
        (6, 7): np.asarray(spheres_ref.rad), (8, 11): np.asarray(spheres_ref.albedo_t).T,
        (12, 15): np.asarray(spheres_ref.emission_t).T,
    }
    for (lo, hi), want in columns.items():
        np.testing.assert_allclose(rows[:, lo:hi], want[real], rtol=1e-6, atol=1e-6, err_msg=f"{lo}:{hi}")
    np.testing.assert_array_equal(
        spheres.params.numpy(), np.asarray(spheres_ref.params)[:6].reshape(-1)
    )
    for frame, table in enumerate(spheres.tables):
        np.testing.assert_array_equal(table.centers.numpy(), rows[frame * n:(frame + 1) * n, 0:3])
    if not isinstance(ops, kernels.PoolMeshOperands):
        return
    k = ops.per_frame
    assert ops.instances.shape == (len(frames) * k, 22)
    expected = np.asarray(ref_kernels._instance_table(
        ref_ops.rotation, ref_ops.translation, ref_ops.scale, ref_ops.bounds_min,
        ref_ops.bounds_max, ref_ops.inst_albedo,
    ))
    np.testing.assert_allclose(ops.instances.numpy(), expected, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(ref_ops.ifid), np.repeat(np.arange(len(frames)), k))
    for got, want in zip(kernels.pool_instance_aabbs(ops), ref_kernels.pool_instance_aabbs(ref_ops)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- (c), (d) whole pool renders and their statistics -------------------------


@pytest.mark.parametrize(
    "batch,tlas", [(SPHERE_BATCH, None), (MESH_BATCH, None), (MESH_BATCH, False)],
    ids=["spheres", "mesh-tlas-default", "mesh-flat"],
)
def test_pool_render_matches_the_reference(batch, tlas):
    name, frames, kwargs = batch
    expected, _ = _reference_pool(name, frames, kwargs, tlas)
    got, stats = _port_pool(name, frames, kwargs)
    assert len(got) == len(expected) == len(frames) and len(stats) == 1
    for out, ref in zip(got, expected):
        assert out.shape == ref.shape and np.isfinite(out).all() and out.max() > 0.05
        _assert_images_equivalent(out, ref)


@pytest.mark.parametrize("batch", [SPHERE_BATCH, MESH_BATCH], ids=["spheres", "mesh"])
def test_pool_stats_equal_the_reference(batch):
    name, frames, kwargs = batch
    _, recorded = _reference_pool(name, frames, kwargs, False)
    _, stats = _port_pool(name, frames, kwargs)
    (iterations, served, refilled, live_sum, _launched, _occ, refill_log), = recorded
    got = stats[0]
    rays = dict(kwargs)["width"] * dict(kwargs)["height"] * dict(kwargs)["samples"]
    assert got.iterations == int(iterations) >= dict(kwargs)["max_bounces"]
    assert got.served == int(served) == got.refilled == int(refilled) == len(frames) * rays
    assert got.live_sum == int(live_sum)
    assert got.refill_log == refill_log[:got.iterations].tolist()
    assert len(got.occ_log) == got.iterations and all(0.0 < x <= 1.0 for x in got.occ_log)
    assert got.launched_sum >= got.live_sum
    assert got.host_reads <= got.iterations + 3


# -- (e), (f) against the port's per-frame tiers, solo pools and chunking -----


def test_mesh_pool_equals_the_masked_deep_loop_to_the_bit():
    name, frames, kwargs = MESH_BATCH
    got, _ = _port_pool(name, frames, kwargs)
    for frame, image in zip(frames, got):
        masked = integrator.render_frame(name, frame, device="cpu", **dict(kwargs))
        wavefront = compaction.render_frame_wavefront(name, frame, device="cpu", **dict(kwargs))
        np.testing.assert_array_equal(image, masked.numpy())
        np.testing.assert_array_equal(image, wavefront.numpy())


def test_sphere_pool_equals_the_sphere_bounce_wavefront_to_the_bit():
    name, frames, kwargs = SPHERE_BATCH
    got, _ = _port_pool(name, frames, kwargs)
    kernels.reset_counts()
    for frame, image in zip(frames, got):
        wavefront = compaction.render_frame_wavefront(name, frame, device="cpu", **dict(kwargs))
        np.testing.assert_array_equal(image, wavefront.numpy())
    assert kernels.counts["sphere_bounce_reference"] > 0


def test_batch_equals_solo_pools_and_frame_cap_chunks():
    name = SPHERES
    kwargs = (("width", 8), ("height", 8), ("samples", 1), ("max_bounces", 2))
    frames = (40, 41, 42, 43, 44)
    batched, stats = _port_pool(name, frames, kwargs)
    assert len(stats) == 1
    chunked, chunk_stats = _port_pool(name, frames, kwargs, frame_cap=2)
    assert [s.served for s in chunk_stats] == [128, 128, 64]
    for frame, image, chunk in zip(frames, batched, chunked):
        solo, _ = _port_pool(name, (frame,), kwargs)
        np.testing.assert_array_equal(image, solo[0])
        np.testing.assert_array_equal(image, chunk)


def test_chunked_checks_change_nothing_and_a_finished_window_stays_put():
    """A host check after every iteration gives the images and statistics
    of the default chunks; iterations past the end change no bit of the
    state, ``it`` included."""
    name, frames, kwargs = MESH_BATCH
    window = raypool.PoolWindow(name, frames, device=torch.device("cpu"), **dict(kwargs))
    expected, expected_stats = _port_pool(name, frames, kwargs)
    state = window.initial_state()
    launches = []
    while bool(window.more(state)):
        state = window.iteration(state, len(launches), launches.append)
    for image, want in zip(window.images(state), expected):
        np.testing.assert_array_equal(image.numpy(), want)
    served, iterations, refilled, live_sum, launched_sum = state.counters.tolist()
    stats = expected_stats[0]
    assert (iterations, served, refilled, live_sum, launched_sum) == stats[:5]
    assert state.occ_log[:iterations].tolist() == stats.occ_log
    assert state.refill_log[:iterations].tolist() == stats.refill_log
    assert iterations + 3 >= stats.host_reads

    before = [t.clone() for t in state]
    after = window.iteration(state, iterations)
    for old, new in zip(before, after):
        assert torch.equal(old, new)
    assert [launch.iteration for launch in launches] == list(range(iterations))
    assert int(launches[0].live) == min(window.pool, window.total)


# -- (g) the mesh pool's permutation -------------------------------------------


@pytest.mark.parametrize("boxes", ["scene", "far"])
def test_pool_sort_order_equals_the_reference(boxes):
    """The permutation on a random pool state (lanes of three frames, a
    fifth of them dead and some parked at 1e7 as the pool's never-filled
    lanes are) against the reference's, with the deep scene's slot-union
    boxes or one far box (uniform candidates, isolating the dead and frame
    bits); then the partition and the grouping by frame."""
    rng = np.random.default_rng(7)
    n = 1024
    origins = (rng.normal(size=(n, 3)) * 3.0 + [0.0, 2.0, 0.0]).astype(np.float32)
    directions = rng.normal(size=(n, 3)).astype(np.float32)
    directions /= np.linalg.norm(directions, axis=1, keepdims=True)
    alive = rng.random(n) < 0.8
    origins[-40:] = 1e7
    directions[-40:] = [0.0, 1.0, 0.0]
    alive[-40:] = False
    fid = rng.integers(0, 3, size=n).astype(np.int32)
    if boxes == "far":
        lo, hi = np.full((1, 3), 500.0, np.float32), np.full((1, 3), 501.0, np.float32)
    else:
        ops = _port_ops(DEEP, (30, 31))
        lo_w, hi_w = kernels.pool_instance_aabbs(ops)
        lo = lo_w.reshape(2, -1, 3).amin(dim=0).numpy()
        hi = hi_w.reshape(2, -1, 3).amax(dim=0).numpy()
    expected = np.asarray(ref_raypool._pool_sort_order(
        jnp.asarray(origins), jnp.asarray(directions), jnp.asarray(alive), jnp.asarray(fid),
        jnp.asarray(lo), jnp.asarray(hi),
    ))
    tensors = [torch.from_numpy(a) for a in (origins, directions, alive, fid, lo, hi)]
    perm = raypool._pool_sort_order(*tensors).numpy()
    np.testing.assert_array_equal(perm, expected)
    key = raypool.pool_sort_key(*tensors)
    assert 0 <= key.min() and key.max() < 2**31
    live = int(alive.sum())
    assert alive[perm][:live].all() and not alive[perm][live:].any()
    fid_live = fid[perm][:live]
    assert int((np.diff(fid_live) != 0).sum()) == len(np.unique(fid_live)) - 1


# -- (h) the tier rule ----------------------------------------------------------


@pytest.mark.parametrize("mode", ["off", "force", "auto"])
def test_raypool_active_matches_the_reference(monkeypatch, mode):
    monkeypatch.setenv("TRC_PALLAS", "1")
    monkeypatch.delenv("TRC_RAYPOOL", raising=False)
    for name in (SPHERES, "02_physics-mesh", DEEP):
        for ahead in (0, 1):
            expected = ref_raypool.raypool_active(name, backend_flag=mode, frames_ahead=ahead)
            assert raypool.raypool_active(name, mode=mode, frames_ahead=ahead) == expected, (
                name, ahead,
            )
    with pytest.raises(ValueError, match="raypool mode"):
        raypool.raypool_active(DEEP, mode="sideways")


def test_pool_sizing():
    assert raypool.raypool_width(2_097_152) == 65_536
    assert raypool.raypool_width(512) == raypool.raypool_width(1) == 1024
    assert raypool.raypool_width(2_097_152, 3000) == 3072
    assert raypool.raypool_frame_cap() == 8
    assert raypool.raypool_frame_cap(0) == 1 and raypool.raypool_frame_cap(99) == 32


# -- (i) the backend's pool tier ------------------------------------------------


def _files(directory) -> dict[str, bytes]:
    return {p.name: p.read_bytes() for p in sorted(directory.glob("*.png"))}


def test_backend_batches_the_queue_and_serves_the_cache(tmp_path):
    """Frame 1 with frames 2-3 queued renders all three in one window;
    frames 2-3 then come from the cache (no launch), and every file equals
    a solo pool render's. The cache is bounded by bytes, oldest first."""
    job = _job(DistributionStrategy.naive_fine(), frames=3, workers=1, name="04vs_raypool")
    options = dict(device="cpu", width=8, height=8, samples=1, max_bounces=2, raypool="force")
    backend = TorchRaytraceBackend(base_directory=tmp_path / "batched", **options)
    # The queue's own work units, by attribute; a unit's window takes only
    # units of its own tile (here: whole frames, not tile 0).
    backend.note_upcoming_frames(job, (WorkUnit(2), WorkUnit(3), WorkUnit(2, tile=0)))
    kernels.reset_counts()
    asyncio.run(backend.render_frame(job, 1))
    launches = kernels.counts["pool_sphere_bounce_reference"]
    assert launches > 0 and set(backend._raypool_cache) == {
        (job.job_name, 2, None), (job.job_name, 3, None)
    }
    backend.note_upcoming_frames(job, (3,))
    asyncio.run(backend.render_frame(job, 2))
    backend.note_upcoming_frames(job, ())
    asyncio.run(backend.render_frame(job, 3))
    assert kernels.counts["pool_sphere_bounce_reference"] == launches
    assert not backend._raypool_cache and not backend._upcoming

    solo = TorchRaytraceBackend(base_directory=tmp_path / "solo", **options)
    for frame in (1, 2, 3):
        asyncio.run(solo.render_frame(job, frame))
    batched = _files(tmp_path / "batched" / "frames")
    assert len(batched) == 3 and batched == _files(tmp_path / "solo" / "frames")

    bounded = TorchRaytraceBackend(base_directory=tmp_path / "bounded", **options)
    bounded._RAYPOOL_CACHE_MAX_BYTES = 8 * 8 * 3 * 4  # one linear image
    bounded.note_upcoming_frames(job, (2, 3))
    asyncio.run(bounded.render_frame(job, 1))
    assert set(bounded._raypool_cache) == {(job.job_name, 3, None)}  # frame 2, the oldest, went


def test_the_queue_hint_drives_the_auto_tier_through_the_harness(tmp_path):
    """One port worker serves a deep mesh job through the harness, whose
    worker queue hints its queued frames before each one: under auto the
    frames with frames queued behind them render in pool windows, and every
    file equals the port's masked deep loop's render to the bit."""
    job = _job(
        DistributionStrategy.eager_naive_coarse(5), frames=5, workers=1,
        name="03_physics-2-mesh_raypool",
    )
    width, height, samples, bounces = 8, 6, 1, 3
    backend = TorchRaytraceBackend(
        device="cpu", width=width, height=height, samples=samples, max_bounces=bounces,
        base_directory=tmp_path,
    )
    kernels.reset_counts()
    _master_trace, worker_traces = run_local_job(job, [backend], timeout=300.0)
    rendered = [t for _name, trace in worker_traces for t in trace.frame_render_traces]
    assert sorted(t.frame_index for t in rendered) == [1, 2, 3, 4, 5]
    assert kernels.counts["pool_mesh_bounce_tlas_reference"] > 0
    assert kernels.counts["trace_fused_mesh_tlas_reference"] == 0
    assert not backend._raypool_cache
    masked = integrator.fused_frame_renderer(DEEP, width, height, samples, bounces, "cpu")
    for frame in range(1, 6):
        image = np.asarray(Image.open(tmp_path / "frames" / f"rendered-{frame:05d}.png"))
        np.testing.assert_array_equal(image, masked(frame).numpy())
