"""Tiled work units in the port: its copy of ``jobs/tiles.py``, the tile
file names, the region rays and lanes, row 1's lane mode, the region
renderers of every single-device tier, and tiled jobs through the
backend, each against the JAX package's.

The reference runs as tests/test_tiles.py runs it: ``TRC_PALLAS=1`` puts
its Pallas kernels in interpret mode on the CPU, ``TRC_PALLAS=0`` takes its
scan. Sizes as there: sphere 16x16, 2 spp, 3 bounces; mesh 12x12, 1 spp,
2 bounces.

Tolerances:
- the tile geometry, file names, lanes, seeds and ray origins: equal;
- region ray directions against the reference's: within atol 1e-6, the
  tolerance of the whole-frame rays in tests/test_torch_scene_camera.py
  (XLA rounds a few percent of the normalised directions one ulp apart);
  against the port's own whole-frame rays: bit for bit;
- row 1's plain version in lane mode against the Pallas kernel with
  ``lane=``: every ray at 1 bounce bit for bit, at 4 bounces >= 99.9% of
  rays within rtol=atol=1e-4 (tests/test_torch_kernels.py's rule for the
  positional mode, which these rays meet too); against the port's own
  positional plain version on the whole frame's rows: bit for bit;
- region renders against the reference's: rtol=atol=1e-4 per value;
- stitched tiles against the port's whole frame: ``np.array_equal``.
"""

from __future__ import annotations

import asyncio
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tpu_render_cluster.jobs import tiles as ref_tiles
from tpu_render_cluster.jobs.models import BlenderJob as RefJob
from tpu_render_cluster.jobs.models import DistributionStrategy
from tpu_render_cluster.render import camera as ref_camera
from tpu_render_cluster.render import image_io as ref_image_io
from tpu_render_cluster.render import integrator as ref_integrator
from tpu_render_cluster.render import pallas_kernels as ref_kernels
from tpu_render_cluster.render import scene as ref_scene
from tpu_render_cluster_torch.jobs import tiles
from tpu_render_cluster_torch.jobs.models import BlenderJob as PortJob
from tpu_render_cluster_torch.render import camera as port_camera
from tpu_render_cluster_torch.render import compaction, image_io, integrator, kernels, raypool
from tpu_render_cluster_torch.render import scene as port_scene
from tpu_render_cluster_torch.worker.backends.torch_raytrace import TorchRaytraceBackend

SPHERE_KW = dict(width=16, height=16, samples=2, max_bounces=3)
MESH_KW = dict(width=12, height=12, samples=1, max_bounces=2)
FRAME = 30


def _clear_reference_caches():
    jax.clear_caches()
    ref_integrator.fused_frame_renderer.cache_clear()
    ref_integrator.fused_region_renderer.cache_clear()


@pytest.fixture()
def pallas_interpret(monkeypatch):
    """The reference with its Pallas kernels forced on (interpret mode)."""
    monkeypatch.setenv("TRC_PALLAS", "1")
    _clear_reference_caches()
    yield
    _clear_reference_caches()


@pytest.fixture()
def pallas_off(monkeypatch):
    """The reference's scan tier (its tier wherever Pallas is off)."""
    monkeypatch.setenv("TRC_PALLAS", "0")
    _clear_reference_caches()
    yield
    _clear_reference_caches()


def _grid_tiles(grid, width, height):
    return [
        tiles.tile_bounds(tile, grid, width=width, height=height)
        for tile in range(grid[0] * grid[1])
    ]


# ---------------------------------------------------------------------------
# jobs/tiles.py and the tile file names


def test_tile_geometry_equals_the_reference_on_every_grid():
    for rows in range(1, tiles.MAX_TILE_GRID_DIM + 1):
        for cols in range(1, tiles.MAX_TILE_GRID_DIM + 1):
            grid = (rows, cols)
            tiles.validate_tile_grid(grid)
            for width, height in ((512, 512), (17, 16), (13, 31)):
                for tile in range(rows * cols):
                    assert tiles.tile_rc(tile, grid) == ref_tiles.tile_rc(tile, grid)
                    bounds = tiles.tile_bounds(tile, grid, width=width, height=height)
                    assert bounds == ref_tiles.tile_bounds(tile, grid, width=width, height=height)
                    assert tiles.tile_pixel_fraction(
                        tile, grid, width=width, height=height
                    ) == ref_tiles.tile_pixel_fraction(tile, grid, width=width, height=height)
                covered = np.zeros((height, width), np.int32)
                for y0, x0, th, tw in _grid_tiles(grid, width, height):
                    covered[y0:y0 + th, x0:x0 + tw] += 1
                assert (covered == 1).all() or min(rows, cols) > min(width, height)
            unit = tiles.WorkUnit(4, rows * cols - 1)
            ref_unit = ref_tiles.WorkUnit(4, rows * cols - 1)
            assert (unit.label, unit.sort_key, unit.is_tiled) == (
                ref_unit.label, ref_unit.sort_key, ref_unit.is_tiled
            )
            assert tiles.unit_pixel_fraction(unit, grid) == ref_tiles.unit_pixel_fraction(
                ref_unit, grid
            )
    whole, ref_whole = tiles.WorkUnit(7), ref_tiles.WorkUnit(7)
    assert (whole.label, whole.sort_key, whole.is_tiled) == (
        ref_whole.label, ref_whole.sort_key, ref_whole.is_tiled
    )
    assert tiles.tile_pixel_fraction(None, (2, 2)) == 1.0


@pytest.mark.parametrize(
    "text", ["2x2", "2,3", "4", " 3X5 ", "16x16", "0x2", "17", "2x2x2", "x", "1x17", "-1"]
)
def test_parse_and_validate_equal_the_reference(text):
    try:
        expected = ref_tiles.parse_tile_grid(text)
    except ValueError as error:
        with pytest.raises(ValueError) as raised:
            tiles.parse_tile_grid(text)
        assert str(raised.value) == str(error)
    else:
        assert tiles.parse_tile_grid(text) == expected
    with pytest.raises(ValueError, match="outside the 2x2 grid"):
        tiles.tile_rc(4, (2, 2))


@pytest.mark.parametrize("value", [None, "", "off", "1x1", "2x3", "4"])
def test_env_grid_and_job_units_equal_the_reference(value, monkeypatch, tmp_path):
    if value is None:
        monkeypatch.delenv("TRC_TILE_GRID", raising=False)
    else:
        monkeypatch.setenv("TRC_TILE_GRID", value)
    assert tiles.env_tile_grid() == ref_tiles.env_tile_grid()
    path = Path(__file__).resolve().parent.parent / (
        "blender-projects/04_very-simple/04_very-simple_demo_10f-1w.toml"
    )
    port, ref = PortJob.load_from_file(path), RefJob.load_from_file(path)
    assert port.to_dict() == ref.to_dict()
    assert port.tiles_per_frame() == ref.tiles_per_frame()
    assert port.unit_count() == ref.unit_count()
    assert [tuple(u) for u in port.work_units()] == [tuple(u) for u in ref.work_units()]
    # A job decoded from a dictionary (the wire) never takes the default.
    assert PortJob.from_dict(ref.to_dict() | {"tiles": None}).tile_grid is None
    bad = {**ref.to_dict(), "tiles": [0, 2]}
    with pytest.raises(ValueError) as raised:
        PortJob.from_dict(bad)
    with pytest.raises(ValueError) as expected:
        RefJob.from_dict(bad)
    assert str(raised.value) == str(expected.value)


def test_output_path_for_tile_equals_the_reference():
    for file_format in ("PNG", "JPEG", "jpg", "EXR"):
        for name_format in ("rendered-#####", "frame_##_x", "plain"):
            for grid in ((2, 2), (3, 2), (1, 16)):
                for tile in range(grid[0] * grid[1]):
                    args = (Path("/out/dir"), name_format, file_format, 12, tile, grid)
                    got = image_io.output_path_for_tile(*args)
                    assert got == ref_image_io.output_path_for_tile(*args)
                    assert got.suffix == ".png"
    with pytest.raises(ValueError):
        image_io.output_path_for_tile(Path("/o"), "f-#", "PNG", 1, 4, (2, 2))


# ---------------------------------------------------------------------------
# Region rays, lanes and row 1's lane mode


def _cameras(name: str, frame: int):
    """The reference's camera, and the port's built from its arrays."""
    ref = ref_camera.scene_camera(name, frame)
    arrays = {k: np.asarray(v) for k, v in ref._asdict().items()}
    return ref, port_camera.camera_from_arrays(arrays, "cpu")


@pytest.mark.parametrize("grid", [(2, 2), (3, 2)])
def test_region_rays_and_lanes_equal_the_reference(grid):
    width, height, samples = 16, 13, 2
    ref_cam, cam = _cameras("04_very-simple", FRAME)
    whole_o, whole_d, whole_seed = integrator.frame_rays_and_seed(
        cam, FRAME, width=width, height=height, samples=samples
    )
    for y0, x0, th, tw in _grid_tiles(grid, width, height):
        region = dict(tile_height=th, tile_width=tw)
        ref_rays = jax.jit(functools.partial(
            ref_integrator.region_rays_and_seed, width=width, height=height, samples=samples,
            **region,
        ))
        ref_o, ref_d, ref_lanes, ref_seed = ref_rays(
            ref_cam, jnp.float32(FRAME), y0=jnp.int32(y0), x0=jnp.int32(x0)
        )
        origins, directions, lanes, seed = integrator.region_rays_and_seed(
            cam, FRAME, width=width, height=height, samples=samples, y0=y0, x0=x0, **region
        )
        assert lanes.dtype == torch.int32 and origins.shape == (samples * th * tw, 3)
        np.testing.assert_array_equal(lanes.numpy(), np.asarray(ref_lanes))
        np.testing.assert_array_equal(
            integrator.region_lane_map(
                y0=y0, x0=x0, width=width, height=height, samples=samples, **region
            ).numpy(),
            np.asarray(ref_integrator.region_lane_map(
                y0=y0, x0=x0, width=width, height=height, samples=samples, **region
            )),
        )
        assert seed == int(ref_seed) == whole_seed
        np.testing.assert_array_equal(origins.numpy(), np.asarray(ref_o))
        np.testing.assert_allclose(directions.numpy(), np.asarray(ref_d), rtol=0, atol=1e-6)
        # The region's rays are the whole frame's rows at its lanes.
        rows = lanes.to(torch.int64)
        assert torch.equal(origins, whole_o[rows]) and torch.equal(directions, whole_d[rows])


def _region_inputs(name: str, tile: int):
    """The reference's scene, the port's from its arrays, and one interior
    tile's rays, lanes and seed (frame 30, 16x13 at 2 spp, a 3x2 grid)."""
    ref = ref_scene.build_scene(name, FRAME)
    arrays = {k: np.asarray(v) for k, v in ref._asdict().items()}
    scene = port_scene.scene_from_arrays(arrays, "cpu")
    _, cam = _cameras(name, FRAME)
    y0, x0, th, tw = tiles.tile_bounds(tile, (3, 2), width=16, height=13)
    rays = integrator.region_rays_and_seed(
        cam, FRAME, width=16, height=13, samples=2, y0=y0, x0=x0, tile_height=th, tile_width=tw
    )
    return ref, scene, cam, rays


@pytest.mark.parametrize("max_bounces", [1, 4])
def test_lane_mode_plain_version_matches_pallas_interpret(max_bounces):
    ref, scene, cam, (origins, directions, lanes, seed) = _region_inputs("04_very-simple", 3)
    assert lanes.min() > 0
    expected = np.asarray(
        ref_kernels.trace_paths_fused(
            ref, jnp.asarray(origins.numpy()), jnp.asarray(directions.numpy()), jnp.int32(seed),
            max_bounces=max_bounces, lane=jnp.asarray(lanes.numpy()),
        )
    )
    kernels.reset_counts()
    got = kernels.trace_paths_fused_reference(
        scene, origins, directions, seed, max_bounces=max_bounces, lane=lanes, chunk_rays=16
    )
    assert kernels.counts["trace_fused_lanes_reference"] == 1
    assert kernels.counts["trace_fused_reference"] == 0
    close = np.isclose(got.numpy(), expected, rtol=1e-4, atol=1e-4).all(axis=1)
    if max_bounces == 1:
        np.testing.assert_array_equal(got.numpy(), expected)
    else:
        assert close.mean() >= 0.999, close.mean()
    assert got.max() > 0.1
    # The lane mode on the region's rays = the positional mode on the whole
    # frame's, at the region's rows; and with lanes 0..R-1 = positional.
    whole_o, whole_d, _ = integrator.frame_rays_and_seed(cam, FRAME, width=16, height=13, samples=2)
    whole = kernels.trace_paths_fused_reference(
        scene, whole_o, whole_d, seed, max_bounces=max_bounces
    )
    assert torch.equal(got, whole[lanes.to(torch.int64)])
    arange = torch.arange(origins.shape[0], dtype=torch.int32)
    assert torch.equal(
        kernels.trace_paths_fused(scene, origins, directions, seed, max_bounces=max_bounces,
                                  lane=arange),
        kernels.trace_paths_fused(scene, origins, directions, seed, max_bounces=max_bounces),
    )


def test_lane_row_is_validated():
    _, scene, _, (origins, directions, lanes, seed) = _region_inputs("04_very-simple", 0)
    with pytest.raises(TypeError, match="int32"):
        kernels.trace_paths_fused(scene, origins, directions, seed, max_bounces=1,
                                  lane=lanes.to(torch.int64))
    with pytest.raises(ValueError, match="lane must be"):
        kernels.trace_paths_fused(scene, origins, directions, seed, max_bounces=1, lane=lanes[1:])


# ---------------------------------------------------------------------------
# Region renders against the reference's


@pytest.mark.parametrize(
    "scene_name,kw",
    [("04_very-simple", SPHERE_KW), ("02_physics-mesh", MESH_KW), ("03_physics-2-mesh", MESH_KW)],
)
def test_render_frame_region_matches_reference(pallas_interpret, scene_name, kw):
    """Every tile of 04; of the mesh scenes, whose reference renders take
    seconds in interpret mode, the two diagonal tiles."""
    regions = _grid_tiles((2, 2), kw["width"], kw["height"])
    if scene_name != "04_very-simple":
        regions = regions[::3]
    kernels.reset_counts()
    for y0, x0, th, tw in regions:
        region = dict(y0=y0, x0=x0, tile_height=th, tile_width=tw)
        expected = np.asarray(ref_integrator.render_frame_region(scene_name, FRAME, **region, **kw))
        got = integrator.render_frame_region(scene_name, FRAME, device="cpu", **region, **kw)
        assert got.shape == (th, tw, 3)
        np.testing.assert_allclose(got.numpy(), expected, rtol=1e-4, atol=1e-4)
    # Sphere tiles take row 1's lane mode; mesh tiles the masked deep loop,
    # 02 too (never the mesh megakernel).
    used = {k: v for k, v in kernels.counts.items() if v}
    if scene_name == "04_very-simple":
        assert used == {"trace_fused_lanes_reference": 4}
    else:
        assert used == {"mesh_bounce_tlas_reference": len(regions) * kw["max_bounces"]}


@pytest.mark.parametrize("per_instance", [False, True])
@pytest.mark.parametrize(
    "scene_name,kw", [("04_very-simple", SPHERE_KW), ("03_physics-2-mesh", MESH_KW)]
)
def test_scan_region_matches_reference_scan(pallas_off, scene_name, kw, per_instance):
    for y0, x0, th, tw in _grid_tiles((2, 2), kw["width"], kw["height"])[::3]:
        region = dict(y0=y0, x0=x0, tile_height=th, tile_width=tw)
        expected = np.asarray(ref_integrator.render_frame_region(scene_name, FRAME, **region, **kw))
        got = integrator.render_frame_region(
            scene_name, FRAME, device="cpu", bounce_scan=True, per_instance=per_instance,
            **region, **kw,
        )
        np.testing.assert_allclose(got.numpy(), expected, rtol=1e-4, atol=1e-4)


def test_render_frame_tile_size_matches_reference(pallas_interpret):
    expected = np.asarray(
        ref_integrator.render_frame("04_very-simple", 3, tile_size=8, **SPHERE_KW)
    )
    got = integrator.render_frame("04_very-simple", 3, tile_size=8, device="cpu", **SPHERE_KW)
    assert got.shape == (16, 16, 3)
    np.testing.assert_allclose(got.numpy(), expected, rtol=1e-4, atol=1e-4)
    # Uneven edge tiles, each with its own RNG root: not the untiled image.
    uneven = integrator.render_frame("04_very-simple", 3, width=13, height=11, samples=1,
                                     max_bounces=2, tile_size=8, device="cpu")
    scene = port_scene.build_scene("04_very-simple", 3, "cpu")
    camera = port_camera.scene_camera("04_very-simple", 3, "cpu")
    corner = integrator.render_tile(
        scene, camera, 3, 8, 8, width=13, height=11, tile_height=3, tile_width=5, samples=1,
        max_bounces=2,
    )
    assert uneven.shape == (11, 13, 3) and torch.equal(uneven[8:, 8:], corner)


# ---------------------------------------------------------------------------
# Stitched tiles against the port's whole frame, on every tier


def _stitch(render_tile, grid, width, height, like):
    out = torch.zeros_like(like)
    for y0, x0, th, tw in _grid_tiles(grid, width, height):
        out[y0:y0 + th, x0:x0 + tw] = render_tile(y0, x0, th, tw)
    return out


@pytest.mark.parametrize(
    "scene_name,kw,grid",
    [("04_very-simple", SPHERE_KW, (2, 2)), ("03_physics-2-mesh", MESH_KW, (2, 2)),
     ("04_very-simple", dict(width=16, height=13, samples=2, max_bounces=3), (3, 2))],
    ids=["sphere", "deep-mesh", "sphere-uneven"],
)
def test_masked_tier_assembles_identically(scene_name, kw, grid):
    whole = integrator.fused_frame_renderer(
        scene_name, kw["width"], kw["height"], kw["samples"], kw["max_bounces"], "cpu"
    )(FRAME)
    stitched = _stitch(
        lambda y0, x0, th, tw: integrator.tonemap(integrator.render_frame_region(
            scene_name, FRAME, y0=y0, x0=x0, tile_height=th, tile_width=tw, device="cpu", **kw
        )),
        grid, kw["width"], kw["height"], whole,
    )
    assert np.array_equal(stitched.numpy(), whole.numpy())


@pytest.mark.parametrize(
    "scene_name,kw", [("04_very-simple", SPHERE_KW), ("03_physics-2-mesh", MESH_KW)],
    ids=["sphere-forced", "deep-mesh"],
)
def test_wavefront_tier_assembles_bitwise(scene_name, kw):
    whole = compaction.render_frame_wavefront(scene_name, FRAME, device="cpu", **kw)
    launches: list = []
    stitched = _stitch(
        lambda y0, x0, th, tw: compaction.render_region_wavefront(
            scene_name, FRAME, y0=y0, x0=x0, tile_height=th, tile_width=tw, device="cpu",
            on_launch=launches.append, **kw,
        ),
        (2, 2), kw["width"], kw["height"], whole,
    )
    assert np.array_equal(stitched.numpy(), whole.numpy())
    # Each launch's lane argument is the rays' whole-frame lane.
    n = kw["width"] * kw["height"] * kw["samples"]
    assert all(int(launch.state[4].max()) < n for launch in launches)
    assert max(int(launch.state[4].max()) for launch in launches) >= n // 2


def test_raypool_tier_assembles_bitwise_multi_frame():
    kw, scene_name, frames = MESH_KW, "03_physics-2-mesh", [FRAME, FRAME + 1]
    wholes, _ = raypool.render_batch_raypool(scene_name, frames, device="cpu", **kw)
    stitched = [torch.zeros_like(w) for w in wholes]
    for y0, x0, th, tw in _grid_tiles((2, 2), kw["width"], kw["height"]):
        images, stats = raypool.render_batch_raypool(
            scene_name, frames, region=(y0, x0, th, tw), device="cpu", **kw
        )
        assert stats[0].served == len(frames) * th * tw * kw["samples"]
        for out, image in zip(stitched, images):
            assert image.shape == (th, tw, 3)
            out[y0:y0 + th, x0:x0 + tw] = image
    for out, whole in zip(stitched, wholes):
        assert np.array_equal(out.numpy(), whole.numpy())


def test_raypool_region_width_follows_the_tile():
    assert raypool.raypool_width(8 * 256 * 256) == 65536
    window = raypool.PoolWindow(
        "03_physics-2-mesh", [1], width=13, height=11, samples=1, max_bounces=1,
        device=torch.device("cpu"), region=tiles.tile_bounds(5, (3, 2), width=13, height=11),
    )
    assert (window.tile_height, window.tile_width, window.n) == (4, 7, 28)
    assert window.glane_map.tolist() == integrator.region_lane_map(
        y0=7, x0=6, tile_height=4, tile_width=7, width=13, height=11, samples=1
    ).tolist()


# ---------------------------------------------------------------------------
# The backend


def _tiled_job(name, frames, workers, grid, output_directory) -> RefJob:
    return RefJob(
        job_name=name,
        job_description=None,
        project_file_path="%BASE%/p.blend",
        render_script_path="%BASE%/s.py",
        frame_range_from=1,
        frame_range_to=frames,
        wait_for_number_of_workers=workers,
        frame_distribution_strategy=DistributionStrategy.naive_fine(),
        output_directory_path=output_directory,
        output_file_name_format="rendered-#####",
        output_file_format="PNG",
        tile_grid=grid,
    )


def test_tiled_output_matches_untiled(tmp_path):
    """Two port workers serve a 2x2-tiled job through the JAX package's
    harness, whose master stitches the tiles: the frame PNG equals a
    one-worker untiled run's."""
    from tpu_render_cluster.harness.local import run_local_job

    outputs = {}
    for label, grid, workers in (("whole", None, 1), ("tiled", (2, 2), 2)):
        out = tmp_path / label
        job = _tiled_job(f"04_very-simple_seam-{label}", 1, workers, grid, str(out))
        backends = [
            TorchRaytraceBackend(device="cpu", width=16, height=16, samples=2, max_bounces=3)
            for _ in range(workers)
        ]
        run_local_job(job, backends, timeout=300.0)
        outputs[label] = out / "rendered-00001.png"
    whole = np.asarray(Image.open(outputs["whole"]).convert("RGB"))
    tiled = np.asarray(Image.open(outputs["tiled"]).convert("RGB"))
    assert np.array_equal(whole, tiled)
    assert not list((tmp_path / "tiled").glob("*.tile_*"))


def test_queue_hint_makes_same_tile_pool_windows(tmp_path):
    """The queue's hint with tiled units: a unit's pool window holds the
    same tile of the job's other queued frames, the frames rendered ahead
    are cached under (job, frame, tile), and each served tile equals the
    pool's region render."""
    job = PortJob.from_dict(
        _tiled_job("03_physics-2-mesh_tiles", 3, 1, (2, 2), "%BASE%/frames").to_dict()
    )
    backend = TorchRaytraceBackend(device="cpu", base_directory=tmp_path, **MESH_KW)
    units = [tiles.WorkUnit(f, t) for f in (1, 2, 3) for t in range(4)]
    backend.note_upcoming_frames(job, tuple(units))
    kernels.reset_counts()
    asyncio.run(backend.render_frame(job, 1, tile=2))
    assert [s.served for s in backend.pool_stats] == [3 * 6 * 6]
    assert sorted(backend._raypool_cache) == [(job.job_name, 2, 2), (job.job_name, 3, 2)]
    expected, _ = raypool.render_batch_raypool(
        "03_physics-2-mesh", [1, 2, 3], region=(6, 0, 6, 6), device="cpu", **MESH_KW
    )
    launched = dict(kernels.counts)
    asyncio.run(backend.render_frame(job, 2, tile=2))  # a cache hit: nothing launched
    assert dict(kernels.counts) == launched
    assert (job.job_name, 2, 2) not in backend._raypool_cache
    for frame in (1, 2):
        path = tmp_path / "frames" / f"rendered-{frame:05d}.tile_r1c0.png"
        pixels = np.asarray(Image.open(path))
        np.testing.assert_array_equal(pixels, integrator.tonemap(expected[frame - 1]).numpy())
    # Another tile of frame 2 is not in the cache: it starts its own window
    # over the same tile of the frames the (new) hint names.
    backend.note_upcoming_frames(job, tuple(u for u in units if u.frame_index >= 2))
    asyncio.run(backend.render_frame(job, 2, tile=0))
    assert [s.served for s in backend.pool_stats] == [108, 2 * 6 * 6]
    assert (job.job_name, 3, 0) in backend._raypool_cache

