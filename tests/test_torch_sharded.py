"""The port's sharded renderer (``tpu_render_cluster_torch/parallel/``)
against the reference's ``parallel/sharded_render.py``.

The reference runs as tests/test_render.py runs it: on the 8 forced host
devices of tests/conftest.py, with ``TRC_PALLAS=1`` putting its Pallas
kernels in interpret mode (as tests/test_torch_tiles.py). The port runs on
the CPU, its mesh ``n_devices`` entries of ``cpu``, each shard through the
kernels' plain versions.

Tolerances:
- tile bands and frame batches against the reference's
  ``render_frame_sharded(mode="tile")`` and ``render_frames_batched``:
  rtol=atol=1e-4 per value (the region tests' tolerance);
- spp subsets at n = 1 against the reference's ``mode="spp"``, and at
  n = 2, 4 against the reference's own parts with the pixel offset at 0
  (``tile_base_key(frame, 0, 131071 d)``, ``flat_sample_rays(x0=0)``,
  ``trace_paths``, the mean): rtol=atol=1e-4;
- within the port: one shard (n = 1) equal to the unsharded frame, and the
  backend's sharded frames equal to its default ones, bit for bit.

The reference's spp mode also shifts each shard's pixel columns by its
tag (``x0 = d * 131071`` reaches ``camera_rays``), so its shards past the
first trace rays outside the view; ``test_reference_spp_shards_leave_the_view``
pins that divergence.
"""

from __future__ import annotations

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tpu_render_cluster.jobs.models import DistributionStrategy
from tpu_render_cluster.parallel import sharded_render as ref_sharded
from tpu_render_cluster.render import camera as ref_camera
from tpu_render_cluster.render import integrator as ref_integrator
from tpu_render_cluster.render import mesh as ref_mesh
from tpu_render_cluster.render import scene as ref_scene
from tpu_render_cluster_torch.jobs.models import BlenderJob as PortJob
from tpu_render_cluster_torch.parallel import device_mesh, local_device_count
from tpu_render_cluster_torch.parallel import sharded_render
from tpu_render_cluster_torch.render import integrator, kernels
from tpu_render_cluster_torch.worker.backends.torch_raytrace import TorchRaytraceBackend

SPHERE_KW = dict(width=16, height=16, samples=2, max_bounces=2)
SPP_KW = dict(width=16, height=16, samples=4, max_bounces=2)
TOLERANCE = dict(rtol=1e-4, atol=1e-4)


def _clear_reference_caches():
    jax.clear_caches()
    ref_integrator.fused_frame_renderer.cache_clear()


@pytest.fixture(scope="module")
def pallas_interpret():
    """The reference with its Pallas kernels forced on (interpret mode), for
    the whole module: its tests share compiled shapes."""
    with pytest.MonkeyPatch.context() as patch:
        patch.setenv("TRC_PALLAS", "1")
        _clear_reference_caches()
        yield
    _clear_reference_caches()


def _port_frame(scene, frame, mode, n, **kw):
    return sharded_render.render_frame_sharded(
        scene, frame, mode=mode, n_devices=n, device="cpu", **kw
    ).numpy()


@pytest.mark.parametrize(
    "scene,n,kw",
    [
        ("04_very-simple", 1, SPHERE_KW),
        ("04_very-simple", 2, SPHERE_KW),
        ("04_very-simple", 4, SPHERE_KW),
        ("02_physics-mesh", 2, dict(width=16, height=32, samples=2, max_bounces=2)),
        ("03_physics-2-mesh", 2, dict(width=8, height=8, samples=1, max_bounces=2)),
    ],
    ids=["04-n1", "04-n2", "04-n4", "02-n2", "03-n2"],
)
def test_tile_bands_match_the_reference(pallas_interpret, scene, n, kw):
    expected = np.asarray(
        ref_sharded.render_frame_sharded(scene, 7, mode="tile", n_devices=n, **kw)
    )
    got = _port_frame(scene, 7, "tile", n, **kw)
    assert got.shape == expected.shape == (kw["height"], kw["width"], 3)
    np.testing.assert_allclose(got, expected, **TOLERANCE)
    if n == 1:  # one band is the frame: the reference's render_tile at (0, 0)
        whole = integrator.render_frame(scene, 7, device="cpu", **kw).numpy()
        assert np.array_equal(got, whole)


def test_spp_one_shard_matches_the_reference(pallas_interpret):
    expected = np.asarray(
        ref_sharded.render_frame_sharded("04_very-simple", 3, mode="spp", n_devices=1, **SPP_KW)
    )
    got = _port_frame("04_very-simple", 3, "spp", 1, **SPP_KW)
    np.testing.assert_allclose(got, expected, **TOLERANCE)
    whole = integrator.render_frame("04_very-simple", 3, device="cpu", **SPP_KW).numpy()
    assert np.array_equal(got, whole)


def _reference_spp_parts(scene_name, frame, n, *, width, height, samples, max_bounces):
    """The reference's spp decomposition with the pixel offset at 0: shard
    d's key ``tile_base_key(frame, 0, 131071 d)``, the frame's own pixels,
    ``trace_paths``, the sample mean; the shards summed in order over n."""
    scene = ref_scene.build_scene(scene_name, frame)
    camera = ref_camera.scene_camera(scene_name, frame)
    mesh = ref_mesh.scene_mesh_set(scene_name, frame)
    per_shard = samples // n
    total = None
    for d in range(n):
        base_key = ref_integrator.tile_base_key(jnp.float32(frame), 0, d * 131071)
        origins, directions = ref_integrator.flat_sample_rays(
            camera, base_key, width=width, height=height, y0=0, x0=0, tile_height=height,
            tile_width=width, samples=per_shard,
        )
        radiance = ref_integrator.trace_paths(
            scene, origins, directions, ref_integrator.tile_trace_key(base_key),
            max_bounces=max_bounces, mesh=mesh,
        )
        image = np.asarray(radiance).reshape(per_shard, height * width, 3).mean(axis=0)
        total = image if total is None else total + image
    return (total / np.float32(n)).reshape(height, width, 3)


@pytest.mark.parametrize("n", [2, 4])
def test_spp_subsets_match_the_reference_parts(pallas_interpret, n):
    expected = _reference_spp_parts("04_very-simple", 5, n, **SPP_KW)
    got = _port_frame("04_very-simple", 5, "spp", n, **SPP_KW)
    np.testing.assert_allclose(got, expected, **TOLERANCE)


def test_reference_spp_shards_leave_the_view(pallas_interpret):
    """The reference's shard 1 passes x0 = 131071 to ``render_tile``, whose
    camera rays add it to the pixel columns: every ray of that shard points
    outside the frame's view, and its n = 2 frame is not the port's."""
    width, height = SPP_KW["width"], SPP_KW["height"]
    camera = ref_camera.scene_camera("04_very-simple", 5)
    _, directions = ref_camera.camera_rays(camera, width, height, x0=131071)
    directions = np.asarray(directions)
    forward, right = np.asarray(camera.forward), np.asarray(camera.right)
    # A ray is in the view where its horizontal image-plane coordinate is
    # within the frame's half-width, aspect * tan(fov / 2).
    image_x = (directions @ right) / (directions @ forward)
    half_width = width / height * float(camera.tan_half_fov)
    assert (np.abs(image_x) > 1000 * half_width).all()
    _, own = ref_camera.camera_rays(camera, width, height)
    own = np.asarray(own)
    assert (np.abs((own @ right) / (own @ forward)) <= half_width).all()

    reference = np.asarray(
        ref_sharded.render_frame_sharded("04_very-simple", 5, mode="spp", n_devices=2, **SPP_KW)
    )
    port = _port_frame("04_very-simple", 5, "spp", 2, **SPP_KW)
    assert np.abs(reference - port).max() > 0.05
    # The port's subsets are samples of the frame itself: its mean is the
    # one-device frame's within Monte Carlo noise.
    single = integrator.render_frame("04_very-simple", 5, device="cpu", **SPP_KW).numpy()
    assert abs(port.mean() - single.mean()) < 0.05 * single.mean()


@pytest.mark.parametrize("n", [1, 2, 4])
def test_frame_batches_match_the_reference(pallas_interpret, n):
    frames = [1, 2, 3, 4]
    expected = np.asarray(
        ref_sharded.render_frames_batched("04_very-simple", frames, n_devices=n, **SPHERE_KW)
    )
    got = sharded_render.render_frames_batched(
        "04_very-simple", frames, n_devices=n, device="cpu", **SPHERE_KW
    ).numpy()
    assert got.shape == expected.shape == (4, 16, 16, 3)
    np.testing.assert_allclose(got, expected, **TOLERANCE)


@pytest.mark.parametrize(
    "call",
    [
        lambda m: m.render_frame_sharded(
            "04_very-simple", 1, mode="tile", width=8, height=18, samples=1, max_bounces=1,
            n_devices=4),
        lambda m: m.render_frame_sharded(
            "04_very-simple", 1, mode="spp", width=8, height=8, samples=3, max_bounces=1,
            n_devices=2),
        lambda m: m.render_frames_batched(
            "04_very-simple", [1, 2, 3], width=8, height=8, samples=1, max_bounces=1,
            n_devices=2),
        lambda m: m.render_frame_sharded(
            "04_very-simple", 1, mode="diagonal", width=8, height=8, samples=1,
            max_bounces=1, n_devices=2),
    ],
    ids=["height", "samples", "batch", "mode"],
)
def test_indivisible_sizes_raise_as_the_reference(call):
    with pytest.raises(ValueError) as expected:
        call(ref_sharded)
    with pytest.raises(ValueError) as raised:
        call(_CpuSharded)
    assert str(raised.value) == str(expected.value)


class _CpuSharded:
    """The port's entry points, on the CPU."""

    @staticmethod
    def render_frame_sharded(*args, **kw):
        return sharded_render.render_frame_sharded(*args, device="cpu", **kw)

    @staticmethod
    def render_frames_batched(*args, **kw):
        return sharded_render.render_frames_batched(*args, device="cpu", **kw)


@pytest.mark.parametrize("mode", ["tile", "spp"])
def test_each_shard_launches_the_plain_megakernel_once(mode):
    kernels.reset_counts()
    sharded_render.render_frame_sharded(
        "04_very-simple", 2, mode=mode, n_devices=4, device="cpu", width=8, height=8,
        samples=4, max_bounces=1,
    )
    assert {k: v for k, v in kernels.counts.items() if v} == {"trace_fused_reference": 4}


def test_shard_plan_and_compose_are_the_frame():
    """The plan the entry point runs, rendered shard by shard and composed,
    is its frame to the bit; a band's RNG root is its own."""
    kw = dict(width=8, height=8, max_bounces=2)
    for mode in ("tile", "spp"):
        plan = sharded_render.shard_plan(mode, 4, height=8, samples=4)
        images = [
            sharded_render.render_shard("02_physics-mesh", 9, shard, device=torch.device("cpu"),
                                        **kw)
            for shard in plan
        ]
        frame = sharded_render.render_frame_sharded(
            "02_physics-mesh", 9, mode=mode, n_devices=4, device="cpu", samples=4, **kw
        )
        assert torch.equal(sharded_render.compose(mode, images), frame)
    tile = sharded_render.shard_plan("tile", 4, height=8, samples=4)
    assert [(s.y0, s.rows, s.samples, s.key_x0) for s in tile] == [
        (0, 2, 4, 0), (2, 2, 4, 0), (4, 2, 4, 0), (6, 2, 4, 0)
    ]
    spp = sharded_render.shard_plan("spp", 4, height=8, samples=4)
    assert [(s.y0, s.rows, s.samples, s.key_x0) for s in spp] == [
        (0, 8, 1, 0), (0, 8, 1, 131071), (0, 8, 1, 262142), (0, 8, 1, 393213)
    ]


def test_the_cpu_mesh():
    assert device_mesh(device="cpu") == [torch.device("cpu")]
    assert device_mesh(3, device="cpu") == [torch.device("cpu")] * 3
    assert local_device_count("cpu") == 1
    with pytest.raises(ValueError, match="Requested 0"):
        device_mesh(0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            device_mesh()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            sharded_render.render_frame_sharded("04_very-simple", 1, width=8, height=8)


def _job(tmp_path, scene_job: str) -> PortJob:
    return PortJob.from_dict({
        "job_name": scene_job,
        "job_description": "sharded backend",
        "project_file_path": "%BASE%/p.blend",
        "render_script_path": "%BASE%/s.py",
        "frame_range_from": 1,
        "frame_range_to": 3,
        "wait_for_number_of_workers": 1,
        "output_directory_path": str(tmp_path / scene_job),
        "output_file_name_format": "rendered-####",
        "output_file_format": "PNG",
        "frame_distribution_strategy": DistributionStrategy.naive_fine().to_dict(),
    })


@pytest.mark.parametrize("sharding", ["tile", "spp"])
def test_backend_sharded_frames_equal_the_default_paths(tmp_path, sharding):
    """A one-device mesh: the sharded frames are the default paths' to the
    bit (the deep scene's the masked deep loop's), through no wavefront or
    pool launch whatever those options say; a tile bypasses sharding."""
    kw = dict(width=12, height=8, samples=2, max_bounces=2, device="cpu")
    launches: list = []
    sharded = TorchRaytraceBackend(
        **kw, sharding=sharding, wavefront="force", raypool="force",
        on_launch=launches.append, on_iteration=launches.append,
        base_directory=tmp_path / "sharded",
    )
    default = TorchRaytraceBackend(
        **kw, wavefront="off", raypool="off", base_directory=tmp_path / "default"
    )
    for scene_job in ("04_very-simple", "02_physics-mesh", "03_physics-2-mesh"):
        job = _job(tmp_path, scene_job)
        sharded.note_upcoming_frames(job, (2, 3))
        kernels.reset_counts()
        asyncio.run(sharded.render_frame(job, 1))
        counts = {k: v for k, v in kernels.counts.items() if v}
        assert not [k for k in counts if "pool" in k or "sphere_bounce" in k], counts
        got = np.asarray(Image.open(tmp_path / scene_job / "rendered-0001.png"))
        asyncio.run(default.render_frame(job, 1))
        expected = np.asarray(Image.open(tmp_path / scene_job / "rendered-0001.png"))
        assert np.array_equal(got, expected), scene_job
    assert launches == []
    sharded.warm("04_very-simple")
    tiled = PortJob.from_dict({**_job(tmp_path, "04_very-simple").to_dict(), "tiles": [2, 2]})
    kernels.reset_counts()
    asyncio.run(sharded.render_frame(tiled, 1, tile=3))
    assert kernels.counts["trace_fused_lanes_reference"] == 1
