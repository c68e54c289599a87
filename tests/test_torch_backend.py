"""The port's worker backend serving a job through the JAX package's
in-process master/worker harness, the port's render CLI, and its copy of
the job model.

The harness duck-types the backend (``render_frame`` returning an object
with the 7 phase timestamps and ``to_dict``), so the port's backend plugs
in unchanged while the port itself imports nothing of the JAX package.
Frames are held against the reference renderer at the whole-frame
tolerance of tests/test_torch_frame.py.
"""

from __future__ import annotations

import asyncio
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from tpu_render_cluster.harness.local import run_local_job
from tpu_render_cluster.jobs.models import BlenderJob as RefJob
from tpu_render_cluster.jobs.models import DistributionStrategy
from tpu_render_cluster_torch.jobs.models import BlenderJob as PortJob
from tpu_render_cluster_torch.render import cli, kernels
from tpu_render_cluster_torch.render.integrator import (
    fused_frame_renderer,
    render_frame_region,
    tonemap,
)
from tpu_render_cluster_torch.worker.backends.torch_raytrace import TorchRaytraceBackend

REPO = Path(__file__).resolve().parent.parent
WIDTH, HEIGHT, SAMPLES, BOUNCES = 32, 24, 2, 4


def assert_images_match(got: np.ndarray, expected: np.ndarray) -> None:
    """At least 99.5% of uint8 channel values within +-1, means within 0.5."""
    assert got.shape == expected.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int32) - expected.astype(np.int32))
    assert (diff <= 1).mean() >= 0.995, (diff <= 1).mean()
    assert abs(got.mean() - expected.mean()) <= 0.5


def _job(
    strategy: DistributionStrategy, frames: int = 4, workers: int = 2,
    name: str = "04vs_torch-port",
) -> RefJob:
    return RefJob(
        job_name=name,
        job_description=None,
        project_file_path="%BASE%/p.blend",
        render_script_path="%BASE%/s.py",
        frame_range_from=1,
        frame_range_to=frames,
        wait_for_number_of_workers=workers,
        frame_distribution_strategy=strategy,
        output_directory_path="%BASE%/frames",
        output_file_name_format="rendered-#####",
        output_file_format="PNG",
    )


def _reference_frames(monkeypatch, frames):
    from tpu_render_cluster.render.integrator import fused_frame_renderer

    monkeypatch.setenv("TRC_PALLAS", "1")
    jax.clear_caches()
    fused_frame_renderer.cache_clear()
    try:
        render = fused_frame_renderer("04_very-simple", WIDTH, HEIGHT, SAMPLES, BOUNCES)
        return {f: np.asarray(render(f)) for f in frames}
    finally:
        jax.clear_caches()
        fused_frame_renderer.cache_clear()


def test_two_port_workers_serve_a_job_through_the_harness(tmp_path, monkeypatch):
    job = _job(DistributionStrategy.eager_naive_coarse(2))
    backends = [
        TorchRaytraceBackend(
            device="cpu", width=WIDTH, height=HEIGHT, samples=SAMPLES,
            max_bounces=BOUNCES, base_directory=tmp_path,
        )
        for _ in range(2)
    ]
    _master_trace, worker_traces = run_local_job(job, backends, timeout=300.0)

    rendered = [t for _name, trace in worker_traces for t in trace.frame_render_traces]
    assert sorted(t.frame_index for t in rendered) == [1, 2, 3, 4]
    for t in rendered:
        d = t.details
        assert d.started_process_at <= d.finished_loading_at <= d.started_rendering_at
        assert d.started_rendering_at <= d.finished_rendering_at <= d.file_saving_started_at
        assert d.file_saving_started_at <= d.file_saving_finished_at <= d.exited_process_at

    expected = _reference_frames(monkeypatch, [1, 2, 3, 4])
    for frame, image in expected.items():
        path = tmp_path / "frames" / f"rendered-{frame:05d}.png"
        assert path.is_file()
        assert_images_match(np.asarray(Image.open(path)), image)


def test_two_port_workers_serve_a_mesh_job_through_the_harness(tmp_path):
    """A short 02_physics-mesh job; each PNG equals the port's own renderer
    (tests/test_torch_frame_mesh.py holds that renderer against the
    reference)."""
    job = _job(
        DistributionStrategy.eager_naive_coarse(2), frames=2, name="02_physics-mesh_torch-port"
    )
    width, height = 16, 12
    backends = [
        TorchRaytraceBackend(
            device="cpu", width=width, height=height, samples=1, max_bounces=2,
            base_directory=tmp_path,
        )
        for _ in range(2)
    ]
    _master_trace, worker_traces = run_local_job(job, backends, timeout=300.0)
    rendered = [t for _name, trace in worker_traces for t in trace.frame_render_traces]
    assert sorted(t.frame_index for t in rendered) == [1, 2]
    render = fused_frame_renderer("02_physics-mesh", width, height, 1, 2, "cpu")
    for frame in (1, 2):
        image = np.asarray(Image.open(tmp_path / "frames" / f"rendered-{frame:05d}.png"))
        np.testing.assert_array_equal(image, render(frame).numpy())


def test_backend_serves_a_deep_mesh_job_through_the_harness(tmp_path):
    """Two port workers serve a deep mesh job through the harness. Each
    frame takes the tier the worker queue's hint picks under auto: the ray
    pool when more frames of the job are queued behind it, else the
    wavefront tier (the per-frame tier of a scene past the mesh
    megakernel's bound). Both equal the port's masked deep loop's render to
    the bit (tests/test_torch_wavefront.py and tests/test_torch_raypool.py
    hold them against the reference)."""
    job = _job(
        DistributionStrategy.eager_naive_coarse(2), frames=2, name="03_physics-2-mesh_torch-port"
    )
    width, height, samples, bounces = 8, 6, 1, 3
    backends = [
        TorchRaytraceBackend(
            device="cpu", width=width, height=height, samples=samples, max_bounces=bounces,
            base_directory=tmp_path,
        )
        for _ in range(2)
    ]
    backends[0].warm("03_physics-2-mesh_240f-4w")
    hinted = []
    for backend in backends:
        def note(job, units, note=backend.note_upcoming_frames):
            hinted.append(len(units))
            note(job, units)

        backend.note_upcoming_frames = note
    kernels.reset_counts()
    _master_trace, worker_traces = run_local_job(job, backends, timeout=300.0)
    rendered = [t for _name, trace in worker_traces for t in trace.frame_render_traces]
    assert sorted(t.frame_index for t in rendered) == [1, 2]
    assert len(hinted) == 2  # the queue hints before each frame
    pooled = kernels.counts["pool_mesh_bounce_tlas_reference"] > 0
    assert pooled == any(hinted)
    assert pooled or kernels.counts["mesh_bounce_tlas_reference"] > 0
    assert kernels.counts["trace_fused_mesh_tlas_reference"] == 0
    masked = fused_frame_renderer("03_physics-2-mesh", width, height, samples, bounces, "cpu")
    for frame in (1, 2):
        image = np.asarray(Image.open(tmp_path / "frames" / f"rendered-{frame:05d}.png"))
        np.testing.assert_array_equal(image, masked(frame).numpy())


def test_backend_phases_and_jpeg_output(tmp_path):
    backend = TorchRaytraceBackend(
        device="cpu", width=16, height=12, samples=1, max_bounces=2, base_directory=tmp_path
    )
    job = PortJob.from_dict({**_job(DistributionStrategy.naive_fine()).to_dict(),
                             "output_file_format": "JPEG"})
    timing = asyncio.run(backend.render_frame(job, 3))
    assert (tmp_path / "frames" / "rendered-00003.jpg").is_file()
    assert timing.started_process_at <= timing.finished_loading_at
    assert timing.started_rendering_at <= timing.finished_rendering_at
    assert timing.exited_process_at >= timing.file_saving_finished_at
    assert timing.total_execution_time() > 0
    assert set(timing.to_dict()) == {
        "started_process_at", "finished_loading_at", "started_rendering_at",
        "finished_rendering_at", "file_saving_started_at", "file_saving_finished_at",
        "exited_process_at",
    }


def test_backend_warm_renders_a_frame():
    backend = TorchRaytraceBackend(device="cpu", width=8, height=8, samples=1, max_bounces=1)
    backend.warm("04vs_demo_10f-1w")  # job names resolve like the render path


@pytest.mark.parametrize(
    "option,value,slice_name",
    [("tile_size", 64, "tiles"), ("sharding", "tile", "sharding"),
     ("wavefront", "force", "wavefront"), ("raypool", "force", "ray-pool")],
)
def test_backend_options_of_later_slices_raise(option, value, slice_name):
    """Every option of the reference's backend is ported now, each in its
    slice, and only a value outside its modes raises. ``tile_size`` (the
    tiles slice) is taken and stored, as the reference stores it. The
    wavefront and ray-pool options take their three modes, the sharding
    option (the multi-GPU slice) ``tile``, ``spp`` and None; any other value
    raises naming them, and so does sharding with one card named."""
    if option == "tile_size":
        assert TorchRaytraceBackend(device="cpu", tile_size=value).tile_size == value
        return
    modes = ("tile", "spp", None) if option == "sharding" else ("auto", "off", "force")
    for mode in modes:
        assert getattr(TorchRaytraceBackend(device="cpu", **{option: mode}), option) == mode
    with pytest.raises(ValueError, match=modes[0]):
        TorchRaytraceBackend(device="cpu", **{option: "sideways"})
    if option == "sharding":
        # The mesh is every local card: one named card is refused.
        with pytest.raises(ValueError, match="every local card"):
            TorchRaytraceBackend(device="cuda:1", sharding="tile")


def test_backend_refuses_tiles(tmp_path):
    """A tile of a job without a tile grid is refused and writes nothing; a
    tile of a tiled job renders its region, written as a PNG tile file
    whatever the job's format (tests/test_torch_tiles.py covers the tiers)."""
    backend = TorchRaytraceBackend(device="cpu", width=8, height=6, base_directory=tmp_path)
    untiled = PortJob.from_dict(_job(DistributionStrategy.naive_fine()).to_dict())
    with pytest.raises(RuntimeError, match="no tile grid"):
        asyncio.run(backend.render_frame(untiled, 1, tile=0))
    assert not (tmp_path / "frames").exists()
    job = PortJob.from_dict(
        {**_job(DistributionStrategy.naive_fine()).to_dict(), "tiles": [2, 2],
         "output_file_format": "JPEG"}
    )
    asyncio.run(backend.render_frame(job, 1, tile=3))
    assert [p.name for p in (tmp_path / "frames").iterdir()] == ["rendered-00001.tile_r1c1.png"]
    pixels = np.asarray(Image.open(tmp_path / "frames" / "rendered-00001.tile_r1c1.png"))
    region = render_frame_region(
        "04_very-simple", 1, y0=3, x0=4, tile_height=3, tile_width=4, width=8, height=6,
        device="cpu",
    )
    np.testing.assert_array_equal(pixels, tonemap(region).numpy())


def test_backend_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchRaytraceBackend()


def test_cli_writes_png_and_results_line(tmp_path):
    out = tmp_path / "frame.png"
    result = subprocess.run(
        [sys.executable, "-m", "tpu_render_cluster_torch.render.cli", "--device", "cpu",
         "--scene", "01_simple-animation", "--frame", "4", "--width", "24",
         "--height", "16", "--samples", "1", "--bounces", "2", "--out", str(out)],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
        capture_output=True, text=True, timeout=120,
    )
    assert result.returncode == 0, result.stderr
    image = np.asarray(Image.open(out))
    assert image.shape == (16, 24, 3) and image.std() > 1.0
    line = next(l for l in result.stdout.splitlines() if l.startswith("RESULTS="))
    phases = json.loads(line[len("RESULTS="):])
    assert phases["project_loaded_at"] <= phases["project_finished_rendering_at"]
    assert phases["file_saving_started_at"] <= phases["file_saving_finished_at"]


def test_cli_without_cuda_raises_by_default(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--width", "8", "--height", "8", "--out", str(tmp_path / "f.png")])
    assert not (tmp_path / "f.png").exists()


def test_job_model_loads_every_job_file_like_the_reference(monkeypatch):
    monkeypatch.delenv("TRC_TILE_GRID", raising=False)
    paths = sorted(REPO.glob("blender-projects/*/*.toml"))
    assert paths
    for path in paths:
        port = PortJob.load_from_file(path)
        assert port.to_dict() == RefJob.load_from_file(path).to_dict(), path.name
        assert list(port.frame_indices()) == list(range(port.frame_range_from, port.frame_range_to + 1))
