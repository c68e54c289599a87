"""The port's worker process against unmodified masters, over real sockets.

``python -m tpu_render_cluster_torch.worker.main`` processes (on the CPU,
``--device cpu``, at a small size) serve the Python master CLI
(``python -m tpu_render_cluster.master.main run-job``) for a whole-frame and
a 2x2-tiled ``04_very-simple`` job, and the C++ master ``native/trc-master``
for a whole-frame job, and a worker started with ``--sharding tile`` the
Python master. Every frame must equal, bit for bit, the in-process
port backend's render of it (a tiled job's frames as the master stitched
them); the raw trace must load with the analysis suite's loader and the
cluster trace must validate. The drain, no-GPU and refused-flag cases are
in ``tests/test_torch_worker_drain.py``, so that the test runner's
one-file-a-worker schedule spreads the process tests over two workers.

Every process runs under ``wait(timeout=...)`` and is killed in ``finally``.
A worker starts only once its own master has logged that it listens, on the
port it reports (the Python master binds port 0), so it never attaches to
another test's master.
"""

from __future__ import annotations

import asyncio
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from tpu_render_cluster.analysis.models import JobTrace
from tpu_render_cluster.obs import validate_trace_file
from tpu_render_cluster_torch.jobs.models import BlenderJob
from tpu_render_cluster_torch.worker.backends.torch_raytrace import TorchRaytraceBackend

REPO = Path(__file__).resolve().parent.parent
WIDTH, HEIGHT, SAMPLES = 32, 24, 2
ENV = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(REPO)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _write_job(
    tmp_path: Path,
    *,
    frames: int,
    workers: int,
    strategy_lines: str = 'strategy_type = "naive-fine"',
    tiles: str = "",
) -> Path:
    job_path = tmp_path / "job.toml"
    job_path.write_text(
        f'''job_name = "04_very-simple"
job_description = "port worker process job"
project_file_path = "%BASE%/project.blend"
render_script_path = "%BASE%/script.py"
frame_range_from = 1
frame_range_to = {frames}
wait_for_number_of_workers = {workers}
output_directory_path = "{tmp_path / 'frames'}"
output_file_name_format = "rendered-####"
output_file_format = "PNG"
{tiles}
[frame_distribution_strategy]
{strategy_lines}
'''
    )
    return job_path


def _listening_port(master: subprocess.Popen, log: Path, pattern: str) -> int | None:
    """The port in the master's first log line matching ``pattern``, or
    None if the master exited first."""
    deadline = time.monotonic() + 40
    while time.monotonic() < deadline:
        match = re.search(pattern, log.read_text())
        if match:
            return int(match.group(1))
        if master.poll() is not None:
            return None
        time.sleep(0.05)
    pytest.fail(f"the master did not listen within 40 s:\n{log.read_text()[-2000:]}")


def _python_master(job_path: Path, results: Path, log: Path) -> tuple[subprocess.Popen, int]:
    """The Python master on an ephemeral port, and the port it listens on."""
    with log.open("w") as out:
        master = subprocess.Popen(
            [
                sys.executable, "-m", "tpu_render_cluster.master.main",
                "--host", "127.0.0.1", "--port", "0",
                "run-job", str(job_path), "--resultsDirectory", str(results),
            ],
            cwd=REPO, env=ENV, stdout=out, stderr=subprocess.STDOUT,
        )
    port = _listening_port(master, log, r"Master listening on 127\.0\.0\.1:(\d+)")
    if port is None:
        pytest.fail(f"the master exited before it listened:\n{log.read_text()[-2000:]}")
    return master, port


def _cpp_master(
    binary: Path, job_path: Path, results: Path, log: Path
) -> tuple[subprocess.Popen, int]:
    """``native/trc-master`` on a free port, and that port. It reports the
    port it was given, so a port another process took in between is tried
    again on a new one."""
    for _ in range(3):
        port = _free_port()
        with log.open("w") as out:
            master = subprocess.Popen(
                [
                    str(binary), "--host", "127.0.0.1", "--port", str(port),
                    "run-job", str(job_path), "--resultsDirectory", str(results),
                ],
                env=ENV, stdout=out, stderr=subprocess.STDOUT,
            )
        if _listening_port(master, log, rf"Listening on 127\.0\.0\.1:({port})\.") is not None:
            return master, port
        master.wait(timeout=10)
    pytest.fail(f"native/trc-master did not listen:\n{log.read_text()[-2000:]}")


def _port_worker(
    port: int, base: Path, backend: str = "torch-raytrace", extra: tuple[str, ...] = ()
) -> subprocess.Popen:
    base.mkdir(parents=True, exist_ok=True)
    with (base / "worker.log").open("w") as out:
        return subprocess.Popen(
            [
                sys.executable, "-m", "tpu_render_cluster_torch.worker.main",
                "--masterServerHost", "127.0.0.1", "--masterServerPort", str(port),
                "--baseDirectory", str(base), "--backend", backend,
                "--device", "cpu", "--renderSize", f"{WIDTH}x{HEIGHT}",
                "--renderSamples", str(SAMPLES), *extra,
            ],
            cwd=REPO, env=ENV, stdout=out, stderr=subprocess.STDOUT,
        )


def _wait(process: subprocess.Popen, timeout: float) -> int:
    try:
        return process.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        process.kill()
        process.wait(timeout=10)
        pytest.fail(f"{process.args[:3]} did not finish within {timeout} s")


def _kill(processes) -> None:
    for process in processes:
        if process.poll() is None:
            process.kill()
            process.wait(timeout=10)


def _pixels(path: Path) -> np.ndarray:
    with Image.open(path) as image:
        return np.asarray(image.convert("RGB"))


def _in_process_frames(
    job_path: Path, tmp_path: Path, sharding: str | None = None
) -> dict[int, np.ndarray]:
    """The in-process port backend's whole-frame render of each frame."""
    job = BlenderJob.load_from_file(job_path)
    expected = tmp_path / "expected"
    job = BlenderJob.from_dict(
        {**job.to_dict(), "output_directory_path": str(expected)} | {"tiles": None}
    )
    backend = TorchRaytraceBackend(
        width=WIDTH, height=HEIGHT, samples=SAMPLES, device="cpu", sharding=sharding
    )
    for frame in job.frame_indices():
        asyncio.run(backend.render_frame(job, frame))
    return {
        frame: _pixels(expected / f"rendered-{frame:04d}.png") for frame in job.frame_indices()
    }


def _assert_frames_equal(tmp_path: Path, expected: dict[int, np.ndarray]) -> None:
    rendered = sorted((tmp_path / "frames").glob("rendered-*.png"))
    assert [p.name for p in rendered] == [f"rendered-{f:04d}.png" for f in sorted(expected)]
    for frame, pixels in expected.items():
        got = _pixels(tmp_path / "frames" / f"rendered-{frame:04d}.png")
        assert got.shape == (HEIGHT, WIDTH, 3)
        assert np.array_equal(got, pixels), f"frame {frame} differs"


def _worker_obs(base: Path, *, renders: bool = True) -> dict[str, int]:
    """Checks the worker's span timeline and metrics snapshot under
    <base>/obs/ (the render series only where a renderer fed them); returns
    the kernel launches the snapshot reports."""
    (events,) = (base / "obs").glob("worker-*_trace-events.json")
    (metrics,) = (base / "obs").glob("worker-*_metrics.json")
    assert json.loads(events.read_text())["traceEvents"]
    snapshot = json.loads(metrics.read_text())
    assert "worker_frames_rendered_total" in snapshot["metrics"]
    assert ("render_execute_seconds" in snapshot["metrics"]) == renders
    return snapshot["kernel_launches"]


def _serve_python_master(
    tmp_path: Path, job_path: Path, workers: int, extra: tuple[str, ...] = ()
) -> tuple[Path, list[dict[str, int]]]:
    results = tmp_path / "results"
    master, port = _python_master(job_path, results, tmp_path / "master.log")
    bases = [tmp_path / f"worker{i}" for i in range(workers)]
    processes = [master] + [_port_worker(port, base, extra=extra) for base in bases]
    try:
        assert _wait(master, 50) == 0, (tmp_path / "master.log").read_text()[-2000:]
        for process in processes[1:]:
            assert _wait(process, 20) == 0
    finally:
        _kill(processes)
    return results, [_worker_obs(base) for base in bases]


@pytest.mark.parametrize("tiles", [None, (2, 2)], ids=["whole", "tiles-2x2"])
def test_python_master_serves_port_workers(tmp_path, tiles):
    frames = 4
    job_path = _write_job(
        tmp_path, frames=frames, workers=2,
        tiles="" if tiles is None else f"tiles = [{tiles[0]}, {tiles[1]}]\n",
    )
    results, launches = _serve_python_master(tmp_path, job_path, workers=2)
    _assert_frames_equal(tmp_path, _in_process_frames(job_path, tmp_path))
    assert not list((tmp_path / "frames").glob("*tile*"))  # stitched and cleaned
    trace = JobTrace.load_from_trace_file(next(results.glob("*_raw-trace.json")))
    assert len(trace.worker_traces) == 2
    units = frames * (1 if tiles is None else tiles[0] * tiles[1])
    assert sum(len(w.frame_render_traces) for w in trace.worker_traces.values()) == units
    # One launch a unit, of the sphere megakernel's plain version on the CPU
    # (its lane mode for a tile), counted in the worker processes.
    plain = "trace_fused_reference" if tiles is None else "trace_fused_lanes_reference"
    assert sum(worker[plain] for worker in launches) == units
    assert all(count == 0 for worker in launches for name, count in worker.items() if name != plain)
    assert validate_trace_file(next(results.glob("*_cluster_trace-events.json"))) == []


def test_a_sharded_port_worker_serves_the_python_master(tmp_path):
    """A worker started with ``--sharding tile`` (its mesh one CPU device,
    one band a frame): its frames equal the in-process sharded backend's,
    which equal the unsharded ones, each one plain megakernel launch."""
    frames = 3
    job_path = _write_job(tmp_path, frames=frames, workers=1)
    _, (launches,) = _serve_python_master(
        tmp_path, job_path, workers=1, extra=("--sharding", "tile")
    )
    expected = _in_process_frames(job_path, tmp_path, sharding="tile")
    _assert_frames_equal(tmp_path, expected)
    unsharded = _in_process_frames(job_path, tmp_path / "unsharded")
    assert all(np.array_equal(expected[f], unsharded[f]) for f in expected)
    assert {k: v for k, v in launches.items() if v} == {"trace_fused_reference": frames}


@pytest.mark.skipif(shutil.which("g++") is None, reason="g++ unavailable")
@pytest.mark.parametrize("backend", ["torch-raytrace", "mock"])
def test_cpp_master_serves_a_port_worker(tmp_path, backend):
    from tpu_render_cluster.native import build_master_daemon

    master_binary = build_master_daemon()
    assert master_binary is not None, "native/trc-master failed to compile"
    frames = 3
    job_path = _write_job(tmp_path, frames=frames, workers=1)
    results = tmp_path / "results"
    master, port = _cpp_master(master_binary, job_path, results, tmp_path / "master.log")
    worker = _port_worker(port, tmp_path / "worker0", backend)
    try:
        assert _wait(master, 40) == 0, (tmp_path / "master.log").read_text()[-2000:]
        assert _wait(worker, 20) == 0
    finally:
        _kill([master, worker])
    trace = JobTrace.load_from_trace_file(next(results.glob("*_raw-trace.json")))
    (worker_trace,) = trace.worker_traces.values()
    assert sorted(t.frame_index for t in worker_trace.frame_render_traces) == [1, 2, 3]
    launches = _worker_obs(tmp_path / "worker0", renders=backend != "mock")
    if backend == "mock":  # sleeps in place of rendering: no file, no launch
        assert not list(tmp_path.glob("frames/*")) and not any(launches.values())
        return
    _assert_frames_equal(tmp_path, _in_process_frames(job_path, tmp_path))
    assert launches["trace_fused_reference"] == frames
