"""The port's multi-host surface (``parallel/mesh.py``) and a process group
rendering together on the CPU.

The reference's contract (tests/test_multihost.py) for the port: the no-op
without configuration, the partial-triple error, the reference's launcher
variables as fallbacks, explicit arguments first, and the worker CLI's
flags. Then real ``torch.distributed`` groups over gloo in subprocesses
(each under its own timeout): one process, and two processes that render
04_very-simple as tile bands, as spp subsets and as a 2-frame batch, where
every process's result must equal, bit for bit, one process rendering the
same two shards (``n_devices=2``) on the CPU.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_render_cluster_torch.parallel import mesh, sharded_render
from tpu_render_cluster_torch.worker.main import build_parser

REPO = Path(__file__).resolve().parent.parent
ENV_VARS = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")
GROUP_TIMEOUT_S = 120
KW = dict(width=16, height=8, samples=2, max_bounces=2)


@pytest.fixture()
def no_launcher_env(monkeypatch):
    for var in ENV_VARS:
        monkeypatch.delenv(var, raising=False)


@pytest.fixture()
def recorded_groups(monkeypatch):
    """``init_process_group`` replaced by a recorder of its arguments."""
    calls: list = []
    monkeypatch.setattr(
        mesh.dist, "init_process_group", lambda *args, **kw: calls.append((args, kw))
    )
    return calls


def test_initialize_multihost_is_noop_without_config(no_launcher_env, recorded_groups):
    assert mesh.initialize_multihost() is False
    assert mesh.initialize_multihost(device="cpu") is False
    assert recorded_groups == []


def test_initialize_multihost_rejects_partial_config(
    no_launcher_env, recorded_groups, monkeypatch
):
    with pytest.raises(ValueError, match="incomplete"):
        mesh.initialize_multihost(num_processes=4, device="cpu")
    monkeypatch.setenv("JAX_PROCESS_ID", "2")
    with pytest.raises(ValueError, match="incomplete"):
        mesh.initialize_multihost(device="cpu")
    with pytest.raises(ValueError, match="incomplete"):
        mesh.initialize_multihost("127.0.0.1:9000", device="cpu")
    assert recorded_groups == []


def test_initialize_multihost_reads_the_launcher_env(
    no_launcher_env, recorded_groups, monkeypatch
):
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "10.0.0.1:8476")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "4")
    monkeypatch.setenv("JAX_PROCESS_ID", "3")
    assert mesh.initialize_multihost(device="cpu") is True
    # Explicit arguments win over the environment, one by one.
    assert mesh.initialize_multihost("127.0.0.1:1234", None, 1, device="cpu") is True
    assert recorded_groups == [
        (("gloo",), dict(init_method="tcp://10.0.0.1:8476", world_size=4, rank=3)),
        (("gloo",), dict(init_method="tcp://127.0.0.1:1234", world_size=4, rank=1)),
    ]


def test_a_cuda_group_without_a_card_raises(no_launcher_env, recorded_groups):
    """NCCL is the collective backend unless the CPU was asked for: without
    a card the request raises; it never comes up over gloo instead."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the group would come up over NCCL")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh.initialize_multihost("127.0.0.1:1234", 2, 0)
    assert recorded_groups == []


def test_worker_cli_takes_the_multihost_flags():
    args = build_parser().parse_args([
        "--masterServerHost", "h", "--masterServerPort", "1", "--baseDirectory", ".",
        "--coordinatorAddress", "127.0.0.1:9000", "--numProcesses", "2", "--processId", "1",
        "--sharding", "spp",
    ])
    assert (args.coordinator_address, args.num_processes, args.process_id) == (
        "127.0.0.1:9000", 2, 1
    )
    assert args.sharding == "spp"
    default = build_parser().parse_args(
        ["--masterServerHost", "h", "--masterServerPort", "1", "--baseDirectory", "."]
    )
    assert (default.sharding, default.coordinator_address) == ("none", None)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# One process of a gloo group: join it, render the three decompositions
# over the group's mesh (one CPU shard a process) and save them.
GROUP_PROCESS = """
import sys
import numpy as np
import torch.distributed as dist
from tpu_render_cluster_torch.parallel import device_mesh, mesh, sharded_render

address, processes, rank, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
assert mesh.initialize_multihost(address, processes, rank, device="cpu") is True
assert dist.get_backend() == "gloo" and dist.get_world_size() == processes
assert device_mesh(device="cpu") == [mesh.torch.device("cpu")]
kw = dict(width={width}, height={height}, samples={samples}, max_bounces={max_bounces})
layout = mesh.mesh_layout(device="cpu")
assert (layout.n, layout.first_shard) == (processes, rank), layout
results = dict(
    tile=sharded_render.render_frame_sharded("04_very-simple", 3, mode="tile", device="cpu", **kw),
    spp=sharded_render.render_frame_sharded("04_very-simple", 3, mode="spp", device="cpu", **kw),
    batch=sharded_render.render_frames_batched(
        "04_very-simple", [3, 4], device="cpu", **kw),
)
np.savez(out, **{{k: v.numpy() for k, v in results.items()}})
dist.destroy_process_group()
print("OK", rank)
""".format(**KW)


def _run_group(processes: int, tmp_path: Path) -> list[dict[str, np.ndarray]]:
    address = f"127.0.0.1:{_free_port()}"
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    for var in ENV_VARS:
        env.pop(var, None)
    outs = [tmp_path / f"rank{rank}.npz" for rank in range(processes)]
    running = [
        subprocess.Popen(
            [sys.executable, "-c", GROUP_PROCESS, address, str(processes), str(rank),
             str(outs[rank])],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for rank in range(processes)
    ]
    try:
        logs = [process.communicate(timeout=GROUP_TIMEOUT_S)[0] for process in running]
    finally:
        for process in running:
            if process.poll() is None:
                process.kill()
                process.wait(timeout=10)
    for rank, (process, log) in enumerate(zip(running, logs)):
        assert process.returncode == 0 and f"OK {rank}" in log, log[-3000:]
    return [dict(np.load(out)) for out in outs]


def _one_process(n: int) -> dict[str, np.ndarray]:
    return dict(
        tile=sharded_render.render_frame_sharded(
            "04_very-simple", 3, mode="tile", n_devices=n, device="cpu", **KW).numpy(),
        spp=sharded_render.render_frame_sharded(
            "04_very-simple", 3, mode="spp", n_devices=n, device="cpu", **KW).numpy(),
        batch=sharded_render.render_frames_batched(
            "04_very-simple", [3, 4], n_devices=n, device="cpu", **KW).numpy(),
    )


@pytest.mark.parametrize("processes", [1, 2])
def test_a_gloo_group_renders_as_one_process(processes, tmp_path):
    expected = _one_process(processes)
    for result in _run_group(processes, tmp_path):
        assert sorted(result) == sorted(expected)
        for name, image in expected.items():
            assert result[name].shape == image.shape
            assert np.array_equal(result[name], image), name
