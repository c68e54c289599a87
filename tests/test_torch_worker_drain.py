"""The port's worker process: drain on SIGTERM, no GPU, refused flags.

A worker sent SIGTERM mid-job drains: it finishes the frame in flight,
returns its queue with the goodbye message and exits 0, and a second worker
finishes the job against the unmodified Python master, every frame
bit-equal to the in-process backend's. Without a GPU and without ``--device
cpu`` the worker exits non-zero before it connects. Flags of the reference
that the port does not have yet are refused. Helpers and bounds as in
``tests/test_torch_worker.py``.
"""

from __future__ import annotations

import json
import signal
import subprocess
import sys
import time

import pytest
import torch

from tests.test_torch_worker import (
    ENV,
    REPO,
    _assert_frames_equal,
    _free_port,
    _in_process_frames,
    _kill,
    _port_worker,
    _python_master,
    _wait,
    _write_job,
)
from tpu_render_cluster_torch.worker import main as worker_main


def test_sigterm_drains_the_queue_to_another_worker(tmp_path):
    """Worker A holds the whole job in its queue; SIGTERM after its first
    frame makes it finish that frame, return the rest with the goodbye and
    exit 0. Worker B, started after A left, renders what A returned."""
    frames = 12
    job_path = _write_job(
        tmp_path, frames=frames, workers=1,
        strategy_lines=f'strategy_type = "eager-naive-coarse"\ntarget_queue_size = {frames}',
    )
    results = tmp_path / "results"
    master, port = _python_master(job_path, results, tmp_path / "master.log")
    first = _port_worker(port, tmp_path / "worker0")
    processes = [master, first]
    try:
        deadline = time.monotonic() + 40
        while not list((tmp_path / "frames").glob("rendered-*.png")):
            assert time.monotonic() < deadline, "worker A rendered nothing"
            assert master.poll() is None and first.poll() is None
            time.sleep(0.02)
        first.send_signal(signal.SIGTERM)
        assert _wait(first, 20) == 0
        second = _port_worker(port, tmp_path / "worker1")
        processes.append(second)
        assert _wait(master, 40) == 0, (tmp_path / "master.log").read_text()[-2000:]
        assert _wait(second, 20) == 0
    finally:
        _kill(processes)
    log = (tmp_path / "worker0" / "worker.log").read_text()
    returned = [line for line in log.splitlines() if "Goodbye sent (drain" in line]
    assert len(returned) == 1, log[-2000:]
    count = int(returned[0].split("Goodbye sent (drain, ")[1].split(" frame")[0])
    assert 1 <= count < frames
    snapshot = json.loads(next(results.glob("*_metrics.json")).read_text())["metrics"]
    drains = snapshot["master_worker_drains_total"]["series"]
    assert sum(drains.values()) == 1
    _assert_frames_equal(tmp_path, _in_process_frames(job_path, tmp_path))


def test_worker_without_gpu_exits_before_connecting(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device resolves")
    port = _free_port()  # nothing listens here
    started = time.monotonic()
    result = subprocess.run(
        [
            sys.executable, "-m", "tpu_render_cluster_torch.worker.main",
            "--masterServerHost", "127.0.0.1", "--masterServerPort", str(port),
            "--baseDirectory", str(tmp_path),
        ],
        cwd=REPO, env=ENV, capture_output=True, text=True, timeout=60,
    )
    assert result.returncode != 0
    assert "CUDA is not available" in result.stderr
    assert time.monotonic() - started < 30  # no connect retries were made
    assert not (tmp_path / "obs").exists()  # no worker ever ran


@pytest.mark.parametrize(
    "flags",
    [
        ["--sharding", "tile"],
        ["--coordinatorAddress", "127.0.0.1:1234"],
        ["--telemetryPort", "9809"],
        ["--router", "127.0.0.1:9900"],
        ["--backend", "blender"],
    ],
    ids=["sharding", "coordinatorAddress", "telemetryPort", "router", "blender"],
)
def test_unported_flags_are_refused(flags, capsys):
    """Flags the port does not have yet exit with 2 before anything runs.
    ``--sharding`` and the multi-host triple are ported (the multi-GPU
    slice): taken by the parser and the refusal check, the backend built
    sharded, and a partial triple refused as the reference refuses it."""
    args = ["--masterServerHost", "127.0.0.1", "--masterServerPort", "1", "--baseDirectory", "."]
    if flags[0] == "--sharding":
        parser = worker_main.build_parser()
        parsed = parser.parse_args(args + flags + ["--device", "cpu"])
        worker_main.refuse_unported(parsed, parser)
        worker_main.refuse_sharding_conflicts(parsed, parser)
        assert worker_main.make_backend(parsed).sharding == "tile"
        return
    if flags[0] == "--coordinatorAddress":
        with pytest.raises(ValueError, match="incomplete"):
            worker_main.main(args + flags + ["--device", "cpu"])
        assert worker_main.NOT_PORTED not in capsys.readouterr().err
        return
    with pytest.raises(SystemExit) as exit_info:
        worker_main.main(args + flags)
    assert exit_info.value.code == 2
    assert worker_main.NOT_PORTED in capsys.readouterr().err


def test_a_bad_sharding_value_exits_2(capsys):
    args = ["--masterServerHost", "127.0.0.1", "--masterServerPort", "1", "--baseDirectory", "."]
    with pytest.raises(SystemExit) as exit_info:
        worker_main.main(args + ["--sharding", "diagonal"])
    assert exit_info.value.code == 2
    assert "invalid choice: 'diagonal'" in capsys.readouterr().err


@pytest.mark.parametrize(
    "flags,env,message",
    [
        (["--coordinatorAddress", "127.0.0.1:1234", "--numProcesses", "2", "--processId", "0"],
         {}, "in a group of 2 processes"),
        ([], {"JAX_NUM_PROCESSES": "4"}, "in a group of 4 processes"),
        (["--device", "cuda:1"], {}, "may name only cuda or cpu"),
    ],
    ids=["flags", "launcher-env", "one-card"],
)
def test_sharding_where_it_cannot_render_exits_2(flags, env, message, monkeypatch, capsys):
    """``--sharding`` in a group of more than one process exits 2 before
    any group or backend comes up: the master hands each process its own
    frames, and the collectives would mix them (ROADMAP.md, section 3);
    so does ``--sharding`` with one card named by ``--device``."""
    for name in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    monkeypatch.setattr(
        worker_main, "initialize_multihost", lambda *a, **k: pytest.fail("the group came up")
    )
    args = ["--masterServerHost", "127.0.0.1", "--masterServerPort", "1", "--baseDirectory", "."]
    with pytest.raises(SystemExit) as exit_info:
        worker_main.main(args + ["--sharding", "tile"] + flags)
    assert exit_info.value.code == 2
    assert message in capsys.readouterr().err
