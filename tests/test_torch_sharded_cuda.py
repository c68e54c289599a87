"""The sharded renderer (``parallel/sharded_render.py``) on the GPU.

Needs a CUDA GPU and nvcc (the kernels have no CPU mode); skipped elsewhere.
Imports no jax: ``python -m pytest -q -m cuda tests/test_torch_sharded_cuda.py``.

Tolerances: a one-device mesh's frames (tile and spp) equal the unsharded
renders of the same tier bit for bit; each of 4 shards (tile bands and spp
subsets) on the card equals the same shard rendered with the kernels'
plain versions on the card, row 1 and the octant-ordered mesh kernels bit
for bit (tests/test_torch_kernels_cuda.py, test_torch_octant_cuda.py), and
so does their composition; with two or more cards the frame over all of
them equals the same shards rendered on one card, and a
two-process NCCL group (half the cards each) returns, in every process,
the frame of the same shards rendered here, bit for bit. With two or more
cards the frame's milliseconds over all of them are printed beside the same
shards on one card, and at the worker's size beside the backend's default
path on one card (printed, not checked).
"""

from __future__ import annotations

import contextlib
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_render_cluster_torch.parallel import device_mesh, sharded_render
from tpu_render_cluster_torch.render import integrator, kernels

pytestmark = pytest.mark.cuda

REPO = Path(__file__).resolve().parent.parent

KW = dict(width=64, height=64, max_bounces=4)
SCENES = ("04_very-simple", "02_physics-mesh", "03_physics-2-mesh")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@contextlib.contextmanager
def plain_versions():
    """The integrator's kernel calls through the plain versions, on the
    tensors' device (the card)."""
    names = ("trace_paths_fused", "trace_paths_fused_mesh", "mesh_bounce")
    saved = {name: getattr(kernels, name) for name in names}
    try:
        for name in names:
            setattr(kernels, name, getattr(kernels, f"{name}_reference"))
        yield
    finally:
        for name, wrapper in saved.items():
            setattr(kernels, name, wrapper)


@pytest.mark.parametrize("mode", ["tile", "spp"])
@pytest.mark.parametrize("scene", SCENES)
def test_cuda_one_device_mesh_is_the_frame(cuda_device, scene, mode):
    got = sharded_render.render_frame_sharded(
        scene, 2, mode=mode, n_devices=1, samples=4, **KW
    )
    assert got.device == cuda_device
    expected = integrator.render_frame(scene, 2, samples=4, **KW)
    assert torch.equal(got, expected)


@pytest.mark.parametrize("mode", ["tile", "spp"])
@pytest.mark.parametrize("scene", SCENES)
def test_cuda_four_shards_equal_their_plain_versions(cuda_device, scene, mode):
    plan = sharded_render.shard_plan(mode, 4, height=KW["height"], samples=4)
    kernels.reset_counts()
    shards = [
        sharded_render.render_shard(scene, 2, shard, device=cuda_device, **KW) for shard in plan
    ]
    assert not any(v for k, v in kernels.counts.items() if k.endswith("_reference"))
    with plain_versions():
        plain = [
            sharded_render.render_shard(scene, 2, shard, device=cuda_device, **KW)
            for shard in plan
        ]
    for got, expected in zip(shards, plain):
        assert torch.equal(got, expected)
    assert torch.equal(sharded_render.compose(mode, shards), sharded_render.compose(mode, plain))


@pytest.mark.parametrize("mode", ["tile", "spp"])
@pytest.mark.parametrize("scene", SCENES)
def test_cuda_every_card_renders_its_shard(cuda_device, scene, mode):
    """Every card of the host, a shard each, against the same shards
    rendered on card 0; the frame's time over all cards and over card 0
    alone (the same shards) is printed, not checked."""
    cards = len(device_mesh())
    if cards < 2:
        pytest.skip("one card: the mesh has one shard")
    size = dict(width=256, height=64 * cards, max_bounces=4)
    kernels.reset_counts()
    got = sharded_render.render_frame_sharded(
        scene, 2, mode=mode, samples=2 * cards, **size
    )
    assert got.device == cuda_device
    assert sum(v for k, v in kernels.counts.items() if not k.endswith("_reference")) >= cards
    plan = sharded_render.shard_plan(mode, cards, height=size["height"], samples=2 * cards)

    def one_card():
        return sharded_render.compose(mode, [
            sharded_render.render_shard(scene, 2, shard, device=cuda_device, **size)
            for shard in plan
        ])

    assert torch.equal(got, one_card())
    times = {}
    for label, render in (
        ("all cards", lambda: sharded_render.render_frame_sharded(
            scene, 2, mode=mode, samples=2 * cards, **size)),
        ("card 0", one_card),
    ):
        render()
        torch.cuda.synchronize()
        started = time.perf_counter()
        for _ in range(3):
            render()
        for card in range(cards):
            torch.cuda.synchronize(card)
        times[label] = (time.perf_counter() - started) / 3 * 1e3
    print(f"{scene} {mode}, {cards} shards of {size['width']}x{size['height']}, "
          f"{2 * cards} spp: ms a frame {times} on {_card()}")


def _card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


@pytest.mark.parametrize("mode", ["tile", "spp"])
@pytest.mark.parametrize("scene", SCENES)
def test_cuda_all_cards_against_the_one_card_default(cuda_device, scene, mode):
    """A whole frame at the worker's size (512x512, 8 spp, 4 bounces) over
    every card of the host against the backend's default path (sharding
    off) on card 0 alone, each the display image on the card; the milliseconds
    a frame of both are printed, not checked (what decides whether
    ``--sharding`` pays on a node)."""
    from tpu_render_cluster_torch.render.integrator import tonemap
    from tpu_render_cluster_torch.worker.backends.torch_raytrace import TorchRaytraceBackend

    cards = len(device_mesh())
    if cards < 2:
        pytest.skip("one card: the mesh has one shard")
    size = dict(width=512, height=512, samples=8, max_bounces=4)
    sharded = TorchRaytraceBackend(sharding=mode, **size)
    default = TorchRaytraceBackend(**size)
    renders = {
        f"{cards} cards, sharded": lambda: tonemap(sharded._render_sharded(scene, 2)),
        "card 0, default path": lambda: default._renderer(scene)(2),
    }
    times = {}
    for label, render in renders.items():
        image = render()
        assert image.shape == (512, 512, 3) and image.dtype == torch.uint8
        assert image.float().std() > 5.0
        for card in range(cards):
            torch.cuda.synchronize(card)
        started = time.perf_counter()
        for _ in range(5):
            render()
        for card in range(cards):
            torch.cuda.synchronize(card)
        times[label] = (time.perf_counter() - started) / 5 * 1e3
    print(f"{scene} {mode} at 512x512x8, 4 bounces: ms a frame {times} on {_card()}")


# One process of a two-process NCCL group on one host, each process given
# half the cards by CUDA_VISIBLE_DEVICES (as two hosts would hold them).
GROUP_PROCESS = """
import sys
import numpy as np
import torch.distributed as dist
from tpu_render_cluster_torch.parallel import mesh, sharded_render

address, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
assert mesh.initialize_multihost(address, 2, rank) is True
assert dist.get_backend() == "nccl"
kw = dict(width=64, height=64, samples=8, max_bounces=4)
results = {
    f"{scene} {mode}": sharded_render.render_frame_sharded(scene, 2, mode=mode, **kw)
    for scene in ("04_very-simple", "02_physics-mesh", "03_physics-2-mesh")
    for mode in ("tile", "spp")
}
results["batch"] = sharded_render.render_frames_batched(
    "04_very-simple", list(range(1, 9)), width=64, height=64, samples=4, max_bounces=4)
np.savez(out, **{key: value.cpu().numpy() for key, value in results.items()})
dist.destroy_process_group()
print("OK", rank)
"""


def test_cuda_two_process_nccl_group(cuda_device, tmp_path):
    """Two processes over NCCL, half the host's cards each: every process's
    frames equal this process's rendering of the same shards on card 0,
    the bands gathered, the spp subsets summed per process and then across
    (the group's order of additions)."""
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two cards: one for each process of the group")
    local = cards // 2
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        address = f"127.0.0.1:{probe.getsockname()[1]}"
    outs = [tmp_path / f"rank{rank}.npz" for rank in range(2)]
    processes = []
    for rank in range(2):
        visible = ",".join(str(rank * local + index) for index in range(local))
        env = {**os.environ, "PYTHONPATH": str(REPO), "CUDA_VISIBLE_DEVICES": visible}
        processes.append(subprocess.Popen(
            [sys.executable, "-c", GROUP_PROCESS, address, str(rank), str(outs[rank])],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    try:
        logs = [process.communicate(timeout=300)[0] for process in processes]
    finally:
        for process in processes:
            if process.poll() is None:
                process.kill()
                process.wait(timeout=10)
    for rank, (process, log) in enumerate(zip(processes, logs)):
        assert process.returncode == 0 and f"OK {rank}" in log, log[-3000:]
    n = 2 * local
    kw = dict(width=64, height=64, max_bounces=4)
    expected = {}
    for scene in SCENES:
        for mode in ("tile", "spp"):
            plan = sharded_render.shard_plan(mode, n, height=64, samples=8)
            shards = [sharded_render.render_shard(scene, 2, shard, device=cuda_device, **kw)
                      for shard in plan]
            if mode == "tile":
                expected[f"{scene} {mode}"] = torch.cat(shards)
            else:
                halves = [sharded_render._sum(shards[:local]), sharded_render._sum(shards[local:])]
                expected[f"{scene} {mode}"] = (halves[0] + halves[1]) / n
    expected["batch"] = torch.stack([
        sharded_render.render_shard(
            "04_very-simple", frame, sharded_render.Shard(0, 0, 64, 4, 0), device=cuda_device,
            **kw)
        for frame in range(1, 9)
    ])
    for out in outs:
        got = dict(np.load(out))
        for key, image in expected.items():
            assert np.array_equal(got[key], image.cpu().numpy()), key
