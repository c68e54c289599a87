"""Whole frames and the worker at the reference's TLAS tiers, on the CPU.

Frames: 02 (the mesh megakernel, row 3 TLAS) and the deep scene through the
wavefront (row 4 TLAS with its vote and key passes), 16x16, 1 sample, 2
bounces, at ``TRC_TLAS_BLOCK=128``, ``TRC_TLAS_LEAF=1`` and
``TRC_TLAS_LEAF=16``, against the reference's ``render_frame`` and
``render_frame_wavefront`` with ``TRC_PALLAS=1`` (interpret mode) in the
same environment, its jit caches cleared around it. Tolerance: the image
bound of tests/test_raypool.py (at most max(1, round(0.001 n)) pixels off
by more than 2e-3, mean absolute error below 1e-4); the launches name the
width (``..._tlas_reference[p128]``). The port's own masked deep frame at
each tier equals its wavefront frame to the bit, as at the default tiers.

The worker: a backend and a worker's backend built from its command line
(``--device cpu``, in a process of its own) started with the four
variables resolve them into their renderer keys and launches (the TLAS
tiers are environment tiers alone, as the reference's); renderer caches
hold distinct tiers side by side; a pool window follows
``TRC_RAYPOOL_FRAMES``.
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

from tests.test_torch_backend import _job
from tests.test_torch_raypool import _assert_images_equivalent
from tpu_render_cluster.jobs.models import DistributionStrategy
from tpu_render_cluster.render import compaction as ref_compaction
from tpu_render_cluster.render import integrator as ref_integrator
from tpu_render_cluster_torch.render import compaction, integrator, kernels
from tpu_render_cluster_torch.worker.backends.torch_raytrace import TorchRaytraceBackend

REPO = Path(__file__).resolve().parent.parent
SHALLOW, DEEP, FRAME = "02_physics-mesh", "03_physics-2-mesh", 30
SIZE = dict(width=16, height=16, samples=1, max_bounces=2)
TIERS = ("TRC_TLAS", "TRC_TLAS_LEAF", "TRC_TLAS_BLOCK", "TRC_RAYPOOL_FRAMES",
         "TRC_RAYPOOL_WIDTH")
SETTINGS = {
    "block-128": {"TRC_TLAS_BLOCK": "128"},
    "leaf-1": {"TRC_TLAS_LEAF": "1"},
    "leaf-16": {"TRC_TLAS_LEAF": "16"},
}


@pytest.fixture
def clean_tiers(monkeypatch):
    for name in TIERS:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


@pytest.fixture
def frame_env(clean_tiers, request):
    env = SETTINGS[request.param]
    clean_tiers.setenv("TRC_PALLAS", "1")
    for name, value in env.items():
        clean_tiers.setenv(name, value)
    jax.clear_caches()
    yield env
    jax.clear_caches()


@pytest.mark.parametrize("frame_env", list(SETTINGS), indirect=True)
@pytest.mark.parametrize("path", ["02 megakernel", "deep wavefront"])
def test_frames_at_the_tiers_match_the_reference(frame_env, path):
    packet = int(frame_env.get("TRC_TLAS_BLOCK", kernels.TLAS_BLOCK_R))
    kernels.reset_counts()
    if path == "02 megakernel":
        expected = np.asarray(ref_integrator.render_frame(SHALLOW, FRAME, **SIZE))
        got = integrator.render_frame(SHALLOW, FRAME, device="cpu", **SIZE)
        kernel = "trace_fused_mesh_tlas_reference"
    else:
        expected = np.asarray(ref_compaction.render_frame_wavefront(DEEP, FRAME, **SIZE))
        got = compaction.render_frame_wavefront(DEEP, FRAME, device="cpu", **SIZE)
        kernel = "mesh_bounce_tlas_reference"
        masked = integrator.render_frame(DEEP, FRAME, device="cpu", **SIZE)
        assert torch.equal(masked, got)
    assert kernels.counts.get(kernels.packet_name(kernel, packet), 0) >= 1, kernels.counts
    _assert_images_equivalent(got.numpy(), expected)
    assert got.max() > 0.05


def _keyed_renderer(backend, scene, leaf, block):
    """The masked renderer cached under the backend's BVH tiers and the
    TLAS tiers ``(leaf, block)``: the key the backend's renderer must hit."""
    return integrator._fused_frame_renderer(
        scene, backend.width, backend.height, backend.samples, backend.max_bounces,
        backend.device, False, False, *backend.tiers().values(), leaf, block)


def test_backend_options_and_environment_reach_the_renderer_keys(clean_tiers):
    """The backend's BVH options and the environment's TLAS tiers resolve
    together into the renderers' keys, when the renderer is asked for; the
    environment reaches the launches of a ``--device cpu`` backend."""
    options = dict(device="cpu", width=8, height=8, samples=1, max_bounces=2)
    backend = TorchRaytraceBackend(use_tlas=True, **options)
    clean_tiers.setenv("TRC_TLAS_LEAF", "1")
    clean_tiers.setenv("TRC_TLAS_BLOCK", "512")
    assert integrator.resolve_tlas_config() == (1, 512)
    assert backend._renderer(SHALLOW) is _keyed_renderer(backend, SHALLOW, 1, 512)
    clean_tiers.setenv("TRC_TLAS_LEAF", "8")
    clean_tiers.setenv("TRC_TLAS_BLOCK", "100")  # snaps to 128, as the reference's
    assert backend._renderer(SHALLOW) is _keyed_renderer(backend, SHALLOW, 8, 128)
    assert backend._renderer(SHALLOW) is not _keyed_renderer(backend, SHALLOW, 1, 512)
    kernels.reset_counts()
    image = backend._renderer(DEEP)(FRAME)  # the wavefront tier
    assert image.shape == (8, 8, 3)
    assert kernels.counts["mesh_bounce_tlas_reference[p128]"] >= 2
    assert kernels.counts["mesh_bounce_tlas_reference"] == 0


def test_renderer_caches_hold_distinct_tiers_side_by_side(clean_tiers):
    """An environment change between calls resolves to another renderer,
    the same environment to the same."""
    a = integrator.fused_frame_renderer(DEEP, 8, 8, 1, 2, "cpu")
    clean_tiers.setenv("TRC_TLAS_LEAF", "8")
    b = integrator.fused_frame_renderer(DEEP, 8, 8, 1, 2, "cpu")
    clean_tiers.setenv("TRC_TLAS_BLOCK", "1024")
    c = integrator.fused_frame_renderer(DEEP, 8, 8, 1, 2, "cpu")
    assert len({id(a), id(b), id(c)}) == 3
    assert integrator.fused_frame_renderer(DEEP, 8, 8, 1, 2, "cpu") is c
    region = integrator.fused_region_renderer(DEEP, 8, 8, 4, 4, 1, 2, "cpu")
    clean_tiers.delenv("TRC_TLAS_LEAF")
    clean_tiers.delenv("TRC_TLAS_BLOCK")
    assert integrator.fused_frame_renderer(DEEP, 8, 8, 1, 2, "cpu") is a
    assert integrator.fused_region_renderer(DEEP, 8, 8, 4, 4, 1, 2, "cpu") is not region


def test_a_pool_window_follows_the_frame_cap(clean_tiers, tmp_path):
    """Frame 1 with frames 2-5 queued: at ``TRC_RAYPOOL_FRAMES=3`` one window
    of 3 frames (the reference's ``[frame] + upcoming[:cap - 1]``) in a pool
    of ``TRC_RAYPOOL_WIDTH`` lanes, its launches at ``TRC_TLAS_BLOCK``."""
    clean_tiers.setenv("TRC_RAYPOOL_FRAMES", "3")
    clean_tiers.setenv("TRC_RAYPOOL_WIDTH", "2048")
    clean_tiers.setenv("TRC_TLAS_BLOCK", "512")
    job = _job(DistributionStrategy.naive_fine(), frames=5, workers=1, name="03_physics-2-mesh")
    backend = TorchRaytraceBackend(device="cpu", width=8, height=8, samples=1, max_bounces=2,
                                   base_directory=tmp_path)
    backend.note_upcoming_frames(job, (2, 3, 4, 5))
    kernels.reset_counts()
    asyncio.run(backend.render_frame(job, 1))
    stats = backend.pool_stats[-1]
    assert stats.served == 3 * 8 * 8
    assert set(backend._raypool_cache) == {(job.job_name, 2, None), (job.job_name, 3, None)}
    assert kernels.counts["pool_mesh_bounce_tlas_reference[p512]"] == stats.iterations
    # The launched lanes round to the 512-lane packet, the pool holds 2,048.
    assert stats.launched_sum % 512 == 0 and max(stats.occ_log) <= 1.0


def test_a_worker_started_with_the_tiers_resolves_them(tmp_path):
    """A worker process's backend, built from its command line with
    ``--device cpu`` and the four variables in its environment: its tiers,
    its pool window's cap and width, and the width its launches count."""
    script = (
        "import json\n"
        "from tpu_render_cluster_torch.render import integrator, kernels, raypool\n"
        "from tpu_render_cluster_torch.worker import main\n"
        "args = main.build_parser().parse_args(['--masterServerHost', '127.0.0.1',\n"
        "    '--masterServerPort', '1', '--baseDirectory', %r, '--device', 'cpu',\n"
        "    '--renderSize', '8x8', '--renderSamples', '1'])\n"
        "backend = main.make_backend(args)\n"
        "backend.max_bounces = 2\n"
        "kernels.reset_counts()\n"
        "backend._renderer('03_physics-2-mesh')(30)\n"
        "leaf, block = integrator.resolve_tlas_config()\n"
        "renderer = backend._renderer('02_physics-mesh')\n"
        "keyed = integrator._fused_frame_renderer('02_physics-mesh', 8, 8, 1, 2,\n"
        "    backend.device, False, False, *backend.tiers().values(), 8, 128)\n"
        "print(json.dumps({**backend.tiers(), 'tlas_leaf': leaf, 'tlas_block': block,\n"
        "    'keyed': renderer is keyed,\n"
        "    'frames': raypool.raypool_frame_cap(), 'width': raypool.raypool_width(64),\n"
        "    'launches': {k: v for k, v in kernels.counts.items() if v}}))\n"
    ) % str(tmp_path)
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(REPO),
           "TRC_TLAS_BLOCK": "128", "TRC_TLAS_LEAF": "8", "TRC_RAYPOOL_FRAMES": "16",
           "TRC_RAYPOOL_WIDTH": "3000"}
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    resolved = json.loads(out.stdout.strip().splitlines()[-1])
    assert resolved["tlas_leaf"] == 8 and resolved["tlas_block"] == 128 and resolved["keyed"]
    assert resolved["frames"] == 16 and resolved["width"] == 3072
    assert resolved["launches"]["mesh_bounce_tlas_reference[p128]"] == 2
    assert "mesh_bounce_tlas_reference" not in resolved["launches"]
