"""The CUDA path-trace kernels (the sphere and mesh megakernels, their
per-bounce forms and the ray-pool bounces) against their plain PyTorch
versions, on a GPU.

Needs a CUDA GPU and nvcc (the kernels have no CPU mode); skipped elsewhere.
Imports no jax, so it runs on a GPU machine without the JAX package's
dependencies: ``python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py``.

Tolerance as in tests/test_torch_kernels.py, rtol = atol = 1e-4 per ray:
every ray at 1 bounce (the mesh kernel: all but an edge-tie budget of
max(1, round(0.001 R)) rays), at least 99.9% at 4 bounces. A per-bounce
kernel: all five outputs of every ray but that budget.
"""

from __future__ import annotations

import pytest
import torch

from tpu_render_cluster_torch.render import compaction, integrator, kernels, raypool
from tpu_render_cluster_torch.render.mesh import (
    MeshInstances,
    MeshSet,
    build_bvh,
    make_icosphere,
    scene_mesh_set,
)
from tpu_render_cluster_torch.render.scene import build_mesh_instances, build_scene

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc: the kernel has no CPU mode")
    return torch.device("cuda")


def _launched(kernel: str) -> dict[str, int]:
    """``kernels.counts`` after one launch of ``kernel`` and nothing else:
    no other kernel and no plain version."""
    return {name: int(name == kernel) for name in kernels.counts}


@pytest.mark.parametrize("max_bounces", [1, 4])
@pytest.mark.parametrize("name", ["04_very-simple", "03_physics-2"])
def test_cuda_kernel_matches_plain_version(cuda_device, name, max_bounces):
    scene = build_scene(name, 7, cuda_device)
    camera = integrator.scene_camera(name, 7, cuda_device)
    origins, directions, seed = integrator.frame_rays_and_seed(
        camera, 7, width=128, height=128, samples=4
    )
    kernels.reset_counts()
    got = kernels.trace_paths_fused(scene, origins, directions, seed, max_bounces=max_bounces)
    torch.cuda.synchronize()
    assert kernels.counts == _launched("trace_fused")
    expected = kernels.trace_paths_fused_reference(
        scene, origins, directions, seed, max_bounces=max_bounces
    )
    close = torch.isclose(got, expected, rtol=1e-4, atol=1e-4).all(dim=1).float().mean().item()
    assert close >= (1.0 if max_bounces == 1 else 0.999), close


def test_cuda_frame_renderer_goes_through_the_kernel(cuda_device):
    kernels.reset_counts()
    image = integrator.fused_frame_renderer("01_simple-animation", 64, 48, 2, 4)(3)
    assert image.device.type == "cuda" and image.shape == (48, 64, 3)
    assert kernels.counts == _launched("trace_fused")
    cpu = integrator.fused_frame_renderer("01_simple-animation", 64, 48, 2, 4, "cpu")(3)
    diff = (image.cpu().int() - cpu.int()).abs()
    assert (diff <= 1).float().mean().item() >= 0.995


@pytest.mark.parametrize("max_bounces", [1, 4])
@pytest.mark.parametrize("name", ["02_physics-mesh", "03_physics-2-mesh"])
def test_cuda_mesh_kernel_matches_plain_version(cuda_device, name, max_bounces):
    """02_physics-mesh is the main path's mesh; 03_physics-2-mesh's deep
    icosphere tree is past the dispatch bound and called directly."""
    scene = build_scene(name, 30, cuda_device)
    mesh = scene_mesh_set(name, 30, device=cuda_device)
    camera = integrator.scene_camera(name, 30, cuda_device)
    origins, directions, seed = integrator.frame_rays_and_seed(
        camera, 30, width=128, height=128, samples=4
    )
    kernels.reset_counts()
    got = kernels.trace_paths_fused_mesh(
        scene, mesh, origins, directions, seed, max_bounces=max_bounces
    )
    torch.cuda.synchronize()
    assert kernels.counts == _launched("trace_fused_mesh")
    expected = kernels.trace_paths_fused_mesh_reference(
        scene, mesh, origins, directions, seed, max_bounces=max_bounces
    )
    close = torch.isclose(got, expected, rtol=1e-4, atol=1e-4).all(dim=1)
    if max_bounces == 1:
        assert (~close).sum().item() <= max(1, round(0.001 * close.numel()))
    else:
        assert close.float().mean().item() >= 0.999


@pytest.mark.parametrize(
    "n_faces,low,high",
    # 700 faces of the level-3 icosphere: 48-96 KB of tables, staged past
    # the default 48 KB limit; all 1,280 faces: beyond 96 KB, read from
    # device memory.
    [(700, 48 * 1024, 96 * 1024), (None, 96 * 1024, 1 << 30)],
)
def test_cuda_mesh_kernel_with_large_tables(cuda_device, n_faces, low, high):
    vertices, faces = make_icosphere(3)
    bvh = build_bvh(vertices, faces[:n_faces], device=cuda_device)
    instances = build_mesh_instances("02_physics-mesh", 30, cuda_device)
    mesh = MeshSet(bvh, MeshInstances(*(field[:3] for field in instances)))
    table_bytes = 64 * bvh.v0.shape[0] + 48 * bvh.skip.shape[0] + 88 * 3
    assert low < table_bytes <= high, table_bytes
    scene = build_scene("02_physics-mesh", 30, cuda_device)
    camera = integrator.scene_camera("02_physics-mesh", 30, cuda_device)
    origins, directions, seed = integrator.frame_rays_and_seed(
        camera, 30, width=64, height=64, samples=2
    )
    got = kernels.trace_paths_fused_mesh(scene, mesh, origins, directions, seed, max_bounces=4)
    expected = kernels.trace_paths_fused_mesh_reference(
        scene, mesh, origins, directions, seed, max_bounces=4
    )
    close = torch.isclose(got, expected, rtol=1e-4, atol=1e-4).all(dim=1)
    assert close.float().mean().item() >= 0.999


def test_cuda_mesh_frame_renderer_goes_through_the_kernel(cuda_device):
    kernels.reset_counts()
    image = integrator.fused_frame_renderer("02_physics-mesh", 64, 48, 2, 4)(3)
    assert image.device.type == "cuda" and image.shape == (48, 64, 3)
    assert kernels.counts == _launched("trace_fused_mesh")
    cpu = integrator.fused_frame_renderer("02_physics-mesh", 64, 48, 2, 4, "cpu")(3)
    diff = (image.cpu().int() - cpu.int()).abs()
    assert (diff <= 1).float().mean().item() >= 0.995


@pytest.mark.parametrize(
    "kernel,name",
    [("mesh_bounce", "03_physics-2-mesh"), ("sphere_bounce", "04_very-simple"),
     ("sphere_bounce", "03_physics-2")],
)
def test_cuda_bounce_kernel_matches_plain_version(cuda_device, kernel, name):
    """Each launch of a wavefront frame (bounce 0: every lane alive, lanes
    re-sorted; later bounces: a sorted dead tail) again through the kernel
    and through its plain version, on the same state."""
    scene = build_scene(name, 30, cuda_device)
    mesh = scene_mesh_set(name, 30, device=cuda_device) if kernel == "mesh_bounce" else None
    camera = integrator.scene_camera(name, 30, cuda_device)
    origins, directions, seed = integrator.frame_rays_and_seed(
        camera, 30, width=128, height=128, samples=4
    )
    launches: list = []
    compaction.trace_paths_wavefront(
        scene, origins, directions, seed, max_bounces=4, mesh=mesh, on_launch=launches.append
    )
    assert len(launches) >= 2 and launches[-1].live < launches[-1].bucket
    for launch in launches:
        args = (*launch.state, launch.live, seed, launch.bounce)
        kernels.reset_counts()
        if mesh is None:
            got = kernels.sphere_bounce(scene, *args, total_bounces=4)
            torch.cuda.synchronize()
            expected = kernels.sphere_bounce_reference(scene, *args, total_bounces=4)
        else:
            got = kernels.mesh_bounce(scene, mesh, *args, total_bounces=4)
            torch.cuda.synchronize()
            expected = kernels.mesh_bounce_reference(scene, mesh, *args, total_bounces=4)
        assert kernels.counts == {
            k: int(k in (kernel, f"{kernel}_reference")) for k in kernels.counts
        }
        close = torch.ones(launch.bucket, dtype=torch.bool, device=cuda_device)
        for have, want in zip(got[:4], expected[:4]):
            close &= torch.isclose(have, want, rtol=1e-4, atol=1e-4).all(dim=1)
        budget = max(1, round(0.001 * launch.bucket))
        assert (~close).sum().item() <= budget
        assert (got.alive != expected.alive).sum().item() <= budget
        assert not got.alive[launch.live:].any()
        assert (got.contribution[launch.live:] == 0).all()


def test_cuda_deep_mesh_tiers_go_through_the_kernel(cuda_device):
    """A deep mesh frame through the masked deep loop launches the
    per-bounce mesh kernel once per bounce; the wavefront driver gives the
    same image to the bit; both agree with the CPU render."""
    name = "03_physics-2-mesh"
    kernels.reset_counts()
    image = integrator.fused_frame_renderer(name, 64, 48, 2, 4)(3)
    assert image.device.type == "cuda" and image.shape == (48, 64, 3)
    assert kernels.counts == {k: 4 * (k == "mesh_bounce") for k in kernels.counts}
    kernels.reset_counts()
    launches: list = []
    wavefront = compaction.render_frame_wavefront(
        name, 3, width=64, height=48, samples=2, max_bounces=4, on_launch=launches.append
    )
    assert kernels.counts == {k: len(launches) * (k == "mesh_bounce") for k in kernels.counts}
    assert torch.equal(integrator.tonemap(wavefront), image)
    cpu = integrator.fused_frame_renderer(name, 64, 48, 2, 4, "cpu")(3)
    diff = (image.cpu().int() - cpu.int()).abs()
    assert (diff <= 1).float().mean().item() >= 0.995


def test_cuda_sphere_wavefront_goes_through_the_kernel(cuda_device):
    kernels.reset_counts()
    launches: list = []
    wavefront = compaction.render_frame_wavefront(
        "04_very-simple", 3, width=64, height=48, samples=2, max_bounces=4,
        on_launch=launches.append,
    )
    assert kernels.counts == {k: len(launches) * (k == "sphere_bounce") for k in kernels.counts}
    masked = integrator.render_frame(
        "04_very-simple", 3, width=64, height=48, samples=2, max_bounces=4
    )
    close = torch.isclose(wavefront, masked, rtol=1e-4, atol=1e-4).all(dim=-1)
    assert close.float().mean().item() >= 0.999


@pytest.mark.parametrize(
    "kernel,name,frames,size",
    [("pool_mesh_bounce", "03_physics-2-mesh", (30, 31), (64, 48, 2, 4096)),
     ("pool_sphere_bounce", "04_very-simple", (30, 31, 32), (64, 48, 2, 4096)),
     # The default window of 8 frames (the stacked tables take about 70 KB
     # of shared memory, past the default 48 KB) and the cap of 32 (too
     # large to stage, so read from global memory), the lanes of each
     # launch carrying many frame ids.
     ("pool_mesh_bounce", "03_physics-2-mesh", tuple(range(1, 9)), (16, 16, 1, 1024)),
     ("pool_mesh_bounce", "03_physics-2-mesh", tuple(range(1, 33)), (16, 16, 1, 1024))],
)
def test_cuda_pool_kernel_matches_plain_version(cuda_device, kernel, name, frames, size):
    """Every launch of a pool window (lanes of several frames at mixed
    bounces, a dead tail) again through the kernel and its plain version,
    and each frame's image against the CPU wavefront's."""
    width, height, samples, pool_width = size
    launches: list = []
    kernels.reset_counts()
    images, stats = raypool.render_batch_raypool(
        name, frames, width=width, height=height, samples=samples, max_bounces=4,
        pool_width=pool_width, frame_cap=len(frames), on_iteration=launches.append,
    )
    assert kernels.counts == {k: stats[0].iterations * (k == kernel) for k in kernels.counts}
    assert len(launches) == stats[0].iterations >= 4
    window = raypool.PoolWindow(
        name, frames, width=width, height=height, samples=samples, max_bounces=4,
        pool_width=pool_width, device=cuda_device,
    )
    wrapper, plain = getattr(kernels, kernel), getattr(kernels, f"{kernel}_reference")
    for launch in launches:
        live = int(launch.live)
        got = wrapper(window.ops, *launch.state, live, total_bounces=4)
        expected = plain(window.ops, *launch.state, live, total_bounces=4)
        torch.cuda.synchronize()
        close = torch.ones(window.pool, dtype=torch.bool, device=cuda_device)
        for have, want in zip(got[:4], expected[:4]):
            close &= torch.isclose(have, want, rtol=1e-4, atol=1e-4).all(dim=1)
        budget = max(1, round(0.001 * window.pool))
        assert (~close).sum().item() <= budget
        assert (got.alive != expected.alive).sum().item() <= budget
        assert not got.alive[live:].any() and (got.contribution[live:] == 0).all()
    for frame, image in zip(frames, images):
        # On the card, the wavefront runs the same bounce step on the same
        # rays; on the CPU, the rays differ in the last bits, and a few
        # rays meet a surface at an edge tie (the budget of the kernel
        # checks, per pixel).
        card, cpu = (
            compaction.render_frame_wavefront(
                name, frame, width=width, height=height, samples=samples, max_bounces=4,
                device=device,
            )
            for device in (cuda_device, "cpu")
        )
        assert (image - card).abs().max().item() <= 1e-5
        close = torch.isclose(image.cpu(), cpu, rtol=1e-4, atol=1e-4).all(dim=-1)
        assert (~close).sum().item() <= max(1, round(0.001 * close.numel()))


def test_cuda_backend_pool_tier_goes_through_the_kernel(cuda_device, tmp_path):
    """A deep mesh job's frame with two more queued: one pool window, every
    iteration one pool_mesh_bounce launch and nothing else; the queued
    frames come from the cache without a launch."""
    from tpu_render_cluster_torch.jobs.models import BlenderJob
    from tpu_render_cluster_torch.worker.backends.torch_raytrace import TorchRaytraceBackend

    job = BlenderJob.from_dict({
        "job_name": "03_physics-2-mesh_cuda", "job_description": None,
        "project_file_path": "%BASE%/p.blend", "render_script_path": "%BASE%/s.py",
        "frame_range_from": 1, "frame_range_to": 3, "wait_for_number_of_workers": 1,
        "frame_distribution_strategy": {"strategy_type": "naive-fine"},
        "output_directory_path": "%BASE%/frames", "output_file_name_format": "f-#####",
        "output_file_format": "PNG",
    })
    launches: list = []
    backend = TorchRaytraceBackend(
        width=64, height=48, samples=2, max_bounces=4, base_directory=tmp_path,
        on_iteration=launches.append,
    )
    import asyncio

    kernels.reset_counts()
    backend.note_upcoming_frames(job, (2, 3))
    asyncio.run(backend.render_frame(job, 1))
    backend.note_upcoming_frames(job, (3,))
    asyncio.run(backend.render_frame(job, 2))
    backend.note_upcoming_frames(job, ())
    asyncio.run(backend.render_frame(job, 3))
    assert launches and kernels.counts == {
        k: len(launches) * (k == "pool_mesh_bounce") for k in kernels.counts
    }
    assert len(list((tmp_path / "frames").glob("*.png"))) == 3


def test_cuda_pool_iterations_read_nothing_back(cuda_device):
    """A chunk of the loop's body under torch.cuda.set_sync_debug_mode
    ("error"): any synchronizing call inside it raises."""
    window = raypool.PoolWindow(  # 65,536 rays: at least 16 iterations serve rays
        "03_physics-2-mesh", (30, 31), width=128, height=128, samples=2, max_bounces=4,
        pool_width=4096, device=cuda_device,
    )
    state = window.iteration(window.initial_state(), 0)  # builds the kernel
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for index in range(1, 1 + raypool.CHECK_EVERY):
            state = window.iteration(state, index)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(state.counters[1]) == 1 + raypool.CHECK_EVERY
