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

The mesh kernels' tests run with ``use_tlas=False`` (the flat kernels) and
``use_tlas=None`` (the default, their TLAS variants on these scenes); the
TLAS variants' own checks are in tests/test_torch_tlas_cuda.py.
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


def _variant(kernel: str, use_tlas) -> str:
    """The mesh kernel a scene of these tests launches: the TLAS variant by
    default (more instances than a TLAS leaf), the flat one with False."""
    return kernel if use_tlas is False else f"{kernel}_tlas"


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


def _row1_rays(device, rays: int):
    """The first ``rays`` primary rays of 04_very-simple's frame 7 at
    256x256 x 8 spp (524,288: several waves of the kernel's resident
    threads), with its scene and seed."""
    scene = build_scene("04_very-simple", 7, device)
    camera = integrator.scene_camera("04_very-simple", 7, device)
    origins, directions, seed = integrator.frame_rays_and_seed(
        camera, 7, width=256, height=256, samples=8
    )
    return scene, origins[:rays], directions[:rays], seed


# Row 1 runs persistent blocks that take rays from a work counter: ragged
# widths, fewer rays than one wave of resident threads (4,097 and 65,536)
# and several waves (524,288), each bit-equal to the plain version.
@pytest.mark.parametrize("max_bounces", [0, 1, 4])
@pytest.mark.parametrize("rays", [1, 31, 33, 4097, 65536, 524288])
def test_cuda_row1_bit_equal_to_plain_version(cuda_device, rays, max_bounces):
    scene, origins, directions, seed = _row1_rays(cuda_device, rays)
    kernels.reset_counts()
    got = kernels.trace_paths_fused(scene, origins, directions, seed, max_bounces=max_bounces)
    torch.cuda.synchronize()
    assert kernels.counts == _launched("trace_fused")
    expected = kernels.trace_paths_fused_reference(
        scene, origins, directions, seed, max_bounces=max_bounces
    )
    assert torch.equal(got, expected)
    assert (got == 0).all() if max_bounces == 0 else (got > 0).any()


def test_cuda_row1_launches_in_a_row_reset_the_work_counter(cuda_device):
    """Back-to-back launches on one stream, no synchronisation between:
    through the wrapper, and through the C entry with one shared counter
    (which the entry clears on the stream before each kernel)."""
    scene, origins, directions, seed = _row1_rays(cuda_device, 300001)
    expected = kernels.trace_paths_fused_reference(scene, origins, directions, seed, max_bounces=4)
    kernels.reset_counts()
    first = kernels.trace_paths_fused(scene, origins, directions, seed, max_bounces=4)
    second = kernels.trace_paths_fused(scene, origins, directions, seed, max_bounces=4)
    torch.cuda.synchronize()
    assert kernels.counts["trace_fused"] == 2
    assert torch.equal(first, expected) and torch.equal(second, expected)
    library = kernels._library("trace_fused")
    spheres, params = kernels._sphere_operands(scene)
    counter = torch.full((1,), 7, dtype=torch.int32, device=cuda_device)
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    outputs = []
    for _ in range(2):
        radiance = torch.full_like(origins, float("nan"))
        status = library.trace_fused_launch(
            origins.data_ptr(), directions.data_ptr(), origins.shape[0], spheres.data_ptr(),
            spheres.shape[0], params.data_ptr(), int(seed), 4, radiance.data_ptr(),
            counter.data_ptr(), stream,
        )
        assert status == 0
        outputs.append(radiance)
    torch.cuda.synchronize()
    assert all(torch.equal(out, expected) for out in outputs)
    # The counter ends past the last ray: every ray was taken.
    assert int(counter) >= origins.shape[0]


def test_cuda_frame_renderer_goes_through_the_kernel(cuda_device):
    kernels.reset_counts()
    image = integrator.fused_frame_renderer("01_simple-animation", 64, 48, 2, 4)(3)
    assert image.device.type == "cuda" and image.shape == (48, 64, 3)
    assert kernels.counts == _launched("trace_fused")
    cpu = integrator.fused_frame_renderer("01_simple-animation", 64, 48, 2, 4, "cpu")(3)
    diff = (image.cpu().int() - cpu.int()).abs()
    assert (diff <= 1).float().mean().item() >= 0.995


@pytest.mark.parametrize("use_tlas", [False, None])
@pytest.mark.parametrize("max_bounces", [1, 4])
@pytest.mark.parametrize("name", ["02_physics-mesh", "03_physics-2-mesh"])
def test_cuda_mesh_kernel_matches_plain_version(cuda_device, name, max_bounces, use_tlas):
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
        scene, mesh, origins, directions, seed, max_bounces=max_bounces, use_tlas=use_tlas
    )
    torch.cuda.synchronize()
    assert kernels.counts == _launched(_variant("trace_fused_mesh", use_tlas))
    expected = kernels.trace_paths_fused_mesh_reference(
        scene, mesh, origins, directions, seed, max_bounces=max_bounces, use_tlas=use_tlas
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


@pytest.mark.parametrize("use_tlas", [False, None])
def test_cuda_mesh_frame_renderer_goes_through_the_kernel(cuda_device, use_tlas):
    kernels.reset_counts()
    image = integrator.fused_frame_renderer(
        "02_physics-mesh", 64, 48, 2, 4, use_tlas=use_tlas
    )(3)
    assert image.device.type == "cuda" and image.shape == (48, 64, 3)
    assert kernels.counts == _launched(_variant("trace_fused_mesh", use_tlas))
    cpu = integrator.fused_frame_renderer(
        "02_physics-mesh", 64, 48, 2, 4, "cpu", use_tlas=use_tlas
    )(3)
    diff = (image.cpu().int() - cpu.int()).abs()
    assert (diff <= 1).float().mean().item() >= 0.995


@pytest.mark.parametrize(
    "kernel,name,use_tlas",
    [("mesh_bounce", "03_physics-2-mesh", False), ("mesh_bounce", "03_physics-2-mesh", None),
     ("sphere_bounce", "04_very-simple", None), ("sphere_bounce", "03_physics-2", None)],
)
def test_cuda_bounce_kernel_matches_plain_version(cuda_device, kernel, name, use_tlas):
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
        scene, origins, directions, seed, max_bounces=4, mesh=mesh, on_launch=launches.append,
        use_tlas=use_tlas,
    )
    assert len(launches) >= 2 and launches[-1].live < launches[-1].bucket
    if mesh is not None:
        kernel = _variant(kernel, use_tlas)
    for launch in launches:
        args = (*launch.state, launch.live, seed, launch.bounce)
        kernels.reset_counts()
        if mesh is None:
            got = kernels.sphere_bounce(scene, *args, total_bounces=4)
            torch.cuda.synchronize()
            expected = kernels.sphere_bounce_reference(scene, *args, total_bounces=4)
        else:
            got = kernels.mesh_bounce(scene, mesh, *args, total_bounces=4, use_tlas=use_tlas)
            torch.cuda.synchronize()
            expected = kernels.mesh_bounce_reference(
                scene, mesh, *args, total_bounces=4, use_tlas=use_tlas
            )
        # A mesh launch brings its ordered walk's passes (sah: octant tables).
        launched = kernels.launch_names(kernel, mesh is not None)
        assert kernels.counts == {
            k: int(k in (*launched, f"{kernel}_reference")) for k in kernels.counts
        }
        close = torch.ones(launch.bucket, dtype=torch.bool, device=cuda_device)
        for have, want in zip(got[:4], expected[:4]):
            close &= torch.isclose(have, want, rtol=1e-4, atol=1e-4).all(dim=1)
        budget = max(1, round(0.001 * launch.bucket))
        assert (~close).sum().item() <= budget
        assert (got.alive != expected.alive).sum().item() <= budget
        assert not got.alive[launch.live:].any()
        assert (got.contribution[launch.live:] == 0).all()


@pytest.mark.parametrize("use_tlas", [False, None])
def test_cuda_deep_mesh_tiers_go_through_the_kernel(cuda_device, use_tlas):
    """A deep mesh frame through the masked deep loop launches the
    per-bounce mesh kernel once per bounce; the wavefront driver gives the
    same image to the bit; both agree with the CPU render."""
    name = "03_physics-2-mesh"
    kernel = _variant("mesh_bounce", use_tlas)
    kernels.reset_counts()
    image = integrator.fused_frame_renderer(name, 64, 48, 2, 4, use_tlas=use_tlas)(3)
    assert image.device.type == "cuda" and image.shape == (48, 64, 3)
    assert kernels.counts == {k: 4 * (k in kernels.launch_names(kernel)) for k in kernels.counts}
    kernels.reset_counts()
    launches: list = []
    wavefront = compaction.render_frame_wavefront(
        name, 3, width=64, height=48, samples=2, max_bounces=4, on_launch=launches.append,
        use_tlas=use_tlas,
    )
    assert kernels.counts == {
        k: len(launches) * (k in kernels.launch_names(kernel)) for k in kernels.counts
    }
    assert torch.equal(integrator.tonemap(wavefront), image)
    cpu = integrator.fused_frame_renderer(name, 64, 48, 2, 4, "cpu", use_tlas=use_tlas)(3)
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


@pytest.mark.parametrize("use_tlas", [False, None])
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
def test_cuda_pool_kernel_matches_plain_version(
    cuda_device, kernel, name, frames, size, use_tlas
):
    """Every launch of a pool window (lanes of several frames at mixed
    bounces, a dead tail) again through the kernel and its plain version,
    and each frame's image against the CPU wavefront's."""
    width, height, samples, pool_width = size
    options = {} if kernel == "pool_sphere_bounce" else {"use_tlas": use_tlas}
    launched = kernel if not options else _variant(kernel, use_tlas)
    launches: list = []
    kernels.reset_counts()
    images, stats = raypool.render_batch_raypool(
        name, frames, width=width, height=height, samples=samples, max_bounces=4,
        pool_width=pool_width, frame_cap=len(frames), on_iteration=launches.append, **options,
    )
    assert kernels.counts == {
        k: stats[0].iterations * (k in kernels.launch_names(launched)) for k in kernels.counts
    }
    assert len(launches) == stats[0].iterations >= 4
    window = raypool.PoolWindow(
        name, frames, width=width, height=height, samples=samples, max_bounces=4,
        pool_width=pool_width, device=cuda_device, **options,
    )
    wrapper, plain = getattr(kernels, kernel), getattr(kernels, f"{kernel}_reference")
    for launch in launches:
        live = int(launch.live)
        got = wrapper(window.ops, *launch.state, live, total_bounces=4, **options)
        expected = plain(window.ops, *launch.state, live, total_bounces=4, **options)
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
        # rays; on the CPU too: the card's primary rays are the CPU's bit
        # for bit (tests/test_torch_bvh_cuda.py), so no pixel needs an
        # edge-tie budget.
        card, cpu = (
            compaction.render_frame_wavefront(
                name, frame, width=width, height=height, samples=samples, max_bounces=4,
                device=device, **options,
            )
            for device in (cuda_device, "cpu")
        )
        assert (image - card).abs().max().item() <= 1e-5
        close = torch.isclose(image.cpu(), cpu, rtol=1e-4, atol=1e-4).all(dim=-1)
        assert (~close).sum().item() == 0


@pytest.mark.parametrize("use_tlas", [False, None])
def test_cuda_backend_pool_tier_goes_through_the_kernel(cuda_device, tmp_path, use_tlas):
    """A deep mesh job's frame with two more queued: one pool window, every
    iteration one pool_mesh_bounce launch (its TLAS variant by default) and
    nothing else; the queued frames come from the cache without a launch."""
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
        on_iteration=launches.append, use_tlas=use_tlas,
    )
    import asyncio

    kernels.reset_counts()
    backend.note_upcoming_frames(job, (2, 3))
    asyncio.run(backend.render_frame(job, 1))
    backend.note_upcoming_frames(job, (3,))
    asyncio.run(backend.render_frame(job, 2))
    backend.note_upcoming_frames(job, ())
    asyncio.run(backend.render_frame(job, 3))
    launched = kernels.launch_names(_variant("pool_mesh_bounce", use_tlas))
    assert launches and kernels.counts == {
        k: len(launches) * (k in launched) for k in kernels.counts
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


# ---------------------------------------------------------------------------
# The unit kernels of the per-bounce scan renderer (rows 7, 8, 11 and 12).
# Tolerances: the sphere nearest hit's t within rtol 2e-5 / atol 2e-4 and its
# index equal on every ray that hits, the sphere any-hit equal on every ray;
# the instanced nearest hit's t within 1e-4, its row and instance equal on
# every hit ray but an exact-tie budget of max(1, round(0.001 R)), the
# instanced any-hit equal on every ray but that budget.

UNIT_KERNELS = ("intersect_spheres", "occluded_spheres", "intersect_instances", "occluded_instances")


def _unit_launched(launches: dict[str, int]) -> dict[str, int]:
    """``kernels.counts`` after ``launches`` of the unit kernels and
    nothing else: no other kernel and no plain version."""
    return {name: launches.get(name, 0) for name in kernels.counts}


def _assert_unit_matches_plain(name: str, args: tuple, got) -> None:
    """One unit-kernel launch ``name(*args) -> got`` against its plain
    version on the same inputs, at the tolerances above."""
    expected = getattr(kernels, f"{name}_reference")(*args)
    if name == "intersect_spheres":
        assert torch.isclose(got[0], expected[0], rtol=2e-5, atol=2e-4).all()
        hit = expected[0] < 1e29
        assert torch.equal(got[1][hit], expected[1][hit])
    elif name == "intersect_instances":
        assert torch.isclose(got[0], expected[0], rtol=1e-4, atol=1e-4).all()
        hit = expected[0] < args[3]
        differ = hit & ((got[1] != expected[1]) | (got[2] != expected[2]))
        assert differ.sum().item() <= max(1, round(0.001 * hit.numel()))
    elif name == "occluded_spheres":
        assert torch.equal(got, expected)
    else:
        assert (got != expected).sum().item() <= max(1, round(0.001 * got.numel()))


def _frame_state(name: str, device, width=128, height=64):
    """Frame 30's camera rays (one sample) with a seed t from the scene's
    spheres and plane, a tenth of the lanes dead and parked as the scan
    parks them, and shadow rays toward the sun from the hit points."""
    from tpu_render_cluster_torch.render import geometry

    scene = build_scene(name, 30, device)
    camera = integrator.scene_camera(name, 30, device)
    origins, directions, _ = integrator.frame_rays_and_seed(
        camera, 30, width=width, height=height, samples=1
    )
    t, _, _ = geometry.intersect_scene(scene, origins, directions)
    generator = torch.Generator(device=device).manual_seed(7)
    dead = torch.rand(origins.shape[0], generator=generator, device=device) < 0.1
    up = torch.tensor([0.0, 1.0, 0.0], device=device)
    parked_o = torch.where(dead[:, None], 1e7, origins)
    parked_d = torch.where(dead[:, None], up, directions)
    init_t = torch.where(dead, 1e30, t)
    points = origins + directions * torch.clamp_max(t, 50.0)[:, None]
    sun = scene.sun_direction.expand_as(points).contiguous()
    already = dead | (torch.rand(origins.shape[0], generator=generator, device=device) < 0.2)
    return scene, (origins, directions), (parked_o, parked_d, init_t), (points + 0.004 * up, sun, already)


@pytest.mark.parametrize("name", ["04_very-simple", "03_physics-2", "03_physics-2-mesh"])
def test_cuda_sphere_unit_kernels_match_plain_versions(cuda_device, name):
    scene, rays, _, (shadow_o, sun, _) = _frame_state(name, cuda_device)
    for origins, directions in (rays, (shadow_o, sun)):
        kernels.reset_counts()
        got_hit = kernels.intersect_spheres(scene, origins, directions)
        got_shadow = kernels.occluded_spheres(scene, origins, directions)
        torch.cuda.synchronize()
        assert kernels.counts == _unit_launched({"intersect_spheres": 1, "occluded_spheres": 1})
        assert got_hit[0].is_cuda and got_hit[1].dtype == torch.int32
        _assert_unit_matches_plain("intersect_spheres", (scene, origins, directions), got_hit)
        _assert_unit_matches_plain("occluded_spheres", (scene, origins, directions), got_shadow)
        assert (got_hit[0] < 1e29).any() and got_shadow.any()


@pytest.mark.parametrize("name", ["03_physics-2-mesh", "02_physics-mesh"])
def test_cuda_instance_unit_kernels_match_plain_versions(cuda_device, name):
    _, _, (origins, directions, init_t), (shadow_o, sun, already) = _frame_state(name, cuda_device)
    mesh = scene_mesh_set(name, 30, device=cuda_device)
    kernels.reset_counts()
    nearest = kernels.intersect_instances(mesh, origins, directions, init_t)
    shadow = kernels.occluded_instances(mesh, shadow_o, sun, already)
    torch.cuda.synchronize()
    assert kernels.counts == _unit_launched({"intersect_instances": 1, "occluded_instances": 1})
    _assert_unit_matches_plain("intersect_instances", (mesh, origins, directions, init_t), nearest)
    _assert_unit_matches_plain("occluded_instances", (mesh, shadow_o, sun, already), shadow)
    assert (nearest[0] < init_t).any() and shadow[~already].any() and shadow[already].all()


@pytest.mark.parametrize(
    "n_faces,low,high",
    # As test_cuda_mesh_kernel_with_large_tables: 48-96 KB of tables, staged
    # past the default limit; beyond 96 KB, read from device memory.
    [(700, 48 * 1024, 96 * 1024), (None, 96 * 1024, 1 << 30)],
)
def test_cuda_instance_unit_kernels_with_large_tables(cuda_device, n_faces, low, high):
    vertices, faces = make_icosphere(3)
    bvh = build_bvh(vertices, faces[:n_faces], device=cuda_device)
    instances = build_mesh_instances("02_physics-mesh", 30, cuda_device)
    mesh = MeshSet(bvh, MeshInstances(*(field[:3] for field in instances)))
    table_bytes = 64 * bvh.v0.shape[0] + 48 * bvh.skip.shape[0] + 88 * 3
    assert low < table_bytes <= high, table_bytes
    _, _, (origins, directions, init_t), (shadow_o, sun, already) = _frame_state(
        "02_physics-mesh", cuda_device, 64, 64
    )
    nearest = kernels.intersect_instances(mesh, origins, directions, init_t)
    shadow = kernels.occluded_instances(mesh, shadow_o, sun, already)
    torch.cuda.synchronize()
    _assert_unit_matches_plain("intersect_instances", (mesh, origins, directions, init_t), nearest)
    _assert_unit_matches_plain("occluded_instances", (mesh, shadow_o, sun, already), shadow)
    assert (nearest[0] < init_t).any()


@pytest.mark.parametrize("name", ["03_physics-2-mesh", "04_very-simple"])
def test_cuda_backend_scan_tier_launches_the_unit_kernels(cuda_device, tmp_path, monkeypatch, name):
    """A frame through ``TorchRaytraceBackend(bounce_scan=True)``: each of
    the scene's unit kernels launches samples x max_bounces times and
    nothing else runs, no plain version and no path-trace kernel; every
    launch agrees with its plain version on its own inputs; the frame
    agrees with the scan tier's render on the CPU."""
    import asyncio

    from tpu_render_cluster_torch.jobs.models import BlenderJob
    from tpu_render_cluster_torch.worker.backends.torch_raytrace import TorchRaytraceBackend

    samples, bounces = 2, 4
    launches: list = []
    for unit in UNIT_KERNELS:
        def record(*args, _wrapper=getattr(kernels, unit), _unit=unit):
            out = _wrapper(*args)
            launches.append((_unit, args, out))
            return out

        monkeypatch.setattr(kernels, unit, record)
    job = BlenderJob.from_dict({
        "job_name": f"{name}_cuda-scan", "job_description": None,
        "project_file_path": "%BASE%/p.blend", "render_script_path": "%BASE%/s.py",
        "frame_range_from": 1, "frame_range_to": 2, "wait_for_number_of_workers": 1,
        "frame_distribution_strategy": {"strategy_type": "naive-fine"},
        "output_directory_path": "%BASE%/frames", "output_file_name_format": "f-#####",
        "output_file_format": "PNG",
    })
    backend = TorchRaytraceBackend(
        width=64, height=48, samples=samples, max_bounces=bounces, base_directory=tmp_path,
        bounce_scan=True, raypool="force",
    )
    backend.note_upcoming_frames(job, (2,))
    kernels.reset_counts()
    asyncio.run(backend.render_frame(job, 1))
    per_frame = samples * bounces
    used = UNIT_KERNELS if name.endswith("-mesh") else UNIT_KERNELS[:2]
    assert kernels.counts == _unit_launched({unit: per_frame for unit in used})
    assert len(launches) == per_frame * len(used)
    for unit, args, out in launches:
        _assert_unit_matches_plain(unit, args, out)
    monkeypatch.undo()
    card = integrator.fused_frame_renderer(name, 64, 48, samples, bounces, bounce_scan=True)(1)
    cpu = integrator.fused_frame_renderer(name, 64, 48, samples, bounces, "cpu", bounce_scan=True)(1)
    assert ((card.cpu().int() - cpu.int()).abs() <= 1).float().mean().item() >= 0.995
