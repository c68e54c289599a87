"""On a GPU: the single-BVH unit kernels (``csrc/intersect_mesh.cu``,
``csrc/occluded_mesh.cu``) against their plain versions, the scan's
per-instance branch through them, and the card's frame inputs (scene,
camera, mesh instances, primary rays) bit-equal to the CPU's.

Needs a CUDA GPU and nvcc (the kernels have no CPU mode); skipped elsewhere.
Imports no jax: ``python -m pytest -q -m cuda tests/test_torch_bvh_cuda.py``.

Tolerances, as tests/test_mesh.py's: the nearest hit's t within rtol = atol
= 1e-4 on every ray and its triangle row equal on every hit ray, the
any-hit equal on every ray, each but an exact-tie budget of max(1, round(0.001
R)) rays. The frame inputs: bit for bit, 0 differing elements. Whole frames:
at least 99.5% of uint8 values within 1.
"""

from __future__ import annotations

import asyncio

import pytest
import torch

from tpu_render_cluster_torch.render import geometry, integrator, kernels, parity
from tpu_render_cluster_torch.render.mesh import (
    _rays_to_object_space,
    build_bvh,
    intersect_triangles_brute,
    make_icosphere,
    scene_mesh_set,
)
from tpu_render_cluster_torch.render.scene import SCENE_NAMES, build_scene

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc: the kernel has no CPU mode")
    return torch.device("cuda")


def _launched(launches: dict[str, int]) -> dict[str, int]:
    return {name: launches.get(name, 0) for name in kernels.counts}


def _assert_matches_plain(name: str, args: tuple, got) -> None:
    """One launch ``name(*args) -> got`` against its plain version on the
    same inputs, at the tolerances above."""
    expected = getattr(kernels, f"{name}_reference")(*args)
    budget = max(1, round(0.001 * args[1].shape[0]))
    if name == "intersect_mesh":
        assert torch.isclose(got[0], expected[0], rtol=1e-4, atol=1e-4).all()
        hit = expected[0] < args[3]
        assert (hit & (got[1] != expected[1])).sum().item() <= budget
        assert (got[1][~hit] == 0).all() and torch.equal(got[0][~hit], args[3][~hit])
    else:
        assert (got != expected).sum().item() <= budget
        assert got[args[3]].all()


def _object_rays(name: str, device, k: int, width=128, height=64):
    """Frame 30's camera rays (one sample) in instance ``k``'s object space,
    seeded with the sphere/plane t, a tenth of the lanes dead and parked as
    the scan parks them; and shadow rays toward the sun from the hit points
    with an ``already`` mask, in the same object space."""
    scene = build_scene(name, 30, device)
    mesh = scene_mesh_set(name, 30, device=device)
    camera = integrator.scene_camera(name, 30, device)
    origins, directions, _ = integrator.frame_rays_and_seed(
        camera, 30, width=width, height=height, samples=1
    )
    t, _, _ = geometry.intersect_scene(scene, origins, directions)
    generator = torch.Generator(device=device).manual_seed(k)
    dead = torch.rand(origins.shape[0], generator=generator, device=device) < 0.1
    up = torch.tensor([0.0, 1.0, 0.0], device=device)
    parked_o = torch.where(dead[:, None], 1e7, origins)
    parked_d = torch.where(dead[:, None], up, directions)
    init_t = torch.where(dead, 1e30, t)
    points = origins + directions * torch.clamp_max(t, 50.0)[:, None] + 0.004 * up
    sun = scene.sun_direction.expand_as(points).contiguous()
    already = dead | (torch.rand(origins.shape[0], generator=generator, device=device) < 0.2)
    lo, ld = _rays_to_object_space(mesh.instances, k, parked_o, parked_d)
    so, sd = _rays_to_object_space(mesh.instances, k, points, sun)
    return mesh.bvh, (lo, ld, init_t), (so, sd, already)


@pytest.mark.parametrize("name", ["03_physics-2-mesh", "02_physics-mesh"])
def test_cuda_bvh_unit_kernels_match_plain_versions(cuda_device, name):
    hits = shadows = 0
    for k in (0, 5, 17, 23):
        bvh, (lo, ld, init_t), (so, sd, already) = _object_rays(name, cuda_device, k)
        kernels.reset_counts()
        nearest = kernels.intersect_mesh(bvh, lo, ld, init_t)
        shadow = kernels.occluded_mesh(bvh, so, sd, already)
        torch.cuda.synchronize()
        assert kernels.counts == _launched({"intersect_mesh": 1, "occluded_mesh": 1})
        assert nearest[0].is_cuda and nearest[1].dtype == torch.int32 and shadow.dtype == torch.bool
        _assert_matches_plain("intersect_mesh", (bvh, lo, ld, init_t), nearest)
        _assert_matches_plain("occluded_mesh", (bvh, so, sd, already), shadow)
        hits += int((nearest[0] < init_t).sum())
        shadows += int(shadow[~already].sum())
    assert hits > 0 and shadows > 0


def test_cuda_bvh_unit_kernels_against_brute_force(cuda_device):
    """Unseeded, on rays aimed at the icosphere: the kernel's nearest hit is
    brute force's (t within 1e-5), and its any-hit is "brute force hits"."""
    generator = torch.Generator(device=cuda_device).manual_seed(2)
    bvh = scene_mesh_set("03_physics-2-mesh", 30, device=cuda_device).bvh
    origins = torch.randn(4096, 3, generator=generator, device=cuda_device) * 0.3
    origins[:, 2] -= 3.0
    directions = torch.tensor([0.0, 0.0, 1.0], device=cuda_device) + 0.3 * torch.randn(
        4096, 3, generator=generator, device=cuda_device
    )
    directions = directions / directions.norm(dim=1, keepdim=True)
    t, row = kernels.intersect_mesh(bvh, origins, directions, torch.full((4096,), 1e30, device=cuda_device))
    t_brute, row_brute = intersect_triangles_brute(bvh, origins, directions)
    assert torch.isclose(t, t_brute, rtol=1e-5, atol=1e-5).all()
    hit = t_brute < 1e29
    assert hit.sum() > 100 and (hit & (row != row_brute)).sum().item() <= max(1, round(0.001 * 4096))
    none = torch.zeros(4096, dtype=torch.bool, device=cuda_device)
    assert (kernels.occluded_mesh(bvh, origins, directions, none) != hit).sum().item() <= 4


@pytest.mark.parametrize(
    "n_faces,low,high",
    # As tests/test_torch_kernels_cuda.py: 48-96 KB of tables, staged past
    # the default limit; beyond 96 KB, read from device memory.
    [(700, 48 * 1024, 96 * 1024), (None, 96 * 1024, 1 << 30)],
)
def test_cuda_bvh_unit_kernels_with_large_tables(cuda_device, n_faces, low, high):
    vertices, faces = make_icosphere(3)
    bvh = build_bvh(vertices, faces[:n_faces], device=cuda_device)
    assert low < 64 * bvh.v0.shape[0] + 48 * bvh.skip.shape[0] <= high
    generator = torch.Generator(device=cuda_device).manual_seed(3)
    origins = torch.randn(8192, 3, generator=generator, device=cuda_device) * 0.2
    origins[:, 2] -= 2.0
    directions = torch.tensor([0.0, 0.0, 1.0], device=cuda_device) + 0.25 * torch.randn(
        8192, 3, generator=generator, device=cuda_device
    )
    directions = directions / directions.norm(dim=1, keepdim=True)
    init_t = torch.where(torch.rand(8192, generator=generator, device=cuda_device) < 0.3, 2.0, 1e30)
    already = torch.rand(8192, generator=generator, device=cuda_device) < 0.3
    nearest = kernels.intersect_mesh(bvh, origins, directions, init_t)
    shadow = kernels.occluded_mesh(bvh, origins, directions, already)
    torch.cuda.synchronize()
    _assert_matches_plain("intersect_mesh", (bvh, origins, directions, init_t), nearest)
    _assert_matches_plain("occluded_mesh", (bvh, origins, directions, already), shadow)
    assert (nearest[0] < init_t).any()


@pytest.mark.parametrize("name", SCENE_NAMES)
def test_cuda_frame_inputs_equal_the_cpus(cuda_device, name):
    """Scene, camera, instances and the primary rays of the three ray
    builders on the card, bit for bit the CPU's, on several frames."""
    for frame in (1, 30, 77):
        card = parity.frame_inputs(name, frame, cuda_device, width=96, height=64, samples=4)
        cpu = parity.frame_inputs(name, frame, "cpu", width=96, height=64, samples=4)
        assert all(t.device.type == "cuda" for k, t in card.items() if k != "trace_seed")
        differing = parity.differing_elements(card, cpu)
        assert sum(differing.values()) == 0, {k: v for k, v in differing.items() if v}


def test_cuda_backend_per_instance_scan_launches_rows_9_and_10(cuda_device, tmp_path, monkeypatch):
    """A frame through ``TorchRaytraceBackend(bounce_scan=True,
    per_instance=True)``: the single-BVH kernels launch once per instance,
    sample and bounce, the sphere unit kernels once per sample and bounce,
    and nothing else runs; every launch agrees with its plain version on
    its own inputs; the frame agrees with the per-instance scan on the CPU
    and with the instanced scan on the card."""
    from tpu_render_cluster_torch.jobs.models import BlenderJob
    from tpu_render_cluster_torch.worker.backends.torch_raytrace import TorchRaytraceBackend

    name, samples, bounces, width, height = "03_physics-2-mesh", 2, 4, 64, 48
    launches: list = []
    for unit in ("intersect_mesh", "occluded_mesh"):
        def record(*args, _wrapper=getattr(kernels, unit), _unit=unit):
            out = _wrapper(*args)
            launches.append((_unit, args, out))
            return out

        monkeypatch.setattr(kernels, unit, record)
    job = BlenderJob.from_dict({
        "job_name": f"{name}_cuda-per-instance", "job_description": None,
        "project_file_path": "%BASE%/p.blend", "render_script_path": "%BASE%/s.py",
        "frame_range_from": 1, "frame_range_to": 1, "wait_for_number_of_workers": 1,
        "frame_distribution_strategy": {"strategy_type": "naive-fine"},
        "output_directory_path": "%BASE%/frames", "output_file_name_format": "f-#####",
        "output_file_format": "PNG",
    })
    backend = TorchRaytraceBackend(
        width=width, height=height, samples=samples, max_bounces=bounces,
        base_directory=tmp_path, bounce_scan=True, per_instance=True,
    )
    kernels.reset_counts()
    asyncio.run(backend.render_frame(job, 1))
    steps = samples * bounces
    assert kernels.counts == _launched({
        "intersect_mesh": 48 * steps, "occluded_mesh": 48 * steps,
        "intersect_spheres": steps, "occluded_spheres": steps,
    })
    assert len(launches) == 2 * 48 * steps
    for unit, args, out in launches:
        _assert_matches_plain(unit, args, out)
    monkeypatch.undo()
    renders = {
        (device, per_instance): integrator.fused_frame_renderer(
            name, width, height, samples, bounces, device, bounce_scan=True,
            per_instance=per_instance,
        )(1).cpu().int()
        for device, per_instance in ((None, True), ("cpu", True), (None, False))
    }
    card = renders[(None, True)]
    for other in (renders[("cpu", True)], renders[(None, False)]):
        assert ((card - other).abs() <= 1).float().mean().item() >= 0.995
