"""The CUDA path-trace megakernel against its plain PyTorch version, on a GPU.

Needs a CUDA GPU and nvcc (the kernel has no CPU mode); skipped elsewhere.
Imports no jax, so it runs on a GPU machine without the JAX package's
dependencies: ``python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py``.

Tolerance as in tests/test_torch_kernels.py, rtol = atol = 1e-4 per ray:
every ray at 1 bounce, at least 99.9% at 4 bounces.
"""

from __future__ import annotations

import pytest
import torch

from tpu_render_cluster_torch.render import integrator, kernels
from tpu_render_cluster_torch.render.scene import build_scene

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc: the kernel has no CPU mode")
    return torch.device("cuda")


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
    assert kernels.counts == {"trace_fused": 1, "trace_fused_reference": 0}
    expected = kernels.trace_paths_fused_reference(
        scene, origins, directions, seed, max_bounces=max_bounces
    )
    close = torch.isclose(got, expected, rtol=1e-4, atol=1e-4).all(dim=1).float().mean().item()
    assert close >= (1.0 if max_bounces == 1 else 0.999), close


def test_cuda_frame_renderer_goes_through_the_kernel(cuda_device):
    kernels.reset_counts()
    image = integrator.fused_frame_renderer("01_simple-animation", 64, 48, 2, 4)(3)
    assert image.device.type == "cuda" and image.shape == (48, 64, 3)
    assert kernels.counts == {"trace_fused": 1, "trace_fused_reference": 0}
    cpu = integrator.fused_frame_renderer("01_simple-animation", 64, 48, 2, 4, "cpu")(3)
    diff = (image.cpu().int() - cpu.int()).abs()
    assert (diff <= 1).float().mean().item() >= 0.995
