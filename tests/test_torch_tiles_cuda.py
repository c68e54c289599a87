"""Row 1's lane mode (``csrc/trace_fused_lanes.cu``) and the tile region
paths on a GPU.

Needs a CUDA GPU and nvcc (the kernels have no CPU mode); skipped elsewhere.
Imports no jax: ``python -m pytest -q -m cuda tests/test_torch_tiles_cuda.py``.

Tolerances: the lane kernel against its plain version on the card (also on
ragged widths and a permuted lane row) and against the positional kernel on
lanes 0..R-1: bit for bit; stitched region renders against the whole
frame's: bit for bit.
"""

from __future__ import annotations

import pytest
import torch

from tpu_render_cluster_torch.jobs.tiles import tile_bounds
from tpu_render_cluster_torch.render import compaction, integrator, kernels
from tpu_render_cluster_torch.render.scene import build_scene

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("max_bounces", [1, 4])
def test_cuda_lane_kernel_matches_plain_and_positional(cuda_device, max_bounces):
    scene = build_scene("04_very-simple", 7, cuda_device)
    camera = integrator.scene_camera("04_very-simple", 7, cuda_device)
    y0, x0, th, tw = tile_bounds(3, (2, 2), width=128, height=128)
    origins, directions, lanes, seed = integrator.region_rays_and_seed(
        camera, 7, width=128, height=128, samples=4, y0=y0, x0=x0, tile_height=th, tile_width=tw
    )
    kernels.reset_counts()
    got = kernels.trace_paths_fused(
        scene, origins, directions, seed, max_bounces=max_bounces, lane=lanes
    )
    torch.cuda.synchronize()
    assert kernels.counts == {name: int(name == "trace_fused_lanes") for name in kernels.counts}
    expected = kernels.trace_paths_fused_reference(
        scene, origins, directions, seed, max_bounces=max_bounces, lane=lanes
    )
    assert torch.equal(got, expected)
    arange = torch.arange(origins.shape[0], dtype=torch.int32, device=cuda_device)
    assert torch.equal(
        kernels.trace_paths_fused(scene, origins, directions, seed, max_bounces=max_bounces,
                                  lane=arange),
        kernels.trace_paths_fused(scene, origins, directions, seed, max_bounces=max_bounces),
    )


# Row 1's lane mode takes rays from a work counter in persistent blocks:
# ragged widths and a permuted lane row (the lanes of a shuffled frame, so
# no two neighbouring rays have neighbouring lanes), bit-equal to the plain
# version at 0, 1 and 4 bounces.
@pytest.mark.parametrize("max_bounces", [0, 1, 4])
@pytest.mark.parametrize("rays", [1, 31, 33, 4097, 524288])
def test_cuda_lane_kernel_on_a_permuted_lane_row(cuda_device, rays, max_bounces):
    scene = build_scene("04_very-simple", 7, cuda_device)
    camera = integrator.scene_camera("04_very-simple", 7, cuda_device)
    origins, directions, seed = integrator.frame_rays_and_seed(
        camera, 7, width=256, height=256, samples=8
    )
    generator = torch.Generator(device=cuda_device).manual_seed(rays)
    order = torch.randperm(origins.shape[0], generator=generator, device=cuda_device)[:rays]
    lanes = order.to(torch.int32)
    kernels.reset_counts()
    got = kernels.trace_paths_fused(
        scene, origins[order], directions[order], seed, max_bounces=max_bounces, lane=lanes
    )
    torch.cuda.synchronize()
    assert kernels.counts == {name: int(name == "trace_fused_lanes") for name in kernels.counts}
    expected = kernels.trace_paths_fused_reference(
        scene, origins[order], directions[order], seed, max_bounces=max_bounces, lane=lanes
    )
    assert torch.equal(got, expected)
    if rays > 1 and max_bounces > 0:
        # The whole frame's rays in shuffled order give the shuffled radiance.
        whole = kernels.trace_paths_fused(scene, origins, directions, seed,
                                          max_bounces=max_bounces)
        assert torch.equal(got, whole[order])


@pytest.mark.parametrize("scene_name", ["04_very-simple", "03_physics-2-mesh"])
def test_cuda_stitched_regions_equal_the_whole_frame(cuda_device, scene_name):
    kw = dict(width=96, height=80, samples=2, max_bounces=4)
    whole = integrator.render_frame(scene_name, 3, device=cuda_device, **kw)
    wavefront = compaction.render_frame_wavefront(scene_name, 3, device=cuda_device, **kw)
    stitched, stitched_wavefront = torch.zeros_like(whole), torch.zeros_like(whole)
    for tile in range(6):
        y0, x0, th, tw = tile_bounds(tile, (3, 2), width=kw["width"], height=kw["height"])
        region = dict(y0=y0, x0=x0, tile_height=th, tile_width=tw)
        stitched[y0:y0 + th, x0:x0 + tw] = integrator.render_frame_region(
            scene_name, 3, device=cuda_device, **region, **kw
        )
        stitched_wavefront[y0:y0 + th, x0:x0 + tw] = compaction.render_region_wavefront(
            scene_name, 3, device=cuda_device, **region, **kw
        )
    # 04: the lane kernel's tiles against the positional kernel's frame;
    # 03: the masked deep loop with whole-frame lanes against without.
    assert torch.equal(stitched, whole)
    assert torch.equal(stitched_wavefront, wavefront)
