"""The group-walk TLAS kernels against their plain PyTorch versions on a
GPU, bit for bit: ``pool_mesh_bounce_tlas`` (row 6: frame-range staging by
bulk copy) and ``mesh_bounce_tlas`` (row 4: persistent blocks fetching rays
from a work counter), at every group size G of the sweep (1, 2, 4, 8) and at
the wrappers' own choice.

Needs a CUDA GPU and nvcc (the kernels have no CPU mode); skipped elsewhere.
Imports no jax: ``python -m pytest -q -m cuda tests/test_torch_tlas_group_cuda.py``.

Tolerance: none. On every lane the five state outputs, alive and the key
column equal the plain version's to the bit. Launches: a sorted pool window
of ``03_physics-2-mesh`` (its first, middle and last launch); the middle one
with its lanes shuffled so that every block holds lanes of all 8 frames;
frame ids outside the window on dead lanes and on lanes past the live
count (the plain version refuses a live one); live counts 0, 1, P - 1 and
P; widths that are no multiple of 32 G; a window whose K is odd (47
instances: a frame's slot rows are 4,136 bytes, so a bulk copy's ends are
ragged); tables past the 96 KB staging budget (a subdivided icosphere's
BVH); the per-bounce kernel at every launch width of a wavefront frame, on
the odd K and past the budget; and two per-bounce launches in a row on one
stream, which share the work counter.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tpu_render_cluster_torch.render import compaction, integrator, kernels, raypool
from tpu_render_cluster_torch.render.mesh import (
    MeshSet,
    build_bvh,
    make_icosphere,
    scene_mesh_set,
)
from tpu_render_cluster_torch.render.scene import build_scene

pytestmark = pytest.mark.cuda

DEEP = "03_physics-2-mesh"
BOUNCES = 4
GROUPS = (None, 1, 2, 4, 8)  # None: the wrapper's choice


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc: the kernel has no CPU mode")
    return torch.device("cuda")


def _assert_equal(got, expected, what: str) -> None:
    for name, have, want in zip(got._fields, got, expected):
        assert torch.equal(have, want), f"{what}: {name} differs on {int((have != want).sum())} values"


def _odd_mesh(mesh: MeshSet) -> MeshSet:
    """The frame's first 47 instances: an odd K."""
    return MeshSet(bvh=mesh.bvh, instances=type(mesh.instances)(*(t[:47] for t in mesh.instances)))


def _big_mesh(mesh: MeshSet, device) -> MeshSet:
    """The frame's instances on an icosphere subdivided 4 times: a BVH of
    5,120 triangles, past the 96 KB staging budget with any K."""
    return MeshSet(bvh=build_bvh(*make_icosphere(4), device=device), instances=mesh.instances)


def _window(device, frames, mesh_map=None, size=(32, 24, 2), pool_width=2048):
    """A pool window of the deep scene and every launch's input, sorted as
    the pool sorts them."""
    width, height, samples = size
    window = raypool.PoolWindow(
        DEEP, frames, width=width, height=height, samples=samples, max_bounces=BOUNCES,
        pool_width=pool_width, device=device,
    )
    if mesh_map is not None:
        scenes = [build_scene(DEEP, f, device) for f in frames]
        meshes = [mesh_map(scene_mesh_set(DEEP, f, device=device)) for f in frames]
        window.ops = window.mesh_ops = kernels.pool_mesh_operands(scenes, meshes)
    launches: list = []
    state = window.initial_state()
    while bool(window.more(state)):
        state = window.iteration(state, len(launches), launches.append)
    return window, launches


def _check_pool(window, state, live) -> None:
    expected = kernels.pool_mesh_bounce_reference(window.ops, *state, live, total_bounces=BOUNCES)
    for group in GROUPS:
        got = kernels.pool_mesh_bounce(
            window.ops, *state, live, total_bounces=BOUNCES, _group=group
        )
        torch.cuda.synchronize()
        _assert_equal(got, expected, f"pool launch, G {group}, live {live}")


def test_cuda_group_pool_sorted_launches(cuda_device):
    window, launches = _window(cuda_device, list(range(1, 9)))
    for launch in (launches[0], launches[len(launches) // 2], launches[-1]):
        _check_pool(window, launch.state, int(launch.live))


def test_cuda_group_pool_unsorted_and_outside_the_window(cuda_device):
    """The middle launch with its lanes shuffled (every block holds lanes of
    all 8 frames: the frame tables are read from global memory), then with
    frame ids outside the window on dead lanes and on lanes past the live
    count (the plain version refuses a live lane outside the window)."""
    window, launches = _window(cuda_device, list(range(1, 9)))
    state = launches[len(launches) // 2].state
    pool = state[0].shape[0]
    rng = np.random.default_rng(5)
    fid = torch.as_tensor(rng.integers(0, 8, pool), dtype=torch.int32, device=cuda_device)
    mixed = list(state)
    mixed[5] = fid
    mixed[6] = window.seeds[fid.long()]
    perm = torch.as_tensor(rng.permutation(pool), device=cuda_device)
    shuffled = tuple(t[perm] for t in mixed)
    assert shuffled[5][:64].unique().numel() == 8  # a block of 64 lanes at G = 4
    _check_pool(window, shuffled, pool)
    outside = [t.clone() for t in shuffled]
    outside[3][::7], outside[5][::7] = False, -1
    outside[3][3::7], outside[5][3::7] = False, 8
    live = pool - 100
    outside[5][live:] = 31
    _check_pool(window, tuple(outside), live)


def test_cuda_group_pool_live_counts_and_ragged_widths(cuda_device):
    window, launches = _window(cuda_device, list(range(1, 9)))
    state = launches[len(launches) // 3].state
    pool = state[0].shape[0]
    for live in (0, 1, pool - 1, pool):
        _check_pool(window, state, live)
    for width in (1000, 37):
        _check_pool(window, tuple(t[:width] for t in state), width)


def test_cuda_group_pool_odd_k_and_past_the_budget(cuda_device):
    """Three frames of 47 instances (frame 1's slot rows start at an odd
    multiple of 47 x 88 bytes), and two frames whose BVH passes 96 KB."""
    window, launches = _window(cuda_device, [1, 2, 3], _odd_mesh)
    assert window.ops.per_frame == 47
    for launch in (launches[0], launches[len(launches) // 2], launches[-1]):
        _check_pool(window, launch.state, int(launch.live))
    window, launches = _window(cuda_device, [1, 2], lambda m: _big_mesh(m, cuda_device),
                               size=(16, 16, 1), pool_width=512)
    for launch in (launches[0], launches[-1]):
        _check_pool(window, launch.state, int(launch.live))


def _wavefront(device, mesh_map=None, side=64, samples=2):
    scene = build_scene(DEEP, 30, device)
    mesh = scene_mesh_set(DEEP, 30, device=device)
    if mesh_map is not None:
        mesh = mesh_map(mesh)
    origins, directions, seed = integrator.frame_rays_and_seed(
        integrator.scene_camera(DEEP, 30, device), 30, width=side, height=side, samples=samples
    )
    launches: list = []
    compaction.trace_paths_wavefront(
        scene, origins, directions, seed, max_bounces=BOUNCES, mesh=mesh,
        on_launch=launches.append,
    )
    return scene, mesh, seed, launches


def _check_bounce(scene, mesh, seed, launch, live=None) -> None:
    live = launch.live if live is None else live
    args = (*launch.state, live, seed, launch.bounce)
    expected = kernels.mesh_bounce_reference(scene, mesh, *args, total_bounces=BOUNCES)
    for group in GROUPS:
        got = kernels.mesh_bounce(scene, mesh, *args, total_bounces=BOUNCES, _group=group)
        torch.cuda.synchronize()
        _assert_equal(got, expected, f"bounce {launch.bounce}, G {group}, live {live}")


def test_cuda_group_bounce_every_width(cuda_device):
    """Every launch of a 64x64 2 spp wavefront frame (widths 8,192 down to
    the last bucket), the first also at live counts 0, 1 and R - 1."""
    scene, mesh, seed, launches = _wavefront(cuda_device)
    assert len({launch.bucket for launch in launches}) >= 2
    for launch in launches:
        _check_bounce(scene, mesh, seed, launch)
    rays = launches[0].bucket
    for live in (0, 1, rays - 1):
        _check_bounce(scene, mesh, seed, launches[0], live)


def test_cuda_group_bounce_odd_k_and_past_the_budget(cuda_device):
    for mesh_map, side in ((_odd_mesh, 48), (lambda m: _big_mesh(m, cuda_device), 16)):
        scene, mesh, seed, launches = _wavefront(cuda_device, mesh_map, side=side, samples=1)
        for launch in launches[:2]:
            _check_bounce(scene, mesh, seed, launch)


def test_cuda_group_bounce_launches_in_a_row(cuda_device):
    """Two launches on one stream without a synchronisation between them:
    the second clears the work counter the first used up."""
    scene, mesh, seed, launches = _wavefront(cuda_device)
    first, second = launches[0], launches[1]
    outputs = []
    for launch in (first, second, first):
        outputs.append(kernels.mesh_bounce(
            scene, mesh, *launch.state, launch.live, seed, launch.bounce, total_bounces=BOUNCES
        ))
    torch.cuda.synchronize()
    for launch, got in zip((first, second, first), outputs):
        expected = kernels.mesh_bounce_reference(
            scene, mesh, *launch.state, launch.live, seed, launch.bounce, total_bounces=BOUNCES
        )
        _assert_equal(got, expected, f"bounce {launch.bounce} in a row")
