"""The scan's instance kernels against their plain PyTorch versions on a GPU,
bit for bit: ``intersect_instances`` (row 7) and ``occluded_instances``
(row 8), the flat instance sweep walked by a group of G threads a ray
(``GroupFlat``) in persistent blocks that stage their tables once and fetch
rays from a work counter, the any-hit compacting each warp's walking lanes
(by default each warp picks G for its batch).

Needs a CUDA GPU and nvcc (the kernels have no CPU mode); skipped elsewhere.
Imports no jax: ``python -m pytest -q -m cuda tests/test_torch_instances_group_cuda.py``.

Tolerance: none. On every lane the nearest hit's t, triangle row and
instance, and the any-hit, equal the plain version's to the bit. Launches:
the scan's own inputs at bounces 0 and 2 of a 256x256 frame of
``03_physics-2-mesh`` (65,536 rays), cut or repeated to widths 1, 31, 33,
65,537 and 262,144, at every group size G (1, 2, 4, 8) and at the wrappers'
own choice (row 8's: G = 0, each warp's pick); a table of 47 instances (odd
K: the slot rows' bulk copy has ragged ends); tables past the 96 KB staging
budget (a subdivided icosphere's BVH, read from global memory); ``already``
all set, none set and mixed; and rows 7, 8 and 4 (``mesh_bounce_tlas``)
launched in a row on one stream without a synchronisation, which share the
work counter.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from tpu_render_cluster_torch.render import compaction, integrator, kernels
from tpu_render_cluster_torch.render.mesh import MeshSet, build_bvh, make_icosphere
from tpu_render_cluster_torch.render.scene import build_scene

pytestmark = pytest.mark.cuda

DEEP = "03_physics-2-mesh"
FRAME = 1
BOUNCES = 4
GROUPS = (None, 1, 2, 4, 8)  # None: the wrapper's choice
WIDTHS = (1, 31, 33, 65_537, 262_144)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc: the kernel has no CPU mode")
    return torch.device("cuda")


@functools.cache
def _scan_launches(side: int = 256):
    """The instance kernels' inputs at every bounce of one sample of a
    side x side scan frame: (mesh, [(intersect's (origins, directions,
    init_t), occluded's (origins, directions, already)) per bounce])."""
    log = {"intersect_instances": [], "occluded_instances": []}
    saved = {name: getattr(kernels, name) for name in log}

    def recorder(name):
        def record(mesh, *args):
            log[name].append((mesh, args))
            return saved[name](mesh, *args)
        return record

    try:
        for name in log:
            setattr(kernels, name, recorder(name))
        integrator.render_frame(DEEP, FRAME, width=side, height=side, samples=1,
                                max_bounces=BOUNCES, device=torch.device("cuda"),
                                bounce_scan=True)
    finally:
        for name, wrapper in saved.items():
            setattr(kernels, name, wrapper)
    mesh = log["intersect_instances"][0][0]
    return mesh, [(log["intersect_instances"][b][1], log["occluded_instances"][b][1])
                  for b in range(BOUNCES)]


def _width(tensors, width: int):
    """The launch's per-ray inputs cut or repeated to ``width`` rays."""
    rays = tensors[0].shape[0]
    index = torch.arange(width, device=tensors[0].device) % rays
    return tuple(t[index].contiguous() for t in tensors)


def _odd_mesh(mesh: MeshSet) -> MeshSet:
    """The frame's first 47 instances: an odd K."""
    return MeshSet(bvh=mesh.bvh, instances=type(mesh.instances)(*(t[:47] for t in mesh.instances)))


def _big_mesh(mesh: MeshSet, device) -> MeshSet:
    """The frame's instances on an icosphere subdivided 4 times: a BVH of
    5,120 triangles, past the 96 KB staging budget."""
    return MeshSet(bvh=build_bvh(*make_icosphere(4), device=device), instances=mesh.instances)


def _check_intersect(mesh, rays, what: str) -> None:
    expected = kernels.intersect_instances_reference(mesh, *rays)
    for group in GROUPS:
        got = kernels.intersect_instances(mesh, *rays, _group=group)
        torch.cuda.synchronize()
        for name, have, want in zip(("t", "row", "instance"), got, expected):
            assert torch.equal(have, want), (
                f"{what}, G {group}: {name} differs on {int((have != want).sum())} rays"
            )


def _check_occluded(mesh, rays, what: str) -> None:
    expected = kernels.occluded_instances_reference(mesh, *rays)
    for group in GROUPS:
        got = kernels.occluded_instances(mesh, *rays, _group=group)
        torch.cuda.synchronize()
        assert torch.equal(got, expected), (
            f"{what}, G {group}: differs on {int((got != expected).sum())} rays"
        )


@pytest.mark.parametrize("width", WIDTHS)
def test_cuda_instances_every_group_and_width(cuda_device, width):
    """Bounce 0 (camera rays seeded with the sphere/plane hits) and bounce 2
    (most lanes parked dead, few walkers) at each width."""
    mesh, launches = _scan_launches()
    for bounce in (0, 2):
        nearest, shadow = launches[bounce]
        _check_intersect(mesh, _width(nearest, width), f"bounce {bounce}, {width} rays")
        _check_occluded(mesh, _width(shadow, width), f"bounce {bounce}, {width} rays")


def test_cuda_instances_odd_k_and_past_the_budget(cuda_device):
    mesh, launches = _scan_launches()
    for mapped, label in ((_odd_mesh(mesh), "K 47"), (_big_mesh(mesh, cuda_device), "past 96 KB")):
        for bounce in (0, 1):
            nearest, shadow = launches[bounce]
            _check_intersect(mapped, _width(nearest, 20_000), f"{label}, bounce {bounce}")
            _check_occluded(mapped, _width(shadow, 20_000), f"{label}, bounce {bounce}")


@pytest.mark.parametrize("mode", ["all", "none", "mixed"])
def test_cuda_occluded_already(cuda_device, mode):
    """No lane walks (every output 1, written all the same), every lane
    walks, and a random 70% set, on bounce 0's shadow rays."""
    mesh, launches = _scan_launches()
    origins, directions, _ = launches[0][1]
    n = origins.shape[0]
    already = {
        "all": torch.ones(n, dtype=torch.bool, device=cuda_device),
        "none": torch.zeros(n, dtype=torch.bool, device=cuda_device),
        "mixed": torch.as_tensor(np.random.default_rng(10).random(n) < 0.7, device=cuda_device),
    }[mode]
    _check_occluded(mesh, (origins, directions, already), f"already {mode}")
    if mode == "all":
        got = kernels.occluded_instances(mesh, origins, directions, already)
        assert bool(got.all())


def test_cuda_rows_7_8_and_4_in_a_row(cuda_device):
    """Rows 7, 8 and 4 TLAS launched in a row on one stream, twice, without
    a synchronisation: each launch clears the shared work counter the one
    before used up."""
    mesh, launches = _scan_launches()
    nearest, shadow = launches[1]
    scene = build_scene(DEEP, FRAME, cuda_device)
    origins, directions, seed = integrator.frame_rays_and_seed(
        integrator.scene_camera(DEEP, FRAME, cuda_device), FRAME, width=64, height=64, samples=2
    )
    bounces: list = []
    compaction.trace_paths_wavefront(
        scene, origins, directions, seed, max_bounces=BOUNCES, mesh=mesh,
        on_launch=bounces.append,
    )
    step = bounces[0]
    outputs = []
    for _ in range(2):
        outputs.append((
            kernels.intersect_instances(mesh, *nearest),
            kernels.occluded_instances(mesh, *shadow),
            kernels.mesh_bounce(scene, mesh, *step.state, step.live, seed, step.bounce,
                                total_bounces=BOUNCES),
        ))
    torch.cuda.synchronize()
    expected = (
        kernels.intersect_instances_reference(mesh, *nearest),
        kernels.occluded_instances_reference(mesh, *shadow),
        kernels.mesh_bounce_reference(scene, mesh, *step.state, step.live, seed, step.bounce,
                                      total_bounces=BOUNCES),
    )
    for got in outputs:
        for have, want in zip(got[0], expected[0]):
            assert torch.equal(have, want), "row 7 in a row"
        assert torch.equal(got[1], expected[1]), "row 8 in a row"
        for name, have, want in zip(got[2]._fields, got[2], expected[2]):
            assert torch.equal(have, want), f"row 4 in a row: {name}"
