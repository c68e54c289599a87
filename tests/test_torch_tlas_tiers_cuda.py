"""The TLAS tiers on a GPU: each kernel of the TLAS packet (row 3 TLAS, row
4 TLAS, its vote and key passes, row 6 TLAS) built at the packets 128, 512
and 1,024 (one library a width) and run at the leaves 1, 8 and 16, against
its plain PyTorch version at the same packet and leaf, bit for bit on every
lane; a wrapper asked for another packet raises.

Needs a CUDA GPU and nvcc (the kernels have no CPU mode); skipped elsewhere.
Imports no jax: ``python -m pytest -q -m cuda tests/test_torch_tlas_tiers_cuda.py``.

Tolerance: none. At packet P the kernels vote over the lanes of each
P-lane packet, as the plain versions do (``tlas_block``), and walk each
frame's TLAS of the MeshSet's leaf; a megakernel's radiance, a bounce's
state outputs, alive and key, the votes and the key pass's keys, a pool
launch's outputs and keys equal the plain version's to the bit. Inputs:
frame 30 of 02_physics-mesh and 03_physics-2-mesh (``sah`` builds: the
ordered walk; node formats 0 and 1), 64x48 camera rays at 2 samples, every
launch of a deep wavefront frame and the mixed launch of a 2-frame pool
window.
"""

from __future__ import annotations

import pytest
import torch

from tpu_render_cluster_torch.render import compaction, integrator, kernels, raypool
from tpu_render_cluster_torch.render.mesh import scene_mesh_set
from tpu_render_cluster_torch.render.scene import build_scene

pytestmark = pytest.mark.cuda

MESH, DEEP = "02_physics-mesh", "03_physics-2-mesh"
BOUNCES = 4
# (packet, leaf, node format): the other widths at the default leaf, the
# other leaves at the default width.
TIERS = [(128, 4, 0), (512, 4, 1), (1024, 4, 0), (1024, 4, 1), (256, 1, 0), (256, 8, 1),
         (256, 16, 0)]
IDS = [f"p{p}-leaf{leaf}-q{q}" for p, leaf, q in TIERS]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc: the kernel has no CPU mode")
    return torch.device("cuda")


def _assert_equal(got, expected, what: str) -> None:
    if not hasattr(got, "_fields"):
        got, expected = (got,), (expected,)
    for index, (have, want) in enumerate(zip(got, expected)):
        assert torch.equal(have, want), f"{what}: output {index} differs on " \
                                        f"{int((have != want).sum())} values"


def _rays(name: str, device):
    return integrator.frame_rays_and_seed(
        integrator.scene_camera(name, 30, device), 30, width=64, height=48, samples=2
    )


def _mesh(name: str, leaf: int, device):
    return scene_mesh_set(name, 30, device=device, leaf=leaf)


@pytest.mark.parametrize("packet,leaf,quant", TIERS, ids=IDS)
def test_cuda_row3_tlas_at_the_tiers_matches_plain_version(cuda_device, packet, leaf, quant):
    scene = build_scene(MESH, 30, cuda_device)
    mesh = _mesh(MESH, leaf, cuda_device)
    origins, directions, seed = _rays(MESH, cuda_device)
    kernels.reset_counts()
    got = kernels.trace_paths_fused_mesh(scene, mesh, origins, directions, seed,
                                         max_bounces=BOUNCES, quant=quant, tlas_block=packet)
    torch.cuda.synchronize()
    name = kernels.packet_name(kernels.quant_name("trace_fused_mesh_tlas", quant), packet)
    assert kernels.counts.get(name) == 1, kernels.counts
    expected = kernels.trace_paths_fused_mesh_reference(
        scene, mesh, origins, directions, seed, max_bounces=BOUNCES, quant=quant,
        tlas_block=packet)
    _assert_equal(got, expected, name)


@pytest.mark.parametrize("packet,leaf,quant", TIERS, ids=IDS)
def test_cuda_row4_tlas_and_passes_at_the_tiers_match_plain_versions(cuda_device, packet, leaf,
                                                                      quant):
    scene = build_scene(DEEP, 30, cuda_device)
    mesh = _mesh(DEEP, leaf, cuda_device)
    origins, directions, seed = _rays(DEEP, cuda_device)
    launches: list = []
    compaction.trace_paths_wavefront(scene, origins, directions, seed, max_bounces=BOUNCES,
                                     mesh=mesh, on_launch=launches.append, quant=quant,
                                     tlas_block=packet)
    assert len(launches) == BOUNCES
    slots = kernels.tlas_frame(mesh).slots
    for launch in launches:
        args = (*launch.state, launch.live, seed, launch.bounce)
        kernels.reset_counts()
        hits: list = []
        got = kernels.mesh_bounce(scene, mesh, *args, total_bounces=BOUNCES, quant=quant,
                                  tlas_block=packet, _hits=hits)
        for name in kernels.launch_names("mesh_bounce_tlas", True, quant, packet):
            assert kernels.counts.get(name) == 1, (name, kernels.counts)
        plain_hits: list = []
        expected = kernels.mesh_bounce_reference(scene, mesh, *args, total_bounces=BOUNCES,
                                                 quant=quant, tlas_block=packet,
                                                 _hits=plain_hits)
        torch.cuda.synchronize()
        _assert_equal(got, expected, f"bounce {launch.bounce}")
        votes = kernels.packet_votes(launch.state[1], slots, launch.live, block=packet)
        plain = kernels.packet_votes_reference(launch.state[1], slots, launch.live, block=packet)
        for have, want in zip(votes, plain):
            assert torch.equal(have, want), f"bounce {launch.bounce}: votes"
        keys = kernels.entry_keys(mesh, got.origins, got.directions, got.alive, launch.live,
                                  launch.bounce, total_bounces=BOUNCES, quant=quant,
                                  hits=hits[0] if quant else None, tlas_block=packet)
        assert torch.equal(keys, got.key) and torch.equal(keys, expected.key)


@pytest.mark.parametrize("packet,leaf,quant", TIERS, ids=IDS)
def test_cuda_row6_tlas_at_the_tiers_matches_plain_version(cuda_device, packet, leaf, quant):
    window = raypool.PoolWindow(DEEP, [30, 31], width=32, height=32, samples=2,
                                max_bounces=BOUNCES, device=cuda_device, quant=quant,
                                tlas_leaf=leaf, tlas_block=packet)
    launches: list = []
    state = window.initial_state()
    while bool(window.more(state)):
        state = window.iteration(state, len(launches), launches.append)
    counted = kernels.packet_name(kernels.quant_name("pool_mesh_bounce_tlas", quant), packet)
    mixed = max(launches, key=lambda launch: int(launch.live))
    for launch in (launches[0], mixed, launches[-1]):
        live = int(launch.live)
        kernels.reset_counts()
        got = kernels.pool_mesh_bounce(window.ops, *launch.state, live, total_bounces=BOUNCES,
                                       quant=quant, tlas_block=packet)
        assert kernels.counts.get(counted) == 1, kernels.counts
        expected = kernels.pool_mesh_bounce_reference(window.ops, *launch.state, live,
                                                      total_bounces=BOUNCES, quant=quant,
                                                      tlas_block=packet)
        torch.cuda.synchronize()
        _assert_equal(got, expected, f"launch {launch.iteration}")


def test_cuda_wrappers_raise_for_a_packet_without_a_build(cuda_device):
    scene = build_scene(DEEP, 30, cuda_device)
    mesh = _mesh(DEEP, 4, cuda_device)
    origins, directions, seed = _rays(DEEP, cuda_device)
    for block in (64, 300, 2048):
        with pytest.raises(ValueError, match="TLAS packet"):
            kernels.trace_paths_fused_mesh(scene, mesh, origins, directions, seed,
                                           max_bounces=1, tlas_block=block)
