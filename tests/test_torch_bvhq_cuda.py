"""The quantized node formats on a GPU: each instantiation of rows 3, 4 and 6
(TLAS and flat, both walk orders) and of the key pass at node format 1 and 2
against its plain PyTorch version, bit for bit on every lane.

Needs a CUDA GPU and nvcc (the kernels have no CPU mode); skipped elsewhere.
Imports no jax: ``python -m pytest -q -m cuda tests/test_torch_bvhq_cuda.py``.

Tolerance: none. At tier ``quant`` a wrapper launches the kernel
instantiated for that node format and its plain version walks the boxes the
kernel reconstructs (``mesh.dequantize_node_bounds``), so a megakernel's
radiance, a bounce's state outputs, alive, key and hit column, and the key
pass's keys equal the plain version's to the bit. Inputs: frame 30 of
02_physics-mesh and 03_physics-2-mesh (``sah`` builds with octant tables:
the ordered walk) and a ``median`` build of the icosphere (no octant tables:
the canonical walk, its key written by the bounce kernel's epilogue), camera
rays; every launch of a deep wavefront frame and of a
2-frame pool window; a row 3 TLAS launch of more packets than the card holds
resident blocks, and row 4 TLAS at each group size. Whole masked frames are
held equal across node formats and builds, as the reference holds them.
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
QUANTS = (1, 2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc: the kernel has no CPU mode")
    return torch.device("cuda")


def _assert_equal(got, expected, what: str) -> None:
    for name, have, want in zip(got._fields, got, expected):
        assert torch.equal(have, want), f"{what}: {name} differs on {int((have != want).sum())} values"


def _camera_rays(name: str, device):
    return integrator.frame_rays_and_seed(
        integrator.scene_camera(name, 30, device), 30, width=64, height=48, samples=2
    )


def _mesh(name: str, build: str, device, quant: int):
    builder, wide = {"sah": ("sah", 4), "median": ("median", 2)}[build]
    return scene_mesh_set(name, 30, builder, wide, device)


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("build", ["sah", "median"])
@pytest.mark.parametrize("use_tlas", [True, False], ids=["tlas", "flat"])
@pytest.mark.parametrize("name", [MESH, DEEP])
def test_cuda_quantized_megakernel_matches_plain_version(cuda_device, name, use_tlas, build,
                                                          quant):
    scene = build_scene(name, 30, cuda_device)
    mesh = _mesh(name, build, cuda_device, quant)
    assert kernels.walks_ordered(mesh.bvh) == (build == "sah")
    origins, directions, seed = _camera_rays(name, cuda_device)
    kernels.reset_counts()
    got = kernels.trace_paths_fused_mesh(scene, mesh, origins, directions, seed,
                                         max_bounces=BOUNCES, use_tlas=use_tlas, quant=quant)
    torch.cuda.synchronize()
    kernel = kernels.quant_name("trace_fused_mesh_tlas" if use_tlas else "trace_fused_mesh", quant)
    assert kernels.counts == {k: int(k == kernel) for k in kernels.counts}
    expected = kernels.trace_paths_fused_mesh_reference(
        scene, mesh, origins, directions, seed, max_bounces=BOUNCES, use_tlas=use_tlas,
        quant=quant,
    )
    assert torch.isfinite(got).all() and got.max() > 0.05
    assert torch.equal(got, expected), f"{int((got != expected).any(dim=1).sum())} rays differ"
    fp32 = kernels.trace_paths_fused_mesh(scene, mesh, origins, directions, seed,
                                          max_bounces=BOUNCES, use_tlas=use_tlas)
    assert torch.equal(got, fp32)


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("build", ["sah", "median"])
@pytest.mark.parametrize("use_tlas", [True, False], ids=["tlas", "flat"])
def test_cuda_quantized_bounce_and_key_pass_match_plain_versions(cuda_device, use_tlas, build,
                                                                 quant):
    """Every launch of a deep wavefront frame at the tier: the bounce (and on
    the ordered TLAS walk its key pass, fed the bounce's hit column) bit for
    bit, each output; the state outputs equal the fp32 launch's, the key
    outside its candidate bits."""
    scene = build_scene(DEEP, 30, cuda_device)
    mesh = _mesh(DEEP, build, cuda_device, quant)
    origins, directions, seed = integrator.frame_rays_and_seed(
        integrator.scene_camera(DEEP, 30, cuda_device), 30, width=64, height=48, samples=2
    )
    launches: list = []
    compaction.trace_paths_wavefront(
        scene, origins, directions, seed, max_bounces=BOUNCES, mesh=mesh,
        on_launch=launches.append, use_tlas=use_tlas, quant=quant,
    )
    assert len(launches) == BOUNCES
    kernel = "mesh_bounce_tlas" if use_tlas else "mesh_bounce"
    ordered = kernels.walks_ordered(mesh.bvh)
    for launch in launches:
        args = (*launch.state, launch.live, seed, launch.bounce)
        kernels.reset_counts()
        hits: list = []
        got = kernels.mesh_bounce(scene, mesh, *args, total_bounces=BOUNCES, use_tlas=use_tlas,
                                  quant=quant, _hits=hits)
        torch.cuda.synchronize()
        assert kernels.counts == {
            k: int(k in kernels.launch_names(kernel, ordered, quant)) for k in kernels.counts
        }
        plain_hits: list = []
        expected = kernels.mesh_bounce_reference(scene, mesh, *args, total_bounces=BOUNCES,
                                                 use_tlas=use_tlas, quant=quant,
                                                 _hits=plain_hits)
        _assert_equal(got, expected, f"bounce {launch.bounce} at tier {quant}")
        fp32 = kernels.mesh_bounce(scene, mesh, *args, total_bounces=BOUNCES, use_tlas=use_tlas)
        for have, want in zip(got[:5], fp32[:5]):
            assert torch.equal(have, want)
        if not use_tlas:
            continue
        candidate = ~(0x3F << 18)
        assert torch.equal(got.key & candidate, fp32.key & candidate)
        if ordered:
            assert torch.equal(hits[0], plain_hits[0])
            keys = kernels.entry_keys(mesh, got.origins, got.directions, got.alive, launch.live,
                                      launch.bounce, total_bounces=BOUNCES, quant=quant,
                                      hits=hits[0])
            assert torch.equal(keys, got.key)
            assert torch.equal(keys, kernels.entry_keys_reference(
                mesh, got.origins, got.directions, got.alive, launch.live, launch.bounce,
                total_bounces=BOUNCES, quant=quant, hits=hits[0],
            ))


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("use_tlas", [True, False], ids=["tlas", "flat"])
def test_cuda_quantized_pool_matches_plain_version(cuda_device, use_tlas, quant):
    """Every launch of a 2-frame pool window at the tier (its stacked TLAS
    windows against one grid), bit for bit."""
    window = raypool.PoolWindow(
        DEEP, [30, 31], width=32, height=24, samples=2, max_bounces=BOUNCES, pool_width=2048,
        device=cuda_device, use_tlas=use_tlas, quant=quant,
    )
    launches: list = []
    state = window.initial_state()
    while bool(window.more(state)):
        state = window.iteration(state, len(launches), launches.append)
    assert len(launches) >= 4
    for launch in launches:
        live = int(launch.live)
        kernels.reset_counts()
        got = kernels.pool_mesh_bounce(window.ops, *launch.state, live, total_bounces=BOUNCES,
                                       use_tlas=use_tlas, quant=quant)
        name = "pool_mesh_bounce_tlas" if use_tlas else "pool_mesh_bounce"
        assert kernels.counts[kernels.quant_name(name, quant)] == 1
        expected = kernels.pool_mesh_bounce_reference(
            window.ops, *launch.state, live, total_bounces=BOUNCES, use_tlas=use_tlas,
            quant=quant,
        )
        _assert_equal(got, expected, f"pool launch {launch.iteration} at tier {quant}")


@pytest.mark.parametrize("quant", QUANTS)
def test_cuda_quantized_megakernel_past_its_resident_blocks(cuda_device, quant):
    """Row 3 TLAS over more packets than the card holds resident blocks: its
    persistent blocks take several packets each from the work counter."""
    scene = build_scene(DEEP, 30, cuda_device)
    mesh = scene_mesh_set(DEEP, 30, device=cuda_device)
    origins, directions, seed = integrator.frame_rays_and_seed(
        integrator.scene_camera(DEEP, 30, cuda_device), 30, width=256, height=256, samples=8
    )
    packets = origins.shape[0] // kernels.TLAS_BLOCK_R
    assert packets > 132 * 8
    got = kernels.trace_paths_fused_mesh(scene, mesh, origins, directions, seed,
                                         max_bounces=BOUNCES, quant=quant)
    expected = kernels.trace_paths_fused_mesh_reference(scene, mesh, origins, directions, seed,
                                                        max_bounces=BOUNCES, quant=quant)
    assert torch.equal(got, expected), f"{int((got != expected).any(dim=1).sum())} rays differ"


@pytest.mark.parametrize("group", kernels.GROUPS)
@pytest.mark.parametrize("quant", QUANTS)
def test_cuda_quantized_bounce_at_each_group_size(cuda_device, quant, group):
    """Row 4 TLAS's group walk at each G at the tier, on the widest launch
    of a deep frame (persistent blocks, many rays a warp)."""
    scene = build_scene(DEEP, 30, cuda_device)
    mesh = scene_mesh_set(DEEP, 30, device=cuda_device)
    origins, directions, seed = integrator.frame_rays_and_seed(
        integrator.scene_camera(DEEP, 30, cuda_device), 30, width=128, height=128, samples=4
    )
    launches: list = []
    compaction.trace_paths_wavefront(scene, origins, directions, seed, max_bounces=2, mesh=mesh,
                                     on_launch=launches.append, quant=quant)
    launch = launches[1]
    args = (*launch.state, launch.live, seed, launch.bounce)
    hits: list = []
    got = kernels.mesh_bounce(scene, mesh, *args, total_bounces=BOUNCES, quant=quant,
                              _group=group, _hits=hits)
    plain_hits: list = []
    expected = kernels.mesh_bounce_reference(scene, mesh, *args, total_bounces=BOUNCES,
                                             quant=quant, _hits=plain_hits)
    _assert_equal(got, expected, f"G {group} at tier {quant}")
    assert torch.equal(hits[0], plain_hits[0])


@pytest.mark.parametrize("name", [MESH, DEEP])
def test_cuda_masked_frames_equal_across_node_formats_and_builds(cuda_device, name):
    """The masked tier's uint8 frame is the same at every (quant, builder,
    wide), as the reference holds it (tests/test_bvhq.py:420)."""
    frames = {}
    for quant, builder, wide in ((0, "median", 1), (0, "sah", 4), (1, "median", 1),
                                 (2, "sah", 4), (1, "sah", 8)):
        render = integrator.fused_frame_renderer(name, 64, 48, 2, BOUNCES, cuda_device,
                                                 quant=quant, builder=builder, wide=wide)
        frames[quant, builder, wide] = render(30)
    first = next(iter(frames.values()))
    for key, image in frames.items():
        assert torch.equal(image, first), f"{key} differs"
