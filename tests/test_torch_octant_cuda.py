"""The octant-ordered walk on a GPU: the six ordered launches of rows 3, 4
and 6 (TLAS and flat) and the walk's two passes against their plain
PyTorch versions, bit for bit, and the scan's unit kernels (rows 7-10) on
the canonical order whatever the BVH carries.

Needs a CUDA GPU and nvcc (the kernels have no CPU mode); skipped elsewhere.
Imports no jax: ``python -m pytest -q -m cuda tests/test_torch_octant_cuda.py``.

Tolerance: none. The scenes' BVHs are ``sah`` builds with octant tables,
so the wrappers take the ordered walk (the reference's default); on every
lane the outputs equal the plain version's to the bit: a megakernel's
radiance, a bounce's five state outputs, alive and (TLAS) key, the packet
votes (``packet_votes``) and the ordered key pass (``entry_keys``). Inputs:
frame 30 of 02_physics-mesh and of 03_physics-2-mesh (its icosphere BVH
called directly through the megakernels, past the dispatch bound), camera
rays and 1,000 random ones (no multiple of a packet: the last packet votes
with pad rays), every launch of a deep wavefront frame and of a 2-frame
pool window. The redesigned vote pass is also held exactly at 2,097,152
lanes, on an 8-frame pool window's launches (with frame ids: only the rows
of each packet's frames) and on 1,024-lane packets of one sign; row 3 TLAS
at 0, 1 and 4 bounces, on ragged launches and on one whose paths all end
at bounce 0, in both walk orders. The vote is also held on instance rows of
scale above 1 (its object-space product by 1/s). The redesigned key pass is
held on random bounce outputs at 1 to 1,200,000 lanes, live counts 0,
mid-packet and whole, on the last bounce, on each side of its width rule
(a block a packet, persistent blocks), at the largest K the earlier design
took (narrow and wide: a block a packet), and twice in a row on one
stream.
"""

from __future__ import annotations

import ctypes

import numpy as np
import pytest
import torch

from tpu_render_cluster_torch.render import compaction, integrator, kernels, raypool
from tpu_render_cluster_torch.render.mesh import (
    MeshInstances,
    MeshSet,
    cached_mesh_bvh,
    cached_tlas_topology,
    scene_mesh_set,
)
from tpu_render_cluster_torch.render.scene import build_scene

pytestmark = pytest.mark.cuda

MESH, DEEP = "02_physics-mesh", "03_physics-2-mesh"
BOUNCES = 4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc: the kernel has no CPU mode")
    return torch.device("cuda")


def _canonical(mesh: MeshSet) -> MeshSet:
    """The same mesh with a BVH without its octant tables."""
    return mesh._replace(bvh=mesh.bvh._replace(octant=None))


def _assert_equal(got, expected, what: str) -> None:
    for name, have, want in zip(got._fields, got, expected):
        assert torch.equal(have, want), f"{what}: {name} differs on {int((have != want).sum())} values"


def _rays(name: str, source: str, device):
    if source == "camera":
        return integrator.frame_rays_and_seed(
            integrator.scene_camera(name, 30, device), 30, width=64, height=48, samples=2
        )
    rng = np.random.default_rng(3)
    origins = (rng.normal(size=(1000, 3)) * 3.0 + [0.0, 2.0, 0.0]).astype(np.float32)
    directions = rng.normal(size=(1000, 3))
    directions = (directions / np.linalg.norm(directions, axis=1, keepdims=True)).astype(np.float32)
    return torch.from_numpy(origins).to(device), torch.from_numpy(directions).to(device), 77


@pytest.mark.parametrize("source", ["camera", "random"])
@pytest.mark.parametrize("use_tlas", [True, False], ids=["tlas", "flat"])
@pytest.mark.parametrize("name", [MESH, DEEP])
def test_cuda_ordered_megakernel_matches_plain_version(cuda_device, name, use_tlas, source):
    scene = build_scene(name, 30, cuda_device)
    mesh = scene_mesh_set(name, 30, device=cuda_device)
    assert kernels.walks_ordered(mesh.bvh)
    origins, directions, seed = _rays(name, source, cuda_device)
    kernels.reset_counts()
    got = kernels.trace_paths_fused_mesh(
        scene, mesh, origins, directions, seed, max_bounces=BOUNCES, use_tlas=use_tlas
    )
    torch.cuda.synchronize()
    kernel = "trace_fused_mesh_tlas" if use_tlas else "trace_fused_mesh"
    assert kernels.counts == {k: int(k == kernel) for k in kernels.counts}
    expected = kernels.trace_paths_fused_mesh_reference(
        scene, mesh, origins, directions, seed, max_bounces=BOUNCES, use_tlas=use_tlas
    )
    assert torch.isfinite(got).all() and got.max() > 0.05
    assert torch.equal(got, expected), f"{int((got != expected).any(dim=1).sum())} rays differ"


@pytest.mark.parametrize("use_tlas", [True, False], ids=["tlas", "flat"])
def test_cuda_ordered_bounce_and_its_passes_match_plain_versions(cuda_device, use_tlas):
    """Every launch of a deep wavefront frame: the bounce (with its vote
    pass and, TLAS, its key pass) bit for bit, and each pass alone."""
    scene = build_scene(DEEP, 30, cuda_device)
    mesh = scene_mesh_set(DEEP, 30, device=cuda_device)
    origins, directions, seed = integrator.frame_rays_and_seed(
        integrator.scene_camera(DEEP, 30, cuda_device), 30, width=64, height=48, samples=2
    )
    launches: list = []
    compaction.trace_paths_wavefront(
        scene, origins, directions, seed, max_bounces=BOUNCES, mesh=mesh,
        on_launch=launches.append, use_tlas=use_tlas,
    )
    assert len(launches) == BOUNCES and launches[-1].live < launches[-1].bucket
    kernel = "mesh_bounce_tlas" if use_tlas else "mesh_bounce"
    block = kernels.TLAS_BLOCK_R if use_tlas else kernels.BVH_BLOCK_R
    table = kernels.tlas_frame(mesh).slots if use_tlas else kernels.instance_table(mesh)
    for launch in launches:
        args = (*launch.state, launch.live, seed, launch.bounce)
        kernels.reset_counts()
        got = kernels.mesh_bounce(scene, mesh, *args, total_bounces=BOUNCES, use_tlas=use_tlas)
        torch.cuda.synchronize()
        assert kernels.counts == {
            k: int(k in kernels.launch_names(kernel)) for k in kernels.counts
        }
        expected = kernels.mesh_bounce_reference(
            scene, mesh, *args, total_bounces=BOUNCES, use_tlas=use_tlas
        )
        _assert_equal(got, expected, f"bounce {launch.bounce}")
        votes = kernels.packet_votes(launch.state[1], table, launch.live, block=block,
                                     world=use_tlas)
        plain = kernels.packet_votes_reference(launch.state[1], table, launch.live, block=block,
                                               world=use_tlas)
        for have, want in zip(votes, plain):
            assert (have is None) == (want is None)
            assert have is None or torch.equal(have, want)
        if use_tlas:
            keys = kernels.entry_keys(mesh, got.origins, got.directions, got.alive, launch.live,
                                      launch.bounce, total_bounces=BOUNCES)
            assert torch.equal(keys, got.key)
            assert torch.equal(keys, kernels.entry_keys_reference(
                mesh, got.origins, got.directions, got.alive, launch.live, launch.bounce,
                total_bounces=BOUNCES,
            ))


@pytest.mark.parametrize("use_tlas", [True, False], ids=["tlas", "flat"])
def test_cuda_ordered_pool_matches_plain_version(cuda_device, use_tlas):
    """Every launch of a 2-frame pool window, bit for bit."""
    window = raypool.PoolWindow(
        DEEP, [30, 31], width=32, height=24, samples=2, max_bounces=BOUNCES, pool_width=2048,
        device=cuda_device, use_tlas=use_tlas,
    )
    launches: list = []
    state = window.initial_state()
    while bool(window.more(state)):
        state = window.iteration(state, len(launches), launches.append)
    assert len(launches) >= 4
    for launch in launches:
        live = int(launch.live)
        got = kernels.pool_mesh_bounce(window.ops, *launch.state, live, total_bounces=BOUNCES,
                                       use_tlas=use_tlas)
        expected = kernels.pool_mesh_bounce_reference(
            window.ops, *launch.state, live, total_bounces=BOUNCES, use_tlas=use_tlas
        )
        _assert_equal(got, expected, f"pool launch {launch.iteration}")


def test_cuda_canonical_walk_without_octant_tables(cuda_device):
    """A BVH without octant tables takes the canonical kernels: no pass is
    launched, and each launch equals the canonical plain version."""
    scene = build_scene(DEEP, 30, cuda_device)
    mesh = _canonical(scene_mesh_set(DEEP, 30, device=cuda_device))
    assert not kernels.walks_ordered(mesh.bvh)
    origins, directions, seed = integrator.frame_rays_and_seed(
        integrator.scene_camera(DEEP, 30, cuda_device), 30, width=32, height=24, samples=2
    )
    launches: list = []
    kernels.reset_counts()
    compaction.trace_paths_wavefront(
        scene, origins, directions, seed, max_bounces=BOUNCES, mesh=mesh,
        on_launch=launches.append,
    )
    assert kernels.counts == {
        k: len(launches) * (k == "mesh_bounce_tlas") for k in kernels.counts
    }
    launch = launches[1]
    args = (*launch.state, launch.live, seed, launch.bounce)
    got = kernels.mesh_bounce(scene, mesh, *args, total_bounces=BOUNCES)
    _assert_equal(got, kernels.mesh_bounce_reference(scene, mesh, *args, total_bounces=BOUNCES),
                  "canonical bounce")
    radiance = kernels.trace_paths_fused_mesh(scene, mesh, origins, directions, seed,
                                              max_bounces=BOUNCES)
    plain = kernels.trace_paths_fused_mesh_reference(scene, mesh, origins, directions, seed,
                                                     max_bounces=BOUNCES)
    assert torch.isclose(radiance, plain, rtol=1e-4, atol=1e-4).all(dim=1).float().mean() >= 0.999


def test_cuda_unit_kernels_walk_the_canonical_order(cuda_device):
    """Rows 7-10 read no octant table, as their reference kernels: on the
    same rays a BVH with octant tables and one without give the same bits,
    and the canonical plain versions' results."""
    mesh = scene_mesh_set(DEEP, 30, device=cuda_device)
    canonical = _canonical(mesh)
    origins, directions, _ = integrator.frame_rays_and_seed(
        integrator.scene_camera(DEEP, 30, cuda_device), 30, width=64, height=48, samples=1
    )
    rays = origins.shape[0]
    init_t = torch.full((rays,), kernels.INF, device=cuda_device)
    already = torch.zeros(rays, dtype=torch.bool, device=cuda_device)
    already[::3] = True
    for m in (mesh, canonical):
        kernels.reset_counts()
        nearest = kernels.intersect_instances(m, origins, directions, init_t)
        shadow = kernels.occluded_instances(m, origins, directions, already)
        assert kernels.counts["packet_octants"] == 0
        if m is mesh:
            first = (nearest, shadow)
        else:
            for have, want in zip((*nearest, shadow), (*first[0], first[1])):
                assert torch.equal(have, want)
    plain = kernels.intersect_instances_reference(canonical, origins, directions, init_t)
    for have, want in zip(first[0], plain):
        assert torch.equal(have, want)
    assert torch.equal(first[1], kernels.occluded_instances_reference(
        canonical, origins, directions, already
    ))
    row = kernels.instance_table(mesh)[0]
    lo = kernels._to_object(row, origins, shift=True)
    ld = kernels._to_object(row, directions, shift=False)
    t, tri = kernels.intersect_mesh(mesh.bvh, lo, ld, init_t)
    t0, tri0 = kernels.intersect_mesh(canonical.bvh, lo, ld, init_t)
    assert torch.equal(t, t0) and torch.equal(tri, tri0)
    hit = kernels.occluded_mesh(mesh.bvh, lo, ld, already)
    assert torch.equal(hit, kernels.occluded_mesh(canonical.bvh, lo, ld, already))
    assert torch.equal(hit, kernels.occluded_mesh_reference(canonical.bvh, lo, ld, already))


# -- the redesigned vote pass and row 3 TLAS ------------------------------------


def _random_directions(count: int, seed: int, device) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=(count, 3)).astype(np.float32)).to(device)


def _assert_votes_equal(got, expected, what: str) -> None:
    for have, want in zip(got, expected):
        assert (have is None) == (want is None), what
        assert have is None or torch.equal(have, want), f"{what}: {int((have != want).sum())} differ"


@pytest.mark.parametrize("live", [2_097_152, 1_000_000])
def test_cuda_vote_pass_at_full_width(cuda_device, live):
    """Row 4 TLAS's widest launch: 2,097,152 lanes, the world vote and 48
    rows, all packets walked or those past a live count zeroed."""
    mesh = scene_mesh_set(DEEP, 30, device=cuda_device)
    slots = kernels.tlas_frame(mesh).slots
    assert slots.shape[0] == 48
    directions = _random_directions(2_097_152, 5, cuda_device)
    kernels.reset_counts()
    got = kernels.packet_votes(directions, slots, live, block=kernels.TLAS_BLOCK_R)
    torch.cuda.synchronize()
    assert kernels.counts["packet_octants"] == 1
    _assert_votes_equal(got, kernels.packet_votes_reference(directions, slots, live,
                                                            block=kernels.TLAS_BLOCK_R), "votes")


@pytest.mark.parametrize("block", [256, 1024])
def test_cuda_vote_pass_on_scaled_instances(cuda_device, block):
    """Instance rows of scale above 1 (1/s in [0.3, 0.8) on every other row
    of 03's table): each row's vote goes through to_object's product by 1/s,
    exactly as the plain version's."""
    mesh = scene_mesh_set(DEEP, 30, device=cuda_device)
    table = kernels.tlas_frame(mesh).slots.clone()
    rng = np.random.default_rng(11)
    scaled = torch.from_numpy(rng.uniform(0.3, 0.8, size=table[::2].shape[0]).astype(np.float32))
    table[::2, 12] = scaled.to(cuda_device)
    directions = _random_directions(262_144 + 77, 12, cuda_device)
    live = 200_000
    got = kernels.packet_votes(directions, table, live, block=block)
    _assert_votes_equal(got, kernels.packet_votes_reference(directions, table, live, block=block),
                        "scaled rows")


def _pool_launches(device):
    """Every launch of an 8-frame pool window at a small size."""
    window = raypool.PoolWindow(
        DEEP, list(range(30, 38)), width=32, height=24, samples=2, max_bounces=BOUNCES,
        pool_width=2048, device=device,
    )
    launches: list = []
    state = window.initial_state()
    while bool(window.more(state)):
        state = window.iteration(state, len(launches), launches.append)
    return window, launches


def test_cuda_vote_pass_on_pool_launches(cuda_device):
    """The pool's votes, only the rows of the frames each packet carries:
    the launch whose live lanes hold the most frames, the drain, and the
    former with its lanes' frame ids drawn over all 8 frames and shuffled
    (every packet carries every frame)."""
    window, launches = _pool_launches(cuda_device)
    slots = kernels.pool_tlas_operands(window.ops).slots
    k = window.ops.per_frame

    def frames_of(launch):
        return int(launch.state[5][:int(launch.live)].unique().numel())

    mixed = max(launches, key=frames_of)
    assert frames_of(mixed) >= 2
    generator = torch.Generator(device=cuda_device).manual_seed(8)
    fid = torch.randint(0, 8, (window.pool,), generator=generator, device=cuda_device,
                        dtype=torch.int32)
    perm = torch.randperm(window.pool, generator=generator, device=cuda_device)
    shuffled = (mixed.state[1][perm], fid[perm], window.pool)
    cases = {
        "mixed": (mixed.state[1], mixed.state[5], int(mixed.live)),
        "drain": (launches[-1].state[1], launches[-1].state[5], int(launches[-1].live)),
        "shuffled": shuffled,
    }
    for what, (directions, frames, live) in cases.items():
        args = dict(block=kernels.TLAS_BLOCK_R, world=False, frames=frames, per_frame=k)
        got = kernels.packet_votes(directions, slots, live, **args)
        _assert_votes_equal(got, kernels.packet_votes_reference(directions, slots, live, **args),
                            what)
    carried = kernels.carried_frames(fid[perm], kernels.TLAS_BLOCK_R, 8)
    assert bool(carried.all())


def test_cuda_vote_pass_on_flat_packets_of_one_sign(cuda_device):
    """1,024-lane packets with every lane positive along x (a count of 1,024,
    past a 10-bit field), exactly half along y (a tie) and none along z:
    every whole packet's world octant is 1."""
    mesh = scene_mesh_set(DEEP, 30, device=cuda_device)
    table = kernels.instance_table(mesh)
    directions = _random_directions(100_000, 6, cuda_device)
    directions[:, 0] = directions[:, 0].abs() + 0.5
    directions[:, 1] = -directions[:, 1].abs() - 0.5
    directions[::2, 1] = -directions[::2, 1]  # y: every other lane positive, a tie: no y bit
    directions[:, 2] = -directions[:, 2].abs() - 0.5
    got = kernels.packet_votes(directions, table, 100_000, block=kernels.BVH_BLOCK_R)
    expected = kernels.packet_votes_reference(directions, table, 100_000,
                                              block=kernels.BVH_BLOCK_R)
    _assert_votes_equal(got, expected, "flat packets")
    assert bool((got[0][:-1] == 1).all())


@pytest.mark.parametrize("ordered", [True, False], ids=["ordered", "canonical"])
@pytest.mark.parametrize("max_bounces", [1, 4])
@pytest.mark.parametrize("name", [MESH, DEEP])
def test_cuda_tlas_megakernel_on_ragged_launches(cuda_device, name, max_bounces, ordered):
    """Row 3 TLAS bit for bit against its plain version at 1 and 4 bounces,
    on 02 and on 03's deep tree called directly, at 1,000 random rays (a
    ragged last packet), in both walk orders."""
    scene = build_scene(name, 30, cuda_device)
    mesh = scene_mesh_set(name, 30, device=cuda_device)
    if not ordered:
        mesh = _canonical(mesh)
    origins, directions, seed = _rays(name, "random", cuda_device)
    kernels.reset_counts()
    got = kernels.trace_paths_fused_mesh(scene, mesh, origins, directions, seed,
                                         max_bounces=max_bounces, use_tlas=True)
    torch.cuda.synchronize()
    assert kernels.counts == {k: int(k == "trace_fused_mesh_tlas") for k in kernels.counts}
    expected = kernels.trace_paths_fused_mesh_reference(scene, mesh, origins, directions, seed,
                                                        max_bounces=max_bounces, use_tlas=True)
    assert torch.equal(got, expected), f"{int((got != expected).any(dim=1).sum())} rays differ"


def test_cuda_tlas_megakernel_when_every_path_ends_at_bounce_0(cuda_device):
    """Rays above everything aimed at the sky: every packet's paths end at
    bounce 0, and each lane keeps the sky's radiance."""
    scene = build_scene(MESH, 30, cuda_device)
    mesh = scene_mesh_set(MESH, 30, device=cuda_device)
    rays = 3 * 256 + 17
    origins = torch.tensor([[0.0, 500.0, 0.0]], device=cuda_device).expand(rays, 3).contiguous()
    directions = torch.nn.functional.normalize(
        _random_directions(rays, 7, cuda_device).abs() + torch.tensor([0.0, 2.0, 0.0],
                                                                       device=cuda_device), dim=1)
    got = kernels.trace_paths_fused_mesh(scene, mesh, origins, directions, 9, max_bounces=BOUNCES,
                                         use_tlas=True)
    expected = kernels.trace_paths_fused_mesh_reference(scene, mesh, origins, directions, 9,
                                                        max_bounces=BOUNCES, use_tlas=True)
    assert torch.equal(got, expected)
    one = kernels.trace_paths_fused_mesh_reference(scene, mesh, origins, directions, 9,
                                                   max_bounces=1, use_tlas=True)
    assert torch.equal(got, one) and got.max() > 0.0


@pytest.mark.parametrize("ordered", [True, False], ids=["ordered", "canonical"])
def test_cuda_tlas_megakernel_at_zero_bounces(cuda_device, ordered):
    """max_bounces 0 on more packets than the card holds blocks (each block
    takes several from the work counter): every lane's radiance is 0, as the
    plain version's."""
    scene = build_scene(MESH, 30, cuda_device)
    mesh = scene_mesh_set(MESH, 30, device=cuda_device)
    if not ordered:
        mesh = _canonical(mesh)
    rays = 600_000
    origins = torch.zeros((rays, 3), device=cuda_device)
    origins[:, 1] = 2.0
    directions = _random_directions(rays, 13, cuda_device)
    got = kernels.trace_paths_fused_mesh(scene, mesh, origins, directions, 5, max_bounces=0,
                                         use_tlas=True)
    expected = kernels.trace_paths_fused_mesh_reference(scene, mesh, origins, directions, 5,
                                                        max_bounces=0, use_tlas=True)
    assert torch.equal(got, expected) and not bool(got.any())


# -- the key pass (csrc/mesh_entry_keys.cu) -------------------------------------


def _key_state(lanes: int, seed: int, device, spread: float = 3.0):
    """Random outputs of a bounce: origins around the field, unit
    directions, about one lane in ten dead."""
    rng = np.random.default_rng(seed)
    origins = (rng.normal(size=(lanes, 3)) * spread + [0.0, 2.0, 0.0]).astype(np.float32)
    directions = rng.normal(size=(lanes, 3))
    directions = (directions / np.linalg.norm(directions, axis=1, keepdims=True)).astype(np.float32)
    alive = rng.random(lanes) > 0.1
    return tuple(torch.from_numpy(a).to(device) for a in (origins, directions, alive))


def _assert_keys_equal(mesh, state, live: int, bounce: int) -> None:
    kernels.reset_counts()
    got = kernels.entry_keys(mesh, *state, live, bounce, total_bounces=BOUNCES)
    torch.cuda.synchronize()
    assert kernels.counts == {k: int(k == "mesh_entry_keys") for k in kernels.counts}
    expected = kernels.entry_keys_reference(mesh, *state, live, bounce, total_bounces=BOUNCES)
    assert torch.equal(got, expected), f"{int((got != expected).sum())} keys differ"


@pytest.mark.parametrize("live", ["none", "mid-packet", "all"])
@pytest.mark.parametrize("lanes", [1, 255, 257, 1000, 1_200_000])
def test_cuda_key_pass_at_each_width_and_live_count(cuda_device, lanes, live):
    """The keys of 03's 48 slots bit for bit, at bounce 1 and on the last
    bounce (every candidate K); 1,200,000 lanes are more packets than the
    card holds resident warps, so warps take several from the counter."""
    mesh = scene_mesh_set(DEEP, 30, device=cuda_device)
    state = _key_state(lanes, lanes % 97, cuda_device)
    count = {"none": 0, "mid-packet": min(lanes, lanes * 5 // 8 + 1), "all": lanes}[live]
    for bounce in (1, BOUNCES - 1):
        _assert_keys_equal(mesh, state, count, bounce)


def _key_launch(mesh, lanes: int) -> dict:
    """The key pass's plan for a launch of ``lanes`` lanes over the mesh's
    tables (its ``mesh_entry_keys_occupancy`` entry)."""
    frame = kernels.tlas_frame(mesh)
    occupancy = kernels._library("mesh_entry_keys").mesh_entry_keys_occupancy
    occupancy.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
    occupancy.restype = ctypes.c_int
    persistent, shared, grid = (ctypes.c_int() for _ in range(3))
    blocks = occupancy(lanes, frame.slots.shape[0], frame.node_bounds.shape[0],
                       ctypes.addressof(persistent), ctypes.addressof(shared),
                       ctypes.addressof(grid))
    assert blocks > 0
    return {"persistent": bool(persistent.value), "grid": grid.value}


def test_cuda_key_pass_on_each_side_of_the_width_rule(cuda_device):
    """The widest launch that runs a block a packet and the narrowest that
    runs persistent blocks (a block then takes several packets from the
    work counter), the last packet ragged."""
    mesh = scene_mesh_set(DEEP, 30, device=cuda_device)
    block = kernels.TLAS_BLOCK_R
    lo, hi = 1, 2**22  # packets: a block a packet at lo, persistent at hi
    assert not _key_launch(mesh, lo * block)["persistent"]
    assert _key_launch(mesh, hi * block)["persistent"]
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if _key_launch(mesh, mid * block)["persistent"]:
            hi = mid
        else:
            lo = mid
    plan = _key_launch(mesh, hi * block - 19)
    assert plan["persistent"] and plan["grid"] < hi
    for lanes in (lo * block - 19, hi * block - 19):
        state = _key_state(lanes, lanes % 89, cuda_device)
        _assert_keys_equal(mesh, state, lanes - block // 3, 1)


@pytest.mark.parametrize("lanes", [100_000, 1_000_000])
def test_cuda_key_pass_at_the_largest_k(cuda_device, lanes):
    """The largest K whose one octant's TLAS rows and slot rows fit the 96 KB
    that the earlier one-block-a-packet design staged: its eight octant
    tables do not fit, so even a launch of more packets than the card holds
    blocks runs a block a packet, each staging its octant's rows. Half the
    rays aim at slots' boxes, so walks enter leaves."""
    def staged_by_the_earlier_design(k: int) -> bool:
        nodes = len(cached_tlas_topology(k, kernels.TLAS_LEAF).skip)
        return 48 * nodes + 88 * k <= 96 * 1024

    k = 48
    while staged_by_the_earlier_design(k + 1):
        k += 1
    assert k > 500
    rng = np.random.default_rng(17)
    translation = rng.uniform(-40.0, 40.0, (k, 3)).astype(np.float32)
    instances = MeshInstances(
        rotation=torch.eye(3).repeat(k, 1, 1), translation=torch.from_numpy(translation),
        albedo=torch.full((k, 3), 0.5), scale=torch.from_numpy(
            rng.uniform(0.5, 1.5, k).astype(np.float32)),
    )
    mesh = MeshSet(bvh=cached_mesh_bvh("icosphere", "sah", 4, cuda_device),
                   instances=MeshInstances(*(t.to(cuda_device) for t in instances)))
    plan = _key_launch(mesh, lanes)
    assert not plan["persistent"]
    origins, directions, alive = _key_state(lanes, 23, cuda_device, spread=30.0)
    aim = torch.from_numpy(translation[rng.integers(0, k, lanes // 2)]).to(cuda_device)
    toward = aim - origins[: lanes // 2]
    directions[: lanes // 2] = toward / toward.norm(dim=1, keepdim=True)
    state = (origins, directions, alive)
    _assert_keys_equal(mesh, state, lanes - 100, 1)
    keys = kernels.entry_keys(mesh, *state, lanes - 100, 1, total_bounces=BOUNCES)
    assert (((keys >> 18) & 63) < 63).sum() > 100  # candidates below the key's clamp


def test_cuda_key_pass_twice_in_a_row_on_one_stream(cuda_device):
    """Two launches back to back on one stream share the work counter, which
    each clears before its kernel: both equal their plain versions."""
    mesh = scene_mesh_set(DEEP, 30, device=cuda_device)
    first = _key_state(300_000, 31, cuda_device)
    second = _key_state(70_000, 37, cuda_device)
    got = [kernels.entry_keys(mesh, *first, 250_000, 0, total_bounces=BOUNCES),
           kernels.entry_keys(mesh, *second, 70_000, 2, total_bounces=BOUNCES)]
    torch.cuda.synchronize()
    for keys, (state, live, bounce) in zip(got, ((first, 250_000, 0), (second, 70_000, 2))):
        expected = kernels.entry_keys_reference(mesh, *state, live, bounce,
                                                total_bounces=BOUNCES)
        assert torch.equal(keys, expected)
