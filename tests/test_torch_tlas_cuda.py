"""The two-level (TLAS) variants of the mesh kernels against their plain
PyTorch versions, on a GPU: ``trace_fused_mesh_tlas``, ``mesh_bounce_tlas``
and ``pool_mesh_bounce_tlas``.

Needs a CUDA GPU and nvcc (the kernels have no CPU mode); skipped elsewhere.
Imports no jax: ``python -m pytest -q -m cuda tests/test_torch_tlas_cuda.py``.

Tolerance: the megakernel as tests/test_torch_kernels_cuda.py, rtol = atol
= 1e-4 per ray, every ray at 1 bounce but an edge-tie budget of max(1,
round(0.001 R)) rays, at least 99.9% at 4 bounces. A per-bounce or pool
launch: its five state outputs within rtol = atol = 1e-4 on every lane but
that budget, and its key column equal to the plain version's on every lane,
to the bit. On live lanes the key also equals the one computed outside the
kernel from the launch's own outputs (``kernels.mesh_sort_keys`` with
``instance_entry_candidates`` over the slot-ordered world boxes), but where
the ray enters two slots' boxes at the same distance: the twin gives the
tie to the lowest slot, the octant-ordered entry walk (the reference's
default) to the slot its packet's table meets first, so such a lane
differs in the candidate bits alone, between two slots of equal entry.
"""

from __future__ import annotations

import pytest
import torch

from tpu_render_cluster_torch.render import compaction, integrator, kernels, raypool
from tpu_render_cluster_torch.render.mesh import scene_mesh_set
from tpu_render_cluster_torch.render.scene import build_scene

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc: the kernel has no CPU mode")
    return torch.device("cuda")


def _close_state(got, expected, budget):
    close = torch.ones_like(got.alive)
    for have, want in zip(got[:4], expected[:4]):
        close &= torch.isclose(have, want, rtol=1e-4, atol=1e-4).all(dim=1)
    assert (~close).sum().item() <= budget
    assert (got.alive != expected.alive).sum().item() <= budget


def _assert_twin_keys(mesh_tlas, got, twin, lanes) -> None:
    """``got``'s key column equals the twin on ``lanes`` but exact entry
    ties, which differ in the candidate bits alone."""
    differ = lanes & (got.key != twin)
    if not differ.any():
        return
    candidate_bits = 0x3F << 18
    assert (((got.key ^ twin) & ~candidate_bits)[differ] == 0).all()
    lo, hi = mesh_tlas.slots[:, 13:16], mesh_tlas.slots[:, 16:19]
    o, d = got.origins[differ], got.directions[differ]
    mine, theirs = (
        kernels.slot_entries(o, d, lo, hi, ((key[differ] >> 18) & 63).long())
        for key in (got.key, twin)
    )
    assert torch.equal(mine, theirs) and (mine < kernels.INF).all()


def _twin_keys(mesh_tlas, out, fid=None):
    """The key of the launch's live lanes computed outside the kernel."""
    lo, hi = mesh_tlas.slots[:, 13:16], mesh_tlas.slots[:, 16:19]
    candidate = kernels.instance_entry_candidates(out.origins, out.directions, lo, hi)
    return kernels.mesh_sort_keys(
        out.origins, out.directions, out.alive, mesh_tlas.key_window, fid=fid,
        candidate=candidate,
    )


@pytest.mark.parametrize("max_bounces", [1, 4])
@pytest.mark.parametrize("name", ["02_physics-mesh", "03_physics-2-mesh"])
def test_cuda_tlas_megakernel_matches_plain_version(cuda_device, name, max_bounces):
    scene = build_scene(name, 30, cuda_device)
    mesh = scene_mesh_set(name, 30, device=cuda_device)
    origins, directions, seed = integrator.frame_rays_and_seed(
        integrator.scene_camera(name, 30, cuda_device), 30, width=64, height=64, samples=2
    )
    kernels.reset_counts()
    got = kernels.trace_paths_fused_mesh(
        scene, mesh, origins, directions, seed, max_bounces=max_bounces
    )
    torch.cuda.synchronize()
    assert kernels.counts == {k: int(k == "trace_fused_mesh_tlas") for k in kernels.counts}
    expected = kernels.trace_paths_fused_mesh_reference(
        scene, mesh, origins, directions, seed, max_bounces=max_bounces, use_tlas=True
    )
    flat = kernels.trace_paths_fused_mesh(
        scene, mesh, origins, directions, seed, max_bounces=max_bounces, use_tlas=False
    )
    assert torch.isfinite(got).all()
    for other in (expected, flat):
        close = torch.isclose(got, other, rtol=1e-4, atol=1e-4).all(dim=1)
        if max_bounces == 1:
            assert (~close).sum().item() <= max(1, round(0.001 * close.numel()))
        else:
            assert close.float().mean().item() >= 0.999


def test_cuda_tlas_bounce_matches_plain_version(cuda_device):
    """Every launch of a deep wavefront frame (the TLAS default) again
    through the kernel and its plain version: the state within the
    budget, the key column bit-equal, the final bounce keyed with K."""
    name = "03_physics-2-mesh"
    scene = build_scene(name, 30, cuda_device)
    mesh = scene_mesh_set(name, 30, device=cuda_device)
    origins, directions, seed = integrator.frame_rays_and_seed(
        integrator.scene_camera(name, 30, cuda_device), 30, width=96, height=96, samples=2
    )
    launches: list = []
    compaction.trace_paths_wavefront(
        scene, origins, directions, seed, max_bounces=4, mesh=mesh, on_launch=launches.append
    )
    assert len(launches) == 4 and launches[-1].live < launches[-1].bucket
    k = mesh.instances.translation.shape[0]
    for launch in launches:
        args = (*launch.state, launch.live, seed, launch.bounce)
        kernels.reset_counts()
        got = kernels.mesh_bounce(scene, mesh, *args, total_bounces=4)
        torch.cuda.synchronize()
        expected = kernels.mesh_bounce_reference(scene, mesh, *args, total_bounces=4)
        assert kernels.counts == {
            name_: int(name_ in (*kernels.launch_names("mesh_bounce_tlas"),
                                 "mesh_bounce_tlas_reference"))
            for name_ in kernels.counts
        }
        _close_state(got, expected, max(1, round(0.001 * launch.bucket)))
        assert got.key.dtype == torch.int32 and torch.equal(got.key, expected.key)
        dead = ~got.alive
        assert ((got.key[dead] >> kernels.KEY_DEAD_BIT) == 1).all()
        if launch.bounce == 3:  # the last bounce keys every lane with K
            assert (((got.key >> 18) & 63) == min(k, 63)).all()
        else:
            live = got.alive & (torch.arange(launch.bucket, device=cuda_device) < launch.live)
            _assert_twin_keys(mesh.tlas, got, _twin_keys(mesh.tlas, got), live)


@pytest.mark.parametrize("frames,size", [((30, 31), (64, 48, 2, 4096)),
                                         (tuple(range(1, 9)), (16, 16, 1, 1024))])
def test_cuda_tlas_pool_kernel_matches_plain_version(cuda_device, frames, size):
    """Every launch of a TLAS pool window (the default) again through the
    kernel and its plain version, keys included; each frame against the
    flat pool's image to the bit."""
    width, height, samples, pool_width = size
    launches: list = []
    kernels.reset_counts()
    images, stats = raypool.render_batch_raypool(
        "03_physics-2-mesh", frames, width=width, height=height, samples=samples,
        max_bounces=4, pool_width=pool_width, frame_cap=len(frames),
        on_iteration=launches.append,
    )
    assert kernels.counts == {
        k: stats[0].iterations * (k in kernels.launch_names("pool_mesh_bounce_tlas"))
        for k in kernels.counts
    }
    window = raypool.PoolWindow(
        "03_physics-2-mesh", frames, width=width, height=height, samples=samples,
        max_bounces=4, pool_width=pool_width, device=cuda_device,
    )
    for launch in launches:
        live = int(launch.live)
        got = kernels.pool_mesh_bounce(window.ops, *launch.state, live, total_bounces=4)
        expected = kernels.pool_mesh_bounce_reference(
            window.ops, *launch.state, live, total_bounces=4
        )
        torch.cuda.synchronize()
        _close_state(got, expected, max(1, round(0.001 * window.pool)))
        assert torch.equal(got.key, expected.key)
        assert not got.alive[live:].any()
        assert ((got.key[~got.alive] >> kernels.KEY_DEAD_BIT) == 1).all()
        fid = launch.state[5]
        assert torch.equal((got.key >> 24) & 31, fid.clamp(0, 31))
    flat_images, flat_stats = raypool.render_batch_raypool(
        "03_physics-2-mesh", frames, width=width, height=height, samples=samples,
        max_bounces=4, pool_width=pool_width, frame_cap=len(frames), use_tlas=False,
    )
    assert flat_stats[0].iterations == stats[0].iterations
    for image, flat in zip(images, flat_images):
        assert (image - flat).abs().max().item() <= 1e-5


def test_cuda_tlas_tiers_default_and_flat(cuda_device):
    """The deep loop and the wavefront on the card: the TLAS default
    launches mesh_bounce_tlas and nothing else, its image equal to the flat
    kernel's and the wavefront's to the bit; 02 through the megakernel's
    TLAS variant by default."""
    name = "03_physics-2-mesh"
    kernels.reset_counts()
    tlas = integrator.render_frame(name, 3, width=64, height=48, samples=2, max_bounces=4)
    assert kernels.counts == {
        k: 4 * (k in kernels.launch_names("mesh_bounce_tlas")) for k in kernels.counts
    }
    flat = integrator.render_frame(
        name, 3, width=64, height=48, samples=2, max_bounces=4, use_tlas=False
    )
    launches: list = []
    kernels.reset_counts()
    wavefront = compaction.render_frame_wavefront(
        name, 3, width=64, height=48, samples=2, max_bounces=4, on_launch=launches.append
    )
    assert kernels.counts == {
        k: len(launches) * (k in kernels.launch_names("mesh_bounce_tlas")) for k in kernels.counts
    }
    assert torch.equal(wavefront, tlas)
    assert (tlas - flat).abs().max().item() <= 1e-5
    kernels.reset_counts()
    integrator.render_frame("02_physics-mesh", 3, width=64, height=48, samples=2, max_bounces=4)
    assert kernels.counts == {k: int(k == "trace_fused_mesh_tlas") for k in kernels.counts}
