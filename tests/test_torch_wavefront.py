"""The deep-mesh tiers of the port: the masked deep loop of
``integrator.trace_paths`` against the JAX package's, and the wavefront
driver (``render/compaction.py``) against the masked tier.

The reference runs with ``TRC_PALLAS=1`` (its per-bounce mesh kernel in
interpret mode) on ``03_physics-2-mesh`` frame 30, whose 39-node icosphere
tree x 48 instances is past the mesh megakernel's bound. Inputs are made
with numpy from a seed. (Whole deep frames against the reference are in
tests/test_torch_frame_mesh.py.)

Tolerances:
- the deep loop against the reference's, per ray over its three channels,
  rtol = atol = 1e-4: at 1 bounce every ray but an edge-tie budget of
  max(1, round(0.001 R)) (a ray through the shared edge of two triangles
  may take either face's normal), at 4 bounces at least 99.9% (a path
  tracer is chaotic);
- the port's wavefront against its masked deep loop: equal to the bit. Per
  ray both run the same bounce on the same state with the same lane, and
  a lane that is not launched adds exactly zero in the masked loop. A
  sphere scene under ``force`` against the sphere megakernel: within
  rtol = atol = 1e-4 on at least 99.9% of rays, since the megakernel sums
  a path's radiance in one register and the wavefront bounce by bounce.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from tests.test_torch_frame import assert_images_match
from tests.test_torch_mesh_bounce import DEEP, FRAME, camera_rays, check_deep_loop
from tpu_render_cluster_torch.render import compaction, integrator, kernels
from tpu_render_cluster_torch.render import scene as port_scene
from tpu_render_cluster_torch.render.mesh import scene_mesh_set


def test_deep_loop_at_the_tlas_default_matches_the_reference(monkeypatch):
    """The reference's default tier (its TLAS walk and fused sort keys)
    gives per ray the radiance of its flat walk, which the port's deep loop
    follows (the 1- and 4-bounce flat cases are in
    tests/test_torch_mesh_bounce.py)."""
    monkeypatch.setenv("TRC_PALLAS", "1")
    check_deep_loop(max_bounces=4, use_tlas=None)


@functools.lru_cache(maxsize=None)
def _masked_and_wavefront(name: str):
    """(masked frame, wavefront frame, the wavefront's launches) at 12x10,
    2 spp, 4 bounces, frame 30, on the CPU."""
    kwargs = dict(width=12, height=10, samples=2, max_bounces=4, device="cpu")
    masked = integrator.render_frame(name, FRAME, **kwargs)
    launches: list = []
    wavefront = compaction.render_frame_wavefront(
        name, FRAME, on_launch=launches.append, **kwargs
    )
    return masked, wavefront, launches


def test_wavefront_equals_the_masked_deep_loop():
    masked, wavefront, launches = _masked_and_wavefront(DEEP)
    assert masked.shape == (10, 12, 3) and torch.isfinite(masked).all()
    assert torch.equal(wavefront, masked)
    rays = 12 * 10 * 2
    assert [launch.bounce for launch in launches] == list(range(len(launches)))
    assert launches[0].live == rays and len(launches) >= 2
    for launch in launches:
        o, d, thr, alive, lane = launch.state
        assert launch.live <= launch.bucket == o.shape[0]
        assert launch.bucket == compaction.bucket_for(launch.live, rays, kernels.TLAS_BLOCK_R)
        assert alive[:launch.live].all() and not alive[launch.live:].any()
        assert lane.unique().numel() == lane.numel()
    lives = [launch.live for launch in launches]
    assert lives == sorted(lives, reverse=True) and lives[-1] < rays


def test_wavefront_sphere_scene_under_force_matches_the_megakernel():
    name = "04_very-simple"
    kernels.reset_counts()
    masked, wavefront, launches = _masked_and_wavefront(name)
    assert kernels.counts["trace_fused_reference"] == 1
    assert kernels.counts["sphere_bounce_reference"] == len(launches) >= 2
    close = torch.isclose(wavefront, masked, rtol=1e-4, atol=1e-4).all(dim=-1)
    assert close.float().mean().item() >= 0.999
    assert_images_match(
        integrator.tonemap(wavefront).numpy(), integrator.tonemap(masked).numpy()
    )


def test_wavefront_launch_log_records_each_launch():
    """``on_launch`` sees every launch, before it runs."""
    launches: list = []

    def on_launch(launch):
        assert kernels.counts["mesh_bounce_tlas_reference"] == len(launches)
        launches.append(launch)

    port = port_scene.build_scene(DEEP, 2, "cpu")
    origins, directions = (torch.from_numpy(a[:100]) for a in camera_rays(DEEP))
    kernels.reset_counts()
    compaction.trace_paths_wavefront(
        port, origins, directions, 9, max_bounces=3, mesh=scene_mesh_set(DEEP, 2),
        on_launch=on_launch,
    )
    assert kernels.counts["mesh_bounce_tlas_reference"] == len(launches) >= 2
    assert [launch.bounce for launch in launches] == list(range(len(launches)))
    assert launches[0][1:3] == (100, 100)  # capped at the wavefront's width


def test_compaction_order_is_stable_partition():
    rng = np.random.default_rng(11)
    alive = torch.from_numpy(rng.random(257) < 0.4)
    perm, live = compaction.compaction_order(alive)
    perm = perm.numpy()
    n_live = int(live)
    assert n_live == int(alive.sum())
    assert sorted(perm.tolist()) == list(range(257))  # a permutation
    reordered = alive.numpy()[perm]
    assert reordered[:n_live].all() and not reordered[n_live:].any()
    # Stability: original relative order preserved within each class.
    assert (np.diff(perm[:n_live]) > 0).all()
    assert (np.diff(perm[n_live:]) > 0).all()


def test_bucket_ladder():
    bucket_for = compaction.bucket_for
    assert bucket_for(1, cap=8192, block=1024) == 1024
    assert bucket_for(1024, cap=8192, block=1024) == 1024
    assert bucket_for(1025, cap=8192, block=1024) == 2048
    assert bucket_for(5000, cap=8192, block=1024) == 8192
    # Clamped to the wavefront's current width.
    assert bucket_for(5000, cap=4096, block=1024) == 4096
    assert bucket_for(100, cap=640, block=1024) == 640


@pytest.mark.parametrize("mode", [None, "auto", "off", "force"])
def test_wavefront_active_picks_the_reference_scenes(mode):
    """auto: exactly the scenes past the mesh megakernel's bound."""
    expected = {
        None: {DEEP}, "auto": {DEEP}, "off": set(),
        "force": {DEEP, "02_physics-mesh", "04_very-simple"},
    }[mode]
    for name in (DEEP, "02_physics-mesh", "04_very-simple"):
        assert compaction.wavefront_active(name, mode=mode) == (name in expected), name
    with pytest.raises(ValueError, match="wavefront mode"):
        compaction.wavefront_active(DEEP, mode="sideways")
