"""Whole frames at the reference's quantized node formats against the JAX
package's own at the same tier (its kernels in interpret mode,
``TRC_PALLAS=1``): the masked tier, the wavefront and the ray pool, which
at tiers 1 and 2 carry bf16 throughput between launches.

Tolerances: the masked frame against the reference's, tests/test_torch_frame.py's
``assert_images_match``; the wavefront and the pool at tier 1 and 2
against the port's tier 0, the reference's budget (linear MAE < 1e-3,
uint8 within 2), and against the reference's tier-1 frames the existing
tolerances of tests/test_torch_frame.py and tests/test_torch_raypool.py.
"""

from __future__ import annotations

import numpy as np
import torch

from tests.test_torch_frame import assert_images_match
from tests.test_torch_raypool import _assert_images_equivalent
from tpu_render_cluster.render import compaction as ref_compaction
from tpu_render_cluster.render import integrator as ref_integrator
from tpu_render_cluster.render import raypool as ref_raypool
from tpu_render_cluster_torch.render import compaction, integrator, kernels, raypool

DEEP = "03_physics-2-mesh"
FRAME = 30
SIZE = dict(width=12, height=12, samples=1, max_bounces=2)


def test_masked_frame_at_tier_1_matches_the_reference(monkeypatch):
    """The deep scene at (1, median, 1), the reference's masked tier in
    interpret mode (the reference's own frames are bit-equal across the
    tiers, tests/test_bvhq.py:420)."""
    monkeypatch.setenv("TRC_PALLAS", "1")
    expected = ref_integrator.fused_frame_renderer(
        DEEP, SIZE["width"], SIZE["height"], SIZE["samples"], SIZE["max_bounces"], None, 1,
        "median", 1,
    )(FRAME)
    got = integrator.fused_frame_renderer(
        DEEP, SIZE["width"], SIZE["height"], SIZE["samples"], SIZE["max_bounces"], "cpu",
        quant=1, builder="median", wide=1,
    )(FRAME)
    assert_images_match(got.numpy(), np.asarray(expected))


def _assert_within_budget(packed: torch.Tensor, base: torch.Tensor) -> None:
    """The reference's budget of the packed carried state."""
    assert (packed - base).abs().mean().item() < 1e-3
    delta = integrator.tonemap(packed).int() - integrator.tonemap(base).int()
    assert delta.abs().max().item() <= 2


WAVEFRONT = dict(width=12, height=12, samples=1, max_bounces=3, device="cpu")


def test_wavefront_packed_state_within_budget_and_the_references(monkeypatch):
    """Tier 1 and 2 carry bf16 throughput between launches: within the
    reference's budget of the port's tier 0, and the port's tier-1 frame
    against the reference's tier-1 wavefront frame (interpret mode)."""
    base = compaction.render_frame_wavefront(DEEP, FRAME, quant=0, **WAVEFRONT)
    frames = {}
    for quant in (1, 2):
        kernels.reset_counts()
        frames[quant] = compaction.render_frame_wavefront(DEEP, FRAME, quant=quant, **WAVEFRONT)
        assert kernels.counts[kernels.quant_name("mesh_bounce_tlas_reference", quant)] >= 2
        _assert_within_budget(frames[quant], base)
        assert not torch.equal(frames[quant], base)  # the bf16 rounding shows
    monkeypatch.setenv("TRC_PALLAS", "1")
    kwargs = {k: v for k, v in WAVEFRONT.items() if k != "device"}
    expected = ref_compaction.render_frame_wavefront(DEEP, FRAME, quant=1, **kwargs)
    assert_images_match(integrator.tonemap(frames[1]).numpy(),
                        np.asarray(ref_integrator.tonemap(expected)))


POOL = dict(width=8, height=8, samples=1, max_bounces=2, pool_width=1024, frame_cap=2)


def test_raypool_packed_state_within_budget_and_the_references(monkeypatch):
    """The pool at tier 1 carries bf16 throughput: every frame served,
    within the budget of tier 0, and against the reference's tier-1 pool
    (interpret mode)."""
    base, _ = raypool.render_batch_raypool(DEEP, [30, 31], quant=0, device="cpu", **POOL)
    kernels.reset_counts()
    packed, stats = raypool.render_batch_raypool(DEEP, [30, 31], quant=1, device="cpu", **POOL)
    assert kernels.counts[kernels.quant_name("pool_mesh_bounce_tlas_reference", 1)] >= 2
    assert len(packed) == 2 and stats[0].served == 2 * 8 * 8
    for have, want in zip(packed, base):
        _assert_within_budget(have, want)
    monkeypatch.setenv("TRC_PALLAS", "1")
    expected = ref_raypool.render_batch_raypool(DEEP, [30, 31], quant=1, **POOL)
    for have, want in zip(packed, expected):
        _assert_images_equivalent(have.numpy(), np.asarray(want))
