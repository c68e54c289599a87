"""The plain mesh megakernel (row 3), TLAS and flat, at the reference's
quantized node formats on the octant-ordered walk, against the JAX
package's kernel in interpret mode (``TRC_PALLAS=1``): rtol = atol = 1e-4
per ray at 2 bounces on at least 99.9% of rays (tests/test_torch_octant.py).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_bvhq_bounce import _field, pallas_on  # noqa: F401
from tests.test_torch_octant import SEED, _bounce_state
from tests.test_torch_tlas_bounce import _scene
from tpu_render_cluster.render import pallas_kernels as ref_kernels
from tpu_render_cluster_torch.render import kernels


@pytest.mark.parametrize("quant", [1, 2])
@pytest.mark.parametrize("use_tlas", [True, False], ids=["tlas", "flat"])
def test_megakernel_at_the_tier_matches_the_reference(pallas_on, use_tlas, quant):
    """Row 3 on the deep field (called directly: past the dispatch bound),
    300 rays (a padded last packet), 2 bounces, the ordered walk."""
    mesh_set, mesh = _field("sah")
    origins, directions = _bounce_state(7)[:2]
    expected = np.asarray(ref_kernels.trace_paths_fused_mesh(
        _scene()[0], mesh_set, jnp.asarray(origins), jnp.asarray(directions), jnp.int32(SEED),
        max_bounces=2, use_tlas=use_tlas, quant=quant,
    ))
    kernels.reset_counts()
    got = kernels.trace_paths_fused_mesh(
        _scene()[1], mesh, torch.from_numpy(origins), torch.from_numpy(directions), SEED,
        max_bounces=2, use_tlas=use_tlas, quant=quant,
    ).numpy()
    name = "trace_fused_mesh_tlas_reference" if use_tlas else "trace_fused_mesh_reference"
    assert kernels.counts[kernels.quant_name(name, quant)] == 1
    assert got.shape == expected.shape and np.isfinite(got).all() and got.max() > 0.05
    close = np.isclose(got, expected, rtol=1e-4, atol=1e-4).all(axis=1)
    assert close.mean() >= 0.999, close.mean()
