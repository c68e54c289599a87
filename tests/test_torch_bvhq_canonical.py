"""The canonical walk (a ``median`` BVH: no octant tables) of rows 4 and 3
at the reference's quantized node formats, against the JAX package's
kernels in interpret mode (``TRC_PALLAS=1``): the bounce kernel keys its
own output there, with the packed-key rule. Inputs and tolerances as in
tests/test_torch_bvhq_bounce.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_bvhq_bounce import _field, check_bounce, pallas_on  # noqa: F401
from tests.test_torch_octant import SEED, _bounce_state
from tests.test_torch_tlas_bounce import _scene
from tpu_render_cluster.render import pallas_kernels as ref_kernels
from tpu_render_cluster_torch.render import kernels


@pytest.mark.parametrize("quant", [1, 2])
@pytest.mark.parametrize("use_tlas", [True, False], ids=["tlas", "flat"])
def test_canonical_bounce_at_the_tier_matches_the_reference(pallas_on, use_tlas, quant):
    check_bounce(use_tlas, "median", quant)


def test_megakernel_canonical_walk_at_tier_2(pallas_on):
    """Row 3 TLAS on the ``median`` build (canonical walk) at tier 2."""
    mesh_set, mesh = _field("median")
    origins, directions = _bounce_state(7)[:2]
    expected = np.asarray(ref_kernels.trace_paths_fused_mesh(
        _scene()[0], mesh_set, jnp.asarray(origins), jnp.asarray(directions), jnp.int32(SEED),
        max_bounces=2, use_tlas=True, quant=2,
    ))
    got = kernels.trace_paths_fused_mesh_reference(
        _scene()[1], mesh, torch.from_numpy(origins), torch.from_numpy(directions), SEED,
        max_bounces=2, use_tlas=True, quant=2,
    ).numpy()
    close = np.isclose(got, expected, rtol=1e-4, atol=1e-4).all(axis=1)
    assert close.mean() >= 0.999, close.mean()
