"""The plain ray-pool mesh kernel (row 6), TLAS and flat, at the
reference's quantized node formats, against the JAX package's kernel in
interpret mode (``TRC_PALLAS=1``), on a mixed 2-frame pool state whose TLAS
windows quantize against one grid. Tolerances as in
tests/test_torch_bvhq_bounce.py (tests/test_torch_raypool.py's).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_bvhq_bounce import _close, pallas_on  # noqa: F401
from tests.test_torch_octant import TOTAL_BOUNCES
from tests.test_torch_raypool import _mixed_state, _port_ops, _reference_ops
from tests.test_torch_tlas_bounce import DEEP, _assert_keys
from tpu_render_cluster.render import pallas_kernels as ref_kernels
from tpu_render_cluster_torch.render import kernels


@pytest.mark.parametrize("quant", [1, 2])
@pytest.mark.parametrize("use_tlas", [True, False], ids=["tlas", "flat"])
def test_pool_bounce_at_the_tier_matches_the_reference(pallas_on, use_tlas, quant):
    """Row 6 on a mixed pool state of two frames, the window's TLAS windows
    against one grid; the key's candidate of a hit lane is its frame's
    slot."""
    frames = (30, 31)
    state, live = _mixed_state(DEEP, frames)
    args = [jnp.asarray(a) for a in state] + [jnp.int32(live)]
    expected = [None if a is None else np.asarray(a) for a in ref_kernels.pool_mesh_bounce(
        _reference_ops(DEEP, frames), *args, total_bounces=TOTAL_BOUNCES, use_tlas=use_tlas,
        quant=quant,
    )]
    kernels.reset_counts()
    ops = _port_ops(DEEP, frames)
    got = kernels.pool_mesh_bounce(
        ops, *(torch.from_numpy(a) for a in state), live, total_bounces=TOTAL_BOUNCES,
        use_tlas=use_tlas, quant=quant,
    )
    name = "pool_mesh_bounce_tlas_reference" if use_tlas else "pool_mesh_bounce_reference"
    assert kernels.counts[kernels.quant_name(name, quant)] == 1
    pool = state[0].shape[0]
    close = _close(got, expected, pool)
    if use_tlas:
        agree = close & (got.alive.numpy() == expected[4])
        alive = got.alive.numpy() & agree
        _assert_keys(got.key.numpy()[agree], expected[5][agree], alive[agree])
