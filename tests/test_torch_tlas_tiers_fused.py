"""Row 3 TLAS (the mesh megakernel's two-level walk) at the reference's
TLAS tiers: the plain version against ``pallas_kernels.trace_paths_fused_mesh``
in interpret mode (``TRC_PALLAS=1``) on 300 rays at packets of up to 256
lanes and 2P + 44 at 512 and 1,024 (``launch_rays``: a ragged last packet
at every width, several packets at each), over the cases of
tests/test_torch_tlas_tiers.py (every other one: each width and leaf at
least once, both orders, formats 0 and 1).

Tolerance, the existing one (tests/test_torch_kernels_mesh.py): per ray
over its three channels rtol = atol = 1e-4; at 1 bounce every ray but an
edge-tie budget of max(1, round(0.001 R)) (a ray through the shared edge of
two triangles may take either face's normal), at 2 bounces at least 99.9%
of rays.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_tlas_bounce import SEED, _scene
from tests.test_torch_tlas_tiers import (  # noqa: F401
    CASE_IDS,
    CASES,
    _meshes,
    _rays,
    launch_rays,
    tiers_env,
)
from tpu_render_cluster.render import pallas_kernels as ref_kernels
from tpu_render_cluster_torch.render import kernels


@pytest.mark.parametrize("tiers_env", CASES[::2], ids=CASE_IDS[::2], indirect=True)
def test_row3_tlas_matches_the_reference(tiers_env):
    field, packet, leaf, ordered, quant = tiers_env
    mesh_set, mesh = _meshes(field, ordered, leaf)
    origins, directions = _rays(launch_rays(packet, 300), seed=31)
    for bounces in (1, 2):
        expected = np.asarray(ref_kernels.trace_paths_fused_mesh(
            _scene()[0], mesh_set, jnp.asarray(origins), jnp.asarray(directions),
            jnp.int32(SEED), max_bounces=bounces, use_tlas=True, quant=quant,
        ))
        kernels.reset_counts()
        got = kernels.trace_paths_fused_mesh(
            _scene()[1], mesh, torch.from_numpy(origins), torch.from_numpy(directions), SEED,
            max_bounces=bounces, quant=quant, tlas_block=packet,
        ).numpy()
        name = kernels.packet_name(kernels.quant_name("trace_fused_mesh_tlas_reference", quant),
                                   packet)
        assert kernels.counts.get(name) == 1, kernels.counts
        close = np.isclose(got, expected, rtol=1e-4, atol=1e-4).all(axis=1)
        if bounces == 1:
            assert (~close).sum() <= max(1, round(0.001 * close.size))
        else:
            assert close.mean() >= 0.999, close.mean()
        assert got.max() > 0.05
