"""The plain per-bounce mesh kernel (row 4) and the key pass at the
reference's quantized node formats (``TRC_BVH_QUANT`` 1 and 2) against the
JAX package's Pallas kernel in interpret mode (``TRC_PALLAS=1``), TLAS and
flat, on the octant-ordered walk (a ``sah`` BVH with octant tables); the
canonical walk is in tests/test_torch_bvhq_canonical.py, row 3 in
tests/test_torch_bvhq_fused.py, row 6 in tests/test_torch_bvhq_pool.py.

Fields and states as tests/test_torch_octant.py builds them: random-48
(48 icospheres) over the deep scene's icosphere BVH; 300 rays, no multiple
of a packet, with dead lanes and a dead tail; a mixed 2-frame pool state.
Inputs are made with numpy from seeds.

Tolerances (those of the files named there): per ray rtol = atol = 1e-4
but an edge-tie budget of max(1, round(0.001 R)), alive within the same
budget; the key column exact on every live lane and on dead lanes outside
the candidate bits (tests/test_torch_tlas_bounce.py). The packed-key rule
shows: a lane whose nearest hit was an instance keys with that slot, where
the fp32 key takes the entry walk's.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_mesh import reference_mesh_arrays
from tests.test_torch_octant import LIVE, RAYS, SEED, TOTAL_BOUNCES, _bounce_state, _ordered_field
from tests.test_torch_tlas_bounce import _assert_keys, _scene
from tpu_render_cluster.render import mesh as ref_mesh
from tpu_render_cluster.render import pallas_kernels as ref_kernels
from tpu_render_cluster_torch.render import kernels
from tpu_render_cluster_torch.render import mesh as port_mesh


@pytest.fixture
def pallas_on(monkeypatch):
    monkeypatch.setenv("TRC_PALLAS", "1")


@functools.lru_cache(maxsize=None)
def _field(build: str):
    """(reference MeshSet, port MeshSet) of random-48 over the icosphere's
    ``sah`` BVH (octant tables) or ``median`` one (none)."""
    mesh_set = _ordered_field("random-48")[0]
    if build == "median":
        mesh_set = mesh_set._replace(bvh=ref_mesh.cached_mesh_bvh("icosphere", "median", 2))
    return mesh_set, port_mesh.mesh_from_arrays(*reference_mesh_arrays(mesh_set), "cpu")


def _close(got, expected, rays: int) -> np.ndarray:
    close = np.ones(rays, bool)
    for have, want in zip(got[:4], expected[:4]):
        close &= np.isclose(have.numpy(), want, rtol=1e-4, atol=1e-4).all(axis=1)
    budget = max(1, round(0.001 * rays))
    assert (~close).sum() <= budget and (got.alive.numpy() != expected[4]).sum() <= budget
    return close


def check_bounce(use_tlas: bool, build: str, quant: int) -> None:
    """Row 4 at bounce 1 of 4 on a launch of two TLAS packets with dead
    lanes and a dead tail; on the ordered TLAS walk the plain key pass, fed
    the bounce's hit column, gives the bounce's key."""
    mesh_set, mesh = _field(build)
    state = _bounce_state()
    expected = [None if a is None else np.asarray(a) for a in ref_kernels.mesh_bounce_pallas(
        _scene()[0], mesh_set, *(jnp.asarray(a) for a in state[:4]), jnp.int32(SEED), 1,
        total_bounces=TOTAL_BOUNCES, lane=jnp.asarray(state[4]), live_count=jnp.int32(LIVE),
        use_tlas=use_tlas, quant=quant,
    )]
    kernels.reset_counts()
    hits: list = []
    got = kernels.mesh_bounce(
        _scene()[1], mesh, *(torch.from_numpy(a) for a in state), LIVE, SEED, 1,
        total_bounces=TOTAL_BOUNCES, use_tlas=use_tlas, quant=quant, _hits=hits,
    )
    name = "mesh_bounce_tlas_reference" if use_tlas else "mesh_bounce_reference"
    assert kernels.counts[kernels.quant_name(name, quant)] == 1
    _close(got, expected, RAYS)
    if not use_tlas:
        assert got.key is None and expected[5] is None and not hits
        return
    alive = got.alive.numpy()
    _assert_keys(got.key.numpy(), expected[5], alive)
    k = mesh.instances.translation.shape[0]
    hit = hits[0].numpy()
    assert ((hit < k) & alive).any() and not (hit[~alive] < k).any()
    # The packed-key rule: a hit lane's candidate is its slot.
    np.testing.assert_array_equal(((got.key.numpy() >> 18) & 63)[hit < k], hit[hit < k])
    fp32 = kernels.mesh_bounce(
        _scene()[1], mesh, *(torch.from_numpy(a) for a in state), LIVE, SEED, 1,
        total_bounces=TOTAL_BOUNCES, use_tlas=True,
    )
    assert (fp32.key != got.key).any()
    if build == "sah":
        keys = kernels.entry_keys(mesh, got.origins, got.directions, got.alive, LIVE, 1,
                                  total_bounces=TOTAL_BOUNCES, quant=quant, hits=hits[0])
        assert kernels.counts[kernels.quant_name("mesh_entry_keys_reference", quant)] == 1
        assert torch.equal(keys, got.key)
        with pytest.raises(ValueError, match="hits"):
            kernels.entry_keys(mesh, got.origins, got.directions, got.alive, LIVE, 1,
                               total_bounces=TOTAL_BOUNCES, quant=quant)


@pytest.mark.parametrize("quant", [1, 2])
@pytest.mark.parametrize("use_tlas", [True, False], ids=["tlas", "flat"])
def test_ordered_bounce_and_key_pass_at_the_tier_match_the_reference(pallas_on, use_tlas, quant):
    check_bounce(use_tlas, "sah", quant)


@pytest.mark.parametrize("quant", [1, 2])
def test_key_pass_at_the_tier_on_the_last_bounce(pallas_on, quant):
    """On the last bounce the entry walk is skipped: a lane keys with its hit
    slot or K, as the reference's quantized key epilogue."""
    mesh_set, mesh = _field("sah")
    state = _bounce_state()
    last = TOTAL_BOUNCES - 1
    expected = [np.asarray(a) for a in ref_kernels.mesh_bounce_pallas(
        _scene()[0], mesh_set, *(jnp.asarray(a) for a in state[:4]), jnp.int32(SEED), last,
        total_bounces=TOTAL_BOUNCES, lane=jnp.asarray(state[4]), live_count=jnp.int32(LIVE),
        use_tlas=True, quant=quant,
    )]
    hits: list = []
    got = kernels.mesh_bounce(
        _scene()[1], mesh, *(torch.from_numpy(a) for a in state), LIVE, SEED, last,
        total_bounces=TOTAL_BOUNCES, quant=quant, _hits=hits,
    )
    close = _close(got, expected, RAYS)
    alive = got.alive.numpy() & close
    _assert_keys(got.key.numpy()[close], expected[5][close], alive[close])
    k = mesh.instances.translation.shape[0]
    candidate = (got.key.numpy() >> 18) & 63
    np.testing.assert_array_equal(candidate, np.minimum(hits[0].numpy(), k))
