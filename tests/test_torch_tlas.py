"""The port's two-level (TLAS) hierarchy and coherence key against the JAX
package's: the static topology, the per-frame slot order and node boxes,
the key window and the keys, and the ``use_tlas`` rule.

Every comparison is exact, array for array and bit for bit: the topology is
the same numpy build, and the per-frame operands are the same float32
expressions (the slot order's ``(centers - lo) / span * 32``, min and max,
the key's ``(p - lo) * inv * 32``) on the same inputs, the reference's
instances carried across as numpy arrays. Fields: frames 1-10 of
02_physics-mesh and 03_physics-2-mesh, random fields, and the degenerate
all-overlapping field, whose equal Morton codes keep the table order.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_mesh import reference_mesh_arrays
from tpu_render_cluster.render import mesh as ref_mesh
from tpu_render_cluster.render import pallas_kernels as ref_kernels
from tpu_render_cluster_torch.render import kernels
from tpu_render_cluster_torch.render import mesh as port_mesh

MESH_SCENES = ("02_physics-mesh", "03_physics-2-mesh")


@pytest.mark.parametrize("leaf", [1, 4, 16])
@pytest.mark.parametrize("k_count", [1, 2, 5, 12, 24, 48])
def test_topology_equals_the_reference(k_count, leaf):
    expected = ref_mesh.build_tlas_topology(k_count, leaf)
    got = port_mesh.build_tlas_topology(k_count, leaf)
    assert got.depth == expected.depth
    for field in port_mesh.TlasTopology._fields:
        if field == "depth":
            continue
        want, have = np.asarray(getattr(expected, field)), getattr(got, field)
        assert have.dtype == want.dtype and have.shape == want.shape, field
        np.testing.assert_array_equal(have, want, err_msg=field)


def test_topology_is_memoized_and_refuses_an_empty_field():
    topology = port_mesh.cached_tlas_topology(48, 4)
    assert port_mesh.cached_tlas_topology(48, 4) is topology
    assert port_mesh.cached_tlas_topology(48, 1) is not topology
    assert topology.skip.shape == (31,) and topology.depth == 5
    with pytest.raises(ValueError, match="at least one instance"):
        port_mesh.build_tlas_topology(0, 4)


def _reference_boxes(mesh_set):
    """The reference's instance world boxes (lo, hi) [K, 3] as numpy."""
    table = ref_kernels._instance_table(
        mesh_set.instances.rotation, mesh_set.instances.translation,
        mesh_set.instances.scale, mesh_set.bvh.bounds_min, mesh_set.bvh.bounds_max,
    )
    return np.array(table[:, 13:16]), np.array(table[:, 16:19])


def _check_frame_operands(lo_w: np.ndarray, hi_w: np.ndarray) -> None:
    """Slot order, node boxes and key window of one field, port against
    reference, bit for bit."""
    order = np.asarray(ref_mesh.instance_morton_order(jnp.asarray(lo_w), jnp.asarray(hi_w)))
    got_order = port_mesh.instance_morton_order(torch.from_numpy(lo_w), torch.from_numpy(hi_w))
    np.testing.assert_array_equal(got_order.numpy(), order)
    k = lo_w.shape[0]
    topology = ref_mesh.cached_tlas_topology(k, 4)
    node_lo, node_hi = ref_mesh.tlas_node_bounds(
        topology, jnp.asarray(lo_w[order]), jnp.asarray(hi_w[order])
    )
    got_lo, got_hi = port_mesh.tlas_node_bounds(
        port_mesh.cached_tlas_topology(k, 4), torch.from_numpy(lo_w[order]),
        torch.from_numpy(hi_w[order]),
    )
    np.testing.assert_array_equal(got_lo.numpy(), np.asarray(node_lo))
    np.testing.assert_array_equal(got_hi.numpy(), np.asarray(node_hi))
    key_lo, key_inv = ref_kernels.mesh_key_bounds(jnp.asarray(lo_w), jnp.asarray(hi_w))
    window = kernels.mesh_key_bounds(torch.from_numpy(lo_w), torch.from_numpy(hi_w))
    np.testing.assert_array_equal(
        window.numpy(), np.concatenate([np.asarray(key_lo), np.asarray(key_inv)])
    )


def _rays(seed: int, n: int, lo_w: np.ndarray, hi_w: np.ndarray):
    """Rays around a field: half aimed near a random instance's box, some
    axis-aligned, some looking up from above everything (no overlap)."""
    rng = np.random.default_rng(seed)
    origins = (rng.normal(size=(n, 3)) * 4.0 + [0.0, 2.0, 0.0]).astype(np.float32)
    directions = rng.normal(size=(n, 3)).astype(np.float32)
    centers = 0.5 * (lo_w + hi_w)
    aim = centers[rng.integers(0, len(centers), n // 2)]
    directions[n // 2:] = aim + rng.normal(size=aim.shape) * 0.3 - origins[n // 2:]
    directions[:8, :2] = 0.0
    origins[8:16, 1] = 60.0
    directions[8:16] = [0.0, 1.0, 0.0]
    directions /= np.linalg.norm(directions, axis=1, keepdims=True)
    return origins, directions.astype(np.float32)


@pytest.mark.parametrize("name", MESH_SCENES)
def test_frame_operands_and_initial_keys_equal_the_reference(name):
    """Frames 1-10: slot order, node boxes, key window, and the initial
    keys of 200 rays (``initial_mesh_sort_keys``) bit for bit; the port's
    ``tlas_frame`` of the same MeshSet holds those operands."""
    for frame in range(1, 11):
        mesh_set = ref_mesh.scene_mesh_set(name, frame, "sah", 4)
        lo_w, hi_w = _reference_boxes(mesh_set)
        _check_frame_operands(lo_w, hi_w)
        port = port_mesh.mesh_from_arrays(*reference_mesh_arrays(mesh_set), "cpu")
        tlas = kernels.tlas_frame(port)
        order = port_mesh.instance_morton_order(torch.from_numpy(lo_w), torch.from_numpy(hi_w))
        np.testing.assert_array_equal(
            tlas.slots.numpy(), kernels.instance_table(port)[order].numpy()
        )
        assert tlas.node_bounds.shape == (port_mesh.cached_tlas_topology(len(lo_w), 4).skip.size, 8)
        origins, directions = _rays(frame, 200, lo_w, hi_w)
        alive = np.random.default_rng(frame).random(200) < 0.8
        expected = ref_kernels.initial_mesh_sort_keys(
            mesh_set, jnp.asarray(origins), jnp.asarray(directions), jnp.asarray(alive)
        )
        got = kernels.initial_mesh_sort_keys(
            port, torch.from_numpy(origins), torch.from_numpy(directions), torch.from_numpy(alive)
        )
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(expected))


@pytest.mark.parametrize("field", ["random-12", "random-48", "overlapping-8"])
def test_operands_and_keys_on_random_and_degenerate_fields(field):
    """Random boxes, and 8 equal boxes (every Morton code equal: the stable
    argsort keeps the table order); ``mesh_sort_keys`` with random frame ids
    and candidates (beyond the clamps too) and dead lanes."""
    rng = np.random.default_rng({"random-12": 3, "random-48": 5, "overlapping-8": 7}[field])
    if field == "overlapping-8":
        lo_w = np.tile(np.array([[-0.5, 0.25, -1.0]], np.float32), (8, 1))
        hi_w = np.tile(np.array([[1.5, 1.75, 0.5]], np.float32), (8, 1))
    else:
        k = int(field.split("-")[1])
        centers = rng.uniform(-4.0, 4.0, (k, 3)).astype(np.float32)
        half = rng.uniform(0.2, 1.0, (k, 3)).astype(np.float32)
        lo_w, hi_w = centers - half, centers + half
    _check_frame_operands(lo_w, hi_w)
    if field == "overlapping-8":
        order = port_mesh.instance_morton_order(torch.from_numpy(lo_w), torch.from_numpy(hi_w))
        assert order.tolist() == list(range(8))
    n = 300
    origins, directions = _rays(11, n, lo_w, hi_w)
    alive = rng.random(n) < 0.7
    fid = rng.integers(-2, 40, n).astype(np.int32)
    candidate = rng.integers(0, 80, n).astype(np.int32)
    key_lo, key_inv = ref_kernels.mesh_key_bounds(jnp.asarray(lo_w), jnp.asarray(hi_w))
    expected = ref_kernels.mesh_sort_keys(
        jnp.asarray(origins), jnp.asarray(directions), jnp.asarray(alive), key_lo, key_inv,
        fid=jnp.asarray(fid), candidate=jnp.asarray(candidate),
    )
    window = kernels.mesh_key_bounds(torch.from_numpy(lo_w), torch.from_numpy(hi_w))
    got = kernels.mesh_sort_keys(
        torch.from_numpy(origins), torch.from_numpy(directions), torch.from_numpy(alive), window,
        fid=torch.from_numpy(fid), candidate=torch.from_numpy(candidate),
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(expected))
    assert got.min() >= 0 and got.max() < 2**30
    assert ((got >> kernels.KEY_DEAD_BIT) == torch.from_numpy(~alive).int()).all()
    # Without frame ids and candidates both pack zeros there.
    plain = kernels.mesh_sort_keys(
        torch.from_numpy(origins), torch.from_numpy(directions), torch.from_numpy(alive), window
    )
    zeros = ref_kernels.mesh_sort_keys(
        jnp.asarray(origins), jnp.asarray(directions), jnp.asarray(alive), key_lo, key_inv
    )
    np.testing.assert_array_equal(plain.numpy(), np.asarray(zeros))


def test_pool_links_offset_each_frame_window():
    """The stacked TLAS links of F frames: frame f's rows are the topology's
    with skip links offset by f M and leaf starts by f K (the reference's
    pool windows, ``pallas_kernels.py:3915-3958``)."""
    topology = port_mesh.cached_tlas_topology(48, kernels.TLAS_LEAF)
    m = topology.skip.size
    links = kernels.tlas_links(48, 3, torch.device("cpu"))
    assert links.dtype == torch.int32 and links.shape == (3 * m, 4)
    for f in range(3):
        rows = links[f * m:(f + 1) * m].numpy()
        np.testing.assert_array_equal(rows[:, 0], topology.skip + f * m)
        np.testing.assert_array_equal(rows[:, 1], topology.first + f * 48)
        np.testing.assert_array_equal(rows[:, 2], topology.count)
    assert kernels.tlas_links(48, 3, torch.device("cpu")) is links


def test_use_tlas_for_resolves_like_the_reference(monkeypatch):
    """None is the reference's default (``TRC_TLAS`` unset): on above one
    leaf of instances; False never; True above one leaf."""
    monkeypatch.delenv("TRC_TLAS", raising=False)
    monkeypatch.delenv("TRC_TLAS_LEAF", raising=False)
    for k in (1, 4, 5, 24, 48):
        for flag in (None, True, False):
            assert kernels.use_tlas_for(k, flag) == ref_kernels.use_tlas_for(k, flag), (k, flag)
    assert kernels.TLAS_LEAF == ref_kernels.tlas_leaf_size()
    assert kernels.TLAS_BLOCK_R == ref_kernels.tlas_block_r()
    assert kernels.KEY_DEAD_BIT == ref_kernels.KEY_DEAD_BIT


@pytest.mark.parametrize("name", MESH_SCENES)
def test_scene_mesh_sets_carry_the_host_tlas_operands(name):
    """``scene_mesh_set`` computes the frame's TLAS operands beside its
    instances; they equal the operands derived from the instances."""
    mesh = port_mesh.scene_mesh_set(name, 7)
    assert mesh.tlas is not None
    derived = kernels.tlas_frame_on_host(mesh._replace(tlas=None))
    for have, want in zip(mesh.tlas, derived):
        assert torch.equal(have, want)
    assert kernels.tlas_frame(mesh) is mesh.tlas
