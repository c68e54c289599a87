"""The reference's BVH node-format tiers in the port (``TRC_BVH_QUANT`` 1
and 2, with the builder and width tiers): the quantized node tables, the
packed carried state, the tier resolution, and whole frames, against the
JAX package (``tests/test_bvhq.py`` holds the reference's own contracts).

The reference runs on the CPU. Inputs are made with numpy from seeds. The
plain rows 3, 4 and 6 and the key pass against the reference's kernels are
in tests/test_torch_bvhq_bounce.py, tests/test_torch_bvhq_canonical.py,
tests/test_torch_bvhq_fused.py and tests/test_torch_bvhq_pool.py, whole
frames against the reference's in tests/test_torch_bvhq_frames.py.

Tolerances:
- the quantized tables (slab words, meta words, grid), their reconstructed
  boxes and unpacked links, and the bf16 throughput words: equal to the
  bit;
- the masked tier's uint8 frames across (quant, builder, wide): equal to
  the bit, as the reference holds its own (tests/test_bvhq.py:420).
"""

from __future__ import annotations

import functools
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_render_cluster.render import integrator as ref_integrator
from tpu_render_cluster.render import mesh as ref_mesh
from tpu_render_cluster.render import pallas_kernels as ref_kernels
from tpu_render_cluster_torch.render import integrator, kernels, raypool
from tpu_render_cluster_torch.render import mesh as port_mesh
from tpu_render_cluster_torch.render.scene import build_scene
from tpu_render_cluster_torch.worker.backends.torch_raytrace import TorchRaytraceBackend

DEEP, SHALLOW = "03_physics-2-mesh", "02_physics-mesh"
FRAME = 30


def _u32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a)).view(np.uint32)


# -- the quantized tables -------------------------------------------------------


def _box_sets() -> dict:
    """tests/test_bvhq.py's node sets (random, identical, points, a tiny span
    far from the origin, a single node), with random links."""
    rng = np.random.default_rng(41)
    lo = rng.uniform(-20, 20, (64, 3)).astype(np.float32)
    one = np.tile(np.array([[3.0, -2.0, 7.0]], np.float32), (8, 1))
    points = rng.uniform(-5, 5, (16, 3)).astype(np.float32)
    far = np.full((32, 3), 1000.0, np.float32) + rng.uniform(0, 1e-4, (32, 3)).astype(np.float32)
    sets = {
        "random": (lo, lo + rng.uniform(0.01, 8.0, (64, 3)).astype(np.float32)),
        "identical": (one, one + 1.0),
        "points": (points, points.copy()),
        "far-tiny": (far, far + np.float32(1e-5)),
        "single": (np.array([[-1.0, -2.0, -3.0]], np.float32),
                   np.array([[4.0, 5.0, 6.0]], np.float32)),
    }
    out = {}
    for name, (lo, hi) in sets.items():
        n = lo.shape[0]
        links = (rng.integers(0, 60000, n), rng.integers(0, 2000, n) * port_mesh.LEAF_SIZE,
                 rng.integers(0, 32, n))
        out[name] = (lo, hi, *(v.astype(np.int32) for v in links), port_mesh.LEAF_SIZE)
    return out


@functools.lru_cache(maxsize=None)
def _deep_mesh():
    return port_mesh.scene_mesh_set(DEEP, FRAME, device="cpu")


def _frame_tlas(ordered: bool) -> tuple:
    """The port's frame TLAS of 03 as the reference's ``_tlas_node_arrays``
    lays it out (its own node boxes are held against the reference's in
    tests/test_torch_tlas.py)."""
    frame = _deep_mesh().tlas
    topology = port_mesh.cached_tlas_topology(frame.slots.shape[0], kernels.TLAS_LEAF)
    bounds = frame.octant_node_bounds if ordered else frame.node_bounds
    links = ((topology.octant_skip, topology.octant_first, topology.octant_count) if ordered
             else (topology.skip, topology.first, topology.count))
    return (bounds[:, 0:3].numpy(), bounds[:, 4:7].numpy(), *links, 1)


@functools.lru_cache(maxsize=None)
def _pool_ops(frames=(30, 31, 32)):
    meshes = [port_mesh.scene_mesh_set(DEEP, f, device="cpu") for f in frames]
    return kernels.pool_mesh_operands([build_scene(DEEP, f) for f in frames], meshes)


def _pool_tlas() -> tuple:
    """A 3-frame pool window's stacked TLAS windows, links offset per frame."""
    stacked = kernels.pool_tlas_operands(_pool_ops())
    links = stacked.links.numpy()
    return (stacked.node_bounds[:, 0:3].numpy(), stacked.node_bounds[:, 4:7].numpy(),
            links[:, 0], links[:, 1], links[:, 2], 1)


TABLES = ["random", "identical", "points", "far-tiny", "single", "blas-octant", "blas-median",
          "tlas", "tlas-octant", "pool"]


def _table(name: str) -> tuple:
    if name in _box_sets():
        return _box_sets()[name]
    if name == "blas-octant":
        oct_ = port_mesh.cached_mesh_bvh("icosphere", "sah", 4).octant
        return (*(t.numpy() for t in oct_), port_mesh.LEAF_SIZE)
    if name == "blas-median":
        bvh = port_mesh.cached_mesh_bvh("icosphere", "median", 2)
        return (*(t.numpy() for t in bvh[4:9]), port_mesh.LEAF_SIZE)
    if name == "pool":
        return _pool_tlas()
    return _frame_tlas(name == "tlas-octant")


def _port_table(name: str, quant: int) -> kernels.QuantTable:
    """The table as the port's launches pack it, where it has a packing
    site of its own; else ``quant_table`` of the arrays."""
    if name == "blas-octant":
        return kernels.bvh_quant_table(port_mesh.cached_mesh_bvh("icosphere", "sah", 4), quant,
                                       True)
    if name == "blas-median":
        return kernels.bvh_quant_table(port_mesh.cached_mesh_bvh("icosphere", "median", 2), quant,
                                       False)
    if name in ("tlas", "tlas-octant"):
        return kernels.tlas_quant_table(_deep_mesh(), quant, name == "tlas-octant")
    if name == "pool":
        return kernels.pool_tlas_quant(_pool_ops(), quant)
    lo, hi, skip, first, count, unit = _table(name)
    return kernels.quant_table(torch.from_numpy(lo), torch.from_numpy(hi), skip, first, count,
                               quant, unit)


@pytest.mark.parametrize("quant", [1, 2])
@pytest.mark.parametrize("name", TABLES)
def test_quantized_tables_equal_the_references(name, quant):
    lo, hi, skip, first, count, unit = _table(name)
    bq, meta, grid = ref_mesh.quantize_node_tables(
        jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(skip), jnp.asarray(first),
        jnp.asarray(count), quant=quant, first_unit=unit,
    )
    table = _port_table(name, quant)
    words = table.words.numpy()
    assert words.shape == (lo.shape[0], 4 if quant == 1 else 3) and words.dtype == np.int32
    np.testing.assert_array_equal(_u32(words[:, :-1]), _u32(bq))
    np.testing.assert_array_equal(_u32(words[:, -1]), _u32(meta))
    np.testing.assert_array_equal(_u32(table.grid.numpy()), _u32(grid))
    # The reconstruction and the unpack, as the plain versions read them.
    for have, want in zip(port_mesh.dequantize_node_bounds(table.words[:, :-1], table.grid, quant),
                          ref_mesh.dequantize_node_bounds(bq, grid, quant)):
        np.testing.assert_array_equal(_u32(have.numpy()), _u32(want))
    for have, want in zip(port_mesh.unpack_node_meta(table.words[:, -1], first_unit=unit),
                          ref_mesh.unpack_node_meta(meta, first_unit=unit)):
        np.testing.assert_array_equal(have.numpy(), np.asarray(want))


@pytest.mark.parametrize("quant", [1, 2])
@pytest.mark.parametrize("name", TABLES)
def test_quantized_boxes_contain_the_fp32_ones(name, quant):
    """Outward rounding: each reconstructed box contains its fp32 box, and
    the meta word gives back the links (the counts fit its ranges)."""
    lo, hi, skip, first, count, unit = _table(name)
    table = _port_table(name, quant)
    qlo, qhi = port_mesh.dequantize_node_bounds(table.words[:, :-1], table.grid, quant)
    assert (qlo.numpy() <= lo).all() and (qhi.numpy() >= hi).all()
    for have, want in zip(port_mesh.unpack_node_meta(table.words[:, -1], first_unit=unit),
                          (skip, first, count)):
        np.testing.assert_array_equal(have.numpy(), np.asarray(want))


DEGRADE_CASES = [
    (0, ((10, 10, 16),)),
    (1, ((10, 10, 16),)),
    (2, ((10, 10, 16), (30, 40, 4))),
    (1, ((1 << 17, 10, 16),)),
    (1, (((1 << 16) - 1, 10, 16),)),
    (2, ((1 << 16, 10, 16),)),
    (1, ((10, 1 << 12, 16),)),
    (1, ((10, 1 << 11, 16),)),
    (1, ((10, (1 << 11) + 1, 16),)),
    (1, ((10, 10, 31),)),
    (1, ((10, 10, 64),)),
    (1, ((10, 10, 16), (1 << 17, 1, 1))),
    (9, ((10, 10, 16),)),
    (-2, ((10, 10, 16),)),
]


@pytest.mark.parametrize("quant,tables", DEGRADE_CASES)
def test_resolve_bvh_quant_degrades_as_the_references(quant, tables):
    assert kernels.resolve_bvh_quant(quant, *tables) == ref_kernels.resolve_bvh_quant(
        quant, *tables)


def test_the_launch_counts_are_the_references(monkeypatch):
    """The degrade rule reads a launch's tables as the reference counts
    them: a BVH's nodes, leaf slots and LEAF_SIZE; a TLAS's nodes, slots and
    leaf, a pool window's as the reference's padded window stacks them."""
    mesh = _deep_mesh()
    bvh = mesh.bvh
    k = mesh.instances.translation.shape[0]
    m = len(port_mesh.cached_tlas_topology(k, kernels.TLAS_LEAF).skip)
    assert kernels._blas_counts(bvh) == (bvh.skip.shape[0], bvh.v0.shape[0] // 16, 16)
    assert raypool.RAYPOOL_FRAMES == kernels.RAYPOOL_FRAMES == 8
    assert kernels._tlas_counts(k, kernels.RAYPOOL_FRAMES) == (8 * m, 8 * k, 4)
    ops = _pool_ops()
    assert len(ops.meshes) == 3 and kernels.pool_quant(ops, 2, True) == 2
    # A window padded past the first units degrades; the same 3 frames
    # unpadded would not.
    frames = (1 << 11) // k + 1
    assert ref_kernels.resolve_bvh_quant(1, kernels._blas_counts(bvh),
                                         kernels._tlas_counts(k, len(ops.meshes))) == 1
    monkeypatch.setattr(kernels, "RAYPOOL_FRAMES", frames)
    assert kernels.pool_quant(ops, 1, True) == 0
    assert ref_kernels.resolve_bvh_quant(1, kernels._blas_counts(bvh),
                                         kernels._tlas_counts(k, frames)) == 0


ENV_VALUES = {
    "TRC_TLAS": (None, "0", "off", "no", "1", "yes"),
    "TRC_BVH_QUANT": (None, "0", "1", "2", "9", "-3", "junk"),
    "TRC_BVH_BUILDER": (None, "median", "sah", "octree", " MEDIAN "),
    "TRC_BVH_WIDE": (None, "1", "8", "99", "0", "x"),
}
ARGUMENTS = [(None, None, None, None), (False, 1, "median", 2), (True, 7, "sah", 0),
             (None, -1, None, 12)]


def test_resolve_bvh_config_is_the_references(monkeypatch):
    """Over a grid of environment values and explicit arguments."""
    names = list(ENV_VALUES)
    combos = itertools.product(*ENV_VALUES.values())
    for index, values in enumerate(combos):
        if index % 7:  # a spread seventh of the 1,260 combinations
            continue
        for name, value in zip(names, values):
            if value is None:
                monkeypatch.delenv(name, raising=False)
            else:
                monkeypatch.setenv(name, value)
        for args in ARGUMENTS:
            assert integrator.resolve_bvh_config(*args) == ref_integrator.resolve_bvh_config(
                *args), (values, args)
        assert port_mesh.bvh_builder() == ref_mesh.bvh_builder()
        assert port_mesh.bvh_wide() == ref_mesh.bvh_wide()
        assert kernels.bvh_quant_mode() == ref_kernels.bvh_quant_mode()


# -- the packed carried state ----------------------------------------------------


def test_throughput_words_equal_the_references():
    """The bf16 words bit for bit (round to nearest even, a zero pad), and
    the round trip: the bf16 cast, exact on values bf16 holds."""
    rng = np.random.default_rng(3)
    thr = rng.uniform(0, 1.5, (257, 3)).astype(np.float32)
    thr[:8] = [[1.0, 0.5, 0.25], [0.0, 2.0, 0.125], [1.00390625, 1.01171875, 3.0],
               [1e-30, 6e4, 0.1], [1.0 + 2**-8, 1.0 + 3 * 2**-8, 1.0 - 2**-9],
               [0.3, 0.7, 0.9], [-0.5, 1e-5, 7.0], [0.0, 0.0, 0.0]]
    packed = kernels.pack_throughput_bf16(torch.from_numpy(thr))
    expected = ref_kernels.pack_throughput_bf16(jnp.asarray(thr))
    assert packed.shape == (257, 2) and packed.dtype == torch.float32
    np.testing.assert_array_equal(_u32(packed.numpy()), _u32(expected))
    unpacked = kernels.unpack_throughput_bf16(packed)
    np.testing.assert_array_equal(
        unpacked.numpy(), np.asarray(ref_kernels.unpack_throughput_bf16(expected)))
    np.testing.assert_array_equal(
        unpacked.numpy(), torch.from_numpy(thr).to(torch.bfloat16).float().numpy())
    np.testing.assert_array_equal(unpacked.numpy()[:2], thr[:2])


@pytest.mark.parametrize("quant", [0, 1])
def test_pool_carries_the_tiers_throughput_column(quant):
    """One ``PoolState`` at every tier: at 1 the throughput column holds
    bf16 words (a refilled lane packed ones) and a launch gets them
    unpacked; the alive, frame and bounce columns are the same at both."""
    window = raypool.PoolWindow(DEEP, [FRAME, FRAME + 1], width=8, height=8, samples=1,
                                max_bounces=2, pool_width=1024, device=torch.device("cpu"),
                                quant=quant)
    width = 2 if quant else 3
    state = window.initial_state()
    assert state.throughput.shape == (window.pool, width)
    assert state.throughput.dtype == torch.float32
    launches: list = []
    for index in range(2):
        state = window.iteration(state, index, launches.append)
        assert state.throughput.shape == (window.pool, width)
        assert state.alive.dtype == torch.bool and state.fid.dtype == state.bounce.dtype
    first, second = launches
    live = int(first.live)
    assert live == 128 and torch.equal(first.state[2][:live], torch.ones((live, 3)))
    thr = second.state[2]
    assert thr.shape == (window.pool, 3) and thr.dtype == torch.float32
    if quant:  # the words are bf16 values: the round trip changes none
        words = state.throughput
        assert torch.equal(kernels.pack_throughput_bf16(kernels.unpack_throughput_bf16(words)),
                           words)
        assert torch.equal(thr, thr.to(torch.bfloat16).float())


# -- whole frames --------------------------------------------------------------


SIZE = dict(width=12, height=12, samples=1, max_bounces=2)
FORMATS = [(0, "sah", 4), (1, "median", 1), (2, "sah", 4), (1, "sah", 8)]


@pytest.mark.parametrize("name", [DEEP, SHALLOW])
def test_masked_frames_equal_across_node_formats_and_builds(name):
    """The reference's property (tests/test_bvhq.py:420) in the port: the
    masked tier's frame is the same at every (quant, builder, wide)."""
    first = None
    for quant, builder, wide in [(0, "median", 1), *FORMATS]:
        kernels.reset_counts()
        image = integrator.fused_frame_renderer(
            name, SIZE["width"], SIZE["height"], SIZE["samples"], SIZE["max_bounces"], "cpu",
            quant=quant, builder=builder, wide=wide,
        )(FRAME)
        kernel = "mesh_bounce_tlas_reference" if name == DEEP else "trace_fused_mesh_tlas_reference"
        assert kernels.counts[kernels.quant_name(kernel, quant)] >= 1
        first = image if first is None else first
        assert torch.equal(image, first), (quant, builder, wide)


# -- the backend and the renderer caches -----------------------------------------


def test_backend_options_and_environment_reach_the_renderer_keys(monkeypatch):
    """``quant``, ``bvh_builder`` and ``bvh_wide`` (None: the environment's)
    resolve into the renderer's cache key; a ``TRC_BVH_QUANT=2`` environment
    reaches a ``--device cpu`` backend's launches."""
    for name in ("TRC_TLAS", "TRC_BVH_QUANT", "TRC_BVH_BUILDER", "TRC_BVH_WIDE"):
        monkeypatch.delenv(name, raising=False)
    options = dict(device="cpu", width=8, height=8, samples=1, max_bounces=2)
    backend = TorchRaytraceBackend(quant=1, bvh_builder="median", bvh_wide=2, **options)
    assert backend.tiers() == {"use_tlas": True, "quant": 1, "builder": "median", "wide": 2}
    assert backend._renderer(SHALLOW) is integrator.fused_frame_renderer(
        SHALLOW, 8, 8, 1, 2, "cpu", quant=1, builder="median", wide=2)
    monkeypatch.setenv("TRC_BVH_QUANT", "2")
    monkeypatch.setenv("TRC_TLAS", "0")
    env_backend = TorchRaytraceBackend(**options)
    assert env_backend.tiers() == {"use_tlas": False, "quant": 2, "builder": "sah", "wide": 4}
    monkeypatch.setenv("TRC_TLAS", "1")
    kernels.reset_counts()
    image = env_backend._renderer(DEEP)(FRAME)  # the wavefront tier, at tier 2
    assert image.shape == (8, 8, 3)
    assert kernels.counts["mesh_bounce_tlas_reference[q2]"] >= 2
    assert kernels.counts["mesh_bounce_tlas_reference"] == 0


def test_renderer_caches_hold_distinct_tiers_side_by_side(monkeypatch):
    """tests/test_bvhq.py:264 in the port: an environment change between
    calls resolves to another renderer, the same environment to the same."""
    monkeypatch.setenv("TRC_BVH_BUILDER", "median")
    monkeypatch.setenv("TRC_BVH_WIDE", "1")
    monkeypatch.setenv("TRC_BVH_QUANT", "0")
    a = integrator.fused_frame_renderer(DEEP, 8, 8, 1, 2, "cpu")
    monkeypatch.setenv("TRC_BVH_BUILDER", "sah")
    monkeypatch.setenv("TRC_BVH_WIDE", "4")
    b = integrator.fused_frame_renderer(DEEP, 8, 8, 1, 2, "cpu")
    monkeypatch.setenv("TRC_BVH_QUANT", "1")
    c = integrator.fused_frame_renderer(DEEP, 8, 8, 1, 2, "cpu")
    assert len({id(a), id(b), id(c)}) == 3
    assert integrator.fused_frame_renderer(DEEP, 8, 8, 1, 2, "cpu") is c
    assert integrator.fused_region_renderer(DEEP, 8, 8, 4, 4, 1, 2, "cpu") is not (
        integrator.fused_region_renderer(DEEP, 8, 8, 4, 4, 1, 2, "cpu", quant=0))
