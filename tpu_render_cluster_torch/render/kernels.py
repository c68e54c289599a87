"""The render path's kernels and their plain PyTorch versions.

Counterpart of ``tpu_render_cluster/render/pallas_kernels.py``. The
kernels of its twelve ``pallas_call`` sites, written in CUDA C++ for Hopper
and built by ``_build.py``:

- ``csrc/trace_fused.cu``, the sphere path-trace megakernel that replaces
  the TPU's ``_trace_fused`` in its positional-counter mode, and
  ``csrc/trace_fused_lanes.cu``, the same kernel in the TPU kernel's
  ``lane_io`` mode (the RNG counters from a per-ray lane row, for the
  region path of a tile; its body shared through ``csrc/trace_fused.cuh``:
  persistent blocks whose threads take a new ray from a work counter
  whenever their path ends);
- ``csrc/trace_fused_mesh.cu``, the mesh megakernel that replaces
  ``_trace_fused_mesh``: spheres, the plane and K rigid instances of one
  mesh walked through its threaded BVH, over the whole bounce loop;
- ``csrc/sphere_bounce.cu`` and ``csrc/mesh_bounce.cu``, one bounce of
  each megakernel with the path state streamed in and out (the TPU's
  ``_sphere_bounce`` and ``_mesh_bounce_io``, flat instance variant), for
  the deep-mesh loop of ``integrator.trace_paths`` and the wavefront
  tier of ``compaction.py``;
- ``csrc/pool_sphere_bounce.cu`` and ``csrc/pool_mesh_bounce.cu``, one
  bounce over a ray pool whose lanes come from several frames of one
  scene (the TPU's ``pool_sphere_bounce`` and ``pool_mesh_bounce``, flat
  instance variant), for the device-resident ray pool of ``raypool.py``:
  each lane carries its frame id, frame seed and bounce, and sees only its
  own frame's rows of the stacked scene (``PoolSphereOperands``,
  ``PoolMeshOperands``);
- the unit kernels of the per-bounce scan renderer (``integrator``'s
  ``bounce_scan`` tier): ``csrc/intersect_spheres.cu`` and
  ``csrc/occluded_spheres.cu``, rays against the spheres (the TPU's
  ``_nearest_hit`` and ``_any_hit``), and ``csrc/intersect_instances.cu``
  and ``csrc/occluded_instances.cu``, rays against every instance of a
  mesh (``_bvh_nearest_instanced`` and ``_bvh_anyhit_instanced``; persistent
  blocks, a group of G threads a ray: ``instance_group`` of the launch's
  width, or in the any-hit each warp's pick for its compacted walking
  rays), and
  ``csrc/intersect_mesh.cu`` and ``csrc/occluded_mesh.cu``, object-space
  rays against one mesh's BVH (``_bvh_nearest`` and ``_bvh_anyhit``), which
  the scan's per-instance branch launches once per instance;
- the two-level (TLAS) variants of the three mesh path kernels,
  ``csrc/trace_fused_mesh_tlas.cu``, ``csrc/mesh_bounce_tlas.cu`` and
  ``csrc/pool_mesh_bounce_tlas.cu`` (the TPU kernels with ``use_tlas``, the
  reference's default): the instances in Morton slot order
  (``tlas_frame``), walked through a threaded tree of their world boxes;
  the per-bounce and pool variants also write the next sort's coherence key
  of each lane (``coherence_key``), whose candidate comes from a walk of
  the same tree over the instances' world boxes alone. ``use_tlas=None``
  takes them wherever the reference does (``use_tlas_for``: more instances
  than a TLAS leaf holds); ``use_tlas=False`` the flat instance sweep. The
  per-bounce and pool ones walk each ray with a group of G threads
  (``GROUPS``; the pool's ``POOL_GROUP``, the per-bounce one's
  ``bounce_group`` of the launch's width), bit for bit the one-thread walk;
  the per-bounce one runs persistent blocks that take rays from a work
  counter (``_work_counter``), the pool one stages only its blocks' frames;
  the megakernel runs persistent blocks that take packets from a work
  counter, each packet's state in shared memory and its live lanes
  compacted each bounce.

The walk order of rows 3, 4 and 6 (the three mesh path kernels, flat and
TLAS) is the reference's default: on a BVH with octant tables (every
``sah`` build; ``walks_ordered``) each walk takes one of eight near-first
re-threadings of the node tables, the one of its packet's majority vote
over its lanes' directions (``packet_octants``: a packet is the reference
kernel's ray block, ``tlas_block`` lanes under the TLAS, else
``BVH_BLOCK_R``, in launch order), a BLAS walk by the packet's directions
in the instance's object space (``packet_instance_octants``), a TLAS walk by
the world directions, a shadow walk by the sun's; the pool orders its BLAS
only. A megakernel votes inside the launch (a block walks a packet at a
time). A per-bounce or pool launch brings its passes (``ORDERED_PASSES``):
the vote pass ``csrc/packet_octants.cu`` before it (a pool's only for the
frames each packet's lanes carry) and, for the per-bounce TLAS
kernel, the key pass ``csrc/mesh_entry_keys.cu`` after it, whose entry walk
votes over the packet's new directions (``entry_keys``: a block of a
packet's lanes, 256 by default, the walk one box test a step; a wide launch runs
persistent blocks that stage the eight octant tables once and take packets
from a work counter). A BVH without
octant tables takes the canonical order, as in the reference.

``trace_paths_fused`` / ``trace_paths_fused_mesh`` / ``sphere_bounce`` /
``mesh_bounce`` / ``pool_sphere_bounce`` / ``pool_mesh_bounce`` and the
unit kernels' ``intersect_spheres`` / ``occluded_spheres`` /
``intersect_instances`` / ``occluded_instances`` / ``intersect_mesh`` /
``occluded_mesh`` launch their kernel for
CUDA tensors, and raise if they cannot. For CPU tensors they run the plain
versions (``..._reference``), which repeat the reference's arithmetic
operation for operation; there is no fallback from one to the other.
``counts`` records kernel launches and plain-version calls, so a run can
show which one the main path went through; a TLAS variant counts under its
own name (``..._tlas``, ``..._tlas_reference``).

The node format of rows 3, 4 and 6 and the key pass (the reference's
``TRC_BVH_QUANT`` tiers, ``quant``): 0 the fp32 tables; 1 and 2 the
quantized ones (``mesh.quantize_node_tables``: 16-bit or 8-bit slabs and
one meta word a node, 16 or 12 bytes), which the kernels read through the
node-format template of ``csrc/mesh_common.cuh`` and reconstruct as
``origin + q * cell``. A quantized box contains its fp32 original, so the
walk visits a superset of the fp32 walk's nodes and every result is the
fp32 walk's; only the keyed launches (row 4 TLAS, its key pass, row 6
TLAS) change a column: a lane that hit an instance keys with that slot
and drives no entry walk (the packed-key rule). A wrapper takes the tier
it is given (the drivers resolve it, ``integrator.resolve_bvh_config``),
degraded to 0 by the reference's range rule (``resolve_bvh_quant``), and
counts its launches under the tier's own name (``quant_name``). The
quantized tables are packed once per BVH and tier, a frame's TLAS where
its operands lie (``tlas_quant_table``), a pool window's frames against
one grid (``pool_tlas_quant``).

The TLAS tiers (the reference's ``TRC_TLAS_LEAF`` and ``TRC_TLAS_BLOCK``):
a frame's TLAS holds ``mesh.tlas_leaf`` instances a leaf (``mesh_leaf``: 1
to 16, ``TLAS_LEAF`` by default), which shapes its topology and operands and
decides whether a field takes the TLAS at all (``use_tlas_for``); the TLAS
kernels (rows 3, 4 and 6 TLAS, their vote and the key pass) walk packets of
``tlas_block`` lanes (``TLAS_PACKETS``: 128, 256, 512 or 1,024;
``TLAS_BLOCK_R`` by default), a compile-time width of their CUDA sources,
one library a width (``_build.variant``). A wrapper takes the width it is
given and raises for any other; a launch at a width other than
``TLAS_BLOCK_R`` counts under its name with the width appended
(``packet_name``: ``mesh_bounce_tlas[p128]``). The drivers resolve both
tiers (``integrator.resolve_tlas_config``; the environment's resolvers
``tlas_leaf_size`` and ``tlas_block_r`` are the reference's).

RNG: a counter-based PCG hash of (lane, bounce, seed), the same portable
integer hash the TPU kernel uses, so the kernel and the plain version draw
the reference's random numbers bit for bit. The per-bounce kernels take
each ray's original lane, so a ray's stream survives re-sorts.
"""

from __future__ import annotations

import ctypes
import functools
import logging
import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

from tpu_render_cluster_torch.render.fp32 import INV_PI, dot3, fma
from tpu_render_cluster_torch.render.fp32 import sqrt as fp32_sqrt
from tpu_render_cluster_torch.render.mesh import (
    LEAF_SIZE,
    QUANT_MAX_COUNT,
    QUANT_MAX_FIRST_UNITS,
    QUANT_MAX_NODES,
    MeshBVH,
    MeshSet,
    TlasFrame,
    TlasTopology,
    cached_tlas_topology,
    dequantize_node_bounds,
    instance_morton_order,
    morton_dilate5,
    quant_grid,
    quantize_node_tables,
    tlas_node_bounds,
    unpack_node_meta,
)
from tpu_render_cluster_torch.render.rng import MASK32
from tpu_render_cluster_torch.render.scene import Scene
from tpu_render_cluster_torch.utils.env import env_int, env_str

logger = logging.getLogger(__name__)

EPS = 1e-3
INF = 1e30
MAX_SPHERES = 128  # the kernels' shared-memory sphere table
_SPHERE_ALIGN = 8  # the reference pads the sphere count to a multiple of 8
# Mesh-megakernel dispatch bound: the whole-bounce-loop kernel takes a mesh
# scene when BVH nodes x instances is at most this (the reference's rule).
MESH_MEGAKERNEL_MAX_WALK = 1024
_DET_EPS = 1e-12  # Moller-Trumbore's parallel-ray threshold
# The two-level walk: instances per TLAS leaf (the reference's
# ``tlas_leaf_size()`` default; ``TRC_TLAS_LEAF`` clamps to [1,
# TLAS_LEAF_MAX]), and its ray block (``tlas_block_r()``'s default), the TLAS
# tiers' packet and their bucket and lane quantum; the packets the kernels
# are built for (``TRC_TLAS_BLOCK`` snaps to one of them).
TLAS_LEAF = 4
TLAS_LEAF_MAX = 16
TLAS_BLOCK_R = 256
TLAS_PACKETS = (128, 256, 512, 1024)
# The flat instance sweep's ray block (the reference's ``BVH_BLOCK_R``): the
# packet of the flat variants' octant vote.
BVH_BLOCK_R = 1024
# The coherence key's dead flag; the key stays below 2^30, so it sorts as
# a positive int32.
KEY_DEAD_BIT = 29
# The group walk of the TLAS per-bounce and pool kernels: G threads of a
# warp walk one ray (csrc/mesh_common.cuh, GroupTlas). The pool kernel's G
# is the best of a measured sweep on the H100 (PERF.md); the per-bounce
# kernel's follows each launch's width (``bounce_group``).
GROUPS = (1, 2, 4, 8)
POOL_GROUP = 4
# The reference's default pool window (``TRC_RAYPOOL_FRAMES``): it pads a
# window to this many frames, and its node format's degrade rule counts the
# padded window's TLAS (``pool_quant``).
RAYPOOL_FRAMES = 8
# The scan's instanced any-hit kernel's default G: 0, each warp's pick for
# its batch of walking rays (the nearest hit's G: ``instance_group``).
OCCLUDED_GROUP = 0

# Kernel launches ("trace_fused", its lane mode "trace_fused_lanes",
# "trace_fused_mesh", "sphere_bounce", "mesh_bounce", "pool_sphere_bounce",
# "pool_mesh_bounce", the TLAS variants "trace_fused_mesh_tlas",
# "mesh_bounce_tlas", "pool_mesh_bounce_tlas" and the unit kernels
# "intersect_spheres", "occluded_spheres", "intersect_instances",
# "occluded_instances", "intersect_mesh", "occluded_mesh", and the ordered
# walk's passes "packet_octants" and "mesh_entry_keys") and plain-version
# calls ("..._reference") since the last reset_counts().
counts = {
    "trace_fused": 0,
    "trace_fused_reference": 0,
    "trace_fused_mesh": 0,
    "trace_fused_mesh_reference": 0,
    "sphere_bounce": 0,
    "sphere_bounce_reference": 0,
    "mesh_bounce": 0,
    "mesh_bounce_reference": 0,
    "pool_sphere_bounce": 0,
    "pool_sphere_bounce_reference": 0,
    "pool_mesh_bounce": 0,
    "pool_mesh_bounce_reference": 0,
    "intersect_spheres": 0,
    "intersect_spheres_reference": 0,
    "occluded_spheres": 0,
    "occluded_spheres_reference": 0,
    "intersect_instances": 0,
    "intersect_instances_reference": 0,
    "occluded_instances": 0,
    "occluded_instances_reference": 0,
    "intersect_mesh": 0,
    "intersect_mesh_reference": 0,
    "occluded_mesh": 0,
    "occluded_mesh_reference": 0,
    "trace_fused_mesh_tlas": 0,
    "trace_fused_mesh_tlas_reference": 0,
    "mesh_bounce_tlas": 0,
    "mesh_bounce_tlas_reference": 0,
    "pool_mesh_bounce_tlas": 0,
    "pool_mesh_bounce_tlas_reference": 0,
    "trace_fused_lanes": 0,
    "trace_fused_lanes_reference": 0,
    "packet_octants": 0,
    "packet_octants_reference": 0,
    "mesh_entry_keys": 0,
    "mesh_entry_keys_reference": 0,
}

# The kernels that read node tables, and so take a quantized node format:
# rows 3, 4 and 6, flat and TLAS, and the key pass. A launch at tier 1 or 2
# (and a plain-version call) counts under its name with the tier appended
# (``quant_name``), not under the fp32 name; such a count enters ``counts``
# with its first launch and leaves it at ``reset_counts``.
QUANT_KERNELS = (
    "trace_fused_mesh", "trace_fused_mesh_tlas", "mesh_bounce", "mesh_bounce_tlas",
    "pool_mesh_bounce", "pool_mesh_bounce_tlas", "mesh_entry_keys",
)
QUANT_TIERS = (1, 2)
_FP32_COUNTS = frozenset(counts)


def quant_name(name: str, quant: int) -> str:
    """The count of ``name`` (a kernel or its ``_reference``) at node
    format ``quant``: ``name`` itself at 0, else ``name[q<quant>]``."""
    return f"{name}[q{quant}]" if quant else name


# The kernels of the TLAS tiers' packet: a launch at a width other than
# TLAS_BLOCK_R (and a plain-version call) counts under its name with the
# width appended (``packet_name``).
PACKET_KERNELS = (
    "trace_fused_mesh_tlas", "mesh_bounce_tlas", "pool_mesh_bounce_tlas", "mesh_entry_keys",
    "packet_octants",
)


def packet_name(name: str, packet: int | None) -> str:
    """The count of ``name`` at the TLAS packet ``packet``: ``name`` itself
    at ``TLAS_BLOCK_R`` (or None), else ``name[p<packet>]``."""
    return name if packet is None or packet == TLAS_BLOCK_R else f"{name}[p{packet}]"


def _count(name: str, quant: int = 0, packet: int | None = None) -> None:
    key = packet_name(quant_name(name, quant), packet)
    counts[key] = counts.get(key, 0) + 1


# The passes one launch of a per-bounce or pool mesh kernel brings with it
# on the octant-ordered walk (a BVH with octant tables): the packet vote
# before it and, for the per-bounce TLAS kernel, the key's entry walk after.
ORDERED_PASSES = {
    "mesh_bounce": ("packet_octants",),
    "mesh_bounce_tlas": ("packet_octants", "mesh_entry_keys"),
    "pool_mesh_bounce": ("packet_octants",),
    "pool_mesh_bounce_tlas": ("packet_octants",),
}


def launch_names(kernel: str, ordered: bool = True, quant: int = 0,
                 packet: int | None = None) -> tuple[str, ...]:
    """The counts one launch of ``kernel`` through its wrapper adds one to:
    its own and, on the octant-ordered walk, its passes', at node format
    ``quant`` (the tier the launch resolved to) and, for a TLAS kernel, at
    the TLAS packet ``packet``."""
    names = (kernel, *ORDERED_PASSES.get(kernel, ())) if ordered else (kernel,)
    names = tuple(quant_name(n, quant) if n in QUANT_KERNELS else n for n in names)
    if kernel not in PACKET_KERNELS:
        return names
    return tuple(packet_name(n, packet) for n in names)


def reset_counts() -> None:
    for name in list(counts):
        if name in _FP32_COUNTS:
            counts[name] = 0
        else:
            del counts[name]


def bounce_group(rays: int, card_threads: int) -> int:
    """The group size of a ``mesh_bounce_tlas`` launch of ``rays`` rays:
    the smallest G whose ``rays * G`` reaches ``card_threads``, at most 8.
    The threshold the wrapper passes is the card's thread slots
    (``thread_slots``: 270,336 on an H100), a tuned constant, not the
    threads this kernel holds resident (3 blocks of 256 an SM, 101,376 on
    an H100). On the G sweep of the four launch widths of a 512x512x8 frame
    of 03_physics-2-mesh (2,097,152 twice, 262,144, 131,072) it picks the
    best G or one within 1% at every width; the resident threads would put
    the two narrow launches at G = 1, 1.3x and 2.5x slower (PERF.md). Other
    widths, such as the tile paths' launches, were not swept."""
    for group in GROUPS[:-1]:
        if rays * group >= card_threads:
            return group
    return GROUPS[-1]


def instance_group(rays: int, card_threads: int) -> int:
    """The group size of an ``intersect_instances`` launch of ``rays``
    rays: ``bounce_group``'s rule with half the card's thread slots as its
    threshold (135,168 on an H100). On the G sweep at the four bounces of a
    512x512 scan sample (262,144 rays) and of a 256x256 one (65,536) it
    picks G = 1 and G = 4, the best summed over the four bounces at each
    width (PERF.md); the whole slots would put 262,144 rays at G = 2."""
    return bounce_group(rays, card_threads // 2)


@functools.cache
def thread_slots(device_index: int) -> int:
    """The threads a CUDA card can hold at once: SMs x threads per SM."""
    props = torch.cuda.get_device_properties(device_index)
    return props.multi_processor_count * getattr(props, "max_threads_per_multi_processor", 2048)


def _check_group(group: int | None, allowed: tuple = GROUPS) -> None:
    if group is not None and group not in allowed:
        raise ValueError(f"_group must be one of {allowed}, got {group}")


def use_tlas_for(k_count: int, use_tlas: bool | None = None, leaf: int | None = None) -> bool:
    """Whether a field of ``k_count`` instances takes the two-level walk:
    ``use_tlas`` (None: on, the reference's default) and more instances
    than one TLAS leaf of ``leaf`` holds (None: ``TLAS_LEAF``; a smaller
    field is the flat sweep plus a root test). The reference's rule; its
    environment tiers ``TRC_TLAS`` and ``TRC_TLAS_LEAF`` are resolved by the
    drivers (``integrator.resolve_bvh_config``, ``resolve_tlas_config``),
    never here."""
    leaf = TLAS_LEAF if leaf is None else leaf
    return (True if use_tlas is None else bool(use_tlas)) and k_count > leaf


def mesh_leaf(mesh: MeshSet) -> int:
    """The instances a leaf of ``mesh``'s TLAS holds (``MeshSet.tlas_leaf``;
    None: ``TLAS_LEAF``); raises outside [1, TLAS_LEAF_MAX]."""
    leaf = TLAS_LEAF if mesh.tlas_leaf is None else int(mesh.tlas_leaf)
    if not 1 <= leaf <= TLAS_LEAF_MAX:
        raise ValueError(f"a TLAS leaf holds 1 to {TLAS_LEAF_MAX} instances, not {leaf}")
    return leaf


def tlas_packet(block: int | None) -> int:
    """A TLAS launch's packet: ``block`` (None: ``TLAS_BLOCK_R``), one of
    the widths the kernels are built for (``TLAS_PACKETS``); raises for any
    other, never rounds."""
    block = TLAS_BLOCK_R if block is None else int(block)
    if block not in TLAS_PACKETS:
        raise ValueError(f"a TLAS packet is one of {TLAS_PACKETS} lanes, not {block}")
    return block


def tlas_leaf_size() -> int:
    """The ``TRC_TLAS_LEAF`` tier: instances per TLAS leaf (default 4),
    clamped to [1, TLAS_LEAF_MAX] (the reference's ``tlas_leaf_size``)."""
    return max(1, min(env_int("TRC_TLAS_LEAF", TLAS_LEAF), TLAS_LEAF_MAX))


def tlas_block_r() -> int:
    """The ``TRC_TLAS_BLOCK`` tier: the TLAS kernels' packet (default 256),
    snapped down to a power of two in [128, BVH_BLOCK_R], a value below 256
    to 128 (the reference's ``tlas_block_r``)."""
    raw = env_int("TRC_TLAS_BLOCK", TLAS_BLOCK_R)
    block = TLAS_PACKETS[0]
    while block * 2 <= min(raw, BVH_BLOCK_R):
        block *= 2
    return block


def tlas_enabled() -> bool:
    """The ``TRC_TLAS`` tier: the two-level walk unless it says 0, false,
    off or no (default on)."""
    value = env_str("TRC_TLAS")
    return value is None or value not in ("0", "false", "off", "no")


def bvh_quant_mode() -> int:
    """The ``TRC_BVH_QUANT`` tier, clamped to [0, 2] (default 0): the node
    format of rows 3, 4 and 6 and, at 1 or 2, the bf16-packed throughput
    the wavefront and the pool carry between launches."""
    return max(0, min(env_int("TRC_BVH_QUANT", 0), 2))


def resolve_bvh_quant(quant: int, *tables: tuple[int, int, int]) -> int:
    """The node format a launch takes: ``quant`` clamped to [0, 2], or 0
    when a node table outgrows the meta word's ranges (the reference's
    rule, ``pallas_kernels.py:202-233``). Each table is (nodes, ``first``
    units, largest count); the skip links range over [0, nodes], so nodes
    must stay below 2^16. A degrade is logged once per tables."""
    if not quant:
        return 0
    for n_nodes, first_units, max_count in tables:
        if (n_nodes >= QUANT_MAX_NODES or first_units > QUANT_MAX_FIRST_UNITS
                or max_count > QUANT_MAX_COUNT):
            _log_degrade(int(quant), tuple(tables))
            return 0
    return max(0, min(int(quant), 2))


@functools.cache
def _log_degrade(quant: int, tables: tuple) -> None:
    logger.warning("node format %d degraded to 0: a table of %s passes the meta word's "
                   "ranges (nodes < %d, first units <= %d, count <= %d)", quant, tables,
                   QUANT_MAX_NODES, QUANT_MAX_FIRST_UNITS, QUANT_MAX_COUNT)


def _blas_counts(bvh: MeshBVH) -> tuple[int, int, int]:
    """A BVH's node table as ``resolve_bvh_quant`` counts it (the
    reference's: the largest count is a leaf slot's rows)."""
    return (bvh.skip.shape[0], bvh.v0.shape[0] // LEAF_SIZE, LEAF_SIZE)


def _tlas_counts(k_count: int, frames: int = 1, leaf: int | None = None) -> tuple[int, int, int]:
    """A TLAS of ``frames`` stacked K-slot windows of ``leaf``-instance
    leaves (None: ``TLAS_LEAF``) as ``resolve_bvh_quant`` counts it."""
    leaf = TLAS_LEAF if leaf is None else leaf
    m = len(cached_tlas_topology(k_count, leaf).skip)
    return (frames * m, frames * k_count, leaf)


def mesh_quant(mesh: MeshSet, quant: int, tlas: bool, frames: int = 1) -> int:
    """The node format a launch over ``mesh`` (``tlas``: its TLAS too, of
    ``frames`` stacked windows) takes at tier ``quant``."""
    tables = [_blas_counts(mesh.bvh)]
    if tlas:
        tables.append(_tlas_counts(mesh.instances.translation.shape[0], frames, mesh_leaf(mesh)))
    return resolve_bvh_quant(quant, *tables)


# ---------------------------------------------------------------------------
# The carried state of the quantized tiers (the reference's
# ``pallas_kernels.py:363-385``): the wavefront and the pool carry the
# throughput column as bf16, two to a float32 word ([R, 2] words for [R, 3]
# values, one pad). The kernels compute in float32: the drivers pack after
# a launch and unpack before the next.


def pack_throughput_bf16(throughput: torch.Tensor) -> torch.Tensor:
    """[R, 3] float32 -> [R, 2] float32 words holding 4 bf16 lanes (the
    three values rounded to nearest even, then a zero), the reference's
    words bit for bit."""
    half = torch.cat([
        throughput.to(torch.bfloat16),
        torch.zeros((throughput.shape[0], 1), dtype=torch.bfloat16, device=throughput.device),
    ], dim=1)
    return half.view(torch.float32)


def unpack_throughput_bf16(packed: torch.Tensor) -> torch.Tensor:
    """The inverse of ``pack_throughput_bf16``: [R, 2] words -> [R, 3]
    float32."""
    return packed.contiguous().view(torch.bfloat16)[:, :3].to(torch.float32)


def pcg_hash(x: torch.Tensor) -> torch.Tensor:
    """PCG output permutation on uint32 words held in int64 (wraps mod 2^32)."""
    state = (x * 747796405 + 2891336453) & MASK32
    shift = (state >> 28) + 4
    word = (((state >> shift) ^ state) * 277803737) & MASK32
    return (word >> 22) ^ word


def uniform_from_hash(h: torch.Tensor) -> torch.Tensor:
    """uint32 word -> float32 in [0, 1) from its top 24 bits."""
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


class SphereTable(NamedTuple):
    """The scene as both versions consume it, spheres padded to 8."""

    centers: torch.Tensor  # [N, 3]
    r2: torch.Tensor  # [N] radius^2, 0 for pad slots (never hit)
    csq: torch.Tensor  # [N] |c|^2
    radius: torch.Tensor  # [N]
    albedo: torch.Tensor  # [N, 3]
    emission: torch.Tensor  # [N, 3]
    dc_sun: torch.Tensor  # [N] c . sun
    sun_direction: torch.Tensor  # [3]
    sun_color: torch.Tensor
    sky_horizon: torch.Tensor
    sky_zenith: torch.Tensor
    plane_albedo_a: torch.Tensor
    plane_albedo_b: torch.Tensor


def sphere_table(scene: Scene) -> SphereTable:
    """Pad the spheres to a multiple of 8 and precompute |c|^2 and c . sun,
    as the reference's wrapper does (``_trace_fused``)."""
    n = scene.centers.shape[0]
    if n > MAX_SPHERES:
        raise ValueError(
            f"Scene has {n} spheres; the trace_fused kernel takes at most {MAX_SPHERES}."
        )
    pad = -(-n // _SPHERE_ALIGN) * _SPHERE_ALIGN - n
    centers = torch.nn.functional.pad(scene.centers, (0, 0, 0, pad))
    radius = torch.nn.functional.pad(scene.radii, (0, pad))
    sun = scene.sun_direction
    return SphereTable(
        centers=centers,
        r2=radius * radius,
        csq=dot3(centers, centers),
        radius=radius,
        albedo=torch.nn.functional.pad(scene.albedo, (0, 0, 0, pad)),
        emission=torch.nn.functional.pad(scene.emission, (0, 0, 0, pad)),
        dc_sun=dot3(centers, sun.expand_as(centers)),
        sun_direction=sun,
        sun_color=scene.sun_color,
        sky_horizon=scene.sky_horizon,
        sky_zenith=scene.sky_zenith,
        plane_albedo_a=scene.plane_albedo_a,
        plane_albedo_b=scene.plane_albedo_b,
    )


def _check_inputs(scene: Scene, origins: torch.Tensor, directions: torch.Tensor, seed) -> None:
    if not -(2**31) <= int(seed) < 2**31:
        raise ValueError(f"seed {seed} is not an int32")
    _check_rays(scene.centers, origins, directions)


def _check_rays(table: torch.Tensor, origins: torch.Tensor, directions: torch.Tensor) -> None:
    """Rays [R, 3] float32, on the device of ``table`` (a scene or mesh tensor)."""
    if origins.ndim != 2 or origins.shape[1] != 3 or origins.shape != directions.shape:
        raise ValueError(
            f"origins and directions must both be [R, 3]; got "
            f"{tuple(origins.shape)} and {tuple(directions.shape)}"
        )
    for name, tensor in (("origins", origins), ("directions", directions)):
        if tensor.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {tensor.dtype}")
    devices = {origins.device, directions.device, table.device}
    if len(devices) != 1:
        raise ValueError(f"rays and scene must share one device, got {devices}")


def _check_lane(origins: torch.Tensor, lane: torch.Tensor | None) -> None:
    """A lane row: int32 ``[R]`` on the rays' device."""
    if lane is None:
        return
    if lane.dtype != torch.int32:
        raise TypeError(f"lane must be int32, got {lane.dtype}")
    if lane.shape != (origins.shape[0],):
        raise ValueError(f"lane must be [{origins.shape[0]}], got {tuple(lane.shape)}")
    if lane.device != origins.device:
        raise ValueError(f"lane is on {lane.device}, the rays on {origins.device}")


def trace_paths_fused(
    scene: Scene,
    origins: torch.Tensor,
    directions: torch.Tensor,
    seed: int,
    *,
    max_bounces: int,
    lane: torch.Tensor | None = None,
) -> torch.Tensor:
    """Path-trace each ray through the whole bounce loop; radiance ``[R, 3]``.

    ``seed`` is the frame's int32 trace seed (``integrator.trace_seed``);
    ray ``i``'s random numbers come from lane ``i``, or with ``lane`` (int32
    ``[R]``, the TPU kernel's ``lane_io`` mode) from lane ``lane[i]``: the
    region path gives each ray its lane in the whole frame. CUDA tensors go
    to the kernel (``trace_fused``, with ``lane`` ``trace_fused_lanes``),
    CPU tensors to the plain version.
    """
    _check_inputs(scene, origins, directions, seed)
    _check_lane(origins, lane)
    if origins.device.type == "cuda":
        return _launch_trace_fused(scene, origins, directions, seed, max_bounces, lane)
    if origins.device.type == "cpu":
        return trace_paths_fused_reference(
            scene, origins, directions, seed, max_bounces=max_bounces, lane=lane
        )
    raise ValueError(f"Unsupported device {origins.device}")


_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# Each kernel's C entry ``<name>_launch`` (csrc/<name>.cu): its argument
# types. A per-bounce launch takes the five state rows, n_rays and the live
# count, the tables, three ints (seed, bounce, total_bounces; a pool launch
# only total_bounces), the five outputs and the stream.
_STATE_ARGTYPES = [_PTR] * 5 + [_INT, _PTR]
_POOL_STATE_ARGTYPES = [_PTR] * 8 + [_INT, _PTR]
_SPHERE_ARGTYPES = [_PTR, _INT, _PTR]  # spheres, their count, params
_POOL_SPHERE_ARGTYPES = [_PTR, _INT, _INT, _PTR]  # spheres, per frame, frames, params
# triangle rows, their count, node bounds, links, nodes
_BVH_ARGTYPES = [_PTR, _INT, _PTR, _PTR, _INT]
# instances, their count, and the BVH
_MESH_ARGTYPES = [_PTR, _INT, *_BVH_ARGTYPES]
# TLAS node bounds, links, nodes (a pool: per frame)
_TLAS_ARGTYPES = [_PTR, _PTR, _INT]
_OUTPUT_ARGTYPES = [_PTR] * 6
# A TLAS bounce: the key window, after the tables; the key, after the outputs.
_KEYED_OUTPUT_ARGTYPES = [_PTR] * 7
# The walk order of rows 3, 4 and 6, after their tables: `ordered` (the
# node tables are the eight octant orders stacked) and, per bounce and
# pool, the packet votes of ``packet_octants`` (the per-bounce TLAS
# kernel: the world octants, then the slots'; the others the slots'; an
# ordered per-bounce TLAS launch takes the votes for its flag).
_LAUNCH_ARGTYPES = {
    # Row 1's persistent blocks: after the radiance, the work counter.
    "trace_fused": [_PTR, _PTR, _INT, *_SPHERE_ARGTYPES, _INT, _INT, _PTR, _PTR, _PTR],
    "trace_fused_lanes": [
        _PTR, _PTR, _PTR, _INT, *_SPHERE_ARGTYPES, _INT, _INT, _PTR, _PTR, _PTR,
    ],
    # The mesh path kernels and the key pass end with their node format:
    # the tier and the host address of each node table's grid (BLAS, then
    # TLAS), then the stream.
    "trace_fused_mesh": [
        _PTR, _PTR, _INT, *_SPHERE_ARGTYPES, *_MESH_ARGTYPES, _INT, _INT, _INT, _PTR, _INT,
        _PTR, _PTR,
    ],
    "sphere_bounce": [*_STATE_ARGTYPES, *_SPHERE_ARGTYPES, _INT, _INT, _INT, *_OUTPUT_ARGTYPES],
    "mesh_bounce": [
        *_STATE_ARGTYPES, *_SPHERE_ARGTYPES, *_MESH_ARGTYPES, _INT, _PTR, _INT, _INT, _INT,
        *_OUTPUT_ARGTYPES[:-1], _INT, _PTR, _PTR,
    ],
    "pool_sphere_bounce": [
        *_POOL_STATE_ARGTYPES, *_POOL_SPHERE_ARGTYPES, _INT, *_OUTPUT_ARGTYPES,
    ],
    "pool_mesh_bounce": [
        *_POOL_STATE_ARGTYPES, *_POOL_SPHERE_ARGTYPES, *_MESH_ARGTYPES, _INT, _PTR, _INT,
        *_OUTPUT_ARGTYPES[:-1], _INT, _PTR, _PTR,
    ],
    # The TLAS megakernel's persistent blocks: after the radiance, the work
    # counter.
    "trace_fused_mesh_tlas": [
        _PTR, _PTR, _INT, *_SPHERE_ARGTYPES, *_MESH_ARGTYPES, *_TLAS_ARGTYPES, _INT, _INT, _INT,
        _PTR, _PTR, _INT, _PTR, _PTR, _PTR,
    ],
    # The group walk's kernels: after the key, the group size G; the
    # per-bounce one then its work counter, and after its node format the
    # hit column of its key pass (the packed-key rule; null where none).
    "mesh_bounce_tlas": [
        *_STATE_ARGTYPES, *_SPHERE_ARGTYPES, *_MESH_ARGTYPES, *_TLAS_ARGTYPES, _PTR, _PTR, _PTR,
        _INT, _INT, _INT, *_KEYED_OUTPUT_ARGTYPES[:-1], _INT, _PTR, _INT, _PTR, _PTR, _PTR,
        _PTR,
    ],
    "pool_mesh_bounce_tlas": [
        *_POOL_STATE_ARGTYPES, *_POOL_SPHERE_ARGTYPES, *_MESH_ARGTYPES, *_TLAS_ARGTYPES, _PTR,
        _INT, _PTR, _INT, *_KEYED_OUTPUT_ARGTYPES[:-1], _INT, _INT, _PTR, _PTR, _PTR,
    ],
    # The ordered walk's vote pre-pass: directions, n_rays, the live count,
    # the packet, the lanes' frame ids (null: every row) and the rows per
    # frame, the instance rows and their count, the world octants and the
    # slots' (each may be null), the stream.
    "packet_octants": [_PTR, _INT, _PTR, _INT, _PTR, _INT, _PTR, _INT, _PTR, _PTR, _PTR],
    # The ordered per-bounce TLAS launch's keys: its outputs' origins,
    # directions and alive, n_rays, the live count, the slots and their
    # count, the ordered TLAS (bounds, links, M), the key window, bounce,
    # total_bounces, the key, its persistent blocks' work counter, the
    # node format (the tier, the TLAS grid), the bounce's hit column (the
    # packed-key rule; null at tier 0), the stream.
    "mesh_entry_keys": [
        _PTR, _PTR, _PTR, _INT, _PTR, _PTR, _INT, _PTR, _PTR, _INT, _PTR, _INT, _INT, _PTR, _PTR,
        _INT, _PTR, _PTR, _PTR,
    ],
    # A unit kernel: the rays (and its per-ray input), n_rays, the tables,
    # its outputs and the stream.
    "intersect_spheres": [_PTR, _PTR, _INT, *_SPHERE_ARGTYPES, _PTR, _PTR, _PTR],
    "occluded_spheres": [_PTR, _PTR, _INT, *_SPHERE_ARGTYPES, _PTR, _PTR],
    # The instanced ones: after the outputs, the group size G and the work
    # counter.
    "intersect_instances": [
        _PTR, _PTR, _PTR, _INT, *_MESH_ARGTYPES, _PTR, _PTR, _PTR, _INT, _PTR, _PTR,
    ],
    "occluded_instances": [_PTR, _PTR, _PTR, _INT, *_MESH_ARGTYPES, _PTR, _INT, _PTR, _PTR],
    "intersect_mesh": [_PTR, _PTR, _PTR, _INT, *_BVH_ARGTYPES, _PTR, _PTR, _PTR],
    "occluded_mesh": [_PTR, _PTR, _PTR, _INT, *_BVH_ARGTYPES, _PTR, _PTR],
}


@functools.cache
def _library(name: str, packet: int | None = None) -> ctypes.CDLL:
    """The kernel's library, built first if needed, with its C entry points
    typed once, when it loads; a TLAS kernel's at the packet ``packet``
    (None: the default width), whose build must say it is that width's."""
    from tpu_render_cluster_torch.render import _build

    library = _build.load(_build.variant(name, packet))
    if name in _build.PACKET_SOURCES:
        built = getattr(library, f"{name}_packet")()
        if built != (packet or _build.DEFAULT_PACKET):
            raise RuntimeError(f"{name}: the library for {packet} lanes was built for {built}")
    launch = getattr(library, f"{name}_launch")
    launch.argtypes = _LAUNCH_ARGTYPES[name]
    launch.restype = ctypes.c_int
    getattr(library, f"{name}_error_string").argtypes = [ctypes.c_int]
    getattr(library, f"{name}_error_string").restype = ctypes.c_char_p
    return library


def _check_status(library, name: str, status: int) -> None:
    if status != 0:
        message = getattr(library, f"{name}_error_string")(status).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {status} ({message})")


class _IdentityCache:
    """``build(obj)`` kept for the last few objects it was called with,
    keyed by identity: a BVH, a frame's scene or MeshSet, whose tensors are
    never changed in place. An entry holds its object, so the id is not
    reused meanwhile. The wrappers launch once per bounce on the same
    frame, so its operands are built once per frame, not per launch."""

    def __init__(self, build, entries: int = 8) -> None:
        self._build = build
        self._entries: dict[int, tuple[object, object]] = {}
        self._size = entries

    def __call__(self, obj):
        entry = self._entries.get(id(obj))
        if entry is not None and entry[0] is obj:
            return entry[1]
        value = self._build(obj)
        if len(self._entries) >= self._size:
            del self._entries[next(iter(self._entries))]
        self._entries[id(obj)] = (obj, value)
        return value


def _pack_spheres(scene: Scene) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernels' sphere table ([N, 16]: four float4 per sphere, see
    csrc/path_common.cuh) and their 18 scene parameters."""
    table = sphere_table(scene)
    zero = torch.zeros_like(table.csq)
    spheres = torch.stack(
        [
            table.centers[:, 0], table.centers[:, 1], table.centers[:, 2], table.r2,
            table.csq, table.dc_sun, table.radius, zero,
            table.albedo[:, 0], table.albedo[:, 1], table.albedo[:, 2], zero,
            table.emission[:, 0], table.emission[:, 1], table.emission[:, 2], zero,
        ],
        dim=1,
    ).contiguous()
    params = torch.cat(
        [
            table.sun_direction, table.sun_color, table.sky_horizon,
            table.sky_zenith, table.plane_albedo_a, table.plane_albedo_b,
        ]
    ).to(torch.float32).contiguous()
    return spheres, params


_sphere_operands = _IdentityCache(_pack_spheres)


def _ray_operands(origins, directions):
    rays = origins.shape[0]
    if rays >= 2**31:
        raise ValueError(f"{rays} rays exceed the kernel's int32 lane index")
    radiance = torch.empty((rays, 3), dtype=torch.float32, device=origins.device)
    stream = torch.cuda.current_stream(origins.device).cuda_stream
    return origins.contiguous(), directions.contiguous(), radiance, stream


def _launch_trace_fused(scene, origins, directions, seed, max_bounces, lane=None):
    name = "trace_fused" if lane is None else "trace_fused_lanes"
    library = _library(name)
    spheres, params = _sphere_operands(scene)
    origins, directions, radiance, stream = _ray_operands(origins, directions)
    rays = (origins.data_ptr(), directions.data_ptr())
    if lane is not None:
        lane = lane.contiguous()
        rays += (lane.data_ptr(),)
    # The persistent blocks' work counter, this call's own (the C entry
    # clears it on the stream before the kernel).
    counter = torch.empty((1,), dtype=torch.int32, device=origins.device)
    status = getattr(library, f"{name}_launch")(
        *rays, origins.shape[0], spheres.data_ptr(), spheres.shape[0], params.data_ptr(),
        int(seed), int(max_bounces), radiance.data_ptr(), counter.data_ptr(), stream,
    )
    _check_status(library, name, status)
    counts[name] += 1
    return radiance


# ---------------------------------------------------------------------------
# Mesh scenes


def mesh_megakernel_eligible(mesh: MeshSet) -> bool:
    """Whether a mesh scene takes the whole-bounce-loop mesh megakernel
    (BVH nodes x instances at most ``MESH_MEGAKERNEL_MAX_WALK``)."""
    return (
        mesh.bvh.skip.shape[0] * mesh.instances.translation.shape[0]
        <= MESH_MEGAKERNEL_MAX_WALK
    )


def instance_table(mesh: MeshSet) -> torch.Tensor:
    """[K, 22] per-instance table: rotation row-major (0..8), translation
    (9..11), 1/scale (12), the instance's world-space AABB (13..18) and its
    albedo (19..21). The world AABB of the transformed root box is
    center_w = s R c_o + t, half_w = s |R| h_o."""
    instances, bvh = mesh.instances, mesh.bvh
    rotation, translation, scale = instances.rotation, instances.translation, instances.scale
    k = rotation.shape[0]
    center_obj = 0.5 * (bvh.bounds_min[0] + bvh.bounds_max[0])
    half_obj = 0.5 * (bvh.bounds_max[0] - bvh.bounds_min[0])
    center_w = fma(scale[:, None], dot3(rotation, center_obj.expand_as(rotation)), translation)
    half_w = scale[:, None] * dot3(rotation.abs(), half_obj.expand_as(rotation))
    return torch.cat(
        [
            rotation.reshape(k, 9),
            translation,
            (1.0 / scale)[:, None],
            center_w - half_w,
            center_w + half_w,
            instances.albedo,
        ],
        dim=1,
    ).contiguous()


# ``instance_table`` once per frame's MeshSet, for the wrappers and the
# coherence sort key.
instance_operands = _IdentityCache(instance_table)


def instance_entry_candidates(
    origins: torch.Tensor,
    directions: torch.Tensor,
    lo_w: torch.Tensor,
    hi_w: torch.Tensor,
    *,
    chunk_rays: int = 262144,
) -> torch.Tensor:
    """Per-ray broadphase: the instance whose world AABB (``lo_w``/``hi_w``
    [K, 3]) the ray enters first, or K where it overlaps none; [R] int64.

    The reference's ``[R, K]`` slab pass, taken over chunks of rays (a
    whole frame's ``[R, K]`` intermediates would take about 0.4 GB each)
    and one axis at a time; ties go to the lowest instance.
    """
    small = torch.abs(directions) < 1e-12
    inv = 1.0 / torch.where(small, torch.where(directions < 0, -1e-12, 1e-12), directions)
    k = lo_w.shape[0]
    out = torch.empty((origins.shape[0],), dtype=torch.int64, device=origins.device)
    for start in range(0, origins.shape[0], chunk_rays):
        rows = slice(start, start + chunk_rays)
        near = far = None
        for axis in range(3):
            o = origins[rows, axis:axis + 1]
            i = inv[rows, axis:axis + 1]
            t0 = (lo_w[:, axis] - o) * i
            t1 = (hi_w[:, axis] - o) * i
            lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
            near = lo if near is None else torch.maximum(near, lo)
            far = hi if far is None else torch.minimum(far, hi)
        entry = torch.clamp_min(near, 0.0)
        overlap = far >= entry
        entry = torch.where(overlap, entry, INF)
        out[rows] = torch.where(overlap.any(dim=1), entry.argmin(dim=1), k)
    return out


def slot_entries(
    origins: torch.Tensor,
    directions: torch.Tensor,
    lo_w: torch.Tensor,
    hi_w: torch.Tensor,
    slot: torch.Tensor,
) -> torch.Tensor:
    """[R]: the distance max(near, 0) at which each ray enters the world box
    of its ``slot`` [R] (rows of ``lo_w`` / ``hi_w`` [K, 3]), as
    ``instance_entry_candidates`` computes it; INF where the ray misses the
    box or the slot is K (none). Two candidates of an entry walk tie
    exactly where their entries are equal."""
    small = torch.abs(directions) < 1e-12
    inv = 1.0 / torch.where(small, torch.where(directions < 0, -1e-12, 1e-12), directions)
    k = lo_w.shape[0]
    row = slot.clamp_max(k - 1)
    t0 = (lo_w[row] - origins) * inv
    t1 = (hi_w[row] - origins) * inv
    near = torch.minimum(t0, t1).amax(dim=1)
    far = torch.maximum(t0, t1).amin(dim=1)
    entry = torch.clamp_min(near, 0.0)
    return torch.where((far >= entry) & (slot < k), entry, INF)


def _check_bvh(bvh: MeshBVH, origins: torch.Tensor, more: Sequence[torch.Tensor] = ()) -> None:
    devices = {t.device for t in (*bvh[:-1], *more)} | {origins.device}
    if len(devices) != 1:
        raise ValueError(f"rays and mesh must share one device, got {devices}")
    if bvh.v0.shape[0] % LEAF_SIZE:
        raise ValueError(f"triangle rows must come in {LEAF_SIZE}-row leaf slots")


def _check_mesh(mesh: MeshSet, origins: torch.Tensor) -> None:
    _check_bvh(mesh.bvh, origins, mesh.instances)


def trace_paths_fused_mesh(
    scene: Scene,
    mesh: MeshSet,
    origins: torch.Tensor,
    directions: torch.Tensor,
    seed: int,
    *,
    max_bounces: int,
    use_tlas: bool | None = None,
    quant: int = 0,
    tlas_block: int | None = None,
) -> torch.Tensor:
    """Path-trace each ray of a mesh scene through the whole bounce loop;
    radiance ``[R, 3]``. CUDA tensors go to the mesh megakernel, CPU
    tensors to its plain version. Takes any mesh: the eligibility rule is
    the caller's (``integrator.trace_paths``). ``use_tlas`` (None:
    ``use_tlas_for`` at the mesh's leaf) picks the two-level variant,
    ``quant`` the node format (``mesh_quant``: the reference's degrade
    rule), ``tlas_block`` the TLAS variant's packet (``tlas_packet``)."""
    _check_inputs(scene, origins, directions, seed)
    _check_mesh(mesh, origins)
    tlas = use_tlas_for(mesh.instances.translation.shape[0], use_tlas, mesh_leaf(mesh))
    quant = mesh_quant(mesh, quant, tlas)
    packet = tlas_packet(tlas_block)
    if origins.device.type == "cuda":
        return _launch_trace_fused_mesh(scene, mesh, origins, directions, seed, max_bounces, tlas,
                                        quant, packet)
    if origins.device.type == "cpu":
        return trace_paths_fused_mesh_reference(
            scene, mesh, origins, directions, seed, max_bounces=max_bounces, use_tlas=tlas,
            quant=quant, tlas_block=packet,
        )
    raise ValueError(f"Unsupported device {origins.device}")


def _pack_bvh(
    bvh: MeshBVH, ordered: bool = False
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(triangle rows [T, 16] = v0, e1, e2, normal each padded to a float4,
    node bounds [N, 8] = lo, 0, hi, 0, node links [N, 4] int32 = skip,
    first, count, 0) in the canonical node order; ``ordered``: the node
    tables of the eight octant orders stacked [8N] (``bvh.octant``, local
    skip links, the same leaf rows)."""
    zero_t = torch.zeros_like(bvh.v0[:, :1])
    triangles = torch.cat(
        [bvh.v0, zero_t, bvh.e1, zero_t, bvh.e2, zero_t, bvh.normal, zero_t], dim=1
    ).to(torch.float32).contiguous()
    nodes = bvh.octant if ordered else bvh
    zero_n = torch.zeros_like(nodes.bounds_min[:, :1])
    bounds = torch.cat([nodes.bounds_min, zero_n, nodes.bounds_max, zero_n], dim=1)
    links = torch.stack(
        [nodes.skip, nodes.first, nodes.count, torch.zeros_like(nodes.skip)], dim=1
    ).to(torch.int32).contiguous()
    return triangles, bounds.to(torch.float32).contiguous(), links


# The kernels' layout of a BVH, packed once per BVH: the canonical order
# (every kernel's without octant tables, and the scan's unit kernels'), and
# the octant-ordered tables of rows 3, 4 and 6.
_bvh_operands = _IdentityCache(_pack_bvh)
_ordered_bvh_operands = _IdentityCache(functools.partial(_pack_bvh, ordered=True))


class QuantTable(NamedTuple):
    """A node table in a quantized format, as the kernels read it: ``words``
    [N, W] int32 on the table's device (W = 4 at tier 1: the three slab
    words, then the meta word, 16 bytes a node; W = 3 at tier 2: two slab
    words and the meta word, 12 bytes), and its ``grid`` [6] float32
    (origin, cell) on the host, which a launch passes by value."""

    words: torch.Tensor
    grid: torch.Tensor


def quant_table(lo, hi, skip, first, count, quant: int, first_unit: int,
                grid: torch.Tensor | None = None) -> QuantTable:
    """``quantize_node_tables`` of a table: its slab words and meta word as
    one row a node where ``lo`` lies, and its grid on the host."""
    bq, meta, grid = quantize_node_tables(lo, hi, skip, first, count, quant=quant,
                                          first_unit=first_unit, grid=grid)
    return QuantTable(torch.cat([bq, meta[:, None]], dim=1).contiguous(), grid.cpu().contiguous())


def _pack_quant_bvh(bvh: MeshBVH, quant: int, ordered: bool) -> QuantTable:
    """A BVH's node table (``ordered``: its eight octant orders stacked, the
    reference's BLAS operand on a BVH with octant tables) at tier
    ``quant``: quantized on the host, the words copied to the BVH's
    device."""
    nodes = bvh.octant if ordered else bvh
    table = quant_table(*(t.cpu() for t in (nodes.bounds_min, nodes.bounds_max, nodes.skip,
                                            nodes.first, nodes.count)), quant, LEAF_SIZE)
    return table._replace(words=table.words.to(bvh.v0.device))


# A BVH's quantized tables, packed once per BVH, tier and order.
_quant_bvh_operands = {
    (quant, ordered): _IdentityCache(functools.partial(_pack_quant_bvh, quant=quant,
                                                       ordered=ordered))
    for quant in QUANT_TIERS for ordered in (False, True)
}


def bvh_quant_table(bvh: MeshBVH, quant: int, ordered: bool) -> QuantTable:
    """The BLAS node table of a launch at tier ``quant`` (1 or 2)."""
    return _quant_bvh_operands[(quant, ordered)](bvh)


def walks_ordered(bvh: MeshBVH) -> bool:
    """Whether the path kernels (rows 3, 4 and 6) walk this BVH in the
    octant order: wherever it carries octant tables (every ``sah`` build),
    as the reference's default does (``_blas_node_arrays``)."""
    return bvh.octant is not None


def _bvh_tables(bvh: MeshBVH, ordered: bool = False, quant: int = 0) -> list:
    """The BVH arguments of a launch (``_BVH_ARGTYPES``): the node count is
    N, and an ordered launch's tables hold 8N rows; at tier ``quant`` the
    node words in place of the bounds, and no links."""
    triangles, bounds, links = (_ordered_bvh_operands if ordered else _bvh_operands)(bvh)
    if quant:
        bounds, links = bvh_quant_table(bvh, quant, ordered).words, None
    return [
        triangles.data_ptr(), triangles.shape[0], bounds.data_ptr(), _pointer(links),
        bvh.skip.shape[0],
    ]


def _mesh_tables(mesh: MeshSet, tlas: bool = False, ordered: bool = False, quant: int = 0) -> list:
    """The mesh arguments of a launch (``_MESH_ARGTYPES``; with ``tlas``,
    the instances in slot order, then the frame's TLAS, ``_TLAS_ARGTYPES``:
    with ``ordered``, its eight octant orders stacked [8M], the node count
    M; at tier ``quant`` the node words in place of bounds and links)."""
    if not tlas:
        table = instance_operands(mesh)
        return [table.data_ptr(), table.shape[0], *_bvh_tables(mesh.bvh, ordered, quant)]
    frame = tlas_frame(mesh)
    k_count = frame.slots.shape[0]
    leaf = mesh_leaf(mesh)
    if quant:
        bounds, links = tlas_quant_table(mesh, quant, ordered).words, None
    elif ordered:
        bounds, links = (frame.octant_node_bounds,
                         tlas_octant_links(k_count, frame.slots.device, leaf))
    else:
        bounds, links = frame.node_bounds, tlas_links(k_count, 1, frame.slots.device, leaf)
    return [
        frame.slots.data_ptr(), k_count, *_bvh_tables(mesh.bvh, ordered, quant),
        bounds.data_ptr(), _pointer(links), frame.node_bounds.shape[0],
    ]


def _grid(table: QuantTable | None) -> int:
    """The host address of a quantized table's grid (0: none, tier 0)."""
    return 0 if table is None else table.grid.data_ptr()


def _launch_trace_fused_mesh(scene, mesh, origins, directions, seed, max_bounces, tlas, quant,
                             packet=TLAS_BLOCK_R):
    name = "trace_fused_mesh_tlas" if tlas else "trace_fused_mesh"
    packet = packet if tlas else None
    library = _library(name, packet)
    launch = getattr(library, f"{name}_launch")
    spheres, params = _sphere_operands(scene)
    origins, directions, radiance, stream = _ray_operands(origins, directions)
    ordered = walks_ordered(mesh.bvh)
    counter = [_work_counter(origins.device, stream).data_ptr()] if tlas else []
    status = launch(
        origins.data_ptr(), directions.data_ptr(), origins.shape[0],
        spheres.data_ptr(), spheres.shape[0], params.data_ptr(),
        *_mesh_tables(mesh, tlas, ordered, quant), int(ordered), int(seed), int(max_bounces),
        radiance.data_ptr(), *counter, *_node_format(mesh, quant, ordered, tlas), stream,
    )
    _check_status(library, name, status)
    _count(name, quant, packet)
    return radiance


def _node_format(mesh: MeshSet, quant: int, ordered: bool, tlas: bool) -> list:
    """A launch's node-format arguments: the tier and the host address of
    the BLAS grid and (``tlas``) the TLAS grid, 0 at tier 0."""
    blas = bvh_quant_table(mesh.bvh, quant, ordered) if quant else None
    grids = [_grid(blas)]
    if tlas:
        grids.append(_grid(tlas_quant_table(mesh, quant, ordered) if quant else None))
    return [int(quant), *grids]


# ---------------------------------------------------------------------------
# The two-level walk's per-frame operands and the coherence key


def tlas_frame_on_host(mesh: MeshSet) -> TlasFrame:
    """A frame's TLAS operands from its MeshSet, computed where its
    instances lie (``mesh.scene_mesh_set`` computes them on the host and
    copies them to the card with the instances). The instance table's rows in Morton slot order (a row
    gather: each row is its instance's own function), the union boxes of
    the TLAS nodes over the slot-ordered world boxes, and the key window
    of the instance field; the reference's per-frame operands of its TLAS
    kernels (``pallas_kernels.py:3263-3272``, ``:3413-3421``), and the
    nodes' union box (on the host), the quantized tables' grid."""
    table = instance_table(mesh)
    lo_w, hi_w = table[:, 13:16], table[:, 16:19]
    slots = table[instance_morton_order(lo_w, hi_w)]
    topology = cached_tlas_topology(table.shape[0], mesh_leaf(mesh))
    node_lo, node_hi = tlas_node_bounds(topology, slots[:, 13:16], slots[:, 16:19])
    zero = torch.zeros_like(node_lo[:, :1])
    node_bounds = torch.cat([node_lo, zero, node_hi, zero], dim=1).contiguous()
    perm = topology.octant_perm
    return TlasFrame(
        slots=slots.contiguous(),
        node_bounds=node_bounds,
        key_window=mesh_key_bounds(lo_w, hi_w),
        octant_node_bounds=node_bounds[torch.as_tensor(perm, dtype=torch.int64)].contiguous(),
        union=torch.cat([node_lo.amin(dim=0), node_hi.amax(dim=0)]).cpu(),
    )


def _frame_quant_table(mesh: MeshSet, quant: int, ordered: bool) -> QuantTable:
    """A frame's TLAS at tier ``quant``, canonical or its eight octant orders
    stacked (the reference's ``_tlas_node_arrays``), against the grid of
    the nodes' union box, where the frame's operands lie."""
    frame = tlas_frame(mesh)
    topology = cached_tlas_topology(frame.slots.shape[0], mesh_leaf(mesh))
    grid = quant_grid(frame.union[0:3], frame.union[3:6], quant)
    if ordered:
        bounds = frame.octant_node_bounds
        links = (topology.octant_skip, topology.octant_first, topology.octant_count)
    else:
        bounds = frame.node_bounds
        links = (topology.skip, topology.first, topology.count)
    return quant_table(bounds[:, 0:3], bounds[:, 4:7], *(np.asarray(v) for v in links),
                       quant, 1, grid)


# A frame's quantized TLAS, once per MeshSet, tier and order.
_tlas_quant_tables = {
    (quant, ordered): _IdentityCache(functools.partial(_frame_quant_table, quant=quant,
                                                       ordered=ordered))
    for quant in QUANT_TIERS for ordered in (False, True)
}


def tlas_quant_table(mesh: MeshSet, quant: int, ordered: bool) -> QuantTable:
    """The frame's TLAS node table at tier ``quant`` (1 or 2): canonical, or
    (``ordered``) its eight octant orders stacked [8M], all against the
    grid of the nodes' union box."""
    return _tlas_quant_tables[(quant, ordered)](mesh)


def _tlas_frame(mesh: MeshSet) -> TlasFrame:
    """The MeshSet's own TLAS operands (``scene_mesh_set``'s, from the host)
    where they hold its leaf's topology (a topology is a function of K and
    the leaf, and a smaller leaf's refines a larger one's, so two leaves give
    the same tree exactly where they give as many nodes), else derived where
    its instances lie."""
    tlas = mesh.tlas
    nodes = len(cached_tlas_topology(mesh.instances.translation.shape[0], mesh_leaf(mesh)).skip)
    if tlas is not None and tlas.node_bounds.shape[0] == nodes:
        return tlas
    return tlas_frame_on_host(mesh)


# A frame's TLAS operands, once per MeshSet.
tlas_frame = _IdentityCache(_tlas_frame)


def tlas_links(k_count: int, frames: int, device: torch.device,
               leaf: int | None = None) -> torch.Tensor:
    """[F M, 4] int32 TLAS links of ``frames`` stacked windows of the
    K-slot topology of ``leaf``-instance leaves (None: ``TLAS_LEAF``;
    ``_pack_bvh``'s layout: skip, first, count, 0): frame f's nodes at rows
    [f M, (f + 1) M), its skip links offset by f M and its leaf starts by
    f K (``pallas_kernels.py:3915-3958``). Static per (K, leaf, F): copied
    to the device once."""
    return _tlas_links(k_count, TLAS_LEAF if leaf is None else leaf, frames,
                       torch.device(device))


def tlas_octant_links(k_count: int, device: torch.device, leaf: int | None = None) -> torch.Tensor:
    """[8M, 4] int32 links of the K-slot topology's eight octant orders
    (``TlasTopology.octant_*``; ``leaf`` as for ``tlas_links``): order o at
    rows [o M, (o + 1) M), its skip links local to them
    (``_tlas_node_arrays``, ``pallas_kernels.py:3130``). Static per (K,
    leaf): copied to the device once."""
    return _tlas_octant_links(k_count, TLAS_LEAF if leaf is None else leaf, torch.device(device))


@functools.lru_cache(maxsize=16)
def _tlas_octant_links(k_count: int, leaf: int, device: torch.device) -> torch.Tensor:
    topology = cached_tlas_topology(k_count, leaf)
    links = np.stack([topology.octant_skip, topology.octant_first, topology.octant_count,
                      np.zeros_like(topology.octant_count)], axis=1)
    return torch.as_tensor(links.astype(np.int32), device=device)


@functools.lru_cache(maxsize=16)
def _tlas_links(k_count: int, leaf: int, frames: int, device: torch.device) -> torch.Tensor:
    topology = cached_tlas_topology(k_count, leaf)
    m = len(topology.skip)
    windows = [
        np.stack([topology.skip + f * m, topology.first + f * k_count, topology.count,
                  np.zeros_like(topology.count)], axis=1)
        for f in range(frames)
    ]
    return torch.as_tensor(np.concatenate(windows).astype(np.int32), device=device)


def mesh_key_bounds(lo_w: torch.Tensor, hi_w: torch.Tensor) -> torch.Tensor:
    """The coherence key's window [6] (lo, then 1 / span) of instance world
    boxes ``lo_w`` / ``hi_w`` [K, 3]: their union padded by one unit (a
    floor bounce's origin sits on the field's boundary; escaped rays clamp
    to edge cells). Frame-dependent, never ray-dependent."""
    lo = lo_w.amin(dim=0) - 1.0
    hi = hi_w.amax(dim=0) + 1.0
    return torch.cat([lo, 1.0 / torch.clamp_min(hi - lo, 1e-6)]).contiguous()


def coherence_key(
    points: torch.Tensor,
    directions: torch.Tensor,
    dead: torch.Tensor,
    fid: torch.Tensor,
    candidate: torch.Tensor,
    window: torch.Tensor,
) -> torch.Tensor:
    """The reference's coherence sort key (``coherence_key_u32``), [R]
    int32, of ``points`` = origin + direction and ``directions`` [R, 3],
    the ``dead`` flags, frame ids ``fid`` and candidate instances
    ``candidate`` [R] under the key ``window`` [6]. LSB to MSB: direction
    octant [0:3), the 5-bit-per-axis Morton cell of the point [3:18), the
    candidate clamped to 63 [18:24), the frame id clamped to 31 [24:29),
    the dead flag at ``KEY_DEAD_BIT``."""
    cell = torch.clamp((points - window[0:3]) * window[3:6] * 32.0, 0.0, 31.0).to(torch.int64)
    morton = (
        morton_dilate5(cell[:, 0]) | (morton_dilate5(cell[:, 1]) << 1)
        | (morton_dilate5(cell[:, 2]) << 2)
    )
    octant = (
        (directions[:, 0] > 0).to(torch.int64)
        | ((directions[:, 1] > 0).to(torch.int64) << 1)
        | ((directions[:, 2] > 0).to(torch.int64) << 2)
    )
    candidate_bits = torch.clamp_max(candidate.to(torch.int64) & MASK32, 63)
    fid_bits = torch.clamp_max(fid.to(torch.int64) & MASK32, 31)
    key = (
        octant | (morton << 3) | (candidate_bits << 18) | (fid_bits << 24)
        | (dead.to(torch.int64) << KEY_DEAD_BIT)
    )
    return key.to(torch.int32)


def mesh_sort_keys(
    origins: torch.Tensor,
    directions: torch.Tensor,
    alive: torch.Tensor,
    window: torch.Tensor,
    fid: torch.Tensor | None = None,
    candidate: torch.Tensor | None = None,
) -> torch.Tensor:
    """The key of a lane's state outside a kernel ([R] int32), the twin of
    the TLAS kernels' key column; ``fid`` and ``candidate`` default to 0."""
    zero = torch.zeros(origins.shape[0], dtype=torch.int64, device=origins.device)
    return coherence_key(
        origins + directions, directions, ~alive, zero if fid is None else fid,
        zero if candidate is None else candidate, window,
    )


def initial_mesh_sort_keys(
    mesh: MeshSet, origins: torch.Tensor, directions: torch.Tensor, alive: torch.Tensor
) -> torch.Tensor:
    """Bounce 0's keys of a TLAS launch ([R] int32), before any kernel has
    written a key column: the candidate is the slot whose world box each
    ray enters first (``instance_entry_candidates`` over the slot-ordered
    boxes), the window the frame's. The one site the masked deep loop and
    the wavefront driver key bounce 0 through."""
    frame = tlas_frame(mesh)
    candidate = instance_entry_candidates(
        origins, directions, frame.slots[:, 13:16], frame.slots[:, 16:19]
    )
    return mesh_sort_keys(origins, directions, alive, frame.key_window, candidate=candidate)


# ---------------------------------------------------------------------------
# One bounce with streamed state


class BounceState(NamedTuple):
    """A bounce's output: this bounce's radiance ``contribution`` [R, 3]
    (from zero) and the path state after it."""

    contribution: torch.Tensor  # [R, 3] float32
    origins: torch.Tensor  # [R, 3] float32
    directions: torch.Tensor  # [R, 3] float32
    throughput: torch.Tensor  # [R, 3] float32
    alive: torch.Tensor  # [R] bool

    @property
    def key(self) -> None:
        """The sphere and flat mesh kernels write no coherence key."""
        return None


class KeyedBounceState(NamedTuple):
    """A TLAS bounce's output: ``BounceState``'s fields and the coherence
    key of the state after the bounce (``coherence_key``), the next sort's
    key."""

    contribution: torch.Tensor  # [R, 3] float32
    origins: torch.Tensor  # [R, 3] float32
    directions: torch.Tensor  # [R, 3] float32
    throughput: torch.Tensor  # [R, 3] float32
    alive: torch.Tensor  # [R] bool
    key: torch.Tensor  # [R] int32


def _check_state(scene, origins, directions, throughput, alive, lane, seed, bounce, total_bounces):
    _check_inputs(scene, origins, directions, seed)
    rays = origins.shape[0]
    if throughput.shape != origins.shape or throughput.dtype != torch.float32:
        raise ValueError(
            f"throughput must be float32 [R, 3]; got {throughput.dtype} {tuple(throughput.shape)}"
        )
    if alive.shape != (rays,) or alive.dtype != torch.bool:
        raise ValueError(f"alive must be bool [R]; got {alive.dtype} {tuple(alive.shape)}")
    if lane.shape != (rays,) or lane.dtype != torch.int32:
        raise ValueError(f"lane must be int32 [R]; got {lane.dtype} {tuple(lane.shape)}")
    devices = {origins.device, throughput.device, alive.device, lane.device}
    if len(devices) != 1:
        raise ValueError(f"the path state must lie on one device, got {devices}")
    if not 0 <= int(bounce) < int(total_bounces):
        raise ValueError(f"bounce {bounce} is not in [0, total_bounces={total_bounces})")


def sphere_bounce(
    scene: Scene,
    origins: torch.Tensor,
    directions: torch.Tensor,
    throughput: torch.Tensor,
    alive: torch.Tensor,
    lane: torch.Tensor,
    live_count,
    seed: int,
    bounce: int,
    *,
    total_bounces: int,
) -> BounceState:
    """One bounce of the sphere megakernel over streamed path state.

    ``lane`` [R] int32 is each ray's original lane, its RNG counter.
    ``live_count`` (an int or a one-element tensor on the rays' device) is
    the number of leading lanes that may be alive: the caller sorts dead
    lanes to the tail, and lanes at or past it pass through with a zero
    contribution. ``bounce`` counts from 0 of ``total_bounces``, which
    sets the RNG counter stride as in the megakernel. CUDA tensors go to
    the kernel, CPU tensors to the plain version.
    """
    _check_state(scene, origins, directions, throughput, alive, lane, seed, bounce, total_bounces)
    if origins.device.type == "cuda":
        return _launch_bounce(
            "sphere_bounce", scene, None, origins, directions, throughput, alive, lane,
            live_count, seed, bounce, total_bounces,
        )
    if origins.device.type == "cpu":
        return sphere_bounce_reference(
            scene, origins, directions, throughput, alive, lane, live_count, seed, bounce,
            total_bounces=total_bounces,
        )
    raise ValueError(f"Unsupported device {origins.device}")


def mesh_bounce(
    scene: Scene,
    mesh: MeshSet,
    origins: torch.Tensor,
    directions: torch.Tensor,
    throughput: torch.Tensor,
    alive: torch.Tensor,
    lane: torch.Tensor,
    live_count,
    seed: int,
    bounce: int,
    *,
    total_bounces: int,
    use_tlas: bool | None = None,
    quant: int = 0,
    tlas_block: int | None = None,
    _group: int | None = None,
    _hits: list | None = None,
) -> BounceState | KeyedBounceState:
    """One bounce of the mesh megakernel over streamed path state; the
    arguments are ``sphere_bounce``'s plus the mesh. Takes any mesh.
    ``use_tlas`` (None: ``use_tlas_for`` at the mesh's leaf) picks the
    two-level variant, ``tlas_block`` its packet (``tlas_packet``: the
    lanes whose votes order its walks and its key pass's),
    whose output also holds the key of each lane's new state: a lane alive
    after the bounce and below the live count keys with the slot it enters
    first (K for none), any other lane and every lane of the last bounce
    with K (``.key`` is None on the flat variant). ``quant`` is the node
    format (``mesh_quant``); at 1 or 2 the key follows the packed-key rule:
    a lane whose nearest hit was an instance keys with that slot, on every
    bounce, and walks no entry. ``_group`` (tests and measurements only)
    fixes the TLAS kernel's group size, else ``bounce_group`` of the
    launch; it changes no output. ``_hits`` (tests and measurements only)
    receives the TLAS launch's hit column on the quantized tiers: each
    lane's winning slot, K for none (what the key pass reads)."""
    _check_state(scene, origins, directions, throughput, alive, lane, seed, bounce, total_bounces)
    _check_mesh(mesh, origins)
    _check_group(_group)
    tlas = use_tlas_for(mesh.instances.translation.shape[0], use_tlas, mesh_leaf(mesh))
    quant = mesh_quant(mesh, quant, tlas)
    packet = tlas_packet(tlas_block)
    if origins.device.type == "cuda":
        return _launch_bounce(
            "mesh_bounce_tlas" if tlas else "mesh_bounce", scene, mesh, origins, directions,
            throughput, alive, lane, live_count, seed, bounce, total_bounces, _group, quant,
            _hits, packet,
        )
    if origins.device.type == "cpu":
        return mesh_bounce_reference(
            scene, mesh, origins, directions, throughput, alive, lane, live_count, seed, bounce,
            total_bounces=total_bounces, use_tlas=tlas, quant=quant, tlas_block=packet,
            _hits=_hits,
        )
    raise ValueError(f"Unsupported device {origins.device}")


def _launch_bounce(
    name, scene, mesh, origins, directions, throughput, alive, lane, live_count, seed, bounce,
    total_bounces, group=None, quant=0, hits_out=None, packet=TLAS_BLOCK_R,
):
    tlas = name == "mesh_bounce_tlas"
    packet = packet if tlas else None
    library = _library(name, packet)
    launch = getattr(library, f"{name}_launch")
    rays = origins.shape[0]
    if rays >= 2**31:
        raise ValueError(f"{rays} rays exceed the kernel's int32 lane index")
    device = origins.device
    live = _live_tensor(live_count, device)
    state = [t.contiguous() for t in (origins, directions, throughput, alive, lane)]
    spheres, params = _sphere_operands(scene)
    tables = [spheres.data_ptr(), spheres.shape[0], params.data_ptr()]
    ordered = mesh is not None and walks_ordered(mesh.bvh)
    if mesh is not None:
        tables += _mesh_tables(mesh, tlas, ordered, quant)
    if tlas:
        frame = tlas_frame(mesh)
        tables.append(frame.key_window.data_ptr())
        votes = _packet_votes(state[1], live, frame.slots, packet, mesh.bvh, ordered, True,
                              packet=packet)
        tables += [0, 0] if votes is None else [votes[0].data_ptr(), _pointer(votes[1])]
    elif mesh is not None:
        votes = _packet_votes(state[1], live, instance_operands(mesh), BVH_BLOCK_R, mesh.bvh,
                              ordered, False)
        tables += [int(ordered), 0 if votes is None else _pointer(votes[1])]
    out = _bounce_outputs(rays, device, tlas)
    stream = torch.cuda.current_stream(device)
    walk = []
    if tlas:  # the group size, then the persistent blocks' work counter
        if group is None:
            group = bounce_group(rays, thread_slots(device.index or 0))
        walk = [group, _work_counter(device, stream.cuda_stream).data_ptr()]
    node_format = [] if mesh is None else _node_format(mesh, quant, ordered, tlas)
    hits = None
    if tlas:
        # The key pass's hit column: the packed-key rule of an ordered launch.
        if quant and ordered:
            hits = torch.empty((rays,), dtype=torch.int32, device=device)
        node_format.append(_pointer(hits))
    status = launch(
        *(t.data_ptr() for t in state[:5]), rays, live.data_ptr(),
        *tables, int(seed), int(bounce), int(total_bounces),
        *(t.data_ptr() for t in out), *walk, *node_format, stream.cuda_stream,
    )
    _check_status(library, name, status)
    _count(name, quant, packet)
    if tlas and ordered:
        _launch_entry_keys(mesh, out.origins, out.directions, out.alive, out.key, live, bounce,
                           total_bounces, quant, hits, packet)
    if hits_out is not None and tlas and quant:
        hits_out.append(hits)
    return out


def _pointer(tensor: torch.Tensor | None) -> int:
    return 0 if tensor is None else tensor.data_ptr()


def _packet_votes(directions, live, table, block, bvh, ordered, world, frames=None,
                  per_frame=0, packet=None):
    """The packet votes of an ordered launch on the card (``packet_votes``:
    ``world`` the packets' world octants [P], and their octants per row of
    ``table`` [P, K], None on a one-node BVH, whose eight tables are one
    node alike; a pool's with its lanes' ``frames``); None on the canonical
    walk. ``packet``: the TLAS packet of the launch they order (its count's
    name), None for a flat launch."""
    if not ordered:
        return None
    return _launch_packet_votes(directions, live, table, block, world, bvh.skip.shape[0] > 1,
                                frames, per_frame, packet)


def _launch_packet_votes(directions, live, table, block, world, rows, frames=None, per_frame=0,
                         packet=None):
    library = _library("packet_octants")
    rays = directions.shape[0]
    packets = -(-rays // block)
    device = directions.device
    k = table.shape[0]
    tlas_out = torch.empty((packets,), dtype=torch.uint8, device=device) if world else None
    slot_out = torch.empty((packets, k), dtype=torch.uint8, device=device) if rows else None
    status = library.packet_octants_launch(
        directions.data_ptr(), rays, live.data_ptr(), block, _pointer(frames), int(per_frame),
        table.data_ptr(), k, _pointer(tlas_out), _pointer(slot_out),
        torch.cuda.current_stream(device).cuda_stream,
    )
    _check_status(library, "packet_octants", status)
    _count("packet_octants", 0, packet)
    return tlas_out, slot_out


def _launch_entry_keys(mesh, origins, directions, alive, key, live, bounce,
                       total_bounces, quant=0, hits=None, packet=TLAS_BLOCK_R) -> None:
    """The key column of an ordered per-bounce TLAS launch's outputs
    (``mesh_entry_keys``), written into ``key``; at tier ``quant`` its
    quantized TLAS and the launch's ``hits`` column; its packets of
    ``packet`` lanes."""
    library = _library("mesh_entry_keys", packet)
    frame = tlas_frame(mesh)
    k_count = frame.slots.shape[0]
    device = key.device
    stream = torch.cuda.current_stream(device).cuda_stream
    table = tlas_quant_table(mesh, quant, True) if quant else None
    if table is None:
        bounds, links = frame.octant_node_bounds, tlas_octant_links(k_count, device,
                                                                      mesh_leaf(mesh))
    else:
        bounds, links = table.words, None
    status = library.mesh_entry_keys_launch(
        origins.data_ptr(), directions.data_ptr(), alive.data_ptr(), origins.shape[0],
        live.data_ptr(), frame.slots.data_ptr(), k_count, bounds.data_ptr(), _pointer(links),
        frame.node_bounds.shape[0], frame.key_window.data_ptr(), int(bounce),
        int(total_bounces), key.data_ptr(), _work_counter(device, stream).data_ptr(),
        int(quant), _grid(table), _pointer(hits), stream,
    )
    _check_status(library, "mesh_entry_keys", status)
    _count("mesh_entry_keys", quant, packet)


def packet_votes(
    directions: torch.Tensor,
    table: torch.Tensor,
    live_count,
    *,
    block: int,
    world: bool = True,
    rows: bool = True,
    frames: torch.Tensor | None = None,
    per_frame: int | None = None,
) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """The packet votes of the octant-ordered walk of a launch of rays
    along ``directions`` [R, 3]: (``world``: each packet's world octant [P],
    the TLAS walks'; ``rows``: its octant in the object space of each row of
    the instance ``table`` [K, 22], [P, K], the BLAS walks'), uint8, None
    where not asked for; P = ceil(R / ``block``) packets of ``block`` lanes
    (``packet_octants`` and ``packet_instance_octants``), those at or past
    ``live_count`` 0 (no kernel walks them).

    ``frames`` (a pool launch): the lanes' frame ids [R] int32, the table's
    rows ``per_frame`` to a frame, frame-major (at most 32 frames). A lane of
    frame f reads only rows [f per_frame, (f + 1) per_frame), so a packet's
    entry of a row of a frame that none of its lanes carries is 0, not its
    vote (ids outside the table's frames count for none): no walk reads
    those entries, and the walks' outputs are those of the votes of every
    row. CUDA tensors go to the vote pass (``csrc/packet_octants.cu``), CPU
    tensors to its plain version."""
    if directions.device.type == "cuda":
        _check_vote_frames(directions, table, frames, per_frame)
        live = _live_tensor(live_count, directions.device)
        if frames is not None:
            frames = frames.to(torch.int32).contiguous()
        return _launch_packet_votes(directions.contiguous(), live, table.contiguous(), block,
                                    world, rows, frames, per_frame or 0)
    if directions.device.type == "cpu":
        return packet_votes_reference(directions, table, live_count, block=block, world=world,
                                      rows=rows, frames=frames, per_frame=per_frame)
    raise ValueError(f"Unsupported device {directions.device}")


def _check_vote_frames(directions, table, frames, per_frame) -> None:
    if frames is None:
        return
    if frames.shape != (directions.shape[0],):
        raise ValueError(f"frames {tuple(frames.shape)}: one id a lane of {directions.shape[0]}")
    if per_frame is None or per_frame < 1 or table.shape[0] % per_frame:
        raise ValueError(f"per_frame {per_frame} must divide the table's {table.shape[0]} rows")
    if table.shape[0] // per_frame > 32:
        raise ValueError(f"{table.shape[0] // per_frame} frames: a vote takes at most 32")


def packet_votes_reference(directions, table, live_count, *, block, world=True, rows=True,
                           frames=None, per_frame=None):
    """The plain version of ``packet_votes``, on any device."""
    _check_vote_frames(directions, table, frames, per_frame)
    counts["packet_octants_reference"] += 1
    return _votes(directions, table, live_count, block, world, rows, frames, per_frame)


def _votes(directions, table, live_count, block, world, rows, frames, per_frame):
    """``packet_votes_reference`` uncounted (the plain pool bounce's)."""
    packets = -(-directions.shape[0] // block)
    walked = (torch.arange(packets, device=directions.device) * block < int(live_count))
    out = []
    if world:
        out.append((packet_octants(directions, block) * walked).to(torch.uint8))
    else:
        out.append(None)
    if rows:
        votes = packet_instance_octants(directions, table, block) * walked[:, None]
        if frames is not None:
            row_frame = torch.arange(table.shape[0], device=directions.device) // per_frame
            votes = votes * carried_frames(frames, block, table.shape[0] // per_frame)[:, row_frame]
        out.append(votes.to(torch.uint8))
    else:
        out.append(None)
    return tuple(out)


def carried_frames(frames: torch.Tensor, block: int, n_frames: int) -> torch.Tensor:
    """[P, n_frames] bool: whether some lane of each packet of ``block``
    lanes carries frame f (``frames`` [R], the lanes' ids; ids outside [0,
    n_frames) count for none)."""
    packets = -(-frames.shape[0] // block)
    packet = torch.arange(frames.shape[0], device=frames.device) // block
    fid = frames.to(torch.int64)
    inside = (fid >= 0) & (fid < n_frames)
    carried = torch.zeros((packets, n_frames), dtype=torch.bool, device=frames.device)
    carried[packet[inside], fid[inside]] = True
    return carried


def entry_keys(
    mesh: MeshSet,
    origins: torch.Tensor,
    directions: torch.Tensor,
    alive: torch.Tensor,
    live_count,
    bounce: int,
    *,
    total_bounces: int,
    quant: int = 0,
    hits: torch.Tensor | None = None,
    tlas_block: int | None = None,
) -> torch.Tensor:
    """The key column [R] int32 of an ordered per-bounce TLAS launch from
    its outputs (``origins``, ``directions`` [R, 3], ``alive`` [R]): the
    coherence key with the slot each live new ray below ``live_count``
    enters first, walked through the TLAS table of its packet's vote
    (``tlas_block`` lanes, ``tlas_packet``) over every lane's new
    direction; K for the others and on the
    last bounce. The mesh's BVH must carry octant tables. ``quant`` is the
    node format (``mesh_quant``); at 1 or 2 the launch's ``hits`` [R]
    int32 (each lane's winning slot, K for none) are required, and a lane
    with a hit keys with it on every bounce and walks no entry (the
    packed-key rule). CUDA tensors go to ``csrc/mesh_entry_keys.cu``, CPU
    tensors to its plain version."""
    if not walks_ordered(mesh.bvh):
        raise ValueError("entry_keys is the octant-ordered walk's: the BVH has no octant tables")
    quant = mesh_quant(mesh, quant, True)
    _check_hits(origins, quant, hits)
    packet = tlas_packet(tlas_block)
    if origins.device.type == "cuda":
        key = torch.empty(origins.shape[0], dtype=torch.int32, device=origins.device)
        _launch_entry_keys(mesh, origins.contiguous(), directions.contiguous(), alive.contiguous(),
                           key, _live_tensor(live_count, origins.device), bounce, total_bounces,
                           quant, None if hits is None else hits.contiguous(), packet)
        return key
    if origins.device.type == "cpu":
        return entry_keys_reference(mesh, origins, directions, alive, live_count, bounce,
                                    total_bounces=total_bounces, quant=quant, hits=hits,
                                    tlas_block=packet)
    raise ValueError(f"Unsupported device {origins.device}")


def _check_hits(origins: torch.Tensor, quant: int, hits: torch.Tensor | None) -> None:
    if not quant:
        return
    if hits is None or hits.shape != (origins.shape[0],) or hits.dtype != torch.int32:
        raise ValueError("a quantized key pass takes its bounce's hits: int32 [R]")
    if hits.device != origins.device:
        raise ValueError(f"hits on {hits.device}, rays on {origins.device}")


def entry_keys_reference(mesh, origins, directions, alive, live_count, bounce, *,
                         total_bounces, quant=0, hits=None, stats=None, tlas_block=None):
    """The plain version of ``entry_keys``, on any device; ``stats`` counts
    the entry walk's rays and box tests (``entry_rays``, ``entry_tests``)."""
    quant = mesh_quant(mesh, quant, True)
    _check_hits(origins, quant, hits)
    packet = tlas_packet(tlas_block)
    _count("mesh_entry_keys_reference", quant, packet)
    if stats is not None:
        for key in ("entry_rays", "entry_tests"):
            stats.setdefault(key, 0)
    walk = _entry_walks[quant](mesh)._replace(packet=packet)
    live = max(0, min(int(live_count), origins.shape[0]))
    return _keys_reference(walk, origins, directions, alive, live, bounce, total_bounces,
                           262144, stats, True, hits if quant else None)


@functools.cache
def _work_counter(device: torch.device, stream: int) -> torch.Tensor:
    """The work counter of the persistent blocks of
    ``trace_fused_mesh_tlas``, ``mesh_bounce_tlas`` and its key pass
    ``mesh_entry_keys``, ``intersect_instances`` and ``occluded_instances``:
    one int32 per device and stream, allocated once; each launch clears it
    on its stream, so launches in a row on one stream share it safely."""
    return torch.zeros((1,), dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# One bounce over a ray pool of several frames


class PoolSphereOperands(NamedTuple):
    """A window of F frames of one sphere scene stacked for the pool
    kernels (the reference's ``PoolSphereOperands``): frame f's N spheres
    (the scene's count padded to 8) are rows [f N, (f + 1) N) of
    ``spheres``. The lighting is frame-invariant (the scenes'
    ``_default_lighting``); ``params`` are frame 0's."""

    tables: tuple[SphereTable, ...]  # per frame, as the plain version reads them
    spheres: torch.Tensor  # [F N, 16]: _pack_spheres' rows, frame-major
    params: torch.Tensor  # [18]
    per_frame: int  # N


class PoolMeshOperands(NamedTuple):
    """``PoolSphereOperands`` plus the window's meshes (the reference's
    ``PoolMeshOperands``): one BVH shared by every frame, and the frames'
    instance tables stacked frame-major, frame f's K instances at rows
    [f K, (f + 1) K) of ``instances``."""

    spheres: PoolSphereOperands
    meshes: tuple[MeshSet, ...]  # per frame; the BVH and the TLAS leaf are frame 0's
    instances: torch.Tensor  # [F K, 22]: instance_table rows, frame-major
    per_frame: int  # K
    # The window's frame cap (the reference pads a window to it; the node
    # format's degrade rule counts it, ``pool_quant``); None: RAYPOOL_FRAMES.
    frame_cap: int | None = None


def pool_sphere_operands(scenes: Sequence[Scene]) -> PoolSphereOperands:
    """Stack the window's per-frame scenes (one scene family, so one padded
    sphere count) for ``pool_sphere_bounce``."""
    if not scenes:
        raise ValueError("a pool window holds at least one frame")
    packed = [_pack_spheres(scene) for scene in scenes]
    per_frame = packed[0][0].shape[0]
    if any(rows.shape[0] != per_frame for rows, _ in packed):
        raise ValueError("every frame of a pool window must pad to the same sphere count")
    return PoolSphereOperands(
        tables=tuple(sphere_table(scene) for scene in scenes),
        spheres=torch.cat([rows for rows, _ in packed]).contiguous(),
        params=packed[0][1],
        per_frame=per_frame,
    )


def pool_mesh_operands(scenes: Sequence[Scene], meshes: Sequence[MeshSet],
                       frame_cap: int | None = None) -> PoolMeshOperands:
    """Stack the window's scenes and MeshSets (one BVH, K instances per
    frame, one TLAS leaf) for ``pool_mesh_bounce``; ``frame_cap``: the
    window's cap (None: ``RAYPOOL_FRAMES``)."""
    if len(meshes) != len(scenes):
        raise ValueError(f"{len(scenes)} scenes but {len(meshes)} meshes")
    bvh = meshes[0].bvh
    per_frame = meshes[0].instances.translation.shape[0]
    for mesh in meshes:
        if mesh.bvh.skip.shape != bvh.skip.shape or mesh.bvh.v0.shape != bvh.v0.shape:
            raise ValueError("the frames of a pool window must share one BVH")
        if mesh.instances.translation.shape[0] != per_frame:
            raise ValueError("every frame of a pool window must hold the same instance count")
        if mesh_leaf(mesh) != mesh_leaf(meshes[0]):
            raise ValueError("every frame of a pool window must take the same TLAS leaf")
    return PoolMeshOperands(
        spheres=pool_sphere_operands(scenes),
        meshes=tuple(meshes),
        instances=torch.cat([instance_table(mesh) for mesh in meshes]).contiguous(),
        per_frame=per_frame,
        frame_cap=frame_cap,
    )


def pool_instance_aabbs(ops: PoolMeshOperands) -> tuple[torch.Tensor, torch.Tensor]:
    """World AABBs (lo, hi) [F K, 3] of the stacked instances: the
    broadphase input of the pool's coherence sort."""
    return ops.instances[:, 13:16], ops.instances[:, 16:19]


def _check_pool_state(
    spheres: PoolSphereOperands, origins, directions, throughput, alive, lane, fid, seed_row,
    bounce_row, total_bounces,
):
    rays = origins.shape[0]
    if origins.ndim != 2 or origins.shape[1] != 3:
        raise ValueError(f"origins must be [P, 3]; got {tuple(origins.shape)}")
    for name, tensor in (("directions", directions), ("throughput", throughput)):
        if tensor.shape != origins.shape:
            raise ValueError(f"{name} must be [P, 3] like origins; got {tuple(tensor.shape)}")
    for name, tensor in (("origins", origins), ("directions", directions),
                         ("throughput", throughput)):
        if tensor.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {tensor.dtype}")
    if alive.shape != (rays,) or alive.dtype != torch.bool:
        raise ValueError(f"alive must be bool [P]; got {alive.dtype} {tuple(alive.shape)}")
    for name, row in (("lane", lane), ("fid", fid), ("seed_row", seed_row),
                      ("bounce_row", bounce_row)):
        if row.shape != (rays,) or row.dtype != torch.int32:
            raise ValueError(f"{name} must be int32 [P]; got {row.dtype} {tuple(row.shape)}")
    devices = {t.device for t in (origins, directions, throughput, alive, lane, fid, seed_row,
                                  bounce_row, spheres.spheres)}
    if len(devices) != 1:
        raise ValueError(f"the pool state and the scene must lie on one device, got {devices}")
    if int(total_bounces) < 1:
        raise ValueError(f"total_bounces must be at least 1, got {total_bounces}")


def pool_sphere_bounce(
    ops: PoolSphereOperands,
    origins: torch.Tensor,
    directions: torch.Tensor,
    throughput: torch.Tensor,
    alive: torch.Tensor,
    lane: torch.Tensor,
    fid: torch.Tensor,
    seed_row: torch.Tensor,
    bounce_row: torch.Tensor,
    live_count,
    *,
    total_bounces: int,
) -> BounceState:
    """One bounce over a pool of P lanes from the window's frames.

    As ``sphere_bounce``, with per-lane rows in place of the scalars:
    ``fid`` the lane's frame in the window (it sees only that frame's
    spheres), ``seed_row`` its frame's int32 trace seed and ``bounce_row``
    its own depth (0 <= bounce < ``total_bounces``), all int32 [P].
    ``live_count`` (an int or a one-element tensor on the pool's device)
    bounds the live prefix; lanes past it pass through. CUDA tensors go to
    the kernel, CPU tensors to the plain version.
    """
    _check_pool_state(ops, origins, directions, throughput, alive, lane, fid, seed_row,
                      bounce_row, total_bounces)
    state = (origins, directions, throughput, alive, lane, fid, seed_row, bounce_row)
    if origins.device.type == "cuda":
        return _launch_pool("pool_sphere_bounce", ops, None, state, live_count, total_bounces)
    if origins.device.type == "cpu":
        return pool_sphere_bounce_reference(ops, *state, live_count, total_bounces=total_bounces)
    raise ValueError(f"Unsupported device {origins.device}")


def pool_mesh_bounce(
    ops: PoolMeshOperands,
    origins: torch.Tensor,
    directions: torch.Tensor,
    throughput: torch.Tensor,
    alive: torch.Tensor,
    lane: torch.Tensor,
    fid: torch.Tensor,
    seed_row: torch.Tensor,
    bounce_row: torch.Tensor,
    live_count,
    *,
    total_bounces: int,
    use_tlas: bool | None = None,
    quant: int = 0,
    tlas_block: int | None = None,
    _group: int | None = None,
) -> BounceState | KeyedBounceState:
    """One mesh bounce over a pool of P lanes from the window's frames; the
    arguments are ``pool_sphere_bounce``'s, a lane seeing its own frame's
    spheres and K instances. ``use_tlas`` (None: ``use_tlas_for`` at the
    window's leaf) picks the two-level variant, ``tlas_block`` its packet
    (``tlas_packet``: the lanes whose votes order its BLAS walks): a lane
    walks its own frame's TLAS, and the
    output holds each lane's key (its frame id in the key; the candidate
    its frame's slot, K for none or for a lane not alive after the bounce
    below the live count; no last-bounce rule: the pool's lanes sit at
    mixed depths). ``quant`` is the node format: at 1 or 2 the window's
    frames' TLAS windows quantize against one grid (``pool_tlas_quant``),
    and a lane whose nearest hit was an instance keys with that slot of its
    frame (the packed-key rule); the degrade rule counts the reference's
    padded window (``pool_quant``). ``_group`` (tests and measurements only) fixes the
    TLAS kernel's group size, else ``POOL_GROUP``; it changes no output."""
    _check_pool_state(ops.spheres, origins, directions, throughput, alive, lane, fid, seed_row,
                      bounce_row, total_bounces)
    _check_mesh(ops.meshes[0], origins)
    _check_group(_group)
    state = (origins, directions, throughput, alive, lane, fid, seed_row, bounce_row)
    tlas = use_tlas_for(ops.per_frame, use_tlas, mesh_leaf(ops.meshes[0]))
    quant = pool_quant(ops, quant, tlas)
    packet = tlas_packet(tlas_block)
    if origins.device.type == "cuda":
        return _launch_pool(
            "pool_mesh_bounce_tlas" if tlas else "pool_mesh_bounce", ops.spheres, ops, state,
            live_count, total_bounces, _group, quant, packet,
        )
    if origins.device.type == "cpu":
        return pool_mesh_bounce_reference(
            ops, *state, live_count, total_bounces=total_bounces, use_tlas=tlas, quant=quant,
            tlas_block=packet,
        )
    raise ValueError(f"Unsupported device {origins.device}")


def pool_quant(ops: "PoolMeshOperands", quant: int, tlas: bool) -> int:
    """The node format of a pool launch at tier ``quant``: ``mesh_quant``
    over the TLAS windows of the reference's window, padded to its frame
    cap (``ops.frame_cap``; None: ``RAYPOOL_FRAMES``; a window that holds
    more: its own)."""
    cap = RAYPOOL_FRAMES if ops.frame_cap is None else ops.frame_cap
    return mesh_quant(ops.meshes[0], quant, tlas, max(len(ops.meshes), cap))


def _bounce_outputs(rays: int, device, keyed: bool) -> BounceState | KeyedBounceState:
    """A bounce launch's outputs, allocated for the kernel to fill."""
    state = [torch.empty((rays, 3), dtype=torch.float32, device=device) for _ in range(4)]
    alive = torch.empty((rays,), dtype=torch.bool, device=device)
    if keyed:
        return KeyedBounceState(*state, alive, torch.empty((rays,), dtype=torch.int32, device=device))
    return BounceState(*state, alive)


class PoolTlasOperands(NamedTuple):
    """A pool window's TLAS operands: its frames' ``TlasFrame``s stacked
    frame-major, frame f's K slots at rows [f K, (f + 1) K) and its M nodes
    at rows [f M, (f + 1) M), and one key window over every frame's
    instances (the reference's pool key, ``pallas_kernels.py:3903-3960``)."""

    slots: torch.Tensor  # [F K, 22]
    node_bounds: torch.Tensor  # [F M, 8]
    links: torch.Tensor  # [F M, 4] int32, offset into the stacked rows (tlas_links)
    key_window: torch.Tensor  # [6]


def _stack_pool_tlas(ops: "PoolMeshOperands") -> PoolTlasOperands:
    frames = [tlas_frame(mesh) for mesh in ops.meshes]
    slots = torch.cat([frame.slots for frame in frames]).contiguous()
    # The window's key window: the min and max of the frames' world boxes,
    # then the frame rule's padding and reciprocal (on the window's device).
    return PoolTlasOperands(
        slots=slots,
        node_bounds=torch.cat([frame.node_bounds for frame in frames]).contiguous(),
        links=tlas_links(ops.per_frame, len(frames), slots.device, mesh_leaf(ops.meshes[0])),
        key_window=mesh_key_bounds(slots[:, 13:16], slots[:, 16:19]),
    )


# A pool window's TLAS operands, stacked once per PoolMeshOperands.
pool_tlas_operands = _IdentityCache(_stack_pool_tlas)


def _stack_pool_quant(ops: "PoolMeshOperands", quant: int) -> QuantTable:
    """The window's stacked TLAS windows at tier ``quant``, against ONE grid
    (the union of every frame's nodes), the skip links and leaf starts with
    their frame offsets inside the meta words (``pallas_kernels.py:3945-3957``)."""
    union = torch.stack([tlas_frame(mesh).union for mesh in ops.meshes])
    grid = quant_grid(union[:, 0:3].amin(dim=0), union[:, 3:6].amax(dim=0), quant)
    stacked = pool_tlas_operands(ops)
    links = stacked.links
    return quant_table(stacked.node_bounds[:, 0:3], stacked.node_bounds[:, 4:7], links[:, 0],
                       links[:, 1], links[:, 2], quant, 1, grid)


# A pool window's quantized TLAS, once per PoolMeshOperands and tier.
_pool_quant_tables = {
    quant: _IdentityCache(functools.partial(_stack_pool_quant, quant=quant))
    for quant in QUANT_TIERS
}


def pool_tlas_quant(ops: "PoolMeshOperands", quant: int) -> QuantTable:
    """A pool window's stacked TLAS at tier ``quant`` (1 or 2)."""
    return _pool_quant_tables[quant](ops)


def _live_tensor(live_count, device) -> torch.Tensor:
    """The live count as one int32 on the card."""
    if isinstance(live_count, torch.Tensor):
        return live_count.to(device=device, dtype=torch.int32).reshape(1)
    # Filled on the card: a copy from pageable host memory would wait for it.
    return torch.full((1,), int(live_count), dtype=torch.int32, device=device)


def _launch_pool(name, spheres, mesh_ops, state, live_count, total_bounces, group=None,
                 quant=0, packet=TLAS_BLOCK_R):
    tlas = name == "pool_mesh_bounce_tlas"
    packet = packet if tlas else None
    library = _library(name, packet)
    launch = getattr(library, f"{name}_launch")
    rays = state[0].shape[0]
    if rays >= 2**31:
        raise ValueError(f"{rays} lanes exceed the kernel's int32 lane index")
    device = state[0].device
    live = _live_tensor(live_count, device)
    state = [t.contiguous() for t in state]
    frames = len(spheres.tables)
    tables = [spheres.spheres.data_ptr(), spheres.per_frame, frames, spheres.params.data_ptr()]
    if mesh_ops is not None:
        bvh = mesh_ops.meshes[0].bvh
        ordered = walks_ordered(bvh)
        pool_tlas = pool_tlas_operands(mesh_ops) if tlas else None
        instances = mesh_ops.instances if pool_tlas is None else pool_tlas.slots
        tables += [instances.data_ptr(), mesh_ops.per_frame, *_bvh_tables(bvh, ordered, quant)]
        node_format = [int(quant), _grid(bvh_quant_table(bvh, quant, ordered) if quant else None)]
        if pool_tlas is not None:
            table = pool_tlas_quant(mesh_ops, quant) if quant else None
            bounds, links = pool_tlas.node_bounds, pool_tlas.links
            if table is not None:
                bounds, links = table.words, None
            node_format.append(_grid(table))
            tables += [
                bounds.data_ptr(), _pointer(links), pool_tlas.links.shape[0] // frames,
                pool_tlas.key_window.data_ptr(),
            ]
        # The pool orders its BLAS only: votes per row of the stacked table,
        # for the frames each packet's lanes carry.
        votes = _packet_votes(state[1], live, instances, packet if tlas else BVH_BLOCK_R,
                              bvh, ordered, False, state[5], mesh_ops.per_frame, packet)
        tables += [int(ordered), 0 if votes is None else _pointer(votes[1])]
    else:
        node_format = []
    out = _bounce_outputs(rays, device, tlas)
    status = launch(
        *(t.data_ptr() for t in state), rays, live.data_ptr(), *tables, int(total_bounces),
        *(t.data_ptr() for t in out), *([POOL_GROUP if group is None else group] if tlas else []),
        *node_format, torch.cuda.current_stream(device).cuda_stream,
    )
    _check_status(library, name, status)
    _count(name, quant, packet)
    return out


# ---------------------------------------------------------------------------
# Unit kernels: rays against the spheres or against every mesh instance


def _check_instance_rays(mesh: MeshSet, origins, directions, row, dtype, name) -> None:
    _check_rays(mesh.instances.translation, origins, directions)
    _check_mesh(mesh, origins)
    _check_ray_row(origins, row, dtype, name)


def _check_bvh_rays(bvh: MeshBVH, origins, directions, row, dtype, name) -> None:
    _check_rays(bvh.v0, origins, directions)
    _check_bvh(bvh, origins)
    _check_ray_row(origins, row, dtype, name)


def _check_ray_row(origins, row, dtype, name) -> None:
    """A per-ray input ``row``: ``dtype`` [R] on the rays' device."""
    if row.shape != (origins.shape[0],) or row.dtype != dtype or row.device != origins.device:
        raise ValueError(
            f"{name} must be {dtype} [R] on the rays' device; got {row.dtype} "
            f"{tuple(row.shape)} on {row.device}"
        )


def intersect_spheres(
    scene: Scene, origins: torch.Tensor, directions: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest sphere hit of each ray ([R, 3] float32): (t [R] float32,
    ``INF`` on a miss; index [R] int32, the first sphere reaching the
    minimum, 0 on a miss). The ground plane is not tested. CUDA tensors go
    to the kernel, CPU tensors to the plain version."""
    _check_rays(scene.centers, origins, directions)
    if origins.device.type == "cuda":
        spheres, params = _sphere_operands(scene)
        t = torch.empty(origins.shape[0], dtype=torch.float32, device=origins.device)
        index = torch.empty(origins.shape[0], dtype=torch.int32, device=origins.device)
        _launch_unit(
            "intersect_spheres", (origins, directions),
            [spheres.data_ptr(), spheres.shape[0], params.data_ptr()], (t, index),
        )
        return t, index
    if origins.device.type == "cpu":
        return intersect_spheres_reference(scene, origins, directions)
    raise ValueError(f"Unsupported device {origins.device}")


def occluded_spheres(
    scene: Scene, origins: torch.Tensor, directions: torch.Tensor
) -> torch.Tensor:
    """Shadow any-hit of each ray against the spheres: bool [R], true where
    some real sphere has its far root past ``EPS`` ahead of the origin.
    CUDA tensors go to the kernel, CPU tensors to the plain version."""
    _check_rays(scene.centers, origins, directions)
    if origins.device.type == "cuda":
        spheres, params = _sphere_operands(scene)
        hit = torch.empty(origins.shape[0], dtype=torch.bool, device=origins.device)
        _launch_unit(
            "occluded_spheres", (origins, directions),
            [spheres.data_ptr(), spheres.shape[0], params.data_ptr()], (hit,),
        )
        return hit
    if origins.device.type == "cpu":
        return occluded_spheres_reference(scene, origins, directions)
    raise ValueError(f"Unsupported device {origins.device}")


def intersect_instances(
    mesh: MeshSet,
    origins: torch.Tensor,
    directions: torch.Tensor,
    init_t: torch.Tensor,
    *,
    _group: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Nearest hit of each world-space ray over every instance of ``mesh``,
    seeded with ``init_t`` [R] float32 (only a hit strictly nearer counts):
    (t [R], ``init_t`` on a miss; triangle row [R] int32, a row of the
    BVH's tables; instance [R] int32), row and instance 0 on a miss. CUDA
    tensors go to the kernel, CPU tensors to the plain version. ``_group``
    (tests and measurements only) fixes the kernel's group size, else
    ``instance_group`` of the launch; it changes no output."""
    _check_instance_rays(mesh, origins, directions, init_t, torch.float32, "init_t")
    _check_group(_group)
    if origins.device.type == "cuda":
        rays, device = origins.shape[0], origins.device
        t = torch.empty(rays, dtype=torch.float32, device=device)
        tri = torch.empty(rays, dtype=torch.int32, device=device)
        inst = torch.empty(rays, dtype=torch.int32, device=device)
        if _group is None:
            _group = instance_group(rays, thread_slots(device.index or 0))
        _launch_unit(
            "intersect_instances", (origins, directions, init_t), _mesh_tables(mesh),
            (t, tri, inst), _group,
        )
        return t, tri, inst
    if origins.device.type == "cpu":
        return intersect_instances_reference(mesh, origins, directions, init_t)
    raise ValueError(f"Unsupported device {origins.device}")


def occluded_instances(
    mesh: MeshSet,
    origins: torch.Tensor,
    directions: torch.Tensor,
    already: torch.Tensor,
    *,
    _group: int | None = None,
) -> torch.Tensor:
    """Shadow any-hit of each world-space ray over every instance of
    ``mesh`` (a triangle ahead of the origin, t > ``EPS``, unbounded): bool
    [R], OR-ed with ``already`` [R] bool, whose lanes do not walk. CUDA
    tensors go to the kernel, CPU tensors to the plain version. ``_group``
    (tests and measurements only) fixes the kernel's group size, else
    (or with ``OCCLUDED_GROUP``) each warp picks it for its batch of
    walking rays; it changes no output."""
    _check_instance_rays(mesh, origins, directions, already, torch.bool, "already")
    _check_group(_group, (*GROUPS, OCCLUDED_GROUP))
    if origins.device.type == "cuda":
        hit = torch.empty(origins.shape[0], dtype=torch.bool, device=origins.device)
        _launch_unit(
            "occluded_instances", (origins, directions, already), _mesh_tables(mesh), (hit,),
            OCCLUDED_GROUP if _group is None else _group,
        )
        return hit
    if origins.device.type == "cpu":
        return occluded_instances_reference(mesh, origins, directions, already)
    raise ValueError(f"Unsupported device {origins.device}")


def intersect_mesh(
    bvh: MeshBVH, origins: torch.Tensor, directions: torch.Tensor, init_t: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest hit of each object-space ray ([R, 3] float32) in one mesh's
    BVH, seeded with ``init_t`` [R] float32 (only a hit strictly nearer
    counts): (t [R], ``init_t`` on a miss; triangle row [R] int32, a row of
    the BVH's tables, 0 on a miss). CUDA tensors go to the kernel, CPU
    tensors to the plain version."""
    _check_bvh_rays(bvh, origins, directions, init_t, torch.float32, "init_t")
    if origins.device.type == "cuda":
        rays, device = origins.shape[0], origins.device
        t = torch.empty(rays, dtype=torch.float32, device=device)
        tri = torch.empty(rays, dtype=torch.int32, device=device)
        _launch_unit("intersect_mesh", (origins, directions, init_t), _bvh_tables(bvh), (t, tri))
        return t, tri
    if origins.device.type == "cpu":
        return intersect_mesh_reference(bvh, origins, directions, init_t)
    raise ValueError(f"Unsupported device {origins.device}")


def occluded_mesh(
    bvh: MeshBVH, origins: torch.Tensor, directions: torch.Tensor, already: torch.Tensor
) -> torch.Tensor:
    """Shadow any-hit of each object-space ray in one mesh's BVH (a
    triangle ahead of the origin, t > ``EPS``, unbounded): bool [R], OR-ed
    with ``already`` [R] bool, whose lanes do not walk. CUDA tensors go to
    the kernel, CPU tensors to the plain version."""
    _check_bvh_rays(bvh, origins, directions, already, torch.bool, "already")
    if origins.device.type == "cuda":
        hit = torch.empty(origins.shape[0], dtype=torch.bool, device=origins.device)
        _launch_unit("occluded_mesh", (origins, directions, already), _bvh_tables(bvh), (hit,))
        return hit
    if origins.device.type == "cpu":
        return occluded_mesh_reference(bvh, origins, directions, already)
    raise ValueError(f"Unsupported device {origins.device}")


def _launch_unit(
    name: str, rays: tuple, tables: list, outputs: tuple, group: int | None = None
) -> None:
    """Launch unit kernel ``name`` on ``rays`` (origins, directions and its
    per-ray input) and ``tables`` into ``outputs``, on the current stream;
    a group-walk kernel (``group`` given: ``intersect_instances``,
    ``occluded_instances``) then takes its group size and its persistent
    blocks' work counter."""
    library = _library(name)
    launch = getattr(library, f"{name}_launch")
    n_rays = rays[0].shape[0]
    if n_rays >= 2**31:
        raise ValueError(f"{n_rays} rays exceed the kernel's int32 lane index")
    rays = [t.contiguous() for t in rays]
    device = rays[0].device
    stream = torch.cuda.current_stream(device).cuda_stream
    walk = [] if group is None else [group, _work_counter(device, stream).data_ptr()]
    status = launch(
        *(t.data_ptr() for t in rays), n_rays, *tables, *(t.data_ptr() for t in outputs), *walk,
        stream,
    )
    _check_status(library, name, status)
    counts[name] += 1


# ---------------------------------------------------------------------------
# The plain versions


def trace_paths_fused_reference(
    scene: Scene,
    origins: torch.Tensor,
    directions: torch.Tensor,
    seed: int,
    *,
    max_bounces: int,
    chunk_rays: int = 32768,
    stats: dict | None = None,
    lane: torch.Tensor | None = None,
) -> torch.Tensor:
    """The plain PyTorch version of the sphere megakernel, on any device.

    It repeats the reference's masked loop (every lane runs every bounce
    under an ``alive`` mask) over chunks of rays: a whole frame's
    ``[rays, spheres]`` intermediates would take about 0.5 GB each. Lanes
    keep their global index, so chunking changes no result. ``lane`` (int32
    ``[R]``): the lane mode, each chunk's RNG counters from its rows of
    ``lane`` in place of the rays' positions.

    ``stats``, when given, receives the work this input needs, counted the
    way the kernel does it: the scene's spheres (its radius-0 pad slots are
    not counted), lane-bounces alive, lanes that hit, and sphere tests of the
    shadow rays (which stop at the first occluder). The counts add up on
    the device and are read once, at the end.
    """
    _check_inputs(scene, origins, directions, seed)
    _check_lane(origins, lane)
    counts["trace_fused_reference" if lane is None else "trace_fused_lanes_reference"] += 1
    return _trace_reference(
        sphere_table(scene), None, origins, directions, seed, max_bounces, chunk_rays, stats,
        lane,
    )


def trace_paths_fused_mesh_reference(
    scene: Scene,
    mesh: MeshSet,
    origins: torch.Tensor,
    directions: torch.Tensor,
    seed: int,
    *,
    max_bounces: int,
    use_tlas: bool | None = None,
    quant: int = 0,
    chunk_rays: int = 262144,
    stats: dict | None = None,
    tlas_block: int | None = None,
) -> torch.Tensor:
    """The plain PyTorch version of the mesh megakernel, on any device.

    The sphere version's masked loop plus, per bounce, the nearest mesh
    hit (seeded with the sphere/plane t; strict ``<`` updates) and the
    mesh shadow any-hit. The BVH walk is a sweep over the nodes in DFS
    preorder that carries, per node, the rays whose walk reaches it: a ray
    reaches a node when it passed the slab test of the node's parent,
    tested against its best t at that moment. That is the per-ray walk of
    the kernel, so the two agree ray for ray, ties included.

    ``use_tlas`` (None: ``use_tlas_for``) walks the instances as the TLAS
    variant does: the slot-ordered table through the frame's TLAS, each
    ray reaching a node when it passed its parent's box with its best t
    (shadow rays: until their first occluder), the leaves' slots in order;
    its packets of ``tlas_block`` lanes (``tlas_packet``) vote its walk
    order.

    ``quant`` (``mesh_quant``) walks the quantized tables' boxes as the
    kernel reconstructs them (``dequantize_node_bounds``) and their
    unpacked links.

    ``stats`` also receives the mesh work: the instance count, the rays
    that search the instances (nearest and shadow rays), world-AABB tests,
    instance walks entered, node slab tests and triangle tests (the shadow
    walks stop at the first occluder, as the kernel's do), and the TLAS
    node tests.
    """
    _check_inputs(scene, origins, directions, seed)
    _check_mesh(mesh, origins)
    tlas = use_tlas_for(mesh.instances.translation.shape[0], use_tlas, mesh_leaf(mesh))
    quant = mesh_quant(mesh, quant, tlas)
    packet = tlas_packet(tlas_block)
    name = "trace_fused_mesh_tlas_reference" if tlas else "trace_fused_mesh_reference"
    _count(name, quant, packet if tlas else None)
    walk = _MeshWalk.build(mesh, scene.sun_direction, use_tlas=tlas, quant=quant)
    return _trace_reference(
        sphere_table(scene), walk._replace(packet=packet), origins, directions, seed, max_bounces,
        chunk_rays, stats,
    )


def sphere_bounce_reference(
    scene: Scene,
    origins: torch.Tensor,
    directions: torch.Tensor,
    throughput: torch.Tensor,
    alive: torch.Tensor,
    lane: torch.Tensor,
    live_count,
    seed: int,
    bounce: int,
    *,
    total_bounces: int,
    chunk_rays: int = 32768,
    stats: dict | None = None,
) -> BounceState:
    """The plain PyTorch version of the per-bounce sphere kernel, on any
    device: one bounce of the sphere megakernel's plain version over the
    leading ``live_count`` lanes, the contribution from zero; the lanes
    past it pass through. ``stats`` as for the megakernel's version."""
    _check_state(scene, origins, directions, throughput, alive, lane, seed, bounce, total_bounces)
    counts["sphere_bounce_reference"] += 1
    return _bounce_reference(
        sphere_table(scene), None, origins, directions, throughput, alive, lane, live_count,
        seed, bounce, total_bounces, chunk_rays, stats,
    )


def mesh_bounce_reference(
    scene: Scene,
    mesh: MeshSet,
    origins: torch.Tensor,
    directions: torch.Tensor,
    throughput: torch.Tensor,
    alive: torch.Tensor,
    lane: torch.Tensor,
    live_count,
    seed: int,
    bounce: int,
    *,
    total_bounces: int,
    use_tlas: bool | None = None,
    quant: int = 0,
    chunk_rays: int = 262144,
    stats: dict | None = None,
    tlas_block: int | None = None,
    _hits: list | None = None,
) -> BounceState | KeyedBounceState:
    """The plain PyTorch version of the per-bounce mesh kernel, on any
    device: ``sphere_bounce_reference`` with the mesh megakernel's plain
    bounce (its node sweep and its work counters). ``use_tlas`` (None:
    ``use_tlas_for``) walks as the TLAS variant and keys its output as the
    kernel does (``mesh_bounce``), the candidates from the plain entry walk
    (counted as ``entry_rays`` and ``entry_tests``); ``quant``,
    ``tlas_block`` and ``_hits`` as for ``mesh_bounce``."""
    _check_state(scene, origins, directions, throughput, alive, lane, seed, bounce, total_bounces)
    _check_mesh(mesh, origins)
    tlas = use_tlas_for(mesh.instances.translation.shape[0], use_tlas, mesh_leaf(mesh))
    quant = mesh_quant(mesh, quant, tlas)
    packet = tlas_packet(tlas_block)
    name = "mesh_bounce_tlas_reference" if tlas else "mesh_bounce_reference"
    _count(name, quant, packet if tlas else None)
    walk = _MeshWalk.build(mesh, scene.sun_direction, use_tlas=tlas, quant=quant)
    return _bounce_reference(
        sphere_table(scene), walk._replace(packet=packet), origins, directions, throughput,
        alive, lane, live_count, seed, bounce, total_bounces, chunk_rays, stats, quant, _hits,
    )


def pool_sphere_bounce_reference(
    ops: PoolSphereOperands,
    origins: torch.Tensor,
    directions: torch.Tensor,
    throughput: torch.Tensor,
    alive: torch.Tensor,
    lane: torch.Tensor,
    fid: torch.Tensor,
    seed_row: torch.Tensor,
    bounce_row: torch.Tensor,
    live_count,
    *,
    total_bounces: int,
    chunk_rays: int = 32768,
    stats: dict | None = None,
) -> BounceState:
    """The plain PyTorch version of the pool sphere kernel, on any device:
    the live lanes of the leading ``live_count`` grouped by frame, each
    group through one bounce of the sphere megakernel's plain version
    against its own frame's table, with each lane's own seed and bounce.
    Per lane that is the masked loop's arithmetic. Dead lanes and lanes
    past the count pass through with a zero contribution. ``stats`` as for
    the megakernel's version, counting one frame's spheres per test."""
    _check_pool_state(ops, origins, directions, throughput, alive, lane, fid, seed_row,
                      bounce_row, total_bounces)
    counts["pool_sphere_bounce_reference"] += 1
    return _pool_reference(
        ops.tables, None, origins, directions, throughput, alive, lane, fid, seed_row,
        bounce_row, live_count, total_bounces, chunk_rays, stats,
    )


def pool_mesh_bounce_reference(
    ops: PoolMeshOperands,
    origins: torch.Tensor,
    directions: torch.Tensor,
    throughput: torch.Tensor,
    alive: torch.Tensor,
    lane: torch.Tensor,
    fid: torch.Tensor,
    seed_row: torch.Tensor,
    bounce_row: torch.Tensor,
    live_count,
    *,
    total_bounces: int,
    use_tlas: bool | None = None,
    quant: int = 0,
    chunk_rays: int = 262144,
    stats: dict | None = None,
    tlas_block: int | None = None,
) -> BounceState | KeyedBounceState:
    """The plain PyTorch version of the pool mesh kernel, on any device:
    ``pool_sphere_bounce_reference`` with each frame's mesh walk (the mesh
    megakernel's plain bounce and its work counters). ``use_tlas`` (None:
    ``use_tlas_for``) walks each frame's TLAS and keys the output as the
    kernel does (``pool_mesh_bounce``); ``quant`` and ``tlas_block`` as
    there, each frame's TLAS boxes from the window's one grid."""
    _check_pool_state(ops.spheres, origins, directions, throughput, alive, lane, fid, seed_row,
                      bounce_row, total_bounces)
    _check_mesh(ops.meshes[0], origins)
    tlas = use_tlas_for(ops.per_frame, use_tlas, mesh_leaf(ops.meshes[0]))
    quant = pool_quant(ops, quant, tlas)
    packet = tlas_packet(tlas_block)
    name = "pool_mesh_bounce_tlas_reference" if tlas else "pool_mesh_bounce_reference"
    _count(name, quant, packet if tlas else None)
    walks = tuple(walk._replace(packet=packet) for walk in _pool_walks[(tlas, quant)](ops))
    return _pool_reference(
        ops.spheres.tables, walks, origins, directions,
        throughput, alive, lane, fid, seed_row, bounce_row, live_count, total_bounces, chunk_rays,
        stats, window=pool_tlas_operands(ops).key_window if tlas else None, packed_keys=quant > 0,
    )


def _frame_walks(ops: PoolMeshOperands, use_tlas: bool, quant: int) -> tuple:
    tlas_bounds = [None] * len(ops.meshes)
    if use_tlas and quant:
        table = pool_tlas_quant(ops, quant)
        bounds = _dequantized_rows(table, quant)
        m = bounds.shape[0] // len(ops.meshes)
        tlas_bounds = [bounds[f * m:(f + 1) * m] for f in range(len(ops.meshes))]
    return tuple(
        _MeshWalk.build(mesh, table.sun_direction, use_tlas=use_tlas, quant=quant,
                        tlas_bounds=bounds)
        for mesh, table, bounds in zip(ops.meshes, ops.spheres.tables, tlas_bounds)
    )


# The plain version's mesh walk of each frame of a pool window, per (TLAS,
# node format).
_pool_walks = {
    (tlas, quant): _IdentityCache(functools.partial(_frame_walks, use_tlas=tlas, quant=quant))
    for tlas in (False, True) for quant in (0, *QUANT_TIERS)
}


def _pool_reference(
    tables, walks, origins, directions, throughput, alive, lane, fid, seed_row, bounce_row,
    live_count, total_bounces, chunk_rays, stats, window=None, packed_keys=False,
):
    """The pool's plain bounce; with a key ``window``, also the TLAS
    variant's key (the walks then TLAS walks); ``packed_keys``: a lane that
    hit an instance keys with that slot of its frame, walking no entry."""
    rays = origins.shape[0]
    live = max(0, min(int(live_count), rays))
    out = BounceState(
        torch.zeros_like(origins), origins.clone(), directions.clone(), throughput.clone(),
        alive.clone(),
    )
    candidate = None
    if window is not None:
        candidate = torch.full((rays,), walks[0].table.shape[0], dtype=torch.int64,
                               device=origins.device)
    if stats is not None:
        keys = _start_stats(stats, tables[0], None if walks is None else walks[0])
    orders = _pool_orders(walks, directions, fid, live)
    frame = fid[:live].to(torch.int64)
    running = alive[:live]
    outside = running & ((frame < 0) | (frame >= len(tables)))
    if outside.any():
        raise ValueError(
            f"live lanes carry frame ids outside the window of {len(tables)} frames"
        )
    for f, table in enumerate(tables):
        # A dead lane adds zero and keeps its state, so only live lanes run.
        rows_f = (running & (frame == f)).nonzero()[:, 0]
        for start in range(0, rows_f.numel(), chunk_rays):
            rows = rows_f[start:start + chunk_rays]
            zero = torch.zeros_like(origins[rows])
            hit_out = [] if packed_keys else None
            o, d, thr, contribution, alive_f = _bounce(
                table, None if walks is None else walks[f], origins[rows], directions[rows],
                throughput[rows], zero, alive[rows, None].to(torch.float32),
                lane[rows].to(torch.int64), bounce_row[rows].to(torch.int64), total_bounces,
                seed_row[rows].to(torch.int64) & MASK32, stats,
                None if walks is None or orders[f] is None else orders[f].rows(rows), hit_out,
            )
            out.contribution[rows] = contribution
            out.origins[rows] = o
            out.directions[rows] = d
            out.throughput[rows] = thr
            out.alive[rows] = alive_f[:, 0] > 0.5
            if candidate is not None:  # the frame-local slot each new ray enters first
                lives = alive_f[:, 0] > 0.5
                if packed_keys:  # a hit's own slot, and no entry walk
                    hit = hit_out[0] >= 0
                    candidate[rows[hit]] = hit_out[0][hit]
                    lives = lives & ~hit
                candidate[rows[lives]] = walks[f].entry_candidates(o[lives], d[lives], stats)
    if stats is not None:
        for key in keys:
            stats[key] = int(stats[key])
    if candidate is None:
        return out
    return KeyedBounceState(
        *out, coherence_key(out.origins + out.directions, out.directions, ~out.alive, fid,
                            candidate, window),
    )


def _pool_orders(walks, directions, fid, live) -> list:
    """Each frame's order of a pool launch: the packets' BLAS votes over
    every lane of the pool, in the stacked table of the frames' walks, for
    the frames each packet's lanes carry (``packet_votes`` with ``frames``:
    a lane reads only its own frame's rows); the pool's TLAS walks stay
    canonical, as the reference's. None per frame on the canonical walk."""
    if not walks:
        return []
    walk = walks[0]
    if walk.octants is None:
        return [None] * len(walks)
    packet = torch.arange(directions.shape[0], device=directions.device) // walk.block
    if len(walk.count) <= 1:  # a one-node tree reads the same row in every octant
        return [_Order(packet=packet, blas=None, tlas=None)] * len(walks)
    k = walk.table.shape[0]
    _, votes = _votes(directions, torch.cat([w.table for w in walks]), live, walk.block, False,
                      True, fid, k)
    return [_Order(packet=packet, blas=votes[:, f * k:(f + 1) * k].to(torch.int64), tlas=None)
            for f in range(len(walks))]


def intersect_spheres_reference(
    scene: Scene,
    origins: torch.Tensor,
    directions: torch.Tensor,
    *,
    chunk_rays: int = 32768,
    stats: dict | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the sphere nearest-hit kernel, on any
    device: the megakernels' sphere pass (``_nearest_sphere``) over chunks
    of rays (a frame's ``[rays, spheres]`` intermediates would take about
    70 MB each). ``stats``, when given, receives the work: the real spheres
    and the rays, each of which tests every sphere."""
    _check_rays(scene.centers, origins, directions)
    counts["intersect_spheres_reference"] += 1
    table = sphere_table(scene)
    rays = origins.shape[0]
    t = torch.empty(rays, dtype=torch.float32, device=origins.device)
    index = torch.empty(rays, dtype=torch.int32, device=origins.device)
    for start in range(0, rays, chunk_rays):
        rows = slice(start, start + chunk_rays)
        t_rows, index_rows = _nearest_sphere(table, origins[rows], directions[rows])
        t[rows] = t_rows[:, 0]
        index[rows] = index_rows.to(torch.int32)
    if stats is not None:
        stats.update(spheres=int((table.r2 > 0.0).sum()), rays=rays)
    return t, index


def occluded_spheres_reference(
    scene: Scene,
    origins: torch.Tensor,
    directions: torch.Tensor,
    *,
    chunk_rays: int = 32768,
    stats: dict | None = None,
) -> torch.Tensor:
    """The plain PyTorch version of the sphere shadow any-hit kernel, on
    any device: the megakernels' shadow test (``_sphere_occluders``) along
    each ray's own direction. ``stats`` receives the real spheres, the rays
    and the sphere tests, each ray's ending at its first occluder."""
    _check_rays(scene.centers, origins, directions)
    counts["occluded_spheres_reference"] += 1
    table = sphere_table(scene)
    spheres = int((table.r2 > 0.0).sum())
    rays = origins.shape[0]
    hit = torch.empty(rays, dtype=torch.bool, device=origins.device)
    tests = 0
    for start in range(0, rays, chunk_rays):
        rows = slice(start, start + chunk_rays)
        o, d = origins[rows], directions[rows]
        occluders = _sphere_occluders(table, o, _sphere_dots(table.centers, d), dot3(o, d)[:, None])
        hit[rows] = occluders.any(dim=1)
        if stats is not None:
            tests = tests + _sphere_tests(occluders, spheres).sum()
    if stats is not None:
        stats.update(spheres=spheres, rays=rays, sphere_tests=int(tests))
    return hit


def _unit_mesh_stats(stats: dict | None, run, keys: tuple[str, ...] = None, **fixed):
    """``run(stats)`` with the mesh work counters ``keys`` (default: all of
    them) set up in ``stats`` (when given) beside the ``fixed`` entries, and
    read once at the end."""
    if stats is None:
        return run(None)
    keys = _MESH_STATS if keys is None else keys
    for key in keys:
        stats.setdefault(key, 0)
    stats.update(fixed)
    result = run(stats)
    for key in keys:
        stats[key] = int(stats[key])
    return result


def intersect_instances_reference(
    mesh: MeshSet,
    origins: torch.Tensor,
    directions: torch.Tensor,
    init_t: torch.Tensor,
    *,
    stats: dict | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the instanced nearest-hit kernel, on
    any device: the mesh megakernel's plain instance walk
    (``_MeshWalk.nearest_rows``), seeded with ``init_t``. ``stats`` as for
    the mesh megakernel's version (its mesh counters)."""
    _check_instance_rays(mesh, origins, directions, init_t, torch.float32, "init_t")
    counts["intersect_instances_reference"] += 1
    walk = _MeshWalk.build(mesh)
    t, k, row = _unit_mesh_stats(
        stats, lambda stats: walk.nearest_rows(origins, directions, init_t, stats),
        instances=walk.table.shape[0],
    )
    return t, row.to(torch.int32), k.clamp_min(0).to(torch.int32)


def occluded_instances_reference(
    mesh: MeshSet,
    origins: torch.Tensor,
    directions: torch.Tensor,
    already: torch.Tensor,
    *,
    stats: dict | None = None,
) -> torch.Tensor:
    """The plain PyTorch version of the instanced shadow any-hit kernel, on
    any device: the mesh megakernel's plain shadow walk
    (``_MeshWalk.occluded``) along each ray's own direction, ``already``
    lanes True without walking. ``stats`` as for
    ``intersect_instances_reference``."""
    _check_instance_rays(mesh, origins, directions, already, torch.bool, "already")
    counts["occluded_instances_reference"] += 1
    walk = _MeshWalk.build(mesh)
    return _unit_mesh_stats(
        stats, lambda stats: walk.occluded(origins, already, stats, directions=directions),
        instances=walk.table.shape[0],
    )


_BLAS_STATS = ("node_tests", "triangle_tests")


def intersect_mesh_reference(
    bvh: MeshBVH,
    origins: torch.Tensor,
    directions: torch.Tensor,
    init_t: torch.Tensor,
    *,
    stats: dict | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the single-BVH nearest-hit kernel, on
    any device: the other plain versions' mesh walk over one BVH
    (``_MeshWalk.blas_nearest``), no instance loop and no world box, seeded
    with ``init_t``. ``stats``, when given, receives the work: the rays, the
    node slab tests and the triangle tests."""
    _check_bvh_rays(bvh, origins, directions, init_t, torch.float32, "init_t")
    counts["intersect_mesh_reference"] += 1
    walk = _blas_walks(bvh)
    t, row = _unit_mesh_stats(
        stats, lambda stats: walk.blas_nearest(origins, directions, init_t, stats),
        _BLAS_STATS, rays=origins.shape[0],
    )
    return t, row.to(torch.int32)


def occluded_mesh_reference(
    bvh: MeshBVH,
    origins: torch.Tensor,
    directions: torch.Tensor,
    already: torch.Tensor,
    *,
    stats: dict | None = None,
) -> torch.Tensor:
    """The plain PyTorch version of the single-BVH shadow any-hit kernel,
    on any device: ``_MeshWalk.blas_occluded`` for the lanes without
    ``already``, the others True without walking. ``stats`` as for
    ``intersect_mesh_reference``, with the lanes that walk."""
    _check_bvh_rays(bvh, origins, directions, already, torch.bool, "already")
    counts["occluded_mesh_reference"] += 1
    walk = _blas_walks(bvh)
    lanes = (~already).nonzero()[:, 0]
    hit = already.clone()
    hit[lanes] = _unit_mesh_stats(
        stats, lambda stats: walk.blas_occluded(origins[lanes], directions[lanes], stats),
        _BLAS_STATS, rays=origins.shape[0], walking_rays=lanes.numel(),
    )
    return hit


# The plain walk of a BVH, built once per BVH; a frame's TLAS walk for the
# key pass, once per MeshSet.
_blas_walks = _IdentityCache(lambda bvh: _MeshWalk.for_bvh(bvh))
_entry_walks = {
    quant: _IdentityCache(lambda mesh, quant=quant: _MeshWalk.build(mesh, use_tlas=True,
                                                                     quant=quant))
    for quant in (0, *QUANT_TIERS)
}


def _bounce_reference(
    table, walk, origins, directions, throughput, alive, lane, live_count, seed, bounce,
    total_bounces, chunk_rays, stats, quant=0, hits_out=None,
):
    rays = origins.shape[0]
    live = max(0, min(int(live_count), rays))
    out = BounceState(
        torch.zeros_like(origins), origins.clone(), directions.clone(), throughput.clone(),
        alive.clone(),
    )
    if stats is not None:
        keys = _start_stats(stats, table, walk)
    # The packets' votes over every lane of the launch, as it came in.
    order = None if walk is None else walk.order(directions)
    keyed = walk is not None and walk.tlas is not None
    # The packed-key rule's hit column: each lane's winning slot, K for none.
    hits = None
    if keyed and quant:
        hits = torch.full((rays,), walk.table.shape[0], dtype=torch.int64, device=origins.device)
    for start in range(0, live, chunk_rays):
        rows = slice(start, min(start + chunk_rays, live))
        zero = torch.zeros_like(origins[rows])
        hit_out = None if hits is None else []
        o, d, thr, contribution, alive_f = _bounce(
            table, walk, origins[rows], directions[rows], throughput[rows], zero,
            alive[rows, None].to(torch.float32), lane[rows].to(torch.int64), bounce,
            total_bounces, int(seed) & MASK32, stats, None if order is None else order.rows(rows),
            hit_out,
        )
        out.contribution[rows] = contribution
        out.origins[rows] = o
        out.directions[rows] = d
        out.throughput[rows] = thr
        out.alive[rows] = alive_f[:, 0] > 0.5
        if hits is not None:
            hits[rows] = torch.where(hit_out[0] >= 0, hit_out[0], hits[rows])
    if hits is not None and hits_out is not None:
        hits_out.append(hits.to(torch.int32))
    if keyed:
        key = _keys_reference(walk, out.origins, out.directions, out.alive, live, bounce,
                              total_bounces, chunk_rays, stats, order is not None, hits)
    if stats is not None:
        for key_name in keys:
            stats[key_name] = int(stats[key_name])
    return KeyedBounceState(*out, key) if keyed else out


def _keys_reference(walk, origins, directions, alive, live, bounce, total_bounces, chunk_rays,
                    stats, ordered, hits=None):
    """The per-bounce TLAS kernel's key of its outputs: the slot each live
    new ray below ``live`` enters first, K for the others and on the last
    bounce (its key is never sorted by); ``ordered``: the entry walk takes
    the TLAS table of its packet's vote over every lane's new direction.
    ``hits`` [R] (the quantized tiers' packed-key rule): a lane whose hit
    slot is below K keys with it, on every bounce, and walks no entry."""
    rays = origins.shape[0]
    k = walk.table.shape[0]
    candidate = torch.full((rays,), k, dtype=torch.int64, device=origins.device)
    walking = alive[:live]
    if hits is not None:
        hit = hits.to(torch.int64) < k
        candidate = torch.where(hit, hits.to(torch.int64), candidate)
        walking = walking & ~hit[:live]
    if int(bounce) < int(total_bounces) - 1:
        lives = walking.nonzero()[:, 0]
        entry = None
        if ordered:
            packet = torch.arange(rays, device=origins.device) // walk.block
            entry = packet_octants(directions, walk.block)[packet]
        for start in range(0, lives.numel(), chunk_rays):
            rows = lives[start:start + chunk_rays]
            candidate[rows] = walk.entry_candidates(
                origins[rows], directions[rows], stats, None if entry is None else entry[rows],
            )
    return coherence_key(
        origins + directions, directions, ~alive, torch.zeros_like(candidate), candidate,
        walk.key_window,
    )


_STATS = ("alive_lane_bounces", "hit_lane_bounces", "shadow_sphere_tests")
_MESH_STATS = (
    "broadphase_rays", "world_aabb_tests", "instance_walks", "node_tests", "triangle_tests"
)
# The TLAS walks' work: node tests of the nearest and shadow walks, and the
# entry walk's rays and its node and world-box tests.
_TLAS_STATS = ("tlas_node_tests", "entry_rays", "entry_tests")


def _start_stats(stats, table, walk):
    keys = _STATS + (_MESH_STATS if walk is not None else ())
    if walk is not None and walk.tlas is not None:
        keys += _TLAS_STATS
    for key in keys:
        stats.setdefault(key, 0)
    # The scene's own pad slots (radius 0, always last) are not counted.
    stats["spheres"] = int((table.r2 > 0.0).sum())
    if walk is not None:
        stats["instances"] = walk.table.shape[0]
    return keys


def _trace_reference(
    table, walk, origins, directions, seed, max_bounces, chunk_rays, stats, lane=None
):
    seed_word = int(seed) & MASK32
    out = torch.empty_like(origins)
    if stats is not None:
        keys = _start_stats(stats, table, walk)
    if walk is not None:
        # Chunks of whole packets: each packet votes over its own lanes.
        chunk_rays = -(-chunk_rays // walk.block) * walk.block
    for start in range(0, origins.shape[0], chunk_rays):
        stop = min(start + chunk_rays, origins.shape[0])
        if lane is None:
            lanes = torch.arange(start, stop, dtype=torch.int64, device=origins.device)
        else:
            lanes = lane[start:stop].to(torch.int64)
        out[start:stop] = _reference_chunk(
            table, walk, origins[start:stop], directions[start:stop], lanes,
            seed_word, max_bounces, stats,
        )
    if stats is not None:
        for key in keys:
            stats[key] = int(stats[key])
    return out


def _reference_chunk(table, walk, o, d, lane, seed_word, max_bounces, stats):
    """The masked loop over a chunk of whole packets (the last one padded
    by the vote as the reference pads the launch); the packets vote at
    each bounce over their lanes' directions, dead lanes' kept ones
    included."""
    device = o.device
    rays = o.shape[0]
    throughput = torch.ones((rays, 3), dtype=torch.float32, device=device)
    radiance = torch.zeros((rays, 3), dtype=torch.float32, device=device)
    alive = torch.ones((rays, 1), dtype=torch.float32, device=device)
    for bounce in range(max_bounces):
        o, d, throughput, radiance, alive = _bounce(
            table, walk, o, d, throughput, radiance, alive, lane, bounce, max_bounces,
            seed_word, stats, None if walk is None else walk.order(d),
        )
    return radiance


def _bounce(table, walk, o, d, throughput, radiance, alive, lane, bounce, total_bounces,
            seed_word, stats, order=None, hit_out=None):
    """One bounce of the reference's masked loop over [n] rays: ``alive``
    is float [n, 1] (0 or 1), ``lane`` int64 [n] the RNG counters;
    ``bounce`` and ``seed_word`` (the uint32 seed in int64) are scalars or
    per-ray int64 [n] rows; ``order`` the rays' ``_Order`` (None: the
    canonical walk); ``hit_out`` (a list) receives each ray's winning
    instance row of the walk's table, -1 where no instance won.
    Returns (o, d, throughput, radiance, alive) after the bounce, radiance
    accumulated into the given one."""
    device = o.device
    c = table.centers
    radius = table.radius
    sun = table.sun_direction
    plane_normal = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32, device=device)

    # -- nearest sphere hit -------------------------------------------
    t_sphere, idx = _nearest_sphere(table, o, d)

    # -- ground plane y = 0 -------------------------------------------
    d_y = d[:, 1:2]
    o_y = o[:, 1:2]
    denom = torch.where(torch.abs(d_y) < 1e-8, 1e-8, d_y)
    t_plane = -o_y / denom
    t_plane = torch.where((t_plane > EPS) & (torch.abs(d_y) >= 1e-8), t_plane, INF)
    if walk is None:
        is_plane = (t_plane < t_sphere).to(torch.float32)
        t = torch.minimum(t_sphere, t_plane)
    else:
        # -- mesh instances, seeded with the sphere/plane hit; dead
        # lanes carry -INF and never walk --------------------------------
        t_sp = torch.minimum(t_sphere, t_plane)
        seed_t = torch.where(alive > 0.5, t_sp, -INF)[:, 0]
        t_mesh, mesh_normal, mesh_albedo = walk.nearest(o, d, seed_t, stats, order, hit_out)
        t_mesh = t_mesh[:, None]
        is_plane = ((t_plane < t_sphere) & (t_mesh >= t_sp)).to(torch.float32)
        is_mesh = t_mesh < t_sp
        t = torch.minimum(t_sp, t_mesh)
    hit = (t < INF).to(torch.float32)

    # -- sky on escape ------------------------------------------------
    blend = torch.clamp(d_y, 0.0, 1.0)
    sun_cos_dir = dot3(d, sun)[:, None]
    sun_disc = torch.where(sun_cos_dir > 0.9995, 8.0, 0.0)
    sky = fma(1.0 - blend, table.sky_horizon, blend * table.sky_zenith)
    sky = sky + sun_disc * table.sun_color
    radiance = radiance + throughput * sky * (alive * (1.0 - hit))

    if stats is not None:
        stats["alive_lane_bounces"] += alive.sum(dtype=torch.int64)
        stats["hit_lane_bounces"] += (alive * hit).sum(dtype=torch.int64)
    alive = alive * hit
    p = fma(d, t, o)

    c_hit = c[idx]
    r_hit = radius[idx][:, None]
    sphere_normal = (p - c_hit) / torch.clamp_min(r_hit, 1e-6)
    normal = is_plane * plane_normal + (1.0 - is_plane) * sphere_normal

    checker = torch.remainder(
        torch.floor(p[:, 0:1]).to(torch.int32) + torch.floor(p[:, 2:3]).to(torch.int32),
        2,
    )
    checker_rgb = torch.where(checker == 0, table.plane_albedo_a, table.plane_albedo_b)
    albedo = is_plane * checker_rgb + (1.0 - is_plane) * table.albedo[idx]
    emission = (1.0 - is_plane) * table.emission[idx]
    if walk is not None:
        # The reference's 0/1-weighted blends select exactly one term.
        normal = torch.where(is_mesh, mesh_normal, normal)
        albedo = torch.where(is_mesh, mesh_albedo, albedo)
        emission = torch.where(is_mesh, 0.0, emission)
    radiance = radiance + throughput * emission * alive

    # -- sun NEE: one any-hit shadow test ------------------------------
    shadow_o = fma(normal, EPS * 4.0, p)
    occluders = _sphere_occluders(table, shadow_o, table.dc_sun, dot3(shadow_o, sun)[:, None])
    shadowed = occluders.any(dim=1, keepdim=True).to(torch.float32)
    cos_sun = torch.clamp_min(dot3(normal, sun)[:, None], 0.0)
    if stats is not None:
        tested = (alive > 0.5) & (cos_sun > 0.0)
        first = _sphere_tests(occluders, stats["spheres"])[:, None]
        stats["shadow_sphere_tests"] += (first * tested).sum()
    if walk is not None:
        # Lanes whose result cannot matter (sphere-shadowed, dead, sun
        # below the surface) do not walk the mesh.
        blocked = (shadowed > 0.0) | (alive <= 0.5) | (cos_sun <= 0.0)
        shadowed = walk.occluded(
            shadow_o, blocked[:, 0], stats, order=order
        )[:, None].to(torch.float32)
    direct = albedo * table.sun_color * (cos_sun * (1.0 - shadowed) * alive) * INV_PI
    radiance = fma(throughput, direct, radiance)

    # -- continue the path: cosine-weighted resample ------------------
    throughput = throughput * (alive * albedo + (1.0 - alive))
    counter = (lane * (2 * total_bounces + 2) + 2 * bounce) & MASK32
    u1 = uniform_from_hash(pcg_hash(counter ^ seed_word))[:, None]
    u2 = uniform_from_hash(pcg_hash(((counter + 1) & MASK32) ^ seed_word))[:, None]
    r = fp32_sqrt(u1)
    phi = torch.tensor(2.0 * math.pi, dtype=torch.float32, device=device) * u2
    # cos and sin correctly rounded to float32 (through float64), as the
    # kernel computes them: the libraries' float32 versions differ in
    # the last bit for a few percent of angles.
    x = r * torch.cos(phi.double()).float()
    y = r * torch.sin(phi.double()).float()
    z = fp32_sqrt(torch.clamp_min(1.0 - u1, 0.0))
    nx, ny, nz = normal[:, 0:1], normal[:, 1:2], normal[:, 2:3]
    helper_x = torch.where(torch.abs(nx) > 0.9, 0.0, 1.0)
    helper_y = 1.0 - helper_x
    tangent = torch.cat([helper_y * nz, -helper_x * nz, helper_x * ny - helper_y * nx], dim=1)
    tangent = tangent / torch.clamp_min(fp32_sqrt(dot3(tangent, tangent))[:, None], 1e-8)
    tx, ty, tz = tangent[:, 0:1], tangent[:, 1:2], tangent[:, 2:3]
    bitangent = torch.cat(
        [fma(ny, tz, -(nz * ty)), fma(nz, tx, -(nx * tz)), fma(nx, ty, -(ny * tx))], dim=1
    )
    new_d = fma(z, normal, fma(x, tangent, y * bitangent))
    new_o = shadow_o
    # where-select (not multiply-mask): dead lanes keep their old
    # finite state, so no inf * 0 can poison later bounces.
    live = alive > 0.5
    o = torch.where(live, new_o, o)
    d = torch.where(live, new_d, d)
    return o, d, throughput, radiance, alive


def _sphere_dots(c: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """[R, N]: c . points of the centers ``c`` [N, 3] and ``points`` [R, 3],
    as dot3 sums it."""
    return fma(c[:, 2], points[:, 2:3], fma(c[:, 1], points[:, 1:2], c[:, 0] * points[:, 0:1]))


def _nearest_sphere(table: SphereTable, o: torch.Tensor, d: torch.Tensor):
    """The kernels' sphere pass for rays ``o``/``d`` [R, 3]: (t [R, 1],
    ``INF`` on a miss; index [R], the lowest sphere among ties, 0 on a
    miss). d . (c - o) is c.d - o.d and |o - c|^2 is |o|^2 - 2 o.c + |c|^2,
    the algebra of the reference's ``_nearest_hit_kernel``."""
    n = table.centers.shape[0]
    oc_dot_d = _sphere_dots(table.centers, d) - dot3(o, d)[:, None]
    oc_sq = dot3(o, o)[:, None] - 2.0 * _sphere_dots(table.centers, o) + table.csq
    disc = fma(oc_dot_d, oc_dot_d, -(oc_sq - table.r2))
    valid = (disc > 0.0) & (table.r2 > 0.0)
    sqrt_disc = fp32_sqrt(torch.clamp_min(disc, 0.0))
    t0 = oc_dot_d - sqrt_disc
    t1 = oc_dot_d + sqrt_disc
    t_all = torch.where(t0 > EPS, t0, torch.where(t1 > EPS, t1, INF))
    t_all = torch.where(valid, t_all, INF)
    t_sphere = t_all.min(dim=1, keepdim=True).values
    sphere_index = torch.arange(n, device=o.device)
    idx = torch.where(t_all == t_sphere, sphere_index, n).min(dim=1).values
    return t_sphere, torch.clamp_max(idx, n - 1)


def _sphere_occluders(table: SphereTable, so: torch.Tensor, dc: torch.Tensor, od: torch.Tensor):
    """[R, N]: whether sphere i has its far root past ``EPS`` ahead of the
    shadow origins ``so`` [R, 3] along a direction whose dots are ``dc``
    (with the centers; [N] for the sun, [R, N] per ray) and ``od`` [R, 1]
    (with ``so``)."""
    ocd_s = dc - od
    ocsq_s = dot3(so, so)[:, None] - 2.0 * _sphere_dots(table.centers, so) + table.csq
    disc_s = fma(ocd_s, ocd_s, -(ocsq_s - table.r2))
    valid_s = (disc_s > 0.0) & (table.r2 > 0.0)
    return valid_s & (ocd_s + fp32_sqrt(torch.clamp_min(disc_s, 0.0)) > EPS)


def _sphere_tests(occluders: torch.Tensor, spheres) -> torch.Tensor:
    """[R]: the spheres a shadow ray tests, stopping at its first occluder.
    Pad slots, which never occlude, come last: an unoccluded ray tests the
    ``spheres`` real ones."""
    return torch.where(occluders.any(dim=1), occluders.to(torch.int8).argmax(dim=1) + 1, spheres)


def _winv(v: torch.Tensor) -> torch.Tensor:
    """1 / v with |v| < 1e-12 pushed to +-1e-12 (sign of v; +0 -> +)."""
    small = torch.abs(v) < 1e-12
    return 1.0 / torch.where(small, torch.where(v < 0, -1e-12, 1e-12), v)


def _slab(lo, hi, o, inv, limit) -> torch.Tensor:
    """Per-ray AABB test: the box is entered before ``limit`` and not
    behind the origin. ``o`` [n, 3]; ``inv`` [n, 3] or [3]; ``limit`` [n]
    or a float."""
    t_lo = (lo - o) * inv
    t_hi = (hi - o) * inv
    near = torch.minimum(t_lo, t_hi)
    far = torch.maximum(t_lo, t_hi)
    tnear = torch.maximum(torch.maximum(near[:, 0], near[:, 1]), near[:, 2])
    tfar = torch.minimum(torch.minimum(far[:, 0], far[:, 1]), far[:, 2])
    return (tfar >= torch.clamp_min(tnear, 0.0)) & (tnear < limit)


def _sum3(a0, b0, a1, b1, a2, b2):
    """a0*b0 + a1*b1 + a2*b2 written out, as XLA rounds it:
    fma(a2, b2, fma(a0, b0, a1 * b1))."""
    return fma(a2, b2, fma(a0, b0, a1 * b1))


def _to_object(row: torch.Tensor, points: torch.Tensor, *, shift: bool) -> torch.Tensor:
    """x' = R^T (x - t) / s of [n, 3] points (``shift``) or directions,
    for one instance-table ``row``."""
    if shift:
        points = points - row[9:12]
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    return torch.stack(
        [_sum3(x, row[0 + j], y, row[3 + j], z, row[6 + j]) for j in range(3)], dim=1
    ) * row[12]


def _to_object_rows(rows: torch.Tensor, points: torch.Tensor, *, shift: bool) -> torch.Tensor:
    """``_to_object`` with one instance-table row a point: ``rows`` [n, 22],
    ``points`` [n, 3]."""
    if shift:
        points = points - rows[:, 9:12]
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    return torch.stack(
        [_sum3(x, rows[:, 0 + j], y, rows[:, 3 + j], z, rows[:, 6 + j]) for j in range(3)], dim=1
    ) * rows[:, 12:13]


def _children(skip: list[int], count: list[int]) -> list[list[int]]:
    """Each node's children in a threaded tree: an inner node's run from
    node + 1 to its skip link, hopping by skip links."""
    children: list[list[int]] = [[] for _ in skip]
    for node, node_skip in enumerate(skip):
        if count[node] == 0:
            child = node + 1
            while child < node_skip:
                children[node].append(child)
                child = skip[child]
    return children


def _sweep(bounds_min, bounds_max, count, children, o, inv, limit, on_leaf, stats, stat,
           positions=None, starts=(0,)):
    """Walk a threaded tree for every ray at once: the nodes in preorder,
    each with the rays that reach it. A ray reaches a node when it passed
    the slab test of the node's parent against its ``limit`` [n] at that
    moment (the caller's leaves update it in place, or set it to -INF to
    end a ray's walk), which is the order of one ray's own walk. ``o`` [n,
    3]; ``inv`` [n, 3] or [3]; ``on_leaf(node, positions)`` visits a leaf;
    ``stats[stat]`` counts the node tests. ``positions`` (default: every
    ray) are the rays that walk; they enter at the nodes ``starts``
    (default: the root)."""
    if positions is None:
        positions = torch.arange(o.shape[0], device=o.device)
    reach = {node: positions for node in starts}
    for node in range(min(starts), len(count)):
        pos = reach.pop(node, None)
        if pos is None or pos.numel() == 0:
            continue
        pos = pos[limit[pos] > -INF]  # drop rays whose walk has ended
        if stats is not None:
            stats[stat] += pos.numel()
        inv_pos = inv if inv.ndim == 1 else inv[pos]
        pos = pos[_slab(bounds_min[node], bounds_max[node], o[pos], inv_pos, limit[pos])]
        if count[node] > 0:
            if pos.numel():
                on_leaf(node, pos)
        else:
            for child in children[node]:
                reach[child] = pos


class _Tree(NamedTuple):
    """One node order of a threaded tree as the plain versions walk it:
    the node boxes on the device, the links on the host, and the nodes a
    walk enters at."""

    bounds_min: torch.Tensor  # [N, 3]
    bounds_max: torch.Tensor  # [N, 3]
    first: list[int]
    count: list[int]
    children: list[list[int]]
    starts: tuple[int, ...]

    @classmethod
    def build(cls, bounds_min, bounds_max, skip, first, count, below_root=False) -> "_Tree":
        """The tree of these tables; ``below_root`` enters a tree of more
        than one node at the root's children, without the root's test."""
        count = [int(c) for c in count]
        children = _children([int(s) for s in skip], count)
        return cls(
            bounds_min=bounds_min, bounds_max=bounds_max, first=[int(f) for f in first],
            count=count, children=children,
            starts=tuple(children[0]) if below_root and len(count) > 1 else (0,),
        )

    @classmethod
    def octants(cls, bounds_min, bounds_max, skip, first, count, below_root=False) -> tuple:
        """The eight octant-ordered trees of tables stacked [8N] (octant o
        at rows [o N, (o + 1) N), local skip links)."""
        n = len(skip) // 8
        return tuple(
            cls.build(bounds_min[o * n:(o + 1) * n], bounds_max[o * n:(o + 1) * n],
                      skip[o * n:(o + 1) * n], first[o * n:(o + 1) * n],
                      count[o * n:(o + 1) * n], below_root)
            for o in range(8)
        )

    def sweep(self, o, inv, limit, on_leaf, stats, stat, positions=None):
        _sweep(self.bounds_min, self.bounds_max, self.count, self.children, o, inv, limit,
               on_leaf, stats, stat, positions, self.starts)


def _walk_trees(trees, octant, o, inv, limit, on_leaves, stats, stat):
    """``_sweep`` each ray through its own order: ``trees[0]`` for every ray
    where ``octant`` is None, else ``trees[octant[i]]`` for ray i (``octant``
    [n] int64). ``on_leaves(node, [(tree, positions), ...])`` visits the
    leaves at node index ``node`` of the trees whose rays reached one. The
    trees are orders of one tree, so they hold as many nodes: the groups of
    rays of each octant are swept in step, node index by node index, one
    slab test and one visit of the leaves for all of them (each group meets
    its nodes in its own preorder, and no ray sees another's)."""
    values = [0] if octant is None else torch.unique(octant).tolist()
    if len(values) == 1:
        tree = trees[values[0]]
        tree.sweep(o, inv, limit, lambda node, pos: on_leaves(node, [(tree, pos)]), stats, stat)
        return
    groups = [trees[v] for v in values]
    bounds_min = torch.stack([tree.bounds_min for tree in groups])
    bounds_max = torch.stack([tree.bounds_max for tree in groups])
    reach = []
    for value, tree in zip(values, groups):
        pos = (octant == value).nonzero()[:, 0]
        reach.append({node: pos for node in tree.starts})
    for node in range(min(min(tree.starts) for tree in groups), len(groups[0].count)):
        parts = [(g, r.pop(node)) for g, r in enumerate(reach) if node in r]
        parts = [(g, pos) for g, pos in parts if pos.numel()]
        if not parts:
            continue
        # The groups' rays in group order: a filter keeps the order, so one
        # count per group splits them again.
        pos = torch.cat([p for _, p in parts])
        group = torch.cat([torch.full_like(p, g) for g, p in parts])
        alive = limit[pos] > -INF  # drop rays whose walk has ended
        pos, group = pos[alive], group[alive]
        if stats is not None:
            stats[stat] += pos.numel()
        inv_pos = inv if inv.ndim == 1 else inv[pos]
        hit = _slab(bounds_min[group, node], bounds_max[group, node], o[pos], inv_pos, limit[pos])
        pos, group = pos[hit], group[hit]
        sizes = torch.bincount(group, minlength=len(groups))[[g for g, _ in parts]].tolist()
        leaves = []
        for (g, _), mine in zip(parts, torch.split(pos, sizes)):
            tree = groups[g]
            if tree.count[node] > 0:
                if mine.numel():
                    leaves.append((tree, mine))
            else:
                for child in tree.children[node]:
                    reach[g][child] = mine
        if leaves:
            on_leaves(node, leaves)


def _leaf_rays(node, leaves):
    """(positions [n], first triangle row [n], real rows [n]) of the rays
    at the leaves ``leaves`` ([(tree, positions), ...], node index
    ``node``), or (positions, first, count) as ints for one leaf."""
    if len(leaves) == 1:
        tree, pos = leaves[0]
        return pos, tree.first[node], tree.count[node]
    pos = torch.cat([p for _, p in leaves])
    first = torch.cat([torch.full_like(p, tree.first[node]) for tree, p in leaves])
    count = torch.cat([torch.full_like(p, tree.count[node]) for tree, p in leaves])
    return pos, first, count


def octant_bits(v: torch.Tensor) -> torch.Tensor:
    """The octant of vectors ``v`` [..., 3] (int64): bit i set where
    component i is positive (0.0 and -0.0 give 0)."""
    positive = (v > 0).to(torch.int64)
    return positive[..., 0] | (positive[..., 1] << 1) | (positive[..., 2] << 2)


def _pad_directions(directions: torch.Tensor, block: int) -> torch.Tensor:
    """The directions padded to whole packets of ``block`` lanes with the
    reference's pad rays' direction (0, 1, 0) (``_pad_rays_to_miss``)."""
    pad = -directions.shape[0] % block
    if not pad:
        return directions
    pads = torch.zeros((pad, 3), dtype=directions.dtype, device=directions.device)
    pads[:, 1] = 1.0
    return torch.cat([directions, pads])


def _vote(padded: torch.Tensor, block: int) -> torch.Tensor:
    """[P] octants of packet-padded vectors [P block, 3]: bit i set when
    strictly more than half of a packet's lanes have component i > 0."""
    positive = (padded > 0).to(torch.int64).reshape(-1, block, 3).sum(dim=1)
    bits = (positive * 2 > block).to(torch.int64)
    return bits[:, 0] | (bits[:, 1] << 1) | (bits[:, 2] << 2)


def packet_octants(directions: torch.Tensor, block: int) -> torch.Tensor:
    """The reference's packet vote (``_octant_of``,
    ``pallas_kernels.py:2263-2275``) of world directions [R, 3]: [P] int64,
    P = ceil(R / block). A packet is ``block`` consecutive lanes in launch
    order, every lane counted (dead, parked or of another frame, each with
    the direction it carries; the last packet's missing lanes as the
    reference's pad rays, direction (0, 1, 0)); bit i of its octant is set
    when strictly more than half of them have a positive component i, so a
    tie, 0.0 and -0.0 give 0. The TLAS walks take the table of their
    packet's octant."""
    return _vote(_pad_directions(directions, block), block)


def packet_instance_octants(
    directions: torch.Tensor, table: torch.Tensor, block: int
) -> torch.Tensor:
    """The vote of each packet of world directions [R, 3] in the object
    space of each instance of ``table`` [K, 22] (``instance_table`` rows):
    [P, K] int64, the octant-ordered BLAS table of the nearest walk of the
    packet's rays through instance k (``blas_base``,
    ``pallas_kernels.py:2451-2455``). The directions, pad rays included,
    go to object space as the walk takes them (``_to_object``, the
    reference's fp32 FMA chain), so a component near 0 keeps its sign."""
    padded = _pad_directions(directions, block)
    if table.shape[0] == 0:
        return torch.zeros((padded.shape[0] // block, 0), dtype=torch.int64,
                           device=directions.device)
    return torch.stack([_vote(_to_object(row, padded, shift=False), block) for row in table],
                       dim=1)


class _Order(NamedTuple):
    """The octant-ordered walk of a launch's rays (the reference's default
    on a BVH with octant tables): each ray's packet, and per packet the
    octant of the nearest walk's BLAS table for each instance row of the
    walk's table and of its TLAS table. None: that level walks the
    canonical order; the shadow walks take the same level's order, with the
    sun's octant (one direction: a vote of one)."""

    packet: torch.Tensor  # [n] int64
    blas: torch.Tensor | None  # [P, K] int64
    tlas: torch.Tensor | None  # [P] int64

    def rows(self, rows) -> "_Order":
        return self._replace(packet=self.packet[rows])


class _TlasWalk(NamedTuple):
    """A frame's TLAS as the plain versions walk it: the node boxes on the
    device, the topology's links on the host; ``octants`` the eight
    near-first orders (``TlasTopology.octant_*``, the boxes gathered through
    ``octant_perm``)."""

    bounds_min: torch.Tensor  # [M, 3]
    bounds_max: torch.Tensor  # [M, 3]
    first: list[int]
    count: list[int]
    children: list[list[int]]
    octants: tuple[_Tree, ...] | None = None

    @classmethod
    def build(
        cls, node_bounds: torch.Tensor, topology: TlasTopology, ordered: bool = False
    ) -> "_TlasWalk":
        count = topology.count.tolist()
        octants = None
        if ordered:
            perm = torch.as_tensor(topology.octant_perm, dtype=torch.int64,
                                   device=node_bounds.device)
            octants = _Tree.octants(
                node_bounds[perm, 0:3], node_bounds[perm, 4:7], topology.octant_skip,
                topology.octant_first, topology.octant_count,
            )
        return cls(
            bounds_min=node_bounds[:, 0:3], bounds_max=node_bounds[:, 4:7],
            first=topology.first.tolist(), count=count,
            children=_children(topology.skip.tolist(), count), octants=octants,
        )

    def walk(self, o, inv, limit, visit, stats, stat="tlas_node_tests", octant=None,
             visit_rows=None):
        """``_sweep`` over the TLAS, ``visit(k, positions)`` for each slot
        of a leaf in order, with the rays that reached the leaf; ``octant``
        [n] (None: the canonical order) picks each ray's ordered table, and
        then ``visit_rows(slots, positions)`` takes the j-th slot of the
        leaves that the groups of rays reached at one step together (the
        slot of each ray), j in order."""

        def on_leaves(node, leaves):
            if octant is None:
                (tree, pos), = leaves
                for k in range(tree.first[node], tree.first[node] + tree.count[node]):
                    visit(k, pos)
                return
            for j in range(max(tree.count[node] for tree, _ in leaves)):
                held = [(tree, p) for tree, p in leaves if tree.count[node] > j]
                visit_rows(
                    torch.cat([torch.full_like(p, tree.first[node] + j) for tree, p in held]),
                    torch.cat([p for _, p in held]),
                )

        canonical = _Tree(self.bounds_min, self.bounds_max, self.first, self.count,
                          self.children, (0,))
        trees = (canonical,) if octant is None else self.octants
        _walk_trees(trees, octant, o, inv, limit, on_leaves, stats, stat)


def _dequantized_rows(table: QuantTable, quant: int) -> torch.Tensor:
    """A quantized table's boxes as the kernels reconstruct them, in the
    fp32 tables' layout [N, 8] (lo, 0, hi, 0)."""
    lo, hi = dequantize_node_bounds(table.words[:, :-1], table.grid, quant)
    zero = torch.zeros_like(lo[:, :1])
    return torch.cat([lo, zero, hi, zero], dim=1)


def _dequantized_bvh(bvh: MeshBVH, quant: int) -> MeshBVH:
    """A BVH whose node tables (canonical and octant) are those the kernels
    read at tier ``quant``: the reconstructed boxes, the unpacked links."""

    def tables(nodes, ordered):
        table = bvh_quant_table(bvh, quant, ordered)
        lo, hi = dequantize_node_bounds(table.words[:, :-1], table.grid, quant)
        skip, first, count = unpack_node_meta(table.words[:, -1], first_unit=LEAF_SIZE)
        return nodes._replace(bounds_min=lo, bounds_max=hi, skip=skip.to(torch.int32),
                              first=first.to(torch.int32), count=count.to(torch.int32))

    octant = None if bvh.octant is None else tables(bvh.octant, True)
    return tables(bvh, False)._replace(octant=octant)


# A BVH's dequantized tables, once per BVH and tier.
_dequantized_bvhs = {
    quant: _IdentityCache(functools.partial(_dequantized_bvh, quant=quant))
    for quant in QUANT_TIERS
}


class _MeshWalk(NamedTuple):
    """The plain version's mesh geometry: the device tables plus the
    tree's links on the host (canonical DFS preorder; ``octants`` the eight
    octant-ordered trees of a BVH that carries them, each entered below its
    root); for the TLAS variants the instances in slot order, the frame's
    TLAS and its key window."""

    table: torch.Tensor | None  # [K, 22] (instance_table); None: one BVH alone
    v0: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor
    normal: torch.Tensor
    bounds_min: torch.Tensor
    bounds_max: torch.Tensor
    first: list[int]
    count: list[int]
    children: list[list[int]]
    sun: torch.Tensor | None  # [3] world sun direction
    sun_object: torch.Tensor | None  # [K, 3]: the sun direction in object space
    tlas: _TlasWalk | None = None  # the TLAS variant's tree; None: the flat sweep
    key_window: torch.Tensor | None = None  # [6], with ``tlas``
    octants: tuple[_Tree, ...] | None = None
    packet: int = TLAS_BLOCK_R  # the TLAS variant's packet (``block``)

    @classmethod
    def build(
        cls, mesh: MeshSet, sun: torch.Tensor | None = None, use_tlas: bool = False,
        quant: int = 0, tlas_bounds: torch.Tensor | None = None,
    ) -> "_MeshWalk":
        """The walk of a frame's mesh; at node format ``quant`` (1 or 2) over
        the boxes the kernels reconstruct from the quantized tables and the
        links they unpack, the TLAS's from ``tlas_bounds`` [M, 8] where
        given (a pool window's frame), else the frame's own table."""
        tlas = key_window = octants = None
        bvh = _dequantized_bvhs[quant](mesh.bvh) if quant else mesh.bvh
        octant = bvh.octant
        if octant is not None:
            octants = _Tree.octants(
                octant.bounds_min, octant.bounds_max, octant.skip.tolist(),
                octant.first.tolist(), octant.count.tolist(), below_root=True,
            )
        if use_tlas:
            frame = tlas_frame(mesh)
            table, key_window = frame.slots, frame.key_window
            node_bounds = frame.node_bounds
            if quant:
                node_bounds = (_dequantized_rows(tlas_quant_table(mesh, quant, False), quant)
                               if tlas_bounds is None else tlas_bounds)
            tlas = _TlasWalk.build(
                node_bounds, cached_tlas_topology(table.shape[0], mesh_leaf(mesh)),
                ordered=octant is not None,
            )
        else:
            table = instance_table(mesh)
        return cls.for_bvh(bvh)._replace(
            table=table, sun=sun, tlas=tlas, key_window=key_window, octants=octants,
            sun_object=None if sun is None else torch.cat(
                [_to_object(row, sun[None, :], shift=False) for row in table]
            ),
        )

    @classmethod
    def for_bvh(cls, bvh: MeshBVH) -> "_MeshWalk":
        """The walk of one BVH in its canonical order, with no instance
        table."""
        count = bvh.count.tolist()
        return cls(
            table=None, v0=bvh.v0, e1=bvh.e1, e2=bvh.e2, normal=bvh.normal,
            bounds_min=bvh.bounds_min, bounds_max=bvh.bounds_max,
            first=bvh.first.tolist(), count=count, children=_children(bvh.skip.tolist(), count),
            sun=None, sun_object=None,
        )

    @property
    def block(self) -> int:
        """The reference kernel's packet: ``packet`` lanes under the TLAS,
        else ``BVH_BLOCK_R``."""
        return self.packet if self.tlas is not None else BVH_BLOCK_R

    def order(self, directions: torch.Tensor) -> "_Order | None":
        """The octant order of a launch of rays along ``directions`` [R, 3]
        (their packets in launch order, ``block`` lanes each), None on a
        BVH without octant tables (the canonical walk); the pool's orders
        are ``_pool_orders``."""
        if self.octants is None:
            return None
        block = self.block
        packet = torch.arange(directions.shape[0], device=directions.device) // block
        blas = None
        if len(self.count) > 1:  # a one-node tree reads the same row in every octant
            blas = packet_instance_octants(directions, self.table, block)
        return _Order(
            packet=packet, blas=blas,
            tlas=packet_octants(directions, block) if self.tlas is not None else None,
        )

    def _trees(self, octant) -> tuple:
        if octant is None:
            return (_Tree(self.bounds_min, self.bounds_max, self.first, self.count,
                          self.children, (0,)),)
        return self.octants

    def _walk(self, o, inv, best_t, on_leaf, stats):
        """``_sweep`` over the BVH in its canonical order: ``o`` [n, 3] and
        ``inv`` [n, 3] or [3] in object space, ``best_t`` [n] the rays'
        limits, ``on_leaf(node, positions)``."""
        _walk_trees(self._trees(None), None, o, inv, best_t,
                    lambda node, leaves: on_leaf(node, leaves[0][1]), stats, "node_tests")

    def _leaf(self, node, o, d):
        """``_leaf_rows`` of a leaf of the canonical order."""
        return self._leaf_rows(self.first[node], self.count[node], o, d)

    def _leaf_rows(self, first, count, o, d):
        """Moller-Trumbore of ``o``/``d`` [n, 3] against the leaf's real
        rows [first, first + count): (hit [n, L], t [n, L]), rounded as XLA
        rounds the reference's expressions. ``first`` and ``count`` may be
        per-ray [n] rows (rays at several leaves): then L is a leaf slot's
        LEAF_SIZE rows, those past a ray's count missed."""
        if isinstance(first, torch.Tensor):
            lanes = torch.arange(LEAF_SIZE, device=o.device)
            rows = first[:, None] + lanes
            v0, e1, e2 = self.v0[rows], self.e1[rows], self.e2[rows]
            hit, t = self._moller_trumbore(o, d, v0, e1, e2)
            return hit & (lanes < count[:, None]), t
        rows = slice(first, first + count)
        return self._moller_trumbore(o, d, self.v0[rows], self.e1[rows], self.e2[rows])

    def _moller_trumbore(self, o, d, v0, e1, e2):
        """Moller-Trumbore of ``o``/``d`` [n, 3] against triangle rows
        ``v0``, ``e1``, ``e2`` ([L, 3], or per ray [n, L, 3])."""
        ox, oy, oz = (o[:, i:i + 1] for i in range(3))
        dx, dy, dz = (d[..., i:i + 1] for i in range(3))
        v0x, v0y, v0z = (v0[..., i] for i in range(3))
        e1x, e1y, e1z = (e1[..., i] for i in range(3))
        e2x, e2y, e2z = (e2[..., i] for i in range(3))
        pvx = fma(dy, e2z, -(dz * e2y))
        pvy = fma(dz, e2x, -(dx * e2z))
        pvz = fma(dx, e2y, -(dy * e2x))
        det = _sum3(e1x, pvx, e1y, pvy, e1z, pvz)
        inv_det = 1.0 / torch.where(torch.abs(det) < _DET_EPS, _DET_EPS, det)
        tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
        u = _sum3(tvx, pvx, tvy, pvy, tvz, pvz) * inv_det
        qvx = fma(tvy, e1z, -(tvz * e1y))
        qvy = fma(tvz, e1x, -(tvx * e1z))
        qvz = fma(tvx, e1y, -(tvy * e1x))
        v = _sum3(dx, qvx, dy, qvy, dz, qvz) * inv_det
        t = _sum3(e2x, qvx, e2y, qvy, e2z, qvz) * inv_det
        hit = (torch.abs(det) > _DET_EPS) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > EPS)
        return hit, t

    def blas_nearest(self, o, d, seed_t, stats, octant=None):
        """Nearest hit in the BVH of object-space rays ``o``/``d`` [n, 3],
        seeded with ``seed_t`` [n] (strict < updates, the first row of a
        leaf reaching the minimum): (t [n] (== seed_t on a miss), the
        winning triangle row [n] int64 (0 on a miss)). ``octant`` [n]: each
        ray's octant-ordered tree (None: the canonical order)."""
        best_t = seed_t.clone()
        best_row = torch.zeros(o.shape[0], dtype=torch.int64, device=o.device)

        def on_leaves(node, leaves):
            pos, first, count = _leaf_rays(node, leaves)
            hit, t = self._leaf_rows(first, count, o[pos], d[pos])
            if stats is not None:
                stats["triangle_tests"] += (
                    count.sum() if isinstance(count, torch.Tensor) else hit.numel()
                )
            t = torch.where(hit, t, INF)
            t_leaf = t.min(dim=1).values
            rows = torch.arange(t.shape[1], device=t.device)
            local = torch.where(t == t_leaf[:, None], rows, t.shape[1]).min(dim=1).values
            closer = t_leaf < best_t[pos]
            best_t[pos[closer]] = t_leaf[closer]
            row = first[closer] if isinstance(first, torch.Tensor) else first
            best_row[pos[closer]] = row + local[closer]

        _walk_trees(self._trees(octant), octant, o, _winv(d), best_t, on_leaves, stats,
                    "node_tests")
        return best_t, best_row

    def blas_occluded(self, o, d, stats, octant=None):
        """Whether each object-space ray ``o`` [n, 3] along ``d`` ([n, 3],
        or one direction [3]) has a triangle of the BVH ahead of it (t >
        EPS, unbounded): bool [n]. A ray stops at its first occluder.
        ``octant`` (an int, or [n]): the octant-ordered tree (None: the
        canonical order)."""
        limit = torch.full((o.shape[0],), INF, device=o.device)

        def on_leaves(node, leaves):
            pos, first, count = _leaf_rays(node, leaves)
            hit, _ = self._leaf_rows(first, count, o[pos], d if d.ndim == 1 else d[pos])
            any_hit = hit.any(dim=1)
            if stats is not None:
                tested = torch.where(any_hit, hit.to(torch.int8).argmax(dim=1) + 1, count)
                stats["triangle_tests"] += tested.sum()
            limit[pos[any_hit]] = -INF  # found: this ray's walk ends

        if isinstance(octant, int):
            octant = torch.full((o.shape[0],), octant, dtype=torch.int64, device=o.device)
        _walk_trees(self._trees(octant), octant, o, _winv(d), limit, on_leaves, stats,
                    "node_tests")
        return limit == -INF

    def nearest_rows(self, o, d, seed_t, stats, order=None):
        """Nearest mesh hit over all instances for world rays ``o``/``d``
        [R, 3], seeded with ``seed_t`` [R]: (t [R] (== seed_t on a miss),
        the winning instance [R] int64 (-1 on a miss), the winning triangle
        row [R] int64 (0 on a miss)). ``order`` (``_Order`` of these rays;
        None: canonical) picks each ray's BLAS and TLAS tables."""
        rays = o.shape[0]
        best_t = seed_t.clone()
        win_k = torch.full((rays,), -1, dtype=torch.int64, device=o.device)
        win_row = torch.zeros((rays,), dtype=torch.int64, device=o.device)
        inv = _winv(d)
        blas = None if order is None else order.blas
        if stats is not None:
            stats["broadphase_rays"] += (seed_t > -INF).sum()

        def enter(k, idx):
            """Instance k's BVH for the rays ``idx`` that passed its box."""
            if stats is not None:
                stats["instance_walks"] += idx.numel()
            row = self.table[k]
            lo = _to_object(row, o[idx], shift=True)
            ld = _to_object(row, d[idx], shift=False)
            octant = None if blas is None else blas[order.packet[idx], k]
            t_k, row_k = self.blas_nearest(lo, ld, best_t[idx], stats, octant)
            closer = t_k < best_t[idx]
            won = idx[closer]
            best_t[won] = t_k[closer]
            win_k[won] = k
            win_row[won] = row_k[closer]

        def enter_rows(slots, idx):
            """The instances ``slots`` [n] of the rays ``idx`` that passed
            their boxes (an ordered TLAS walk's step: one slot a ray)."""
            if stats is not None:
                stats["instance_walks"] += idx.numel()
            rows = self.table[slots]
            lo = _to_object_rows(rows, o[idx], shift=True)
            ld = _to_object_rows(rows, d[idx], shift=False)
            octant = None if blas is None else blas[order.packet[idx], slots]
            t_k, row_k = self.blas_nearest(lo, ld, best_t[idx], stats, octant)
            closer = t_k < best_t[idx]
            won = idx[closer]
            best_t[won] = t_k[closer]
            win_k[won] = slots[closer]
            win_row[won] = row_k[closer]

        if self.tlas is not None:
            def visit(k, pos):
                row = self.table[k]
                if stats is not None:
                    stats["world_aabb_tests"] += pos.numel()
                idx = pos[_slab(row[13:16], row[16:19], o[pos], inv[pos], best_t[pos])]
                if idx.numel():
                    enter(k, idx)

            def visit_rows(slots, pos):
                rows = self.table[slots]
                if stats is not None:
                    stats["world_aabb_tests"] += pos.numel()
                hit = _slab(rows[:, 13:16], rows[:, 16:19], o[pos], inv[pos], best_t[pos])
                if bool(hit.any()):
                    enter_rows(slots[hit], pos[hit])

            tlas_octant = None
            if order is not None and order.tlas is not None:
                tlas_octant = order.tlas[order.packet]
            self.tlas.walk(o, inv, best_t, visit, stats, octant=tlas_octant,
                           visit_rows=visit_rows)
            return best_t, win_k, win_row
        for k in range(self.table.shape[0]):
            row = self.table[k]
            if stats is not None:
                stats["world_aabb_tests"] += (seed_t > -INF).sum()
            idx = _slab(row[13:16], row[16:19], o, inv, best_t).nonzero()[:, 0]
            if idx.numel():
                enter(k, idx)
        return best_t, win_k, win_row

    def nearest(self, o, d, seed_t, stats, order=None, hit_out=None):
        """``nearest_rows``' hit as (t [R] (== seed_t on a miss), world
        normal facing the ray [R, 3], albedo [R, 3]); ``hit_out`` (a list)
        receives the winning instance [R] (-1 on a miss)."""
        best_t, win_k, win_row = self.nearest_rows(o, d, seed_t, stats, order)
        if hit_out is not None:
            hit_out.append(win_k)
        hit = win_k >= 0
        k_hit = win_k.clamp_min(0)
        rot = self.table[k_hit, 0:9]
        n_obj = self.normal[win_row]
        world = torch.stack(
            [_sum3(rot[:, 3 * i], n_obj[:, 0], rot[:, 3 * i + 1], n_obj[:, 1],
                   rot[:, 3 * i + 2], n_obj[:, 2]) for i in range(3)],
            dim=1,
        )
        world = torch.where(hit[:, None], world, 0.0)
        albedo = torch.where(hit[:, None], self.table[k_hit, 19:22], 0.0)
        facing = _sum3(world[:, 0], d[:, 0], world[:, 1], d[:, 1], world[:, 2], d[:, 2]) < 0.0
        world = world * torch.where(facing, 1.0, -1.0)[:, None]
        return best_t, world, albedo

    def occluded(self, so, blocked, stats, directions=None, order=None):
        """Any-hit from the origins ``so`` [R, 3] toward the sun or, given,
        along the rays' own ``directions`` [R, 3]; ``blocked`` [R] lanes
        come back True without walking. A ray stops at its first
        occluder. ``order``: the launch's ``_Order`` (None: canonical); the
        sun's walks take its octant at each level the order orders."""
        occluded = blocked.clone()
        world_inv = _winv(self.sun if directions is None else directions)
        ordered_blas = order is not None and order.blas is not None
        if stats is not None:
            stats["broadphase_rays"] += (~blocked).sum()

        def visit(k, idx):
            """Instance k for the unoccluded rays among ``idx``."""
            idx = idx[~occluded[idx]]
            if idx.numel() == 0:
                return
            if stats is not None:
                stats["world_aabb_tests"] += idx.numel()
            row = self.table[k]
            inv = world_inv if directions is None else world_inv[idx]
            idx = idx[_slab(row[13:16], row[16:19], so[idx], inv, INF)]
            if idx.numel() == 0:
                return
            if stats is not None:
                stats["instance_walks"] += idx.numel()
            lo = _to_object(row, so[idx], shift=True)
            if directions is None:
                ld = self.sun_object[k]
            else:
                ld = _to_object(row, directions[idx], shift=False)
            octant = int(octant_bits(ld)) if ordered_blas else None
            occluded[idx[self.blas_occluded(lo, ld, stats, octant)]] = True

        def visit_rows(slots, idx):
            """The instances ``slots`` [n] for the unoccluded rays among
            ``idx`` (an ordered TLAS walk's step: one slot a ray; the sun's
            walk)."""
            keep = ~occluded[idx]
            slots, idx = slots[keep], idx[keep]
            if idx.numel() == 0:
                return
            if stats is not None:
                stats["world_aabb_tests"] += idx.numel()
            rows = self.table[slots]
            hit = _slab(rows[:, 13:16], rows[:, 16:19], so[idx], world_inv, INF)
            slots, idx, rows = slots[hit], idx[hit], rows[hit]
            if idx.numel() == 0:
                return
            if stats is not None:
                stats["instance_walks"] += idx.numel()
            lo = _to_object_rows(rows, so[idx], shift=True)
            ld = self.sun_object[slots]
            octant = octant_bits(ld) if ordered_blas else None
            occluded[idx[self.blas_occluded(lo, ld, stats, octant)]] = True

        if self.tlas is not None:
            # A ray's walk ends at its first occluder: its limit turns -INF.
            limit = torch.full((so.shape[0],), INF, device=so.device)

            def visit_leaf_slot(k, pos):
                visit(k, pos)
                limit[pos[occluded[pos]]] = -INF

            def visit_leaf_rows(slots, pos):
                visit_rows(slots, pos)
                limit[pos[occluded[pos]]] = -INF

            limit[occluded] = -INF
            tlas_octant = None
            if order is not None and order.tlas is not None:
                tlas_octant = torch.full((so.shape[0],), int(octant_bits(self.sun)),
                                         dtype=torch.int64, device=so.device)
            self.tlas.walk(so, world_inv, limit, visit_leaf_slot, stats, octant=tlas_octant,
                           visit_rows=visit_leaf_rows)
            return occluded
        everyone = torch.arange(so.shape[0], device=so.device)
        for k in range(self.table.shape[0]):
            if bool(occluded.all()):
                break
            visit(k, everyone)
        return occluded

    def entry_candidates(self, o, d, stats, octant=None):
        """The TLAS variants' entry walk for rays ``o``/``d`` [n, 3]: the
        slot whose world box each ray enters first (strict ``<``, the
        lowest slot among ties), K where it overlaps none; [n] int64. The
        tree is walked against the best entry so far, the leaves' world
        boxes tested alone (no BVH). ``octant`` [n]: each ray's ordered
        TLAS table (None: canonical)."""
        n = o.shape[0]
        best_e = torch.full((n,), INF, device=o.device)
        best = torch.full((n,), self.table.shape[0], dtype=torch.int64, device=o.device)
        inv = _winv(d)
        if stats is not None:
            stats["entry_rays"] += n

        def visit(k, pos):
            """Slot k (or one slot a ray, [n]) for the rays ``pos``."""
            row = self.table[k]
            if stats is not None:
                stats["entry_tests"] += pos.numel()
            t_lo = (row[..., 13:16] - o[pos]) * inv[pos]
            t_hi = (row[..., 16:19] - o[pos]) * inv[pos]
            near = torch.minimum(t_lo, t_hi)
            far = torch.maximum(t_lo, t_hi)
            near = torch.maximum(torch.maximum(near[:, 0], near[:, 1]), near[:, 2])
            far = torch.minimum(torch.minimum(far[:, 0], far[:, 1]), far[:, 2])
            entry = torch.clamp_min(near, 0.0)
            entry = torch.where(far >= entry, entry, INF)
            better = entry < best_e[pos]
            best_e[pos[better]] = entry[better]
            best[pos[better]] = k if isinstance(k, int) else k[better]

        def visit_rows(slots, pos):
            visit(slots, pos)

        self.tlas.walk(o, inv, best_e, visit, stats, "entry_tests", octant=octant,
                       visit_rows=visit_rows)
        return best
