"""Triangle meshes with a threaded BVH, and their rigid instances.

Port of the host side of ``tpu_render_cluster/render/mesh.py``: the box and
icosphere generators, the BLAS build (median or binned-SAH splits, the wide
collapse, threaded skip links and the eight octant re-threadings), the
per-process build memo, and the instance transforms a mesh scene animates.
The build is numpy, arithmetic for arithmetic the reference's, so its
tables equal the reference's array for array; the result lands as torch
tensors on the render device.

Layout (the traversal contract every kernel reads):

- triangles are stored leaf-contiguous in ``LEAF_SIZE``-row slots, real
  triangles first, degenerate all-zero rows after;
- nodes are in DFS preorder; ``skip[i]`` is the next node outside node
  ``i``'s subtree, so a walk is one moving index: slab hit on an inner node
  -> ``i + 1``, leaf or miss -> ``skip[i]``;
- ``first`` / ``count`` give a leaf's slot and its real triangle count
  (0 for inner nodes).

It also holds the scan renderer's ray queries against every instance,
``intersect_instances`` and ``occluded_instances``: by default each one
launch of an instanced unit kernel of ``render/kernels.py`` (the reference's
kernel branches); with ``per_instance=True`` the reference's scan over the
instances (its branch with Pallas off), each instance's rays pulled into
object space (``_rays_to_object_space``) and walked through the one BVH by
``intersect_mesh`` / ``occluded_mesh``, one unit-kernel launch per instance.
``intersect_triangles_brute`` tests every triangle: the tests' oracle.

The two-level hierarchy over the instances (TLAS, ``mesh.py:912-1222`` of
the reference): ``build_tlas_topology`` threads a static median-split tree
over instance slots, memoized per (instance count, leaf size) by
``cached_tlas_topology``; per frame, ``instance_morton_order`` assigns the
instances to slots by the Morton code of their world-box centers and
``tlas_node_bounds`` unions the slot-ordered boxes into node boxes. A
``MeshSet`` from ``scene_mesh_set`` carries its frame's ``TlasFrame``,
computed on the host with the instances and copied with them.

The quantized node tables of the reference's ``TRC_BVH_QUANT`` tiers
(``mesh.py:1074-1187`` of the reference): ``quantize_node_tables`` packs a
threaded node table into fixed-point slabs against its own union box,
rounded outward so that a reconstructed box (``dequantize_node_bounds``:
``origin + q * cell`` in float32, the kernels' arithmetic) contains the
fp32 one, and folds skip, first and count into one meta word
(``unpack_node_meta``). ``bvh_builder`` and ``bvh_wide`` read the build
tiers ``TRC_BVH_BUILDER`` and ``TRC_BVH_WIDE``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpu_render_cluster_torch.render.fp32 import fma
from tpu_render_cluster_torch.utils.env import env_int, env_str

LEAF_SIZE = 16
SAH_BINS = 16
_F32 = torch.float32


class OctantTables(NamedTuple):
    """The same tree re-threaded eight times ([8N] rows, octant ``o`` at
    rows ``[o*N, (o+1)*N)``), children ordered near-first along each
    octant's sign vector. Skip links are local (0..N); leaf slots are
    shared with the canonical order."""

    bounds_min: torch.Tensor  # [8N, 3]
    bounds_max: torch.Tensor  # [8N, 3]
    skip: torch.Tensor  # [8N] int32
    first: torch.Tensor  # [8N] int32
    count: torch.Tensor  # [8N] int32


class MeshBVH(NamedTuple):
    """Object-space triangle mesh + threaded BVH (``octant`` is None on
    median builds)."""

    v0: torch.Tensor  # [T, 3]
    e1: torch.Tensor  # [T, 3]  (v1 - v0)
    e2: torch.Tensor  # [T, 3]  (v2 - v0)
    normal: torch.Tensor  # [T, 3] unit geometric normals
    bounds_min: torch.Tensor  # [N, 3]
    bounds_max: torch.Tensor  # [N, 3]
    skip: torch.Tensor  # [N] int32
    first: torch.Tensor  # [N] int32
    count: torch.Tensor  # [N] int32
    octant: OctantTables | None = None


class MeshInstances(NamedTuple):
    """K similarity-transformed instances of one object-space mesh:
    ``x_world = scale * rotation @ x_obj + translation``."""

    rotation: torch.Tensor  # [K, 3, 3]
    translation: torch.Tensor  # [K, 3]
    albedo: torch.Tensor  # [K, 3]
    scale: torch.Tensor  # [K]


class TlasFrame(NamedTuple):
    """A frame's two-level-walk operands in the kernels' layout, float32
    (``kernels.tlas_frame_on_host``)."""

    slots: torch.Tensor  # [K, 22]: kernels.instance_table's rows in Morton slot order
    node_bounds: torch.Tensor  # [M, 8]: each TLAS node's lo, 0, hi, 0
    key_window: torch.Tensor  # [6]: the coherence key's window, lo then 1 / span
    # [8M, 8]: node_bounds gathered through TlasTopology.octant_perm, the
    # rows of the eight octant orders that the ordered walk takes
    octant_node_bounds: torch.Tensor | None = None
    # [6] on the host: the nodes' union box (lo, hi), whose grid the
    # quantized tables are cut against (kernels.tlas_quant_table)
    union: torch.Tensor | None = None


class MeshSet(NamedTuple):
    """A mesh-backed scene's geometry: one shared BVH + its instances, and
    (``scene_mesh_set``) the frame's TLAS operands, computed on the host
    and copied to the device with the instances; None: derived at first
    use (``kernels.tlas_frame``)."""

    bvh: MeshBVH
    instances: MeshInstances
    tlas: TlasFrame | None = None


# ---------------------------------------------------------------------------
# Procedural meshes


def make_box() -> tuple[np.ndarray, np.ndarray]:
    """Unit cube centered at the origin: 8 vertices, 12 triangles."""
    vertices = np.array(
        [
            [-0.5, -0.5, -0.5], [0.5, -0.5, -0.5],
            [0.5, 0.5, -0.5], [-0.5, 0.5, -0.5],
            [-0.5, -0.5, 0.5], [0.5, -0.5, 0.5],
            [0.5, 0.5, 0.5], [-0.5, 0.5, 0.5],
        ],
        np.float32,
    )
    faces = np.array(
        [
            [0, 2, 1], [0, 3, 2],  # -z
            [4, 5, 6], [4, 6, 7],  # +z
            [0, 1, 5], [0, 5, 4],  # -y
            [3, 6, 2], [3, 7, 6],  # +y
            [0, 7, 3], [0, 4, 7],  # -x
            [1, 2, 6], [1, 6, 5],  # +x
        ],
        np.int32,
    )
    return vertices, faces


def make_icosphere(subdivisions: int = 2) -> tuple[np.ndarray, np.ndarray]:
    """Unit icosphere (radius 0.5) via icosahedron midpoint subdivision."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    raw = np.array(
        [
            [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
            [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
            [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
        ],
        np.float32,
    )
    vertices = raw / np.linalg.norm(raw, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int32,
    )
    for _ in range(subdivisions):
        midpoint_cache: dict[tuple[int, int], int] = {}
        vertex_list = list(vertices)
        new_faces = []

        def midpoint(a: int, b: int) -> int:
            key = (min(a, b), max(a, b))
            if key not in midpoint_cache:
                m = vertex_list[a] + vertex_list[b]
                m = m / np.linalg.norm(m)
                midpoint_cache[key] = len(vertex_list)
                vertex_list.append(m.astype(np.float32))
            return midpoint_cache[key]

        for f in faces:
            a, b, c = int(f[0]), int(f[1]), int(f[2])
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        vertices = np.stack(vertex_list)
        faces = np.array(new_faces, np.int32)
    return (vertices * 0.5).astype(np.float32), faces


# ---------------------------------------------------------------------------
# Host-side BVH build (numpy, once per mesh)


def _half_area(lo: np.ndarray, hi: np.ndarray) -> float:
    """Half surface area of an AABB: the SAH's relative cost weight."""
    e = np.maximum(hi - lo, 0.0)
    return float(e[0] * e[1] + e[1] * e[2] + e[2] * e[0])


def _sah_partition(
    tri: np.ndarray, centroids: np.ndarray, indices: np.ndarray
) -> tuple[np.ndarray, np.ndarray] | None:
    """Binned-SAH split of ``indices``: minimize area_L*n_L + area_R*n_R
    over SAH_BINS centroid bins on each axis. None when no axis admits a
    non-degenerate split (the caller then splits at the median)."""
    c = centroids[indices]
    pts = tri[indices]
    best = None  # (cost, axis, threshold bin, bin ids)
    for axis in range(3):
        lo = float(c[:, axis].min())
        hi = float(c[:, axis].max())
        if hi - lo < 1e-12:
            continue
        bins = np.clip(
            ((c[:, axis] - lo) / (hi - lo) * SAH_BINS).astype(np.int64),
            0, SAH_BINS - 1,
        )
        counts = np.bincount(bins, minlength=SAH_BINS)
        bin_lo = np.full((SAH_BINS, 3), np.inf)
        bin_hi = np.full((SAH_BINS, 3), -np.inf)
        for b in range(SAH_BINS):
            member = bins == b
            if member.any():
                p = pts[member].reshape(-1, 3)
                bin_lo[b] = p.min(axis=0)
                bin_hi[b] = p.max(axis=0)
        # Prefix/suffix sweep: split "after bin b" for b in [0, SAH_BINS-2].
        lo_acc, hi_acc = np.full(3, np.inf), np.full(3, -np.inf)
        left_area = np.zeros(SAH_BINS)
        left_count = np.cumsum(counts)
        for b in range(SAH_BINS):
            lo_acc = np.minimum(lo_acc, bin_lo[b])
            hi_acc = np.maximum(hi_acc, bin_hi[b])
            left_area[b] = _half_area(lo_acc, hi_acc)
        lo_acc, hi_acc = np.full(3, np.inf), np.full(3, -np.inf)
        right_area = np.zeros(SAH_BINS)
        for b in range(SAH_BINS - 1, 0, -1):
            lo_acc = np.minimum(lo_acc, bin_lo[b])
            hi_acc = np.maximum(hi_acc, bin_hi[b])
            right_area[b - 1] = _half_area(lo_acc, hi_acc)
        right_count = left_count[-1] - left_count
        for b in range(SAH_BINS - 1):
            if left_count[b] == 0 or right_count[b] == 0:
                continue
            cost = left_area[b] * left_count[b] + right_area[b] * right_count[b]
            if best is None or cost < best[0]:
                best = (cost, axis, b, bins)
    if best is None:
        return None
    _, axis, threshold, bins = best
    return indices[bins <= threshold], indices[bins > threshold]


def build_bvh(
    vertices: np.ndarray,
    faces: np.ndarray,
    builder: str = "sah",
    wide: int = 4,
    device: str | torch.device = "cpu",
) -> MeshBVH:
    """Host-side BLAS build, threaded for stackless traversal.

    ``builder`` is ``median`` (spatial median over centroids) or ``sah``
    (binned surface-area heuristic; also emits the octant tables).
    ``wide`` > 1 collapses the binary tree into an N-ary one by pulling
    grandchildren up, largest-area inner child first. Both change only the
    arrays' contents, never the traversal contract.
    """
    wide = max(1, min(int(wide), 8))
    if builder not in ("median", "sah"):
        raise ValueError(f"Unknown BVH builder: {builder!r}")
    tri = vertices[faces]  # [T, 3, 3]
    centroids = tri.mean(axis=1)
    nodes: list[dict] = []

    def emit(indices: np.ndarray) -> int:
        node_index = len(nodes)
        pts = tri[indices].reshape(-1, 3)
        node = {"min": pts.min(axis=0), "max": pts.max(axis=0),
                "first": -1, "count": 0, "children": None}
        nodes.append(node)
        if len(indices) <= LEAF_SIZE:
            node["first"] = indices  # flattened below
            node["count"] = len(indices)
            return node_index
        part = _sah_partition(tri, centroids, indices) if builder == "sah" else None
        if part is None:
            extent = centroids[indices].max(axis=0) - centroids[indices].min(axis=0)
            axis = int(np.argmax(extent))
            mid = len(indices) // 2
            ordered = indices[np.argsort(centroids[indices, axis], kind="stable")]
            part = (ordered[:mid], ordered[mid:])
        left = emit(part[0])
        right = emit(part[1])
        node["children"] = [left, right]
        return node_index

    emit(np.arange(len(faces)))

    if wide > 1:
        def widen(i: int) -> None:
            node = nodes[i]
            if node["children"] is None:
                return
            children = list(node["children"])
            while len(children) < wide:
                inner = [c for c in children if nodes[c]["children"] is not None]
                if not inner:
                    break
                pick = max(inner, key=lambda c: _half_area(nodes[c]["min"], nodes[c]["max"]))
                at = children.index(pick)
                children[at:at + 1] = nodes[pick]["children"]
            node["children"] = children
            for c in children:
                widen(c)

        widen(0)
        remap: list[dict] = []

        def reindex(i: int) -> int:  # DFS preorder of the reachable nodes
            node = nodes[i]
            new_index = len(remap)
            remap.append(node)
            if node["children"] is not None:
                node["children"] = [reindex(c) for c in node["children"]]
            return new_index

        reindex(0)
        nodes = remap

    # Leaves into aligned LEAF_SIZE-row slots (-1 = degenerate pad row).
    tri_order: list[int] = []
    first = np.zeros(len(nodes), np.int32)
    count = np.zeros(len(nodes), np.int32)
    for i, node in enumerate(nodes):
        if node["children"] is None:
            first[i] = len(tri_order)
            count[i] = node["count"]
            members = [int(t) for t in node["first"]]
            tri_order.extend(members + [-1] * (LEAF_SIZE - len(members)))

    subtree = np.ones(len(nodes), np.int32)

    def size(i: int) -> int:
        node = nodes[i]
        if node["children"] is not None:
            subtree[i] = 1 + sum(size(c) for c in node["children"])
        return subtree[i]

    size(0)
    skip = np.array([i + subtree[i] for i in range(len(nodes))], np.int32)

    octant = None
    if builder == "sah":
        centers = [0.5 * (nd["min"] + nd["max"]) for nd in nodes]
        ob_min, ob_max, o_skip, o_first, o_count = [], [], [], [], []
        for code in range(8):
            sgn = np.array([1.0 if code & (1 << a) else -1.0 for a in range(3)])
            order: list[int] = []

            def emit_octant(i: int) -> None:
                order.append(i)
                children = nodes[i]["children"]
                if children is None:
                    return
                for c in sorted(children, key=lambda c: float(centers[c] @ sgn)):
                    emit_octant(c)

            emit_octant(0)
            ob_min.append(np.stack([nodes[i]["min"] for i in order]))
            ob_max.append(np.stack([nodes[i]["max"] for i in order]))
            o_skip.append(np.array([p + subtree[i] for p, i in enumerate(order)], np.int32))
            o_first.append(first[order])
            o_count.append(count[order])
        octant = OctantTables(
            bounds_min=_tensor(np.concatenate(ob_min).astype(np.float32), device),
            bounds_max=_tensor(np.concatenate(ob_max).astype(np.float32), device),
            skip=_tensor(np.concatenate(o_skip), device),
            first=_tensor(np.concatenate(o_first), device),
            count=_tensor(np.concatenate(o_count), device),
        )

    order_array = np.array(tri_order, np.int64)
    real = order_array >= 0
    reordered = np.zeros((len(order_array), 3, 3), np.float32)
    reordered[real] = tri[order_array[real]]  # pad rows stay all-zero
    v0 = reordered[:, 0]
    e1 = reordered[:, 1] - reordered[:, 0]
    e2 = reordered[:, 2] - reordered[:, 0]
    n = np.cross(e1, e2)
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    n = np.where(
        norm > 1e-12, n / np.maximum(norm, 1e-12), np.array([[0.0, 1.0, 0.0]], np.float32)
    )
    return MeshBVH(
        v0=_tensor(v0, device),
        e1=_tensor(e1, device),
        e2=_tensor(e2, device),
        normal=_tensor(n.astype(np.float32), device),
        bounds_min=_tensor(np.stack([nd["min"] for nd in nodes]), device),
        bounds_max=_tensor(np.stack([nd["max"] for nd in nodes]), device),
        skip=_tensor(skip, device),
        first=_tensor(first, device),
        count=_tensor(count, device),
        octant=octant,
    )


def _tensor(array: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(array), device=device)


# Process-wide build memo, keyed by every parameter that shapes the result.
_geometry_cache: dict[tuple, MeshBVH] = {}


def bvh_builder() -> str:
    """``TRC_BVH_BUILDER``: ``sah`` (default, binned SAH) or ``median``;
    any other value is ``sah``."""
    value = (env_str("TRC_BVH_BUILDER") or "sah").strip().lower()
    return value if value in ("sah", "median") else "sah"


def bvh_wide() -> int:
    """``TRC_BVH_WIDE``: the BLAS branching factor after the wide collapse
    (default 4; 1 = binary; clamped to [1, 8])."""
    return max(1, min(env_int("TRC_BVH_WIDE", 4), 8))


def cached_mesh_bvh(
    kind: str, builder: str = "sah", wide: int = 4, device: str | torch.device = "cpu"
) -> MeshBVH:
    """Memoized BLAS build of a procedural mesh, per (kind, builder, wide,
    device)."""
    wide = max(1, min(int(wide), 8))
    device = torch.device(device)
    key = (kind, builder, wide, device)
    bvh = _geometry_cache.get(key)
    if bvh is None:
        if kind == "box":
            geometry = make_box()
        elif kind == "icosphere":
            geometry = make_icosphere(2)
        else:
            raise ValueError(f"Unknown mesh kind: {kind!r}")
        bvh = build_bvh(*geometry, builder=builder, wide=wide, device=device)
        _geometry_cache[key] = bvh
    return bvh


# ---------------------------------------------------------------------------
# The two-level hierarchy (TLAS) over the instances

_INF = 1e30


class TlasTopology(NamedTuple):
    """Static threaded TLAS topology over ``k_count`` instance slots (the
    reference's): DFS preorder, skip links, leaves covering contiguous slot
    ranges; ``member`` is the [M, K] node -> slot incidence mask of the
    per-frame bounds. ``octant_*`` are the eight near-first re-threadings
    (octant o at rows [o M, (o + 1) M), local skip links, ``octant_perm``
    the canonical node of each row), which the ordered walks take when the
    BVH carries octant tables."""

    skip: np.ndarray  # [M] int32: next subtree root (M = done)
    first: np.ndarray  # [M] int32: leaf slot start (0 for inner)
    count: np.ndarray  # [M] int32: leaf slot count (0 for inner)
    member: np.ndarray  # [M, K] bool: node covers instance slot
    depth: int  # tree depth (root = 1)
    octant_skip: np.ndarray  # [8M] int32
    octant_first: np.ndarray  # [8M] int32
    octant_count: np.ndarray  # [8M] int32
    octant_perm: np.ndarray  # [8M] int32


def build_tlas_topology(k_count: int, leaf_size: int) -> TlasTopology:
    """Median split over instance slot ranges, threaded like ``build_bvh``."""
    if k_count < 1:
        raise ValueError("TLAS needs at least one instance")
    leaf_size = max(1, leaf_size)
    nodes: list[dict] = []

    def emit(lo: int, hi: int, level: int) -> int:
        node_index = len(nodes)
        nodes.append({"lo": lo, "hi": hi, "leaf": hi - lo <= leaf_size, "level": level,
                      "children": None})
        if nodes[node_index]["leaf"]:
            return level
        mid = (lo + hi) // 2
        left = len(nodes)
        left_depth = emit(lo, mid, level + 1)
        right = len(nodes)
        right_depth = emit(mid, hi, level + 1)
        nodes[node_index]["children"] = (left, right)
        return max(left_depth, right_depth)

    depth = emit(0, k_count, 1)
    m = len(nodes)
    skip = np.zeros(m, np.int32)
    first = np.zeros(m, np.int32)
    count = np.zeros(m, np.int32)
    member = np.zeros((m, k_count), bool)
    for i, node in enumerate(nodes):
        j = i + 1
        while j < m and nodes[j]["lo"] >= node["lo"] and nodes[j]["hi"] <= node["hi"]:
            j += 1
        skip[i] = j
        member[i, node["lo"]:node["hi"]] = True
        if node["leaf"]:
            first[i] = node["lo"]
            count[i] = node["hi"] - node["lo"]
    subtree = skip - np.arange(m, dtype=np.int32)
    octant_skip = np.zeros(8 * m, np.int32)
    octant_first = np.zeros(8 * m, np.int32)
    octant_count = np.zeros(8 * m, np.int32)
    octant_perm = np.zeros(8 * m, np.int32)
    for octant in range(8):
        order: list[int] = []

        def emit_octant(i: int) -> None:
            order.append(i)
            children = nodes[i]["children"]
            if children is None:
                return
            # Morton MSB cycle: depth 1 splits z, then y, then x.
            axis = (2, 1, 0)[(nodes[i]["level"] - 1) % 3]
            left, right = children if octant & (1 << axis) else children[::-1]
            emit_octant(left)
            emit_octant(right)

        emit_octant(0)
        rows = slice(octant * m, (octant + 1) * m)
        octant_skip[rows] = np.arange(m) + subtree[order]
        octant_first[rows] = first[order]
        octant_count[rows] = count[order]
        octant_perm[rows] = order
    return TlasTopology(
        skip=skip, first=first, count=count, member=member, depth=depth,
        octant_skip=octant_skip, octant_first=octant_first, octant_count=octant_count,
        octant_perm=octant_perm,
    )


_tlas_topologies: dict[tuple[int, int], TlasTopology] = {}


def cached_tlas_topology(k_count: int, leaf_size: int) -> TlasTopology:
    """Memoized ``build_tlas_topology``, process-wide per (K, leaf)."""
    key = (int(k_count), int(leaf_size))
    topology = _tlas_topologies.get(key)
    if topology is None:
        topology = _tlas_topologies[key] = build_tlas_topology(*key)
    return topology


def tlas_node_bounds(
    topology: TlasTopology, lo_sorted: torch.Tensor, hi_sorted: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-frame node boxes ([M, 3], [M, 3]): masked min / max of the
    instance world boxes ``lo_sorted`` / ``hi_sorted`` [K, 3] in slot order."""
    mask = torch.as_tensor(topology.member, device=lo_sorted.device)[:, :, None]
    node_lo = torch.where(mask, lo_sorted[None], _INF).amin(dim=1)
    node_hi = torch.where(mask, hi_sorted[None], -_INF).amax(dim=1)
    return node_lo, node_hi


# ---------------------------------------------------------------------------
# Quantized node tables (the reference's TRC_BVH_QUANT tiers)
#
# A node table of 36 bytes a node (six f32 slabs, three int32 links) packs
# to 16 bytes (tier 1: 16-bit slabs two to an int32 word, three words) or
# 12 bytes (tier 2: 8-bit slabs six to two words) plus one meta word. The
# slabs are quantized against the table's own union box and rounded
# outward, so a reconstructed box contains its fp32 original and a walk
# over them visits a superset of the fp32 walk's nodes; the triangle tests
# stay exact f32, so every result is the fp32 walk's. Meta word, LSB to
# MSB: skip [0:16), first / first_unit [16:27), count [27:32); a table
# whose counts pass these ranges degrades the tier to 0
# (``kernels.resolve_bvh_quant``).
QUANT_MAX_NODES = 1 << 16
QUANT_MAX_FIRST_UNITS = 1 << 11
QUANT_MAX_COUNT = 31
# The outward pad in grid cells per tier, and the slab bits.
_QUANT_PAD = {1: 4, 2: 1}
_QUANT_BITS = {1: 16, 2: 8}
_F32_EPS_SCALE = torch.tensor(2e-3, dtype=_F32)


def _wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 bit patterns of 32 bits as int32 (two's complement)."""
    return (((v & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000).to(torch.int32)


def quant_grid(glo: torch.Tensor, ghi: torch.Tensor, quant: int) -> torch.Tensor:
    """The grid [6] float32 (origin, then cell) of a table whose node boxes
    span ``glo`` .. ``ghi`` [3], in the reference's float32 arithmetic: the
    window padded by (|lo| + |hi| + 1) * 2e-3 on each side, then cut into
    2^bits - 1 cells."""
    levels = torch.tensor(float((1 << _QUANT_BITS[quant]) - 1), dtype=_F32)
    glo = glo.to(_F32)
    ghi = ghi.to(_F32)
    eps = (glo.abs() + ghi.abs() + 1.0) * _F32_EPS_SCALE.to(glo.device)
    origin = glo - eps
    cell = ((ghi + eps) - origin) / levels.to(glo.device)
    return torch.cat([origin, cell])


def quantize_node_tables(lo, hi, skip, first, count, *, quant: int, first_unit: int,
                         grid: torch.Tensor | None = None):
    """Pack a threaded node table: ``lo`` / ``hi`` [N, 3] node boxes, the
    int32 links ``skip`` / ``first`` / ``count`` [N], ``first_unit`` the
    alignment of ``first`` (``LEAF_SIZE`` for a BLAS, 1 for a TLAS).
    Returns ``(bq [N, 3] (tier 1) or [N, 2] (tier 2) int32, meta [N] int32,
    grid [6] float32)``, bit for bit the reference's. ``grid`` (default:
    ``quant_grid`` of the table's own union box) quantizes against a given
    grid instead: a pool window's frames against their common one."""
    bits = _QUANT_BITS[quant]
    levels = (1 << bits) - 1
    pad = _QUANT_PAD[quant]
    lo = torch.as_tensor(lo, dtype=_F32)
    hi = torch.as_tensor(hi, dtype=_F32, device=lo.device)
    if grid is None:
        grid = quant_grid(lo.amin(dim=0), hi.amax(dim=0), quant)
    grid = grid.to(lo.device)
    origin, cell = grid[0:3], grid[3:6]
    inv = 1.0 / cell
    qlo = torch.clamp(torch.floor((lo - origin) * inv).to(torch.int64) - pad, 0, levels)
    qhi = torch.clamp(torch.ceil((hi - origin) * inv).to(torch.int64) + pad, 0, levels)
    if quant == 1:
        bq = qlo | (qhi << 16)  # per axis: lo | hi << 16
    else:
        bq = torch.stack([
            qlo[:, 0] | (qlo[:, 1] << 8) | (qlo[:, 2] << 16) | (qhi[:, 0] << 24),
            qhi[:, 1] | (qhi[:, 2] << 8),
        ], dim=1)
    skip = torch.as_tensor(skip, device=lo.device).to(torch.int64)
    first = torch.as_tensor(first, device=lo.device).to(torch.int64)
    count = torch.as_tensor(count, device=lo.device).to(torch.int64)
    meta = skip | (torch.div(first, first_unit, rounding_mode="floor") << 16) | (count << 27)
    return _wrap_int32(bq), _wrap_int32(meta), grid


def dequantize_node_bounds(bq: torch.Tensor, grid: torch.Tensor, quant: int):
    """The kernels' slab reconstruction, ``origin + q * cell`` in float32
    (a multiply, then an add): ([N, 3] lo, [N, 3] hi)."""
    words = bq.to(torch.int64) & 0xFFFFFFFF
    if quant == 1:
        qlo, qhi = words & 0xFFFF, (words >> 16) & 0xFFFF
    else:
        w0, w1 = words[:, 0], words[:, 1]
        qlo = torch.stack([w0 & 0xFF, (w0 >> 8) & 0xFF, (w0 >> 16) & 0xFF], dim=1)
        qhi = torch.stack([(w0 >> 24) & 0xFF, w1 & 0xFF, (w1 >> 8) & 0xFF], dim=1)
    grid = grid.to(bq.device)
    origin, cell = grid[None, 0:3], grid[None, 3:6]
    return origin + qlo.to(_F32) * cell, origin + qhi.to(_F32) * cell


def unpack_node_meta(meta: torch.Tensor, *, first_unit: int):
    """The kernels' meta-word unpack: (skip, first, count), int64 [N]."""
    word = meta.to(torch.int64) & 0xFFFFFFFF
    return word & 0xFFFF, ((word >> 16) & 0x7FF) * first_unit, (word >> 27) & 0x1F


def morton_dilate5(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 5 bits of an integer tensor to every third bit: the
    one dilation of the slot order and the coherence key."""
    v = (v | (v << 8)) & 0x0300F
    v = (v | (v << 4)) & 0x030C3
    return (v | (v << 2)) & 0x09249


def instance_morton_order(lo_w: torch.Tensor, hi_w: torch.Tensor) -> torch.Tensor:
    """The slot order ([K] int64, slot -> instance) of instance world boxes
    ``lo_w`` / ``hi_w`` [K, 3]: a stable argsort (as ``jnp.argsort``) of the
    Morton code of their centers on a 32-cell grid over the centers' span,
    so equal codes keep the table order. Ray-independent, so every launch
    of a frame derives the same order."""
    centers = 0.5 * (lo_w + hi_w)
    lo = centers.amin(dim=0)
    span = torch.clamp_min(centers.amax(dim=0) - lo, 1e-6)
    cell = torch.clamp((centers - lo) / span * 32.0, 0.0, 31.0).to(torch.int64)
    code = (
        morton_dilate5(cell[:, 0]) | (morton_dilate5(cell[:, 1]) << 1)
        | (morton_dilate5(cell[:, 2]) << 2)
    )
    return torch.argsort(code, stable=True)


# ---------------------------------------------------------------------------
# Ray queries against one mesh


def _moller_trumbore(origins, directions, v0, e1, e2) -> torch.Tensor:
    """Batched ray x triangle test: [R, T] hit distances (INF = miss)."""
    from tpu_render_cluster_torch.render.kernels import EPS, INF

    d = directions[:, None, :].expand(-1, e2.shape[0], -1)
    pvec = torch.linalg.cross(d, e2[None, :, :].expand_as(d), dim=-1)
    det = (e1[None, :, :] * pvec).sum(dim=-1)
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    tvec = origins[:, None, :] - v0[None, :, :]
    u = (tvec * pvec).sum(dim=-1) * inv_det
    qvec = torch.linalg.cross(tvec, e1[None, :, :].expand_as(tvec), dim=-1)
    v = (directions[:, None, :] * qvec).sum(dim=-1) * inv_det
    t = (e2[None, :, :] * qvec).sum(dim=-1) * inv_det
    hit = (torch.abs(det) > 1e-12) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > EPS)
    return torch.where(hit, t, INF)


def intersect_triangles_brute(bvh: MeshBVH, origins, directions):
    """Nearest triangle hit by brute force, the tests' oracle: (t [R],
    triangle row [R] int32, the first row reaching the minimum; INF and 0
    on a miss)."""
    t = _moller_trumbore(origins, directions, bvh.v0, bvh.e1, bvh.e2)
    best = torch.argmin(t, dim=-1)
    return t.gather(1, best[:, None])[:, 0], best.to(torch.int32)


def intersect_mesh(bvh: MeshBVH, origins, directions, init_t=None):
    """Nearest hit of object-space rays in the BVH: (t [R], ``init_t`` or
    INF on a miss; triangle row [R] int32, 0 on a miss), through the
    single-BVH unit kernel (``kernels.intersect_mesh``)."""
    from tpu_render_cluster_torch.render import kernels

    if init_t is None:
        init_t = torch.full((origins.shape[0],), kernels.INF, device=origins.device)
    return kernels.intersect_mesh(bvh, origins, directions, init_t)


def occluded_mesh(bvh: MeshBVH, origins, directions, already) -> torch.Tensor:
    """Any-hit of object-space rays in the BVH (bool [R]); ``already``
    lanes come back True without walking. Through the single-BVH unit
    kernel (``kernels.occluded_mesh``)."""
    from tpu_render_cluster_torch.render import kernels

    return kernels.occluded_mesh(bvh, origins, directions, already)


# ---------------------------------------------------------------------------
# Ray queries against every instance (the per-bounce scan renderer)


def _rays_to_object_space(instances: MeshInstances, k: int, origins, directions):
    """World -> object space for instance ``k``: x' = R^T (x - t) / s, the
    direction scaled by 1/s too, which keeps the ray parameter t in world
    units. Rounded as the reference's compiler rounds its elementwise
    ``x0 * R[0] + x1 * R[1] + x2 * R[2]``: fma(x2, R[2], fma(x0, R[0], x1 *
    R[1])), then the product with 1/s."""
    rot = instances.rotation[k]
    inv_scale = 1.0 / instances.scale[k]

    def turn(x):
        return fma(x[:, 2:3], rot[2], fma(x[:, 0:1], rot[0], x[:, 1:2] * rot[1])) * inv_scale

    return turn(origins - instances.translation[k]), turn(directions)


def _normal_to_world(rotation: torch.Tensor, normal_obj: torch.Tensor) -> torch.Tensor:
    """World normals R n_obj [R, 3] of object normals [R, 3] under one
    rotation [3, 3], rounded as ``_rays_to_object_space``."""
    return fma(
        normal_obj[:, 2:3], rotation[:, 2],
        fma(normal_obj[:, 0:1], rotation[:, 0], normal_obj[:, 1:2] * rotation[:, 1]),
    )


def _normals_to_world(rotation: torch.Tensor, normal_obj: torch.Tensor) -> torch.Tensor:
    """World normals R n_obj [R, 3] (rigid: the inverse transpose is R) of
    object normals ``normal_obj`` [R, 3] under per-ray rotations [R, 3, 3]."""
    return (
        rotation[..., :, 0] * normal_obj[:, 0:1]
        + rotation[..., :, 1] * normal_obj[:, 1:2]
        + rotation[..., :, 2] * normal_obj[:, 2:3]
    )


def intersect_instances(
    mesh: MeshSet,
    origins: torch.Tensor,
    directions: torch.Tensor,
    init_t: torch.Tensor | None = None,
    *,
    per_instance: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Nearest hit over all instances: (t [R], world normal facing the ray
    [R, 3], albedo [R, 3]).

    ``init_t`` (optional [R]) seeds the best t with a hit the caller already
    knows (the same bounce's sphere/plane t): a mesh miss returns t ==
    init_t, never closer. By default one launch of the instanced
    nearest-hit kernel (``kernels.intersect_instances``), then the gathers
    of the winning triangle's normal and the instance's rotation and
    albedo, as the reference's kernel branch does; the hit test compares
    with the seed, not INF, so a seeded miss keeps a zero normal and a zero
    albedo. ``per_instance`` takes the reference's scan branch instead.
    """
    from tpu_render_cluster_torch.render import kernels

    if init_t is None:
        init_t = torch.full((origins.shape[0],), kernels.INF, device=origins.device)
    if per_instance:
        return _intersect_each_instance(mesh, origins, directions, init_t)
    t, tri, inst = kernels.intersect_instances(mesh, origins, directions, init_t)
    hit = (t < init_t)[:, None]
    tri, inst = tri.to(torch.int64), inst.to(torch.int64)
    normal = _normals_to_world(mesh.instances.rotation[inst], mesh.bvh.normal[tri])
    facing = (
        normal[:, 0] * directions[:, 0] + normal[:, 1] * directions[:, 1]
        + normal[:, 2] * directions[:, 2]
    ) < 0.0
    normal = torch.where(facing[:, None], normal, -normal)
    return (
        t,
        torch.where(hit, normal, 0.0),
        torch.where(hit, mesh.instances.albedo[inst], 0.0),
    )


def _intersect_each_instance(mesh: MeshSet, origins, directions, init_t):
    """``intersect_instances`` as the reference's scan over the instances:
    per instance the rays in its object space, the BVH walk seeded with the
    best t so far, the winning normal to world space and the strict-<
    selects; at the end the normals turned toward the ray, the facing test
    summed as the reference's ``jnp.sum`` reduces: fma(n2, d2, fma(n1, d1,
    n0 * d0)). A miss keeps a zero normal (negated) and albedo."""
    bvh, instances = mesh.bvh, mesh.instances
    best_t = init_t
    best_normal = torch.zeros_like(origins)
    best_albedo = torch.zeros_like(origins)
    for k in range(instances.translation.shape[0]):
        local_origins, local_directions = _rays_to_object_space(instances, k, origins, directions)
        t, tri = intersect_mesh(bvh, local_origins, local_directions, best_t)
        normal = _normal_to_world(instances.rotation[k], bvh.normal[tri])
        closer = (t < best_t)[:, None]
        best_t = torch.where(closer[:, 0], t, best_t)
        best_normal = torch.where(closer, normal, best_normal)
        best_albedo = torch.where(closer, instances.albedo[k], best_albedo)
    n, d = best_normal, directions
    facing = fma(n[:, 2], d[:, 2], fma(n[:, 1], d[:, 1], n[:, 0] * d[:, 0])) < 0.0
    return best_t, torch.where(facing[:, None], best_normal, -best_normal), best_albedo


def occluded_instances(
    mesh: MeshSet,
    origins: torch.Tensor,
    directions: torch.Tensor,
    already: torch.Tensor | None = None,
    *,
    per_instance: bool = False,
) -> torch.Tensor:
    """Any-hit over all instances (shadow rays): bool [R]. ``already``
    (optional [R] bool) marks lanes the caller knows are occluded, or whose
    answer cannot matter: they do not walk and come back True. By default
    one launch of the instanced any-hit kernel
    (``kernels.occluded_instances``); ``per_instance`` takes the
    reference's scan over the instances, one ``occluded_mesh`` walk per
    instance with the running mask as its ``already``."""
    from tpu_render_cluster_torch.render import kernels

    if already is None:
        already = torch.zeros((origins.shape[0],), dtype=torch.bool, device=origins.device)
    if not per_instance:
        return kernels.occluded_instances(mesh, origins, directions, already)
    occluded = already
    for k in range(mesh.instances.translation.shape[0]):
        local_origins, local_directions = _rays_to_object_space(
            mesh.instances, k, origins, directions
        )
        occluded = occluded_mesh(mesh.bvh, local_origins, local_directions, occluded)
    return occluded


def rotation_y(angle: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotation about +y for scalar or batched angles."""
    c, s = torch.cos(angle), torch.sin(angle)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack(
        [
            torch.stack([c, zero, s], dim=-1),
            torch.stack([zero, one, zero], dim=-1),
            torch.stack([-s, zero, c], dim=-1),
        ],
        dim=-2,
    )


def scene_mesh_set(
    scene_name: str, frame, builder: str = "sah", wide: int = 4,
    device: str | torch.device = "cpu",
) -> MeshSet | None:
    """The MeshSet of a scene on ``device`` (None for sphere-only scenes):
    the cached BVH (``builder``, ``wide``) plus this frame's instance
    transforms and TLAS operands, both computed on the host and copied in
    one (``scene.on_device``)."""
    return mesh_frame_on(mesh_frame_on_host(scene_name, frame, builder, wide), device)


class MeshFrame(NamedTuple):
    """A mesh scene's frame on the host: which cached BVH it walks, and its
    instances and TLAS operands, ready to be copied to any device
    (``mesh_frame_on``)."""

    kind: str
    builder: str
    wide: int
    tables: _FrameTables
    union: torch.Tensor


def mesh_frame_on_host(
    scene_name: str, frame, builder: str = "sah", wide: int = 4
) -> MeshFrame | None:
    """``scene_mesh_set``'s host half (None for sphere-only scenes)."""
    from tpu_render_cluster_torch.render.kernels import tlas_frame_on_host
    from tpu_render_cluster_torch.render.scene import mesh_instances_on, mesh_kind_for_scene

    kind = mesh_kind_for_scene(scene_name)
    if kind is None:
        return None
    host = MeshSet(
        bvh=cached_mesh_bvh(kind, builder, wide, "cpu"),
        instances=mesh_instances_on(scene_name, frame, "cpu"),
    )
    tlas = tlas_frame_on_host(host)
    return MeshFrame(kind, builder, wide, _FrameTables(*host.instances, *tlas[:4]), tlas.union)


def mesh_frame_on(frame: MeshFrame | None, device: str | torch.device) -> MeshSet | None:
    """``scene_mesh_set``'s copy half: a host frame's MeshSet on ``device``,
    its tables in one copy."""
    from tpu_render_cluster_torch.render.scene import on_device

    if frame is None:
        return None
    copy = on_device(frame.tables, device)
    return MeshSet(
        bvh=cached_mesh_bvh(frame.kind, frame.builder, frame.wide, device),
        instances=MeshInstances(*copy[:4]),
        tlas=TlasFrame(*copy[4:], union=frame.union),
    )


class _FrameTables(NamedTuple):
    """A frame's instances and TLAS operands, as ``on_device`` copies them."""

    rotation: torch.Tensor
    translation: torch.Tensor
    albedo: torch.Tensor
    scale: torch.Tensor
    slots: torch.Tensor
    node_bounds: torch.Tensor
    key_window: torch.Tensor
    octant_node_bounds: torch.Tensor


def mesh_from_arrays(
    bvh_arrays: dict[str, np.ndarray], instance_arrays: dict[str, np.ndarray], device
) -> MeshSet:
    """A ``MeshSet`` from named arrays, e.g. a reference ``MeshBVH`` and
    ``MeshInstances`` as numpy (``octant``, when present, as a dict of the
    five octant arrays)."""

    def as_tensor(value):
        return torch.as_tensor(np.array(value), device=device)

    octant = bvh_arrays.get("octant")
    bvh = MeshBVH(
        **{field: as_tensor(bvh_arrays[field]) for field in MeshBVH._fields[:-1]},
        octant=None if octant is None else OctantTables(
            **{field: as_tensor(octant[field]) for field in OctantTables._fields}
        ),
    )
    instances = MeshInstances(
        **{field: as_tensor(np.asarray(instance_arrays[field], np.float32))
           for field in MeshInstances._fields}
    )
    return MeshSet(bvh=bvh, instances=instances)
