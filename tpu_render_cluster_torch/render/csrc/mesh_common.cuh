// Mesh-scene device code shared by the mesh path-trace kernels (the
// megakernels trace_fused_mesh.cu and trace_fused_mesh_tlas.cu, the
// per-bounce kernels mesh_bounce.cu and mesh_bounce_tlas.cu, the ray-pool
// kernels pool_mesh_bounce.cu and pool_mesh_bounce_tlas.cu, and the bounce
// scan's unit kernels intersect_instances.cu, occluded_instances.cu,
// intersect_mesh.cu and occluded_mesh.cu): the instance and BVH tables,
// their staging in shared memory, the walk of one object-space ray through
// the threaded BVH (blas_nearest, blas_occluded), the nearest hit and the
// shadow any-hit over the rigid instances of one mesh built on it, in two
// variants (FlatInstances: the instances [first, first + count) in table
// order, a frame's K or a lane's own frame's rows of a pool's frame-major
// stacked table; TlasInstances: the two-level walk of a frame's TLAS over
// the instance table in Morton slot order), the coherence key, and the
// whole mesh-scene bounce built from them and path_common.cuh; for the
// per-bounce and pool TLAS kernels and the scan's instance kernels alone,
// the group walk (G threads of a warp share one ray: GroupTlas, with the
// key's entry walk, and GroupFlat, the flat sweep), the bulk staging of
// tables in shared memory (stage_ranges) and the persistent blocks' work
// fetch and occupancy queries.
//
// Walk order: instances in table order (or the TLAS's leaves in preorder,
// their slots in order), nodes in DFS preorder of one node table, strict
// `<` updates of a best t seeded with the sphere/plane t, the first tying
// row of a leaf winning. Per ray that is the nearest hit the reference's
// packet walk finds, ties included, when both walk the same table: the
// TPU's block-wide `any` culls change which nodes a packet visits, never
// the order in which a ray meets the leaves it needs. The table is the
// reference's (the Order policy): the canonical one (Canonical), or on a
// BVH with octant tables, as the reference's default, one of eight
// near-first re-threadings stacked [8N] (and [8M] for a TLAS), picked per
// packet of the launch by a majority vote over its lanes' directions
// (Octants: the votes come from the caller), a BLAS walk entering below the
// root, whose box the instance's world box stands for. A TLAS node's box
// is the union of its slots' world boxes and the slab arithmetic is
// monotone in the box, so a node test never rejects a ray that one of its
// slots' tests would accept.
//
// Rounding follows the reference's compiler as in path_common.cuh: each
// written-out sum of three products a*b + c*d + e*f is
// fma(e, f, fma(a, b, c * d)), each a*b - c*d is fma(a, b, -(c * d)), in
// the object-space transform, Moller-Trumbore and the normal rotation.
//
// Node format: every node table (a BLAS's, a TLAS's) is read through
// Nodes<Q>, the reference's TRC_BVH_QUANT tiers (below, at Nodes): Q = 0
// the fp32 bounds and links, Q = 1 and 2 the quantized tables, whose boxes
// contain the fp32 ones, so a walk over them finds the same hits. The
// tables, the walks and the bounce take Q as a template parameter of the
// tables (MeshTablesOf<Q>, TlasTablesOf<Q>, GroupTlas<G, Order, Q>); a
// kernel instantiates the formats its C entry dispatches on (with_format).

#pragma once

#include <mutex>
#include <type_traits>
#include <vector>

#include "path_common.cuh"

// The packet of the TLAS kernels (trace_fused_mesh_tlas.cu,
// mesh_bounce_tlas.cu, mesh_entry_keys.cu, pool_mesh_bounce_tlas.cu): the
// reference's ray block of its TLAS variants, tlas_block_r() (the
// TRC_TLAS_BLOCK tier), 256 lanes by default. A build may name another
// width (-DTRC_PACKET=128, 512 or 1024): render/_build.py builds one library
// of each of these kernels a width, at first use, and each exports the
// width it was built for (<name>_packet), which its wrapper checks.
#ifndef TRC_PACKET
#define TRC_PACKET 256
#endif
static_assert(TRC_PACKET == 128 || TRC_PACKET == 256 || TRC_PACKET == 512 || TRC_PACKET == 1024,
              "TRC_PACKET is one of 128, 256, 512, 1024");

namespace mesh {

constexpr int kTlasPacket = TRC_PACKET;

using path::float3v;
constexpr int kInstanceWidth = 22;
constexpr float kDetEps = 1e-12f;
__device__ __forceinline__ float sum3(float a0, float b0, float a1, float b1, float a2,
                                      float b2) {
  return fmaf(a2, b2, fmaf(a0, b0, a1 * b1));
}

// 1 / v with |v| < 1e-12 pushed to +-1e-12 (sign of v; +0 goes to +).
__device__ __forceinline__ float winv(float v) {
  return 1.0f / (fabsf(v) < 1e-12f ? (v < 0.0f ? -1e-12f : 1e-12f) : v);
}

__device__ __forceinline__ float3v winv3(float3v v) { return {winv(v.x), winv(v.y), winv(v.z)}; }

// The ray enters the box before `limit` and not behind its origin.
__device__ __forceinline__ bool slab(float lx, float ly, float lz, float hx, float hy, float hz,
                                     float3v o, float3v inv, float limit) {
  const float lox = (lx - o.x) * inv.x, hix = (hx - o.x) * inv.x;
  const float loy = (ly - o.y) * inv.y, hiy = (hy - o.y) * inv.y;
  const float loz = (lz - o.z) * inv.z, hiz = (hz - o.z) * inv.z;
  const float tnear = fmaxf(fmaxf(fminf(lox, hix), fminf(loy, hiy)), fminf(loz, hiz));
  const float tfar = fminf(fminf(fmaxf(lox, hix), fmaxf(loy, hiy)), fmaxf(loz, hiz));
  return tfar >= fmaxf(tnear, 0.0f) && tnear < limit;
}

__device__ __forceinline__ bool world_box(const float* inst, float3v o, float3v inv,
                                          float limit) {
  return slab(inst[13], inst[14], inst[15], inst[16], inst[17], inst[18], o, inv, limit);
}

__device__ __forceinline__ bool node_box(const float4* bounds, int node, float3v o,
                                         float3v inv, float limit) {
  const float4 lo = bounds[2 * node];
  const float4 hi = bounds[2 * node + 1];
  return slab(lo.x, lo.y, lo.z, hi.x, hi.y, hi.z, o, inv, limit);
}

// ---------------------------------------------------------------------------
// Node formats (the reference's `_read_packed_bounds` and `_read_meta`,
// pallas_kernels.py:2080-2110). A node table in format Q:
//   Q = 0: bounds [R, 2] float4 (lo, hi) and links [R] int4 (skip, first,
//          count, 0), 48 bytes a node;
//   Q = 1: one int4 a node, per axis lo | hi << 16 (16-bit slabs), then the
//          meta word; 16 bytes;
//   Q = 2: three ints a node, lo x | lo y << 8 | lo z << 16 | hi x << 24 and
//          hi y | hi z << 8 (8-bit slabs), then the meta word; 12 bytes.
// A quantized slab reconstructs as origin + float(q) * cell in float32, a
// multiply then an add (mesh.dequantize_node_bounds, the plain version's;
// the build's --fmad=false keeps them apart), and its box contains the fp32
// one (mesh.quantize_node_tables). The meta word: skip [0:16), first / unit
// [16:27), count [27:32), `unit` the alignment of first (a BLAS's leaf rows,
// kLeafRows; a TLAS's slots, 1). A table stages as two parts: the fp32
// bounds and links, or the quantized words and nothing.

constexpr int kLeafRows = 16;  // mesh.LEAF_SIZE

__host__ __device__ inline size_t round16(size_t bytes) { return (bytes + 15) / 16 * 16; }

template <int Q>
struct Nodes {
  static_assert(Q == 1 || Q == 2, "the node formats are 0, 1 and 2");
  static constexpr int kWords = Q == 1 ? 4 : 3;
  const int* words;  // [R, kWords]
  float ox, oy, oz;  // the grid's origin
  float cx, cy, cz;  // and cell
  int unit;

  __host__ __device__ static size_t part_bytes(int part, size_t rows) {
    return part == 0 ? sizeof(int) * kWords * rows : 0;
  }
  __host__ __device__ const char* part(int i) const {
    return i == 0 ? reinterpret_cast<const char*>(words) : nullptr;
  }
  __host__ __device__ void set_parts(const char* words_at, const char*) {
    words = reinterpret_cast<const int*>(words_at);
  }
  // (skip, first, count, 0) of node n.
  __device__ __forceinline__ int4 link(int n) const {
    const int m = words[kWords * n + kWords - 1];
    return make_int4(m & 0xFFFF, ((m >> 16) & 0x7FF) * unit, (m >> 27) & 0x1F, 0);
  }
  __device__ __forceinline__ static float slab_of(float origin, int q, float cell) {
    return __fadd_rn(origin, __fmul_rn(__int2float_rn(q), cell));
  }
  __device__ __forceinline__ void corners(int n, float3v& lo, float3v& hi) const {
    int qlx, qly, qlz, qhx, qhy, qhz;
    if constexpr (Q == 1) {
      const int4 w = reinterpret_cast<const int4*>(words)[n];
      qlx = w.x & 0xFFFF;
      qhx = (w.x >> 16) & 0xFFFF;
      qly = w.y & 0xFFFF;
      qhy = (w.y >> 16) & 0xFFFF;
      qlz = w.z & 0xFFFF;
      qhz = (w.z >> 16) & 0xFFFF;
    } else {
      const int w0 = words[3 * n];
      const int w1 = words[3 * n + 1];
      qlx = w0 & 0xFF;
      qly = (w0 >> 8) & 0xFF;
      qlz = (w0 >> 16) & 0xFF;
      qhx = (w0 >> 24) & 0xFF;
      qhy = w1 & 0xFF;
      qhz = (w1 >> 8) & 0xFF;
    }
    lo = {slab_of(ox, qlx, cx), slab_of(oy, qly, cy), slab_of(oz, qlz, cz)};
    hi = {slab_of(ox, qhx, cx), slab_of(oy, qhy, cy), slab_of(oz, qhz, cz)};
  }
  __device__ __forceinline__ bool box(int n, float3v o, float3v inv, float limit) const {
    float3v lo, hi;
    corners(n, lo, hi);
    return slab(lo.x, lo.y, lo.z, hi.x, hi.y, hi.z, o, inv, limit);
  }
};

template <>
struct Nodes<0> {
  const float4* bounds;  // [R, 2]: lo, hi
  const int4* links;  // [R]: skip, first, count, 0

  __host__ __device__ static size_t part_bytes(int part, size_t rows) {
    return (part == 0 ? 2 * sizeof(float4) : sizeof(int4)) * rows;
  }
  __host__ __device__ const char* part(int i) const {
    return i == 0 ? reinterpret_cast<const char*>(bounds) : reinterpret_cast<const char*>(links);
  }
  __host__ __device__ void set_parts(const char* bounds_at, const char* links_at) {
    bounds = reinterpret_cast<const float4*>(bounds_at);
    links = reinterpret_cast<const int4*>(links_at);
  }
  __device__ __forceinline__ int4 link(int n) const { return links[n]; }
  __device__ __forceinline__ bool box(int n, float3v o, float3v inv, float limit) const {
    return node_box(bounds, n, o, inv, limit);
  }
};

// A node table in format Q from a C entry's arguments: the fp32 bounds and
// links, or the quantized words and the grid (6 floats in host memory:
// origin, cell) with the alignment of `first`.
template <int Q>
inline Nodes<Q> nodes_of(const void* table, const int* links, const float* grid, int unit) {
  if constexpr (Q == 0) {
    return {static_cast<const float4*>(table), reinterpret_cast<const int4*>(links)};
  } else {
    return {static_cast<const int*>(table), grid[0], grid[1], grid[2], grid[3], grid[4], grid[5],
            unit};
  }
}

// The node format of a launch as a compile-time constant: f(format), its
// ::value the format, for quant 0, 1 or 2; cudaErrorInvalidValue for any
// other, and for a quantized format without its grids (each of `grids`
// nonzero).
template <typename F>
inline int with_format(int quant, std::initializer_list<const float*> grids, F&& f) {
  if (quant != 0) {
    for (const float* grid : grids) {
      if (grid == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (quant) {
    case 0: return f(std::integral_constant<int, 0>());
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Copy `bytes` (a multiple of 4) from src to dst (16-byte aligned) with the
// block's threads: as float4s where src is 16-byte aligned and the size a
// multiple of 16, else word by word.
__device__ __forceinline__ void copy_words(char* dst, const char* src, size_t bytes) {
  if ((bytes & 15u) == 0 && (reinterpret_cast<uintptr_t>(src) & 15u) == 0) {
    for (size_t i = threadIdx.x; i < bytes / 16; i += blockDim.x) {
      reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(src)[i];
    }
  } else {
    for (size_t i = threadIdx.x; i < bytes / 4; i += blockDim.x) {
      reinterpret_cast<int*>(dst)[i] = reinterpret_cast<const int*>(src)[i];
    }
  }
}

// The octant of a direction: bit i set where component i is positive (0.0
// and -0.0 give 0); the vote of a packet of one lane, the uniform sun's.
__device__ __forceinline__ int octant_of(float3v v) {
  return (v.x > 0.0f ? 1 : 0) | (v.y > 0.0f ? 2 : 0) | (v.z > 0.0f ? 4 : 0);
}

// x' = R^T (x - t) / s (a point) or R^T x / s (a direction).
__device__ __forceinline__ float3v to_object(const float* inst, float x, float y, float z) {
  const float inv_s = inst[12];
  return {sum3(x, inst[0], y, inst[3], z, inst[6]) * inv_s,
          sum3(x, inst[1], y, inst[4], z, inst[7]) * inv_s,
          sum3(x, inst[2], y, inst[5], z, inst[8]) * inv_s};
}

__device__ __forceinline__ float3v point_to_object(const float* inst, float3v p) {
  return to_object(inst, p.x - inst[9], p.y - inst[10], p.z - inst[11]);
}

// Moller-Trumbore against one triangle row (v0, e1, e2, normal as float4).
__device__ __forceinline__ bool triangle_hit(const float4* row, float3v o, float3v d,
                                             float* t_out) {
  const float4 v0 = row[0];
  const float4 e1 = row[1];
  const float4 e2 = row[2];
  const float pvx = fmaf(d.y, e2.z, -(d.z * e2.y));
  const float pvy = fmaf(d.z, e2.x, -(d.x * e2.z));
  const float pvz = fmaf(d.x, e2.y, -(d.y * e2.x));
  const float det = sum3(e1.x, pvx, e1.y, pvy, e1.z, pvz);
  const float inv_det = 1.0f / (fabsf(det) < kDetEps ? kDetEps : det);
  const float tvx = o.x - v0.x, tvy = o.y - v0.y, tvz = o.z - v0.z;
  const float u = sum3(tvx, pvx, tvy, pvy, tvz, pvz) * inv_det;
  const float qvx = fmaf(tvy, e1.z, -(tvz * e1.y));
  const float qvy = fmaf(tvz, e1.x, -(tvx * e1.z));
  const float qvz = fmaf(tvx, e1.y, -(tvy * e1.x));
  const float v = sum3(d.x, qvx, d.y, qvy, d.z, qvz) * inv_det;
  const float t = sum3(e2.x, qvx, e2.y, qvy, e2.z, qvz) * inv_det;
  *t_out = t;
  return fabsf(det) > kDetEps && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > path::kEps;
}

template <int Q>
struct MeshTablesOf {
  const float* inst;  // [K, 22]
  const float4* tris;  // [T, 4]: v0, e1, e2, normal
  Nodes<Q> nodes;  // [N] (8N: the octant tables)
  int n_instances;
  int n_nodes;
};

using MeshTables = MeshTablesOf<0>;

// Bytes of the tables staged in shared memory, in stage_tables' layout
// (path::staging_for decides whether they are).
template <int Q = 0>
__host__ __device__ inline size_t table_bytes(int n_tri_rows, int n_nodes, int n_instances) {
  return sizeof(float4) * 4 * static_cast<size_t>(n_tri_rows) +
         round16(Nodes<Q>::part_bytes(0, n_nodes)) + round16(Nodes<Q>::part_bytes(1, n_nodes)) +
         sizeof(float) * kInstanceWidth * static_cast<size_t>(n_instances);
}

// Copy the tables into `staging` (layout: triangle rows, the node table's
// two parts, each from a 16-byte boundary, instance table) and point `m` at
// the copies; `n_node_rows` rows of node tables (8N: the octant tables).
// Every thread of the block takes part; the caller synchronises before the
// tables are read.
template <int Q>
__device__ __forceinline__ void stage_tables(MeshTablesOf<Q>& m, float4* staging, int n_tri_rows,
                                             int n_node_rows) {
  float4* tris = staging;
  char* part0 = reinterpret_cast<char*>(tris + 4 * n_tri_rows);
  char* part1 = part0 + round16(Nodes<Q>::part_bytes(0, n_node_rows));
  float* inst = reinterpret_cast<float*>(part1 + round16(Nodes<Q>::part_bytes(1, n_node_rows)));
  for (int i = threadIdx.x; i < 4 * n_tri_rows; i += blockDim.x) tris[i] = m.tris[i];
  copy_words(part0, m.nodes.part(0), Nodes<Q>::part_bytes(0, n_node_rows));
  copy_words(part1, m.nodes.part(1), Nodes<Q>::part_bytes(1, n_node_rows));
  for (int i = threadIdx.x; i < kInstanceWidth * m.n_instances; i += blockDim.x) {
    inst[i] = m.inst[i];
  }
  m.tris = tris;
  m.nodes.set_parts(part0, part1);
  m.inst = inst;
}

template <int Q>
__device__ __forceinline__ void stage_tables(MeshTablesOf<Q>& m, float4* staging, int n_tri_rows) {
  stage_tables(m, staging, n_tri_rows, m.n_nodes);
}

struct MeshHit {
  float t;  // the seed t when nothing closer was hit
  int instance;  // -1: no mesh hit closer than the seed
  int row;
};

// The node table a walk takes (the reference's `blas_base` and `tlas_base`,
// pallas_kernels.py:2263-2295): blas(m, k) the (row base, entry node) of the
// nearest walk through instance row k, blas_sun(m, ld) those of a shadow
// walk along object-space direction ld, tlas() and tlas_sun() the row base
// of the nearest and the shadow TLAS walks.
//
// Canonical: one table, entered at its root (a BVH without octant tables,
// and the scan's unit kernels, whose reference reads none).
struct Canonical {
  template <int Q>
  __device__ __forceinline__ int2 blas(const MeshTablesOf<Q>&, int) const { return {0, 0}; }
  template <int Q>
  __device__ __forceinline__ int2 blas_sun(const MeshTablesOf<Q>&, float3v) const {
    return {0, 0};
  }
  __device__ __forceinline__ int tlas() const { return 0; }
  __device__ __forceinline__ int tlas_sun() const { return 0; }
};

// Octants: the octant-ordered tables of one packet of the launch. A BLAS
// walk reads table o at rows o N and enters at node 1 (node 0 when N = 1);
// its octant is the packet's vote for the instance row (slot_octants[k],
// the votes of the object-space directions; nullptr where N = 1, whose
// eight tables are one node alike), or the sun's own in object space. The
// TLAS rows come from the caller: the packet's world vote times M, 0 where
// the TLAS stays canonical (the pool).
struct Octants {
  const uint8_t* slot_octants;
  int tlas_row;
  int tlas_sun_row;
  template <int Q>
  __device__ __forceinline__ int2 blas(const MeshTablesOf<Q>& m, int k) const {
    const int octant = slot_octants == nullptr ? 0 : slot_octants[k];
    return {octant * m.n_nodes, m.n_nodes > 1 ? 1 : 0};
  }
  template <int Q>
  __device__ __forceinline__ int2 blas_sun(const MeshTablesOf<Q>& m, float3v ld) const {
    return {octant_of(ld) * m.n_nodes, m.n_nodes > 1 ? 1 : 0};
  }
  __device__ __forceinline__ int tlas() const { return tlas_row; }
  __device__ __forceinline__ int tlas_sun() const { return tlas_sun_row; }
};

// Nearest hit of one object-space ray (lo, ld) in the BVH of `instance`:
// nodes in DFS preorder from node `entry` of the table at rows `base` (the
// canonical table: 0, 0; skip links are local to a table, so only the
// reads add the base), each culled by its box against best.t, and each
// triangle hit strictly nearer than best.t makes best = {t, instance, row}
// (the first row of a leaf reaching the minimum wins).
template <int Q>
__device__ __forceinline__ void blas_nearest(const MeshTablesOf<Q>& m, float3v lo, float3v ld,
                                             int instance, MeshHit& best, int base = 0,
                                             int entry = 0) {
  const float3v linv = winv3(ld);
  int node = entry;
  while (node < m.n_nodes) {
    const int4 link = m.nodes.link(base + node);
    if (!m.nodes.box(base + node, lo, linv, best.t)) {
      node = link.x;
    } else if (link.z > 0) {
      for (int r = link.y; r < link.y + link.z; ++r) {
        float t;
        if (triangle_hit(m.tris + 4 * r, lo, ld, &t) && t < best.t) best = {t, instance, r};
      }
      node = link.x;
    } else {
      node = node + 1;
    }
  }
}

// Any triangle of the BVH ahead of the object-space ray (lo, ld) (t > EPS,
// unbounded)? The walk ends at the first one found; it takes the table of
// order.blas_sun(m, ld).
template <typename Order = Canonical, int Q = 0>
__device__ __forceinline__ bool blas_occluded(const MeshTablesOf<Q>& m, float3v lo, float3v ld,
                                              const Order& order = Order()) {
  const int2 at = order.blas_sun(m, ld);
  const int base = at.x;
  const float3v linv = winv3(ld);
  int node = at.y;
  while (node < m.n_nodes) {
    const int4 link = m.nodes.link(base + node);
    if (!m.nodes.box(base + node, lo, linv, path::kInf)) {
      node = link.x;
    } else if (link.z > 0) {
      for (int r = link.y; r < link.y + link.z; ++r) {
        float t;
        if (triangle_hit(m.tris + 4 * r, lo, ld, &t)) return true;
      }
      node = link.x;
    } else {
      node = node + 1;
    }
  }
  return false;
}

// Nearest hit over instances [first, first + count), seeded with t_seed
// (strict < updates); `instance` is the winning row of the whole table.
template <typename Order = Canonical, int Q = 0>
__device__ __forceinline__ MeshHit nearest(const MeshTablesOf<Q>& m, int first, int count,
                                           float3v o, float3v d, float t_seed,
                                           const Order& order = Order()) {
  MeshHit best = {t_seed, -1, 0};
  const float3v inv = winv3(d);
  for (int k = first; k < first + count; ++k) {
    const float* inst = m.inst + kInstanceWidth * k;
    if (!world_box(inst, o, inv, best.t)) continue;
    const int2 at = order.blas(m, k);
    blas_nearest(m, point_to_object(inst, o), to_object(inst, d.x, d.y, d.z), k, best, at.x,
                 at.y);
  }
  return best;
}

// Any triangle of instances [first, first + count) ahead of the shadow
// origin along `sun` (the sun's direction, or a unit kernel's ray's own)?
template <typename Order = Canonical, int Q = 0>
__device__ __forceinline__ bool occluded(const MeshTablesOf<Q>& m, int first, int count,
                                         float3v so, float3v sun, const Order& order = Order()) {
  const float3v inv = winv3(sun);
  for (int k = first; k < first + count; ++k) {
    const float* inst = m.inst + kInstanceWidth * k;
    if (!world_box(inst, so, inv, path::kInf)) continue;
    if (blas_occluded(m, point_to_object(inst, so), to_object(inst, sun.x, sun.y, sun.z),
                      order)) {
      return true;
    }
  }
  return false;
}

// The flat instance sweep: instances [first, first + count) in table order.
template <typename Order = Canonical>
struct FlatInstances {
  int first;
  int count;
  Order order;
  template <int Q>
  __device__ __forceinline__ MeshHit nearest(const MeshTablesOf<Q>& m, float3v o, float3v d,
                                             float t_seed) const {
    return mesh::nearest(m, first, count, o, d, t_seed, order);
  }
  template <int Q>
  __device__ __forceinline__ bool occluded(const MeshTablesOf<Q>& m, float3v so,
                                           float3v sun) const {
    return mesh::occluded(m, first, count, so, sun, order);
  }
};

// ---------------------------------------------------------------------------
// The two-level walk (TLAS): a threaded tree over the instance table's
// slots, whose leaves hold contiguous slot ranges, in _pack_bvh's layout
// (kernels.tlas_links: a pool stacks one window of nodes per frame, its
// skip links and leaf starts offset into the stacked rows).

template <int Q>
struct TlasTablesOf {
  Nodes<Q> nodes;  // [M]; a leaf's first and count are its slot range
  int n_nodes;  // M (a pool: per frame)
  int n_rows;  // the stacked rows (a pool: frames x M)
};

using TlasTables = TlasTablesOf<0>;

// THE threaded walk of nodes [node, node_end), shared by the nearest and
// the shadow walks (the reference's `tlas_walk`): a node whose box
// the ray misses, or enters at or past limit(), is skipped with its subtree;
// a leaf's slot range goes to leaf(first, end), which returns true to end
// the walk. The nodes are read at rows `base` + node (an octant table).
template <int Q, typename Limit, typename Leaf>
__device__ __forceinline__ void tlas_walk(const TlasTablesOf<Q>& t, int node, int node_end,
                                          float3v o, float3v inv, Limit limit, Leaf leaf,
                                          int base = 0) {
  while (node < node_end) {
    const int4 link = t.nodes.link(base + node);
    if (!t.nodes.box(base + node, o, inv, limit())) {
      node = link.x;
    } else if (link.z > 0) {
      if (leaf(link.y, link.y + link.z)) return;
      node = link.x;
    } else {
      node = node + 1;
    }
  }
}

// The two-level walk over nodes [node0, node_end).
template <typename Order = Canonical, int Q = 0>
struct TlasInstances {
  TlasTablesOf<Q> tlas;
  int node0;
  int node_end;
  Order order;

  // Nearest hit, seeded with t_seed: each node culled by its box against
  // best.t, then a leaf's slots as the flat sweep tests an instance.
  __device__ __forceinline__ MeshHit nearest(const MeshTablesOf<Q>& m, float3v o, float3v d,
                                             float t_seed) const {
    MeshHit best = {t_seed, -1, 0};
    const float3v inv = winv3(d);
    tlas_walk(
        tlas, node0, node_end, o, inv, [&] { return best.t; },
        [&](int first, int end) {
          for (int k = first; k < end; ++k) {
            const float* inst = m.inst + kInstanceWidth * k;
            if (!world_box(inst, o, inv, best.t)) continue;
            const int2 at = order.blas(m, k);
            blas_nearest(m, point_to_object(inst, o), to_object(inst, d.x, d.y, d.z), k, best,
                         at.x, at.y);
          }
          return false;
        },
        order.tlas());
    return best;
  }

  // Any triangle ahead of the shadow origin along `sun`: unbounded node
  // tests, the walk ending at the first occluder.
  __device__ __forceinline__ bool occluded(const MeshTablesOf<Q>& m, float3v so,
                                           float3v sun) const {
    const float3v inv = winv3(sun);
    bool hit = false;
    tlas_walk(
        tlas, node0, node_end, so, inv, [] { return path::kInf; },
        [&](int first, int end) {
          for (int k = first; k < end; ++k) {
            const float* inst = m.inst + kInstanceWidth * k;
            if (!world_box(inst, so, inv, path::kInf)) continue;
            if (blas_occluded(m, point_to_object(inst, so), to_object(inst, sun.x, sun.y, sun.z),
                              order)) {
              hit = true;
              return true;
            }
          }
          return false;
        },
        order.tlas_sun());
    return hit;
  }
};

// The reference's Morton dilation of the key (`morton_dilate5`): the low 5
// bits of v to every third bit.
__device__ __forceinline__ uint32_t dilate5(uint32_t v) {
  v = (v | (v << 8)) & 0x0300Fu;
  v = (v | (v << 4)) & 0x030C3u;
  return (v | (v << 2)) & 0x09249u;
}

__device__ __forceinline__ uint32_t key_cell(float p, float lo, float inv) {
  return static_cast<uint32_t>(static_cast<int>(fminf(fmaxf((p - lo) * inv * 32.0f, 0.0f), 31.0f)));
}

// The coherence sort key of a lane's state (`coherence_key_u32`), bit for
// bit: p = o + d; LSB to MSB the direction octant [0:3), the 5-bit Morton
// cell of p in the key window (lo[3], 1/span[3]) [3:18), the candidate
// clamped to 63 [18:24), the frame id clamped to 31 [24:29), the dead flag
// at bit 29.
__device__ __forceinline__ int coherence_key(float3v o, float3v d, bool dead, int fid,
                                             int candidate, const float* window) {
  const uint32_t morton = dilate5(key_cell(o.x + d.x, window[0], window[3])) |
                          (dilate5(key_cell(o.y + d.y, window[1], window[4])) << 1) |
                          (dilate5(key_cell(o.z + d.z, window[2], window[5])) << 2);
  const uint32_t octant = (d.x > 0.0f ? 1u : 0u) | (d.y > 0.0f ? 2u : 0u) | (d.z > 0.0f ? 4u : 0u);
  const uint32_t cand = min(static_cast<uint32_t>(candidate), 63u);
  const uint32_t frame = min(static_cast<uint32_t>(fid), 31u);
  return static_cast<int>(octant | (morton << 3) | (cand << 18) | (frame << 24) |
                          (dead ? 1u << 29 : 0u));
}

// One bounce of a mesh-scene path, in the reference's order: nearest sphere
// and ground-plane hit, then the nearest instance hit seeded with that t;
// sky on escape; emission and albedo of the sphere, plane or instance hit;
// sun NEE with the sphere any-hit and the mesh any-hit; cosine resample.
// Same contract as path::sphere_bounce: adds into rad, advances o, d and
// thr, and returns false (leaving o, d and thr) when the path escaped. The
// path sees spheres [sphere_first, sphere_first + n_spheres) and the
// instances `instances` walks (FlatInstances or TlasInstances, or a group
// walk). `hit_instance`, where given, receives the instance row of m that
// the nearest hit took, -1 where no instance won (the packed-key rule's
// slot).
template <typename Scene, int Q, typename Instances>
__device__ __forceinline__ bool bounce(const Scene& scene, int sphere_first, int n_spheres,
                                       const MeshTablesOf<Q>& mesh, const Instances& instances,
                                       uint32_t lane, int bounce_index, uint32_t counter_stride,
                                       uint32_t seed, float3v& o, float3v& d, float3v& thr,
                                       float3v& rad, int* hit_instance = nullptr) {
  const float3v sun = {scene.params[0], scene.params[1], scene.params[2]};
  int idx;
  const float t_sphere = path::nearest_sphere(scene, sphere_first, n_spheres, o, d, &idx);
  const float t_plane = path::plane_hit(o, d);
  const float t_sp = fminf(t_sphere, t_plane);
  const MeshHit hit = instances.nearest(mesh, o, d, t_sp);
  if (hit_instance != nullptr) *hit_instance = hit.instance;
  const bool is_mesh = hit.instance >= 0;
  const bool is_plane = !is_mesh && t_plane < t_sphere;
  const float t = is_mesh ? hit.t : t_sp;

  if (!(t < path::kInf)) {
    path::add_sky(scene, d, thr, &rad);
    return false;
  }

  const float3v p = {fmaf(d.x, t, o.x), fmaf(d.y, t, o.y), fmaf(d.z, t, o.z)};
  float3v normal, albedo;
  if (is_mesh) {
    // The winning row's object normal to world space (w = R n), turned
    // toward the incoming ray, and the instance's albedo.
    const float* inst = mesh.inst + kInstanceWidth * hit.instance;
    const float4 n = mesh.tris[4 * hit.row + 3];
    normal = {sum3(inst[0], n.x, inst[1], n.y, inst[2], n.z),
              sum3(inst[3], n.x, inst[4], n.y, inst[5], n.z),
              sum3(inst[6], n.x, inst[7], n.y, inst[8], n.z)};
    if (!(sum3(normal.x, d.x, normal.y, d.y, normal.z, d.z) < 0.0f)) {
      normal = {-normal.x, -normal.y, -normal.z};
    }
    albedo = {inst[19], inst[20], inst[21]};
  } else if (is_plane) {
    normal = {0.0f, 1.0f, 0.0f};
    albedo = path::plane_albedo(scene, p);
  } else {
    path::shade_sphere(scene, idx, p, thr, &rad, &normal, &albedo);
  }

  const float3v so = {fmaf(normal.x, path::kOffset, p.x), fmaf(normal.y, path::kOffset, p.y),
                      fmaf(normal.z, path::kOffset, p.z)};
  const float cos_sun =
      fmaxf(path::dot3(normal.x, normal.y, normal.z, sun.x, sun.y, sun.z), 0.0f);
  if (cos_sun > 0.0f && !path::sphere_shadowed(scene, sphere_first, n_spheres, so) &&
      !instances.occluded(mesh, so, sun)) {
    path::add_direct(scene, albedo, cos_sun, thr, &rad);
  }

  thr = {thr.x * albedo.x, thr.y * albedo.y, thr.z * albedo.z};
  d = path::resample(normal, lane, bounce_index, counter_stride, seed);
  o = so;
  return true;
}

// ---------------------------------------------------------------------------
// The packet vote inside a block (the megakernels trace_fused_mesh.cu and
// trace_fused_mesh_tlas.cu, whose block of threads is the reference's packet
// of lanes): every thread of the block calls these together, each with the
// direction its lane carries (a finished path's last one, a lane past the
// launch the reference's pad direction (0, 1, 0)).

// The block's octant of the directions d: bit i set when strictly more
// than half of its threads (at most 512) have component i > 0
// (`_octant_of`). One barrier: each warp adds its counts of the three axes,
// in fields of 10 bits of one sum, to counters[round % 3], and thread 0
// clears the counter of the next round, which every thread read before the
// last round's barrier. `counters`: 3 ints of shared memory, zero before
// round 0; `round` counts the block's votes from 0.
__device__ __forceinline__ int block_octant(float3v d, int* counters, int round) {
  const unsigned packed =
      (d.x > 0.0f ? 1u : 0u) | (d.y > 0.0f ? 1u << 10 : 0u) | (d.z > 0.0f ? 1u << 20 : 0u);
  const unsigned warp_sum = __reduce_add_sync(0xffffffffu, packed);
  if ((threadIdx.x & 31u) == 0) atomicAdd(&counters[round % 3], static_cast<int>(warp_sum));
  if (threadIdx.x == 0) counters[(round + 1) % 3] = 0;
  __syncthreads();
  const unsigned sum = static_cast<unsigned>(counters[round % 3]);
  const unsigned n = blockDim.x;
  return (2 * (sum & 1023u) > n ? 1 : 0) | (2 * ((sum >> 10) & 1023u) > n ? 2 : 0) |
         (2 * ((sum >> 20) & 1023u) > n ? 4 : 0);
}

// The block's octant of d in the object space of each instance row k of m
// (to_object, as the walk takes it) into octants[k]; counts, 3 K ints of
// shared memory, are zero on entry and on return. Each warp sums a row's
// positive components (the three axes in fields of 10 bits of one sum) and
// adds them in.
template <int Q>
__device__ __forceinline__ void block_instance_octants(const MeshTablesOf<Q>& m, float3v d,
                                                       int* counts, uint8_t* octants) {
  const bool leader = (threadIdx.x & 31u) == 0;
  for (int k = 0; k < m.n_instances; ++k) {
    const float3v od = to_object(m.inst + kInstanceWidth * k, d.x, d.y, d.z);
    const unsigned packed =
        (od.x > 0.0f ? 1u : 0u) | (od.y > 0.0f ? 1u << 10 : 0u) | (od.z > 0.0f ? 1u << 20 : 0u);
    const unsigned sum = __reduce_add_sync(0xffffffffu, packed);
    if (leader) {
      atomicAdd(&counts[3 * k + 0], static_cast<int>(sum & 1023u));
      atomicAdd(&counts[3 * k + 1], static_cast<int>((sum >> 10) & 1023u));
      atomicAdd(&counts[3 * k + 2], static_cast<int>(sum >> 20));
    }
  }
  __syncthreads();
  const int n = static_cast<int>(blockDim.x);
  for (int k = threadIdx.x; k < m.n_instances; k += blockDim.x) {
    octants[k] = static_cast<uint8_t>((2 * counts[3 * k + 0] > n ? 1 : 0) |
                                      (2 * counts[3 * k + 1] > n ? 2 : 0) |
                                      (2 * counts[3 * k + 2] > n ? 4 : 0));
    counts[3 * k + 0] = counts[3 * k + 1] = counts[3 * k + 2] = 0;
  }
  __syncthreads();
}

// The packet votes of the vote pass (packet_octants.cu) and of the TLAS
// megakernel (trace_fused_mesh_tlas.cu), whose threads count several lanes
// each: a direction's positive components as 1s in three fields of 10 bits
// (summed over a packet of at most 1,023 lanes in one int), and the octant
// of such counts over a packet of n lanes.
__device__ __forceinline__ unsigned positive_bits(float3v v) {
  return (v.x > 0.0f ? 1u : 0u) | (v.y > 0.0f ? 1u << 10 : 0u) | (v.z > 0.0f ? 1u << 20 : 0u);
}

__device__ __forceinline__ uint8_t octant_of_counts(unsigned counts, int n) {
  return static_cast<uint8_t>((2 * static_cast<int>(counts & 1023u) > n ? 1 : 0) |
                              (2 * static_cast<int>((counts >> 10) & 1023u) > n ? 2 : 0) |
                              (2 * static_cast<int>((counts >> 20) & 1023u) > n ? 4 : 0));
}

// A packet's vote counted in shared memory by several warps, each adding
// the sum of its lanes' positive_bits (each field at most 32): N lanes in
// kWords words. Below 1,024 lanes one word of 10-bit fields; a packet of
// 1,024 lanes, whose counts reach 1,024, keeps x and y in 16-bit fields of
// one word and z in a second (as packet_octants.cu's warp_octant).
template <int N>
struct PacketCounts {
  static constexpr int kWords = N < 1024 ? 1 : 2;

  __device__ static __forceinline__ void add(unsigned* words, unsigned warp_sum) {
    if constexpr (kWords == 1) {
      atomicAdd(words, warp_sum);
    } else {
      atomicAdd(words, (warp_sum & 1023u) | (((warp_sum >> 10) & 1023u) << 16));
      atomicAdd(words + 1, warp_sum >> 20);
    }
  }

  __device__ static __forceinline__ uint8_t octant(const unsigned* words) {
    if constexpr (kWords == 1) {
      return octant_of_counts(words[0], N);
    } else {
      const int cx = static_cast<int>(words[0] & 0xffffu), cy = static_cast<int>(words[0] >> 16);
      const int cz = static_cast<int>(words[1]);
      return static_cast<uint8_t>((2 * cx > N ? 1 : 0) | (2 * cy > N ? 2 : 0) |
                                  (2 * cz > N ? 4 : 0));
    }
  }
};

// The position of the n-th set bit of `bits` (n from 0, below its popc).
__device__ __forceinline__ int nth_bit(unsigned bits, int n) {
  int at = 0;
#pragma unroll
  for (int width = 16; width > 0; width >>= 1) {
    const int low = __popc(bits & ((1u << width) - 1u));
    if (n >= low) {
      n -= low;
      bits >>= width;
      at += width;
    }
  }
  return at;
}

// Bytes of the per-instance vote's shared memory (counts, then octants), 0
// where no vote is taken.
inline size_t instance_vote_bytes(bool votes, int n_instances) {
  if (!votes) return 0;
  return ((sizeof(int) * 3 + 1) * static_cast<size_t>(n_instances) + 15) &
         ~static_cast<size_t>(15);
}

// The dynamic shared memory of a megakernel launch: its tables (`bytes`,
// staged when they fit in kMaxStagedBytes beside the vote's `vote_bytes`)
// and the vote's counters after them, at *vote_offset; the kernel's limit
// raised where needed (path::allow_shared).
template <typename Kernel>
inline cudaError_t megakernel_shared(Kernel kernel, size_t bytes, size_t vote_bytes,
                                     size_t* shared_bytes, bool* staged, size_t* vote_offset) {
  const size_t tables = (bytes + 15) & ~static_cast<size_t>(15);
  *staged = tables + vote_bytes <= static_cast<size_t>(path::kMaxStagedBytes);
  *vote_offset = *staged ? tables : 0;
  *shared_bytes = *vote_offset + vote_bytes;
  return path::allow_shared(kernel, *shared_bytes);
}

// ---------------------------------------------------------------------------
// Bulk staging (mesh_bounce_tlas.cu, pool_mesh_bounce_tlas.cu,
// intersect_instances.cu, occluded_instances.cu): contiguous
// table ranges copied from global into shared memory by Hopper's bulk
// asynchronous copy (cp.async.bulk), issued by one thread and completed on
// one mbarrier, in place of a copy loop over the whole block. A bulk copy
// moves a 16-byte-aligned range whose size is a multiple of 16; a range here
// only needs 4-byte alignment (a slot row is 88 bytes), so its ragged ends
// (under 16 bytes each) are copied word by word by the block's threads and
// its staged copy keeps the source's offset modulo 16: range i lands at
// region_i + (src_i % 16), each region stage_region(bytes) long.

struct Range {
  char* region;  // in shared memory, 16-byte aligned
  const char* src;  // in global memory, 4-byte aligned
  uint32_t bytes;  // a multiple of 4; 0: nothing to stage

  // Where the range's copy lands.
  __device__ __forceinline__ char* staged() const {
    return region + (reinterpret_cast<uintptr_t>(src) & 15u);
  }
  // [lo, hi): the part of the range a bulk copy moves (offsets into it).
  __device__ __forceinline__ void middle(uint32_t* lo, uint32_t* hi) const {
    const uint32_t offset = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(src) & 15u);
    const uint32_t head = (16u - offset) & 15u;
    const uint32_t tail = static_cast<uint32_t>((reinterpret_cast<uintptr_t>(src) + bytes) & 15u);
    *lo = min(head, bytes);
    *hi = max(*lo, bytes - min(tail, bytes));
  }
};

// Shared-memory bytes to reserve for `bytes` staged at any 4-byte offset.
__host__ __device__ inline size_t stage_region(size_t bytes) { return (bytes + 15) / 16 * 16 + 16; }

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Stage the N ranges; every thread of the block takes part, and the copies
// are complete and visible to the whole block on return.
template <int N>
__device__ __forceinline__ void stage_ranges(const Range (&ranges)[N], uint64_t* barrier) {
  const uint32_t bar = shared_address(barrier);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t total = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      uint32_t lo, hi;
      ranges[i].middle(&lo, &hi);
      total += hi - lo;
    }
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(total)
                 : "memory");
#pragma unroll
    for (int i = 0; i < N; ++i) {
      uint32_t lo, hi;
      ranges[i].middle(&lo, &hi);
      if (hi > lo) {
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
            "[%3];\n" ::"r"(shared_address(ranges[i].staged() + lo)),
            "l"(reinterpret_cast<uint64_t>(ranges[i].src + lo)), "r"(hi - lo), "r"(bar)
            : "memory");
      }
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint32_t lo, hi;
    ranges[i].middle(&lo, &hi);
    char* dst = ranges[i].staged();
    const uint32_t ends = lo + (ranges[i].bytes - hi);  // the ragged words, head then tail
    for (uint32_t w = 4 * threadIdx.x; w < ends; w += 4 * blockDim.x) {
      const uint32_t at = w < lo ? w : hi + (w - lo);
      *reinterpret_cast<uint32_t*>(dst + at) =
          *reinterpret_cast<const uint32_t*>(ranges[i].src + at);
    }
  }
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar)
        : "memory");
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// The group walk (mesh_bounce_tlas.cu, pool_mesh_bounce_tlas.cu and, over
// the flat sweep, intersect_instances.cu and occluded_instances.cu): G
// threads of a warp (G = 1, 2, 4 or 8, an aligned run of lanes) share one
// ray. They follow the same node sequence of the TLAS walk and of every BLAS
// walk and split the work of a leaf: a BLAS leaf's triangle rows and a TLAS
// leaf's slots' world-box tests (the flat sweep: one leaf of all K slots)
// go to the G threads strided. A nearest walk's
// threads each keep their first minimum of the leaf (strict `<`, the group's
// best t as seed) and reduce it by (t, slot, row) through __shfl_xor_sync
// before the next node test; a leaf's slots are entered in order, each
// against the group's best t so far; the any-hit walk ends on an any-vote of
// the group; the entry walk reduces by (entry, slot). The sequential walk
// (TlasInstances) reduces a leaf to its minimum t, the first row winning a
// tie, and culls each node with the best t after the last leaf, so the
// group visits the same nodes and finds the same hit, row and candidate,
// ties included. Every thread of a group computes the ray's bounce, so all
// hold the same state; one thread stores it.

template <int G>
struct Group {
  static_assert(G == 1 || G == 2 || G == 4 || G == 8, "a group is 1, 2, 4 or 8 threads");
  unsigned mask;  // the group's lanes in the warp
  int rank;  // this thread's place in the group

  __device__ __forceinline__ static Group of_thread() {
    const int lane = static_cast<int>(threadIdx.x & 31u);
    return {((1u << G) - 1u) << (lane & ~(G - 1)), lane & (G - 1)};
  }
  __device__ __forceinline__ bool any(bool p) const {
    if (G == 1) return p;
    return __any_sync(mask, p) != 0;
  }
  template <typename T>
  __device__ __forceinline__ T exchange(T v, int offset) const {
    return __shfl_xor_sync(mask, v, offset, G);
  }
  template <typename T>
  __device__ __forceinline__ T from(T v, int src) const {
    if (G == 1) return v;
    return __shfl_sync(mask, v, src, G);
  }
  // The group's least (t, instance, row); every thread gets it.
  __device__ __forceinline__ void least(MeshHit& h) const {
    for (int offset = G / 2; offset > 0; offset >>= 1) {
      const float t = exchange(h.t, offset);
      const int k = exchange(h.instance, offset);
      const int r = exchange(h.row, offset);
      if (t < h.t || (t == h.t && (k < h.instance || (k == h.instance && r < h.row)))) {
        h = {t, k, r};
      }
    }
  }
  // The group's least (entry, slot).
  __device__ __forceinline__ void least(float& entry, int& slot) const {
    for (int offset = G / 2; offset > 0; offset >>= 1) {
      const float e = exchange(entry, offset);
      const int k = exchange(slot, offset);
      if (e < entry || (e == entry && k < slot)) {
        entry = e;
        slot = k;
      }
    }
  }
};

// blas_nearest with the group: best is the group's on entry and on return.
template <int G, int Q>
__device__ __forceinline__ void group_blas_nearest(const Group<G>& g, const MeshTablesOf<Q>& m,
                                                   float3v lo, float3v ld, int instance,
                                                   MeshHit& best, int base = 0, int entry = 0) {
  const float3v linv = winv3(ld);
  int node = entry;
  while (node < m.n_nodes) {
    const int4 link = m.nodes.link(base + node);
    if (!m.nodes.box(base + node, lo, linv, best.t)) {
      node = link.x;
    } else if (link.z > 0) {
      MeshHit mine = best;
      for (int r = link.y + g.rank; r < link.y + link.z; r += G) {
        float t;
        if (triangle_hit(m.tris + 4 * r, lo, ld, &t) && t < mine.t) mine = {t, instance, r};
      }
      g.least(mine);
      best = mine;
      node = link.x;
    } else {
      node = node + 1;
    }
  }
}

// blas_occluded with the group.
template <int G, typename Order = Canonical, int Q = 0>
__device__ __forceinline__ bool group_blas_occluded(const Group<G>& g, const MeshTablesOf<Q>& m,
                                                    float3v lo, float3v ld,
                                                    const Order& order = Order()) {
  const int2 at = order.blas_sun(m, ld);
  const int base = at.x;
  const float3v linv = winv3(ld);
  int node = at.y;
  while (node < m.n_nodes) {
    const int4 link = m.nodes.link(base + node);
    if (!m.nodes.box(base + node, lo, linv, path::kInf)) {
      node = link.x;
    } else if (link.z > 0) {
      bool hit = false;
      for (int r = link.y + g.rank; r < link.y + link.z && !hit; r += G) {
        float t;
        hit = triangle_hit(m.tris + 4 * r, lo, ld, &t);
      }
      if (g.any(hit)) return true;
      node = link.x;
    } else {
      node = node + 1;
    }
  }
  return false;
}

// A slot's world box against a ray, all of the slab test but the limit:
// the box is hit when `reached` and near < limit.
__device__ __forceinline__ void slot_box(const float* inst, float3v o, float3v inv, bool* reached,
                                         float* near) {
  const float lox = (inst[13] - o.x) * inv.x, hix = (inst[16] - o.x) * inv.x;
  const float loy = (inst[14] - o.y) * inv.y, hiy = (inst[17] - o.y) * inv.y;
  const float loz = (inst[15] - o.z) * inv.z, hiz = (inst[18] - o.z) * inv.z;
  const float tnear = fmaxf(fmaxf(fminf(lox, hix), fminf(loy, hiy)), fminf(loz, hiz));
  const float tfar = fminf(fminf(fmaxf(lox, hix), fmaxf(loy, hiy)), fmaxf(loz, hiz));
  *reached = tfar >= fmaxf(tnear, 0.0f);
  *near = tnear;
}

// Slots [first, end) of one leaf by a group, the flat sweep's and a TLAS
// leaf's loop: each chunk of G slots has its world boxes tested one a thread
// (slot_box, no limit), then the group enters the chunk's reached slots in
// order, each against the group's best t so far. Slot k's row is at
// m.inst + 22 (k - slot_base); a hit's `instance` is k - slot_base.
template <int G, typename Order = Canonical, int Q = 0>
__device__ __forceinline__ void group_slots_nearest(const Group<G>& g, const MeshTablesOf<Q>& m,
                                                    int first, int end, int slot_base, float3v o,
                                                    float3v d, float3v inv, MeshHit& best,
                                                    const Order& order = Order()) {
  for (int chunk = first; chunk < end; chunk += G) {
    bool reached = false;
    float near = 0.0f;
    if (chunk + g.rank < end) {
      slot_box(m.inst + kInstanceWidth * (chunk + g.rank - slot_base), o, inv, &reached, &near);
    }
    for (int j = 0; j < G && chunk + j < end; ++j) {
      const bool hit_box = g.from(static_cast<int>(reached), j) != 0;
      const float box_near = g.from(near, j);
      if (!(hit_box && box_near < best.t)) continue;
      const float* inst = m.inst + kInstanceWidth * (chunk + j - slot_base);
      const int2 at = order.blas(m, chunk + j);
      group_blas_nearest(g, m, point_to_object(inst, o), to_object(inst, d.x, d.y, d.z),
                         chunk + j - slot_base, best, at.x, at.y);
    }
  }
}

// The any-hit over slots [first, end) by a group: true at the first occluder.
template <int G, typename Order = Canonical, int Q = 0>
__device__ __forceinline__ bool group_slots_occluded(const Group<G>& g, const MeshTablesOf<Q>& m,
                                                     int first, int end, int slot_base,
                                                     float3v so, float3v sun, float3v inv,
                                                     const Order& order = Order()) {
  for (int chunk = first; chunk < end; chunk += G) {
    bool reached = false;
    float near = 0.0f;
    if (chunk + g.rank < end) {
      slot_box(m.inst + kInstanceWidth * (chunk + g.rank - slot_base), so, inv, &reached, &near);
    }
    for (int j = 0; j < G && chunk + j < end; ++j) {
      const bool hit_box = g.from(static_cast<int>(reached), j) != 0;
      const float box_near = g.from(near, j);
      if (!(hit_box && box_near < path::kInf)) continue;
      const float* inst = m.inst + kInstanceWidth * (chunk + j - slot_base);
      if (group_blas_occluded(g, m, point_to_object(inst, so),
                              to_object(inst, sun.x, sun.y, sun.z), order)) {
        return true;
      }
    }
  }
  return false;
}

// The flat sweep by a group: instances [first, first + count) in table
// order, one leaf of `count` slots; bit for bit FlatInstances, which a
// group of one thread runs itself (the same walk in fewer registers).
template <int G>
struct GroupFlat {
  Group<G> g;
  int first;
  int count;

  template <int Q>
  __device__ __forceinline__ MeshHit nearest(const MeshTablesOf<Q>& m, float3v o, float3v d,
                                             float t_seed) const {
    if constexpr (G == 1) {
      return mesh::nearest(m, first, count, o, d, t_seed);
    } else {
      MeshHit best = {t_seed, -1, 0};
      group_slots_nearest(g, m, first, first + count, 0, o, d, winv3(d), best);
      return best;
    }
  }

  template <int Q>
  __device__ __forceinline__ bool occluded(const MeshTablesOf<Q>& m, float3v so,
                                           float3v sun) const {
    if constexpr (G == 1) {
      return mesh::occluded(m, first, count, so, sun);
    } else {
      return group_slots_occluded(g, m, first, first + count, 0, so, sun, winv3(sun));
    }
  }
};

// The two-level walk of one frame's TLAS window by a group: nodes [node0,
// node_end) of the stacked TLAS rows, node n at row n - node_base of
// `nodes` (an octant table's: at order.tlas() + n - node_base); slot k's row
// at mesh.inst + 22 (k - slot_base). A staged copy of a range of frames sets
// the bases to its first frame's rows; a hit's `instance` is k - slot_base,
// the row of mesh.inst that mesh::bounce shades.
template <int G, typename Order = Canonical, int Q = 0>
struct GroupTlas {
  Group<G> g;
  Nodes<Q> nodes;
  int node_base;
  int slot_base;
  int node0;
  int node_end;
  Order order;

  __device__ __forceinline__ const float* slot(const MeshTablesOf<Q>& m, int k) const {
    return m.inst + kInstanceWidth * (k - slot_base);
  }

  __device__ __forceinline__ MeshHit nearest(const MeshTablesOf<Q>& m, float3v o, float3v d,
                                             float t_seed) const {
    MeshHit best = {t_seed, -1, 0};
    const float3v inv = winv3(d);
    const int row = order.tlas() - node_base;
    int node = node0;
    while (node < node_end) {
      const int4 link = nodes.link(row + node);
      if (!nodes.box(row + node, o, inv, best.t)) {
        node = link.x;
        continue;
      }
      group_slots_nearest(g, m, link.y, link.y + link.z, slot_base, o, d, inv, best, order);
      node = link.z > 0 ? link.x : node + 1;
    }
    return best;
  }

  __device__ __forceinline__ bool occluded(const MeshTablesOf<Q>& m, float3v so,
                                           float3v sun) const {
    const float3v inv = winv3(sun);
    const int row = order.tlas_sun() - node_base;
    int node = node0;
    while (node < node_end) {
      const int4 link = nodes.link(row + node);
      if (!nodes.box(row + node, so, inv, path::kInf)) {
        node = link.x;
        continue;
      }
      if (group_slots_occluded(g, m, link.y, link.y + link.z, slot_base, so, sun, inv, order)) {
        return true;
      }
      node = link.z > 0 ? link.x : node + 1;
    }
    return false;
  }

  // The entry walk of the coherence key (the reference's AABB-only TLAS
  // walk, `pallas_kernels.py:2983-3065`): the slot, less slot_offset, whose
  // world box the ray enters first (entry max(near, 0), strict `<`, so the
  // first slot met wins a tie), `sentinel` where it enters none. Nodes are
  // culled against the best entry so far; no BVH is entered. The nodes are
  // read at rows `tlas_row` + n - node_base (the entry walk's own octant
  // table; 0: canonical).
  __device__ __forceinline__ int entry_candidate(const MeshTablesOf<Q>& m, float3v o, float3v d,
                                                 int slot_offset, int sentinel,
                                                 int tlas_row = 0) const {
    const float3v inv = winv3(d);
    const int row = tlas_row - node_base;
    float best_entry = path::kInf;
    int best = sentinel;
    int node = node0;
    while (node < node_end) {
      const int4 link = nodes.link(row + node);
      if (!nodes.box(row + node, o, inv, best_entry)) {
        node = link.x;
        continue;
      }
      if (link.z > 0) {
        float entry_min = best_entry;
        int slot_min = best;
        for (int k = link.y + g.rank; k < link.y + link.z; k += G) {
          bool reached;
          float near;
          slot_box(slot(m, k), o, inv, &reached, &near);
          const float entry = fmaxf(near, 0.0f);
          if (reached && entry < entry_min) {
            entry_min = entry;
            slot_min = k - slot_offset;
          }
        }
        g.least(entry_min, slot_min);
        best_entry = entry_min;
        best = slot_min;
        node = link.x;
      } else {
        node = node + 1;
      }
    }
    return best;
  }
};

// ---------------------------------------------------------------------------
// Persistent blocks (mesh_bounce_tlas.cu, intersect_instances.cu,
// occluded_instances.cu): a launch starts as many blocks as are resident at
// once (occupancy x SMs, fewer for a narrow launch); each stages its tables
// once by bulk copy, and each warp then takes the next rays from a counter
// in global memory until the launch's rays run out, so a slow warp holds no
// block slot and a launch stages its tables a few hundred times, not once
// per block of rays. The counter is a scratch int of the caller's, cleared
// on the launch's stream before the kernel.

// The staged regions of the unit kernels' tables (triangle rows, node
// bounds, node links, instance rows): byte offsets into the dynamic shared
// memory (stage_region each) and their total; all 0 where the total passes
// kMaxStagedBytes: nothing is staged and the tables are read from global
// memory.
struct MeshStaging {
  uint32_t offset[4];
  uint32_t bytes;
};

inline MeshStaging plan_mesh(int n_tri_rows, int n_nodes, int n_instances) {
  const size_t sizes[4] = {
      sizeof(float4) * 4 * static_cast<size_t>(n_tri_rows),
      sizeof(float4) * 2 * static_cast<size_t>(n_nodes),
      sizeof(int4) * static_cast<size_t>(n_nodes),
      sizeof(float) * kInstanceWidth * static_cast<size_t>(n_instances),
  };
  MeshStaging plan = {};
  size_t total = 0;
  for (int i = 0; i < 4; ++i) {
    plan.offset[i] = static_cast<uint32_t>(total);
    total += stage_region(sizes[i]);
  }
  if (total > static_cast<size_t>(path::kMaxStagedBytes)) return MeshStaging{};
  plan.bytes = static_cast<uint32_t>(total);
  return plan;
}

// Stage the tables of plan_mesh in `smem` and point `m` at the copies
// (nothing where plan.bytes is 0); every thread of the block takes part.
__device__ __forceinline__ void stage_mesh(MeshTables& m, int n_tri_rows, const MeshStaging& plan,
                                           char* smem, uint64_t* barrier) {
  if (plan.bytes == 0) return;
  const Range ranges[4] = {
      {smem + plan.offset[0], reinterpret_cast<const char*>(m.tris),
       static_cast<uint32_t>(sizeof(float4) * 4 * n_tri_rows)},
      {smem + plan.offset[1], m.nodes.part(0),
       static_cast<uint32_t>(Nodes<0>::part_bytes(0, m.n_nodes))},
      {smem + plan.offset[2], m.nodes.part(1),
       static_cast<uint32_t>(Nodes<0>::part_bytes(1, m.n_nodes))},
      {smem + plan.offset[3], reinterpret_cast<const char*>(m.inst),
       static_cast<uint32_t>(sizeof(float) * kInstanceWidth * m.n_instances)},
  };
  stage_ranges(ranges, barrier);
  m.tris = reinterpret_cast<const float4*>(ranges[0].staged());
  m.nodes.set_parts(ranges[1].staged(), ranges[2].staged());
  m.inst = reinterpret_cast<const float*>(ranges[3].staged());
}

// The first of the warp's next `count` items (every lane gets it): lane 0
// takes them from the counter.
__device__ __forceinline__ int warp_fetch(int* counter, int count) {
  int start = 0;
  if ((threadIdx.x & 31u) == 0) start = atomicAdd(counter, count);
  return __shfl_sync(0xffffffffu, start, 0);
}

// The blocks of `kernel` (a launch of `threads` threads and `bytes` of
// dynamic shared memory) resident on one SM of the current device, its
// shared-memory limit raised to kMaxStagedBytes first where that and its
// static shared memory pass the default 48 KB.
template <typename Kernel>
inline cudaError_t blocks_per_sm(Kernel kernel, int threads, uint32_t bytes, int* blocks) {
  const cudaError_t status = path::allow_shared(kernel, bytes, path::kMaxStagedBytes);
  if (status != cudaSuccess) return status;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads, bytes);
}

// The blocks of `kernel` resident on the whole card at once (blocks_per_sm
// x SMs). The runtime's queries depend on nothing else, so each (device,
// kernel, bytes) asks them once and later launches reuse the answer.
template <typename Kernel>
inline cudaError_t card_blocks(Kernel kernel, int threads, uint32_t bytes, int* blocks) {
  struct Known {
    int device;
    const void* kernel;
    uint32_t bytes;
    int blocks;
  };
  static std::mutex mutex;
  static std::vector<Known> known;
  const void* key = reinterpret_cast<const void*>(kernel);
  int device = 0;
  cudaError_t status = cudaGetDevice(&device);
  if (status != cudaSuccess) return status;
  const std::lock_guard<std::mutex> lock(mutex);
  for (const Known& k : known) {
    if (k.device == device && k.kernel == key && k.bytes == bytes) {
      *blocks = k.blocks;
      return cudaSuccess;
    }
  }
  int per_sm = 0, sms = 0;
  status = blocks_per_sm(kernel, threads, bytes, &per_sm);
  if (status == cudaSuccess) {
    status = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (status != cudaSuccess) return status;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  known.push_back({device, key, bytes, per_sm * sms});
  *blocks = per_sm * sms;
  return cudaSuccess;
}

}  // namespace mesh
