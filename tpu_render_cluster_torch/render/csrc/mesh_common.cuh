// Mesh-scene device code shared by the mesh path-trace kernels (the
// megakernel trace_fused_mesh.cu, the per-bounce kernel mesh_bounce.cu, the
// ray-pool kernel pool_mesh_bounce.cu and the bounce scan's unit kernels
// intersect_instances.cu, occluded_instances.cu, intersect_mesh.cu and
// occluded_mesh.cu): the instance and BVH tables, their staging in shared
// memory, the walk of one object-space ray through the threaded BVH
// (blas_nearest, blas_occluded), the nearest hit and the shadow any-hit over
// the rigid instances [first, first + count) of one mesh built on it (a
// frame's K instances, or a lane's own frame's rows of a pool's frame-major
// stacked table), and the whole mesh-scene bounce built from them and
// path_common.cuh.
//
// Walk order: instances in table order, nodes in canonical DFS preorder
// entered at node 0, strict `<` updates of a best t seeded with the
// sphere/plane t, the first tying row of a leaf winning. Per ray that is the
// nearest hit the reference's packet walk finds, ties aside: the TPU's
// block-wide `any` culls and its near-first instance order change which
// nodes a packet visits, never a ray's nearest hit.
//
// Rounding follows the reference's compiler as in path_common.cuh: each
// written-out sum of three products a*b + c*d + e*f is
// fma(e, f, fma(a, b, c * d)), each a*b - c*d is fma(a, b, -(c * d)), in
// the object-space transform, Moller-Trumbore and the normal rotation.

#pragma once

#include "path_common.cuh"

namespace mesh {

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

struct MeshTables {
  const float* inst;  // [K, 22]
  const float4* tris;  // [T, 4]: v0, e1, e2, normal
  const float4* bounds;  // [N, 2]: lo, hi
  const int4* links;  // [N]: skip, first, count, 0
  int n_instances;
  int n_nodes;
};

// Bytes of the tables staged in shared memory, in stage_tables' layout
// (path::staging_for decides whether they are).
__host__ __device__ inline size_t table_bytes(int n_tri_rows, int n_nodes, int n_instances) {
  return sizeof(float4) * (4 * static_cast<size_t>(n_tri_rows) + 2 * static_cast<size_t>(n_nodes)) +
         sizeof(int4) * static_cast<size_t>(n_nodes) +
         sizeof(float) * kInstanceWidth * static_cast<size_t>(n_instances);
}

// Copy the tables into `staging` (layout: triangle rows, node bounds, node
// links, instance table) and point `m` at the copies. Every thread of the
// block takes part; the caller synchronises before the tables are read.
__device__ __forceinline__ void stage_tables(MeshTables& m, float4* staging, int n_tri_rows) {
  float4* tris = staging;
  float4* bounds = tris + 4 * n_tri_rows;
  int4* links = reinterpret_cast<int4*>(bounds + 2 * m.n_nodes);
  float* inst = reinterpret_cast<float*>(links + m.n_nodes);
  for (int i = threadIdx.x; i < 4 * n_tri_rows; i += blockDim.x) tris[i] = m.tris[i];
  for (int i = threadIdx.x; i < 2 * m.n_nodes; i += blockDim.x) bounds[i] = m.bounds[i];
  for (int i = threadIdx.x; i < m.n_nodes; i += blockDim.x) links[i] = m.links[i];
  for (int i = threadIdx.x; i < kInstanceWidth * m.n_instances; i += blockDim.x) {
    inst[i] = m.inst[i];
  }
  m.tris = tris;
  m.bounds = bounds;
  m.links = links;
  m.inst = inst;
}

struct MeshHit {
  float t;  // the seed t when nothing closer was hit
  int instance;  // -1: no mesh hit closer than the seed
  int row;
};

// Nearest hit of one object-space ray (lo, ld) in the BVH of `instance`:
// nodes in DFS preorder from node 0, each culled by its box against best.t,
// and each triangle hit strictly nearer than best.t makes best = {t,
// instance, row} (the first row of a leaf reaching the minimum wins).
__device__ __forceinline__ void blas_nearest(const MeshTables& m, float3v lo, float3v ld,
                                             int instance, MeshHit& best) {
  const float3v linv = winv3(ld);
  int node = 0;
  while (node < m.n_nodes) {
    const int4 link = m.links[node];
    if (!node_box(m.bounds, node, lo, linv, best.t)) {
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
// unbounded)? The walk ends at the first one found.
__device__ __forceinline__ bool blas_occluded(const MeshTables& m, float3v lo, float3v ld) {
  const float3v linv = winv3(ld);
  int node = 0;
  while (node < m.n_nodes) {
    const int4 link = m.links[node];
    if (!node_box(m.bounds, node, lo, linv, path::kInf)) {
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
__device__ __forceinline__ MeshHit nearest(const MeshTables& m, int first, int count, float3v o,
                                           float3v d, float t_seed) {
  MeshHit best = {t_seed, -1, 0};
  const float3v inv = winv3(d);
  for (int k = first; k < first + count; ++k) {
    const float* inst = m.inst + kInstanceWidth * k;
    if (!world_box(inst, o, inv, best.t)) continue;
    blas_nearest(m, point_to_object(inst, o), to_object(inst, d.x, d.y, d.z), k, best);
  }
  return best;
}

// Any triangle of instances [first, first + count) ahead of the shadow
// origin along `sun` (the sun's direction, or a unit kernel's ray's own)?
__device__ __forceinline__ bool occluded(const MeshTables& m, int first, int count, float3v so,
                                         float3v sun) {
  const float3v inv = winv3(sun);
  for (int k = first; k < first + count; ++k) {
    const float* inst = m.inst + kInstanceWidth * k;
    if (!world_box(inst, so, inv, path::kInf)) continue;
    if (blas_occluded(m, point_to_object(inst, so), to_object(inst, sun.x, sun.y, sun.z))) {
      return true;
    }
  }
  return false;
}

// One bounce of a mesh-scene path, in the reference's order: nearest sphere
// and ground-plane hit, then the nearest instance hit seeded with that t;
// sky on escape; emission and albedo of the sphere, plane or instance hit;
// sun NEE with the sphere any-hit and the mesh any-hit; cosine resample.
// Same contract as path::sphere_bounce: adds into rad, advances o, d and
// thr, and returns false (leaving o, d and thr) when the path escaped. The
// path sees spheres [sphere_first, sphere_first + n_spheres) and instances
// [inst_first, inst_first + inst_count).
template <typename Scene>
__device__ __forceinline__ bool bounce(const Scene& scene, int sphere_first, int n_spheres,
                                       const MeshTables& mesh, int inst_first, int inst_count,
                                       uint32_t lane, int bounce_index, uint32_t counter_stride,
                                       uint32_t seed, float3v& o, float3v& d, float3v& thr,
                                       float3v& rad) {
  const float3v sun = {scene.params[0], scene.params[1], scene.params[2]};
  int idx;
  const float t_sphere = path::nearest_sphere(scene, sphere_first, n_spheres, o, d, &idx);
  const float t_plane = path::plane_hit(o, d);
  const float t_sp = fminf(t_sphere, t_plane);
  const MeshHit hit = nearest(mesh, inst_first, inst_count, o, d, t_sp);
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
      !occluded(mesh, inst_first, inst_count, so, sun)) {
    path::add_direct(scene, albedo, cos_sun, thr, &rad);
  }

  thr = {thr.x * albedo.x, thr.y * albedo.y, thr.z * albedo.z};
  d = path::resample(normal, lane, bounce_index, counter_stride, seed);
  o = so;
  return true;
}

}  // namespace mesh
