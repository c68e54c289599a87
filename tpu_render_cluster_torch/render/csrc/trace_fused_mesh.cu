// Mesh-scene path-trace megakernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `_trace_fused_mesh` / `_mesh_trace_kernel_factory`
// with state_io=False (tpu_render_cluster/render/pallas_kernels.py): one
// launch runs the whole bounce loop for every ray and writes radiance once.
// Per bounce, in the reference's order: nearest sphere and ground-plane hit
// (path_common.cuh, shared with trace_fused.cu), then the nearest hit over
// K rigid instances of one mesh, each walked through its threaded BVH
// seeded with the sphere/plane t; sky on escape; emission and albedo of
// the sphere, plane or instance hit; sun next-event estimation with the
// sphere any-hit and the mesh any-hit; and the counter-PCG cosine resample.
//
// Bound: operations. A path-bounce costs a world-AABB slab test per
// instance (about 24 flops), a transform into object space per instance it
// enters (about 40), a slab test per BVH node visited and a Moller-Trumbore
// test per triangle row (about 50), against 36 bytes of rays and radiance
// per path. Design for this card, not the TPU's block layout:
//   - one thread per ray; path state stays in registers for all bounces;
//   - the tables (spheres, the [K, 22] instance table, node bounds and
//     links, 64-byte triangle rows) are staged once per block in shared
//     memory when they fit (the box mesh is 1 KB of triangles, the
//     icosphere 26 KB), else read from device memory through L1;
//   - the TPU's block-wide `any` packet culls become per-thread tests:
//     per ray, the nearest hit does not depend on how many other rays
//     visit a node, and instances and nodes are visited in table order
//     (instances) and canonical DFS preorder entered at node 0 (nodes),
//     with strict `<` updates and the first tying row of a leaf winning;
//   - a ray whose path escaped leaves the loop, the shadow any-hits stop at
//     the first occluder and are skipped where the sun is below the
//     surface: each such term is a finite value times alive = 0 (or
//     cos = 0) in the reference, so leaving adds exactly zero.
//
// Rounding follows the reference's compiler as in path_common.cuh: each
// written-out sum of three products a*b + c*d + e*f is
// fma(e, f, fma(a, b, c * d)), each a*b - c*d is fma(a, b, -(c * d)), in
// the object-space transform, Moller-Trumbore and the normal rotation.
// Built with --fmad=false, so nvcc contracts nothing else.

#include "path_common.cuh"

namespace {

using path::float3v;
constexpr int kThreads = 256;
constexpr int kInstanceWidth = 22;
constexpr float kDetEps = 1e-12f;
// Stage the mesh tables in shared memory up to this many bytes (above 48 KB
// the launcher raises the kernel's dynamic shared-memory limit).
constexpr int kMaxStagedBytes = 96 * 1024;

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

struct MeshHit {
  float t;  // the seed t when nothing closer was hit
  int instance;  // -1: no mesh hit closer than the seed
  int row;
};

// Nearest hit over every instance, seeded with t_seed (strict < updates).
__device__ __forceinline__ MeshHit mesh_nearest(const MeshTables& m, float3v o, float3v d,
                                                float t_seed) {
  MeshHit best = {t_seed, -1, 0};
  const float3v inv = winv3(d);
  for (int k = 0; k < m.n_instances; ++k) {
    const float* inst = m.inst + kInstanceWidth * k;
    if (!world_box(inst, o, inv, best.t)) continue;
    const float3v lo = point_to_object(inst, o);
    const float3v ld = to_object(inst, d.x, d.y, d.z);
    const float3v linv = winv3(ld);
    int node = 0;
    while (node < m.n_nodes) {
      const int4 link = m.links[node];
      if (!node_box(m.bounds, node, lo, linv, best.t)) {
        node = link.x;
      } else if (link.z > 0) {
        for (int r = link.y; r < link.y + link.z; ++r) {
          float t;
          if (triangle_hit(m.tris + 4 * r, lo, ld, &t) && t < best.t) best = {t, k, r};
        }
        node = link.x;
      } else {
        node = node + 1;
      }
    }
  }
  return best;
}

// Any triangle of any instance between the shadow origin and the sun?
__device__ __forceinline__ bool mesh_occluded(const MeshTables& m, float3v so, float3v sun) {
  const float3v inv = winv3(sun);
  for (int k = 0; k < m.n_instances; ++k) {
    const float* inst = m.inst + kInstanceWidth * k;
    if (!world_box(inst, so, inv, path::kInf)) continue;
    const float3v lo = point_to_object(inst, so);
    const float3v ld = to_object(inst, sun.x, sun.y, sun.z);
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
  }
  return false;
}

__global__ void __launch_bounds__(kThreads)
trace_fused_mesh_kernel(const float* __restrict__ origins,
                        const float* __restrict__ directions, int n_rays,
                        const float4* __restrict__ spheres, int n_spheres,
                        const float* __restrict__ params, MeshTables mesh, int n_tri_rows,
                        bool staged, uint32_t seed, int max_bounces,
                        float* __restrict__ radiance_out) {
  __shared__ path::SceneShared scene;
  extern __shared__ float4 staging[];
  if (staged) {
    // Layout: triangle rows, node bounds, node links, instance table.
    float4* tris = staging;
    float4* bounds = tris + 4 * n_tri_rows;
    int4* links = reinterpret_cast<int4*>(bounds + 2 * mesh.n_nodes);
    float* inst = reinterpret_cast<float*>(links + mesh.n_nodes);
    for (int i = threadIdx.x; i < 4 * n_tri_rows; i += blockDim.x) tris[i] = mesh.tris[i];
    for (int i = threadIdx.x; i < 2 * mesh.n_nodes; i += blockDim.x) bounds[i] = mesh.bounds[i];
    for (int i = threadIdx.x; i < mesh.n_nodes; i += blockDim.x) links[i] = mesh.links[i];
    for (int i = threadIdx.x; i < kInstanceWidth * mesh.n_instances; i += blockDim.x) {
      inst[i] = mesh.inst[i];
    }
    mesh.tris = tris;
    mesh.bounds = bounds;
    mesh.links = links;
    mesh.inst = inst;
  }
  path::load_scene(scene, spheres, n_spheres, params);  // ends with __syncthreads()

  const int64_t ray = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (ray >= n_rays) return;
  const uint32_t lane = static_cast<uint32_t>(ray);
  const float3v sun = {scene.params[0], scene.params[1], scene.params[2]};

  float3v o = {origins[3 * ray + 0], origins[3 * ray + 1], origins[3 * ray + 2]};
  float3v d = {directions[3 * ray + 0], directions[3 * ray + 1], directions[3 * ray + 2]};
  float3v thr = {1.0f, 1.0f, 1.0f};
  float3v rad = {0.0f, 0.0f, 0.0f};
  const uint32_t counter_stride = 2u * static_cast<uint32_t>(max_bounces) + 2u;

  for (int bounce = 0; bounce < max_bounces; ++bounce) {
    int idx;
    const float t_sphere = path::nearest_sphere(scene, n_spheres, o, d, &idx);
    const float t_plane = path::plane_hit(o, d);
    const float t_sp = fminf(t_sphere, t_plane);
    const MeshHit hit = mesh_nearest(mesh, o, d, t_sp);
    const bool is_mesh = hit.instance >= 0;
    const bool is_plane = !is_mesh && t_plane < t_sphere;
    const float t = is_mesh ? hit.t : t_sp;

    // -- sky on escape: the path ends here -----------------------------------
    if (!(t < path::kInf)) {
      path::add_sky(scene, d, thr, &rad);
      break;
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

    // -- sun NEE: sphere any-hit, then mesh any-hit ----------------------------
    const float3v so = {fmaf(normal.x, path::kOffset, p.x), fmaf(normal.y, path::kOffset, p.y),
                        fmaf(normal.z, path::kOffset, p.z)};
    const float cos_sun = fmaxf(path::dot3(normal.x, normal.y, normal.z, sun.x, sun.y, sun.z), 0.0f);
    if (cos_sun > 0.0f && !path::sphere_shadowed(scene, n_spheres, so) &&
        !mesh_occluded(mesh, so, sun)) {
      path::add_direct(scene, albedo, cos_sun, thr, &rad);
    }

    // -- continue the path: cosine-weighted resample --------------------------
    thr = {thr.x * albedo.x, thr.y * albedo.y, thr.z * albedo.z};
    d = path::resample(normal, lane, bounce, counter_stride, seed);
    o = so;
  }

  radiance_out[3 * ray + 0] = rad.x;
  radiance_out[3 * ray + 1] = rad.y;
  radiance_out[3 * ray + 2] = rad.z;
}

}  // namespace

// Plain C entry for ctypes. Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() so the caller sees a refused launch at once.
// Tables as render/kernels.py builds them: spheres [n_spheres, 16],
// params [18], instances [n_instances, 22], triangle rows [n_tri_rows, 16],
// node bounds [n_nodes, 8] and node links [n_nodes, 4] (int32).
extern "C" int trace_fused_mesh_launch(const float* origins, const float* directions,
                                       int n_rays, const float* spheres, int n_spheres,
                                       const float* params, const float* instances,
                                       int n_instances, const float* triangles,
                                       int n_tri_rows, const float* node_bounds,
                                       const int* node_links, int n_nodes, int seed,
                                       int max_bounces, float* radiance, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaSuccess);
  if (n_spheres < 1 || n_spheres > path::kMaxSpheres || max_bounces < 0 ||
      n_instances < 0 || n_tri_rows < 1 || n_nodes < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const MeshTables mesh = {instances,
                           reinterpret_cast<const float4*>(triangles),
                           reinterpret_cast<const float4*>(node_bounds),
                           reinterpret_cast<const int4*>(node_links),
                           n_instances,
                           n_nodes};
  const size_t staged_bytes = sizeof(float4) * (4 * static_cast<size_t>(n_tri_rows) +
                                                2 * static_cast<size_t>(n_nodes)) +
                              sizeof(int4) * static_cast<size_t>(n_nodes) +
                              sizeof(float) * kInstanceWidth * static_cast<size_t>(n_instances);
  const bool staged = staged_bytes <= static_cast<size_t>(kMaxStagedBytes);
  const size_t shared_bytes = staged ? staged_bytes : 0;
  if (shared_bytes > 48 * 1024) {
    const cudaError_t status = cudaFuncSetAttribute(
        trace_fused_mesh_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared_bytes));
    if (status != cudaSuccess) return static_cast<int>(status);
  }
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  trace_fused_mesh_kernel<<<blocks, kThreads, shared_bytes,
                            static_cast<cudaStream_t>(stream)>>>(
      origins, directions, n_rays, reinterpret_cast<const float4*>(spheres), n_spheres,
      params, mesh, n_tri_rows, staged, static_cast<uint32_t>(seed), max_bounces, radiance);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* trace_fused_mesh_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
