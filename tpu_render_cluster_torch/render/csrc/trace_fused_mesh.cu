// Mesh-scene path-trace megakernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `_trace_fused_mesh` / `_mesh_trace_kernel_factory`
// with state_io=False (tpu_render_cluster/render/pallas_kernels.py): one
// launch runs the whole bounce loop for every ray and writes radiance once.
// Per bounce, in the reference's order: nearest sphere and ground-plane hit
// (path_common.cuh), then the nearest hit over
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
// The bounce itself (mesh::bounce), the walks, the table staging and their
// rounding are in mesh_common.cuh, shared with the per-bounce mesh kernel
// (mesh_bounce.cu). Built with --fmad=false, so nvcc contracts nothing but
// the fmaf written out there.

#include "mesh_common.cuh"

namespace {

using path::float3v;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
trace_fused_mesh_kernel(const float* __restrict__ origins,
                        const float* __restrict__ directions, int n_rays,
                        const float4* __restrict__ spheres, int n_spheres,
                        const float* __restrict__ params, mesh::MeshTables tables,
                        int n_tri_rows, bool staged, uint32_t seed, int max_bounces,
                        float* __restrict__ radiance_out) {
  __shared__ path::SceneShared scene;
  extern __shared__ float4 staging[];
  if (staged) mesh::stage_tables(tables, staging, n_tri_rows);
  path::load_scene(scene, spheres, n_spheres, params);  // ends with __syncthreads()

  const int64_t ray = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (ray >= n_rays) return;
  const uint32_t lane = static_cast<uint32_t>(ray);

  float3v o = path::load3(origins, ray);
  float3v d = path::load3(directions, ray);
  float3v thr = {1.0f, 1.0f, 1.0f};
  float3v rad = {0.0f, 0.0f, 0.0f};
  const uint32_t counter_stride = 2u * static_cast<uint32_t>(max_bounces) + 2u;

  const mesh::FlatInstances instances = {0, tables.n_instances};
  for (int bounce = 0; bounce < max_bounces; ++bounce) {
    if (!mesh::bounce(scene, 0, n_spheres, tables, instances, lane, bounce, counter_stride, seed,
                      o, d, thr, rad)) {
      break;  // the path escaped
    }
  }
  path::store3(radiance_out, ray, rad);
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
  const mesh::MeshTables tables = {instances,
                                   reinterpret_cast<const float4*>(triangles),
                                   reinterpret_cast<const float4*>(node_bounds),
                                   reinterpret_cast<const int4*>(node_links),
                                   n_instances,
                                   n_nodes};
  size_t shared_bytes;
  bool staged;
  const cudaError_t status = path::staging_for(
      trace_fused_mesh_kernel, mesh::table_bytes(n_tri_rows, n_nodes, n_instances), &shared_bytes,
      &staged);
  if (status != cudaSuccess) return static_cast<int>(status);
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  trace_fused_mesh_kernel<<<blocks, kThreads, shared_bytes,
                            static_cast<cudaStream_t>(stream)>>>(
      origins, directions, n_rays, reinterpret_cast<const float4*>(spheres), n_spheres,
      params, tables, n_tri_rows, staged, static_cast<uint32_t>(seed), max_bounces, radiance);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* trace_fused_mesh_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
