// Nearest hit over all mesh instances, one launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bvh_nearest_instanced` /
// `_bvh_instanced_kernel_factory` with anyhit=False
// (tpu_render_cluster/render/pallas_kernels.py), the mesh pass of the
// per-bounce scan renderer (render/mesh.py `intersect_instances`). Per ray:
//   in:  origin, direction [R, 3] float32 (world space), a seed t [R]
//        float32 (the caller's sphere/plane hit; a walk that cannot beat it
//        is culled), the instance table [K, 22] (render/kernels.py
//        `instance_table`, world AABBs included) and the BVH tables;
//   out: t [R] float32 (the seed on a miss), the winning triangle row [R]
//        int32 (a row of the BVH's v0/e1/e2/normal tables, as the TPU
//        kernel's `start + local`) and instance [R] int32; 0 and 0 where
//        nothing beats the seed.
//
// Bound: operations: per ray a world-AABB slab test per instance, the
// object-space transform of each instance entered, a slab test per node
// reached and a Moller-Trumbore test per triangle of each leaf reached,
// against 28 bytes in and 12 out per ray. Design: one thread per ray, the
// tables staged in shared memory by path::staging_for (global memory past
// 96 KB), the walk is mesh::nearest (mesh_common.cuh), the megakernels' own
// instance walk: instances in table order, each culled by its world box
// against the ray's best t so far, nodes in DFS preorder, strict `<`
// updates. The TPU kernel's per-block candidate instance and near-first
// instance order only tighten the block-wide culls of 1,024-ray packets; per
// ray they change no result, exact ties between instances aside. Built with
// --fmad=false.

#include "mesh_common.cuh"

namespace {

using path::float3v;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
intersect_instances_kernel(const float* __restrict__ origins,
                           const float* __restrict__ directions,
                           const float* __restrict__ init_t, int n_rays, mesh::MeshTables tables,
                           int n_tri_rows, bool staged, float* __restrict__ t_out,
                           int* __restrict__ tri_out, int* __restrict__ inst_out) {
  extern __shared__ float4 staging[];
  if (staged) {
    mesh::stage_tables(tables, staging, n_tri_rows);
    __syncthreads();
  }
  const int64_t ray = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (ray >= n_rays) return;
  const mesh::MeshHit hit =
      mesh::nearest(tables, 0, tables.n_instances, path::load3(origins, ray),
                    path::load3(directions, ray), init_t[ray]);
  t_out[ray] = hit.t;
  tri_out[ray] = hit.instance >= 0 ? hit.row : 0;
  inst_out[ray] = hit.instance >= 0 ? hit.instance : 0;
}

}  // namespace

// Plain C entry for ctypes. Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() so the caller sees a refused launch at once.
// Rays [n_rays, 3] and init_t [n_rays] float32; the mesh tables as for
// trace_fused_mesh_launch; outputs [n_rays] float32, int32, int32.
extern "C" int intersect_instances_launch(const float* origins, const float* directions,
                                          const float* init_t, int n_rays,
                                          const float* instances, int n_instances,
                                          const float* triangles, int n_tri_rows,
                                          const float* node_bounds, const int* node_links,
                                          int n_nodes, float* t_out, int* tri_out, int* inst_out,
                                          void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaSuccess);
  if (n_instances < 0 || n_tri_rows < 1 || n_nodes < 1) {
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
  const cudaError_t status =
      path::staging_for(intersect_instances_kernel,
                        mesh::table_bytes(n_tri_rows, n_nodes, n_instances), &shared_bytes, &staged);
  if (status != cudaSuccess) return static_cast<int>(status);
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  intersect_instances_kernel<<<blocks, kThreads, shared_bytes,
                               static_cast<cudaStream_t>(stream)>>>(
      origins, directions, init_t, n_rays, tables, n_tri_rows, staged, t_out, tri_out, inst_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* intersect_instances_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
