// Shadow any-hit over all mesh instances, one launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bvh_anyhit_instanced` /
// `_bvh_instanced_kernel_factory` with anyhit=True
// (tpu_render_cluster/render/pallas_kernels.py), the mesh shadow test of the
// per-bounce scan renderer (render/mesh.py `occluded_instances`). Per ray:
//   in:  origin, direction [R, 3] float32 (world space), already [R] bytes
//        (lanes the caller knows are occluded, or whose answer cannot
//        matter), the instance table [K, 22] and the BVH tables;
//   out: [R] bytes, 1 where some triangle of some instance lies ahead of the
//        origin (t > EPS, unbounded), or where already is set.
//
// Bound: operations: per ray that walks, a world-AABB slab test per
// instance, the transform of each instance entered, a slab test per node
// reached and a Moller-Trumbore test per triangle tested, all ending at the
// first occluder, against 25 bytes in and 1 out per ray. Design: one thread
// per ray, the tables staged in shared memory by path::staging_for (global
// memory past 96 KB), the walk is mesh::occluded (mesh_common.cuh), the
// megakernels' own shadow walk along the ray's own direction. A lane with
// `already` set leaves at once (the TPU kernel replaces it with a ray that
// misses everything and ORs the mask back in); a block whose lanes are all
// set stages nothing. Built with --fmad=false.

#include "mesh_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
occluded_instances_kernel(const float* __restrict__ origins,
                          const float* __restrict__ directions,
                          const uint8_t* __restrict__ already, int n_rays,
                          mesh::MeshTables tables, int n_tri_rows, bool staged,
                          uint8_t* __restrict__ hit_out) {
  extern __shared__ float4 staging[];
  const int64_t ray = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool walks = ray < n_rays && already[ray] == 0;
  // Uniform per block: a block with no lane to walk stages no table.
  if (!__syncthreads_or(walks)) {
    if (ray < n_rays) hit_out[ray] = 1;
    return;
  }
  if (staged) {
    mesh::stage_tables(tables, staging, n_tri_rows);
    __syncthreads();
  }
  if (ray >= n_rays) return;
  hit_out[ray] = !walks || mesh::occluded(tables, 0, tables.n_instances,
                                          path::load3(origins, ray),
                                          path::load3(directions, ray))
                     ? 1
                     : 0;
}

}  // namespace

// Plain C entry for ctypes. Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() so the caller sees a refused launch at once.
// Rays [n_rays, 3] float32, already [n_rays] bytes (a torch.bool tensor);
// the mesh tables as for trace_fused_mesh_launch; the output [n_rays] bytes.
extern "C" int occluded_instances_launch(const float* origins, const float* directions,
                                         const unsigned char* already, int n_rays,
                                         const float* instances, int n_instances,
                                         const float* triangles, int n_tri_rows,
                                         const float* node_bounds, const int* node_links,
                                         int n_nodes, unsigned char* hit_out, void* stream) {
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
      path::staging_for(occluded_instances_kernel,
                        mesh::table_bytes(n_tri_rows, n_nodes, n_instances), &shared_bytes, &staged);
  if (status != cudaSuccess) return static_cast<int>(status);
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  occluded_instances_kernel<<<blocks, kThreads, shared_bytes,
                              static_cast<cudaStream_t>(stream)>>>(
      origins, directions, already, n_rays, tables, n_tri_rows, staged, hit_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* occluded_instances_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
