// Shadow any-hit in one mesh's BVH, object-space rays, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bvh_anyhit` / `_bvh_anyhit_kernel_factory`
// (tpu_render_cluster/render/pallas_kernels.py), the walk of one instance in
// the per-instance branch of the scan renderer's shadow query
// (render/mesh.py `occluded_instances(..., per_instance=True)`, through
// `occluded_mesh`). Per ray:
//   in:  origin, direction [R, 3] float32 (the instance's object space),
//        already [R] bytes (lanes occluded by the instances walked before,
//        or whose answer cannot matter) and the BVH tables;
//   out: [R] bytes, 1 where some triangle lies ahead of the origin (t > EPS,
//        unbounded), or where already is set.
//
// Bound: operations: per ray that walks, a slab test per node reached and a
// Moller-Trumbore test per triangle tested, all ending at the first
// occluder, against 2 bytes per ray and the 24 bytes of the ray read where
// it walks. Design: one thread per ray, the BVH staged in shared memory by
// path::staging_for, the walk is mesh::blas_occluded (mesh_common.cuh), the
// one the instanced kernels run inside each instance. A lane with `already`
// set leaves at once and comes back 1, as the TPU kernel's `already` lanes
// drive no node; a block whose lanes are all set stages nothing. The TPU
// kernel pads its last packet with lanes that start occluded; one thread
// per ray has no padding. Built with --fmad=false.

#include "mesh_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
occluded_mesh_kernel(const float* __restrict__ origins, const float* __restrict__ directions,
                     const uint8_t* __restrict__ already, int n_rays, mesh::MeshTables tables,
                     int n_tri_rows, bool staged, uint8_t* __restrict__ hit_out) {
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
  hit_out[ray] = !walks || mesh::blas_occluded(tables, path::load3(origins, ray),
                                               path::load3(directions, ray))
                     ? 1
                     : 0;
}

}  // namespace

// Plain C entry for ctypes. Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() so the caller sees a refused launch at once.
// Rays [n_rays, 3] float32, already [n_rays] bytes (a torch.bool tensor);
// the BVH tables as for intersect_mesh_launch; the output [n_rays] bytes.
extern "C" int occluded_mesh_launch(const float* origins, const float* directions,
                                    const unsigned char* already, int n_rays,
                                    const float* triangles, int n_tri_rows,
                                    const float* node_bounds, const int* node_links, int n_nodes,
                                    unsigned char* hit_out, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaSuccess);
  if (n_tri_rows < 1 || n_nodes < 1) return static_cast<int>(cudaErrorInvalidValue);
  const mesh::MeshTables tables = {nullptr,
                                   reinterpret_cast<const float4*>(triangles),
                                   reinterpret_cast<const float4*>(node_bounds),
                                   reinterpret_cast<const int4*>(node_links),
                                   0,
                                   n_nodes};
  size_t shared_bytes;
  bool staged;
  const cudaError_t status = path::staging_for(
      occluded_mesh_kernel, mesh::table_bytes(n_tri_rows, n_nodes, 0), &shared_bytes, &staged);
  if (status != cudaSuccess) return static_cast<int>(status);
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  occluded_mesh_kernel<<<blocks, kThreads, shared_bytes, static_cast<cudaStream_t>(stream)>>>(
      origins, directions, already, n_rays, tables, n_tri_rows, staged, hit_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* occluded_mesh_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
