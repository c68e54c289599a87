// Nearest hit in one mesh's BVH, object-space rays, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bvh_nearest` / `_bvh_kernel_factory`
// (tpu_render_cluster/render/pallas_kernels.py), the walk of one instance in
// the per-instance branch of the scan renderer's nearest-hit query
// (render/mesh.py `intersect_instances(..., per_instance=True)`, through
// `intersect_mesh`). Per ray:
//   in:  origin, direction [R, 3] float32 (the instance's object space), a
//        seed t [R] float32 (the best hit of the instances walked before; a
//        node that cannot beat it is culled) and the BVH tables as
//        render/kernels.py `_pack_bvh` lays them out: triangle rows [T, 16],
//        node bounds [N, 8], node links [N, 4] int32;
//   out: t [R] float32 (the seed where nothing strictly nearer is hit) and
//        the winning triangle row [R] int32 (0 then, as the TPU kernel's
//        `best_idx` starts).
//
// Bound: operations: per ray a slab test per node reached and a
// Moller-Trumbore test per triangle of each leaf reached, against 28 bytes
// in and 8 out per ray. Design: one thread per ray, the BVH staged in shared
// memory by path::staging_for (the icosphere's 416 rows and 39 nodes are
// about 28 KB; global memory past 96 KB), the walk is mesh::blas_nearest
// (mesh_common.cuh), the one the instanced kernels run inside each
// instance: nodes in DFS preorder, culled with tnear < best t, strict `<`
// updates, the first row of a leaf reaching the minimum. The TPU kernel's
// block-wide `any` culls change which nodes a 1,024-ray packet visits,
// never a ray's nearest hit, exact ties aside. Built with --fmad=false.

#include "mesh_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
intersect_mesh_kernel(const float* __restrict__ origins, const float* __restrict__ directions,
                      const float* __restrict__ init_t, int n_rays, mesh::MeshTables tables,
                      int n_tri_rows, bool staged, float* __restrict__ t_out,
                      int* __restrict__ tri_out) {
  extern __shared__ float4 staging[];
  if (staged) {
    mesh::stage_tables(tables, staging, n_tri_rows);
    __syncthreads();
  }
  const int64_t ray = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (ray >= n_rays) return;
  mesh::MeshHit best = {init_t[ray], -1, 0};
  mesh::blas_nearest(tables, path::load3(origins, ray), path::load3(directions, ray), 0, best);
  t_out[ray] = best.t;
  tri_out[ray] = best.row;
}

}  // namespace

// Plain C entry for ctypes. Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() so the caller sees a refused launch at once.
// Rays [n_rays, 3] and init_t [n_rays] float32; the BVH tables as for
// trace_fused_mesh_launch (no instance table); outputs [n_rays] float32 and
// int32.
extern "C" int intersect_mesh_launch(const float* origins, const float* directions,
                                     const float* init_t, int n_rays, const float* triangles,
                                     int n_tri_rows, const float* node_bounds,
                                     const int* node_links, int n_nodes, float* t_out,
                                     int* tri_out, void* stream) {
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
      intersect_mesh_kernel, mesh::table_bytes(n_tri_rows, n_nodes, 0), &shared_bytes, &staged);
  if (status != cudaSuccess) return static_cast<int>(status);
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  intersect_mesh_kernel<<<blocks, kThreads, shared_bytes, static_cast<cudaStream_t>(stream)>>>(
      origins, directions, init_t, n_rays, tables, n_tri_rows, staged, t_out, tri_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* intersect_mesh_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
