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
// against 28 bytes in and 12 out per ray. What holds it back: the world-box
// sweep is cheap (the 48 boxes of 262,144 rays, staging and I/O included,
// take about 8 us alone on an H100); the BLAS walks are not, and the scan
// does not sort its rays, so the few rays of a warp that enter an instance
// walk while their warp-mates (sky rays, parked dead lanes, rays whose seed
// culls every box) wait. Design:
//   - persistent blocks (mesh_common.cuh): the launch starts as many blocks
//     as are resident at once; each stages the BVH and the instance table
//     (about 33 KB for 48 icospheres) once, by bulk copy (mesh::stage_mesh;
//     past 96 KB the tables are read from global memory), and each warp
//     takes the next 32 / G rays from the caller's work counter until the
//     launch's rays run out;
//   - a group of G threads walks each ray (mesh::GroupFlat, G = 1, 2, 4 or
//     8, chosen per launch by the wrapper from the launch's width): the flat
//     sweep as one leaf of K slots, each chunk of G world boxes tested one a
//     thread, the reached instances entered in table order against the
//     group's best t, each BLAS leaf's rows split over the group. Bit for
//     bit the one-thread sweep (mesh::nearest, which G = 1 runs): instances
//     in table order, each culled by its world box against the best t so
//     far, nodes in DFS preorder, strict `<` updates, the first row of a
//     leaf winning a tie.
// The TPU kernel's per-block candidate instance and near-first instance
// order only tighten the block-wide culls of 1,024-ray packets; per ray
// they change no result, exact ties between instances aside. Built with
// --fmad=false.

#include "mesh_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 3;

template <int G>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
intersect_instances_kernel(const float* __restrict__ origins,
                           const float* __restrict__ directions,
                           const float* __restrict__ init_t, int n_rays, mesh::MeshTables tables,
                           int n_tri_rows, mesh::MeshStaging plan, float* __restrict__ t_out,
                           int* __restrict__ tri_out, int* __restrict__ inst_out,
                           int* __restrict__ next_ray) {
  __shared__ uint64_t barrier;
  extern __shared__ float4 staging[];
  mesh::stage_mesh(tables, n_tri_rows, plan, reinterpret_cast<char*>(staging), &barrier);
  const mesh::GroupFlat<G> walk = {mesh::Group<G>::of_thread(), 0, tables.n_instances};
  const int lane_in_warp = static_cast<int>(threadIdx.x & 31u);
  for (;;) {
    const int start = mesh::warp_fetch(next_ray, 32 / G);  // the warp's next 32 / G rays
    if (start >= n_rays) break;
    const int64_t ray = static_cast<int64_t>(start) + lane_in_warp / G;
    if (ray < n_rays) {
      const mesh::MeshHit hit = walk.nearest(tables, path::load3(origins, ray),
                                             path::load3(directions, ray), init_t[ray]);
      if (walk.g.rank == 0) {
        t_out[ray] = hit.t;
        tri_out[ray] = hit.instance >= 0 ? hit.row : 0;
        inst_out[ray] = hit.instance >= 0 ? hit.instance : 0;
      }
    }
    __syncwarp();
  }
}

using Kernel = decltype(&intersect_instances_kernel<1>);

// The group-G kernel (nullptr for another G).
Kernel kernel_for(int group) {
  switch (group) {
    case 1: return intersect_instances_kernel<1>;
    case 2: return intersect_instances_kernel<2>;
    case 4: return intersect_instances_kernel<4>;
    case 8: return intersect_instances_kernel<8>;
    default: return nullptr;
  }
}

}  // namespace

// Plain C entry for ctypes. Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() so the caller sees a refused launch at once.
// Rays [n_rays, 3] and init_t [n_rays] float32; the mesh tables as for
// trace_fused_mesh_launch; outputs [n_rays] float32, int32, int32; then the
// group size G (1, 2, 4 or 8 threads a ray) and the work counter, one int32
// in device memory that no other launch uses meanwhile (cleared here on
// `stream` before the kernel).
extern "C" int intersect_instances_launch(const float* origins, const float* directions,
                                          const float* init_t, int n_rays,
                                          const float* instances, int n_instances,
                                          const float* triangles, int n_tri_rows,
                                          const float* node_bounds, const int* node_links,
                                          int n_nodes, float* t_out, int* tri_out, int* inst_out,
                                          int group, int* work_counter, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaSuccess);
  const Kernel kernel = kernel_for(group);
  if (kernel == nullptr || n_instances < 0 || n_tri_rows < 1 || n_nodes < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const mesh::MeshTables tables = {instances,
                                   reinterpret_cast<const float4*>(triangles),
                                   reinterpret_cast<const float4*>(node_bounds),
                                   reinterpret_cast<const int4*>(node_links),
                                   n_instances,
                                   n_nodes};
  const mesh::MeshStaging plan = mesh::plan_mesh(n_tri_rows, n_nodes, n_instances);
  int resident = 0;
  cudaError_t status = mesh::card_blocks(kernel, kThreads, plan.bytes, &resident);
  if (status != cudaSuccess) return static_cast<int>(status);
  // As many blocks as are resident at once, and no more than the rays need.
  const int64_t needed = (static_cast<int64_t>(n_rays) * group + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(needed < resident ? needed : resident);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  status = cudaMemsetAsync(work_counter, 0, sizeof(int), s);
  if (status != cudaSuccess) return static_cast<int>(status);
  kernel<<<blocks, kThreads, plan.bytes, s>>>(origins, directions, init_t, n_rays, tables,
                                               n_tri_rows, plan, t_out, tri_out, inst_out,
                                               work_counter);
  return static_cast<int>(cudaGetLastError());
}

// The blocks of the group-G kernel resident on one SM at a launch of these
// tables (a negative CUDA error code on failure), with the launch's dynamic
// shared memory in *shared_bytes (0: the tables are read from global
// memory).
extern "C" int intersect_instances_occupancy(int group, int n_instances, int n_tri_rows,
                                             int n_nodes, int* shared_bytes) {
  const mesh::MeshStaging plan = mesh::plan_mesh(n_tri_rows, n_nodes, n_instances);
  *shared_bytes = static_cast<int>(plan.bytes);
  const Kernel kernel = kernel_for(group);
  if (kernel == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  int blocks_per_sm = 0;
  const cudaError_t status = mesh::blocks_per_sm(kernel, kThreads, plan.bytes, &blocks_per_sm);
  return status == cudaSuccess ? blocks_per_sm : -static_cast<int>(status);
}

extern "C" const char* intersect_instances_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
