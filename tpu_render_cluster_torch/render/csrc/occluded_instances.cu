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
// first occluder, against 25 bytes in and 1 out per ray. What holds it
// back: most lanes do not walk (`already` holds the lanes the spheres
// shadow, dead lanes and lanes facing away from the sun: 0.94-0.99 of them
// after bounce 0 on 03_physics-2-mesh), and those that do are spread over
// the launch, so one thread a ray leaves most threads of a warp idle behind
// a few walkers. Design:
//   - persistent blocks (mesh_common.cuh) as in intersect_instances.cu: the
//     tables staged once a block by bulk copy, each warp taking the next 32
//     rays from the caller's work counter;
//   - the warp compacts its walkers: lanes with `already` set write 1 at
//     once; __ballot_sync numbers the walking rays, and the warp's 32 / G
//     groups take them in turn until none is left, then the warp fetches
//     again. A launch in which no lane walks still writes every output;
//   - a group of G threads walks each ray (mesh::GroupFlat), ending at the
//     group's first occluder: the answer of the one-thread sweep
//     (mesh::occluded, which G = 1 runs) along the ray's own direction. By
//     default (G = 0) each warp picks G for its batch from its count of
//     walkers, the largest G that takes them all in one round: the
//     walking share falls from about 0.9 at bounce 0 to 0.005-0.06 later
//     (03_physics-2-mesh), so one launch width wants G = 1 at bounce 0 and
//     G = 4-8 after it. A fixed G = 1, 2, 4 or 8 is for tests and sweeps.
// The TPU kernel replaces a lane with `already` set with a ray that misses
// everything and ORs the mask back in. Built with --fmad=false.

#include "mesh_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 3;

// The position of the n-th (from 0) set bit of `mask`, which has more than
// n set bits.
__device__ __forceinline__ int nth_set_bit(unsigned mask, int n) {
  int position = 0;
#pragma unroll
  for (int width = 16; width > 0; width >>= 1) {
    const unsigned low = mask & ((1u << width) - 1u);
    const int below = __popc(low);
    if (n >= below) {
      n -= below;
      mask >>= width;
      position += width;
    } else {
      mask = low;
    }
  }
  return position;
}

// A warp's walking rays taken by its 32 / G groups in turn, G threads a
// ray, until none is left (`walking`: the warp's lanes whose ray walks).
template <int G>
__device__ __forceinline__ void walk_rays(const mesh::MeshTables& tables,
                                          const float* __restrict__ origins,
                                          const float* __restrict__ directions,
                                          uint8_t* __restrict__ hit_out, int start,
                                          unsigned walking) {
  const mesh::GroupFlat<G> walk = {mesh::Group<G>::of_thread(), 0, tables.n_instances};
  const int lane_in_warp = static_cast<int>(threadIdx.x & 31u);
  const int n_walking = __popc(walking);
  for (int base = 0; base < n_walking; base += 32 / G) {
    const int taken = base + lane_in_warp / G;
    if (taken < n_walking) {
      const int64_t ray = static_cast<int64_t>(start) + nth_set_bit(walking, taken);
      const bool hit = walk.occluded(tables, path::load3(origins, ray),
                                     path::load3(directions, ray));
      if (walk.g.rank == 0) hit_out[ray] = hit ? 1 : 0;
    }
    __syncwarp();
  }
}

// G = 1, 2, 4 or 8 threads a walking ray; G = 0: each warp picks G for its
// batch, the largest that takes all its walkers in one round (more than 16
// walkers: 1; 9-16: 2; 5-8: 4; at most 4: 8).
template <int G>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
occluded_instances_kernel(const float* __restrict__ origins,
                          const float* __restrict__ directions,
                          const uint8_t* __restrict__ already, int n_rays,
                          mesh::MeshTables tables, int n_tri_rows, mesh::MeshStaging plan,
                          uint8_t* __restrict__ hit_out, int* __restrict__ next_ray) {
  __shared__ uint64_t barrier;
  extern __shared__ float4 staging[];
  mesh::stage_mesh(tables, n_tri_rows, plan, reinterpret_cast<char*>(staging), &barrier);
  const int lane_in_warp = static_cast<int>(threadIdx.x & 31u);
  for (;;) {
    const int start = mesh::warp_fetch(next_ray, 32);  // the warp's next 32 rays
    if (start >= n_rays) break;
    const int64_t mine = static_cast<int64_t>(start) + lane_in_warp;
    const bool walks = mine < n_rays && already[mine] == 0;
    if (mine < n_rays && !walks) hit_out[mine] = 1;
    const unsigned walking = __ballot_sync(0xffffffffu, walks);
    if constexpr (G > 0) {
      walk_rays<G>(tables, origins, directions, hit_out, start, walking);
    } else {
      const int n_walking = __popc(walking);
      if (n_walking > 16) {
        walk_rays<1>(tables, origins, directions, hit_out, start, walking);
      } else if (n_walking > 8) {
        walk_rays<2>(tables, origins, directions, hit_out, start, walking);
      } else if (n_walking > 4) {
        walk_rays<4>(tables, origins, directions, hit_out, start, walking);
      } else if (n_walking > 0) {
        walk_rays<8>(tables, origins, directions, hit_out, start, walking);
      }
    }
  }
}

using Kernel = decltype(&occluded_instances_kernel<1>);

// The group-G kernel (G = 0: the warp's pick; nullptr for another G).
Kernel kernel_for(int group) {
  switch (group) {
    case 0: return occluded_instances_kernel<0>;
    case 1: return occluded_instances_kernel<1>;
    case 2: return occluded_instances_kernel<2>;
    case 4: return occluded_instances_kernel<4>;
    case 8: return occluded_instances_kernel<8>;
    default: return nullptr;
  }
}

}  // namespace

// Plain C entry for ctypes. Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() so the caller sees a refused launch at once.
// Rays [n_rays, 3] float32, already [n_rays] bytes (a torch.bool tensor);
// the mesh tables as for trace_fused_mesh_launch; the output [n_rays] bytes;
// then the group size G (1, 2, 4 or 8 threads a ray, or 0: each warp's pick
// for its batch) and the work counter,
// one int32 in device memory that no other launch uses meanwhile (cleared
// here on `stream` before the kernel).
extern "C" int occluded_instances_launch(const float* origins, const float* directions,
                                         const unsigned char* already, int n_rays,
                                         const float* instances, int n_instances,
                                         const float* triangles, int n_tri_rows,
                                         const float* node_bounds, const int* node_links,
                                         int n_nodes, unsigned char* hit_out, int group,
                                         int* work_counter, void* stream) {
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
  // As many blocks as are resident at once, and no more than one fetch of
  // 32 rays a warp needs.
  const int64_t needed = (static_cast<int64_t>(n_rays) + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(needed < resident ? needed : resident);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  status = cudaMemsetAsync(work_counter, 0, sizeof(int), s);
  if (status != cudaSuccess) return static_cast<int>(status);
  kernel<<<blocks, kThreads, plan.bytes, s>>>(origins, directions, already, n_rays, tables,
                                               n_tri_rows, plan, hit_out, work_counter);
  return static_cast<int>(cudaGetLastError());
}

// The blocks of the group-G kernel resident on one SM at a launch of these
// tables (a negative CUDA error code on failure), with the launch's dynamic
// shared memory in *shared_bytes (0: the tables are read from global
// memory).
extern "C" int occluded_instances_occupancy(int group, int n_instances, int n_tri_rows,
                                            int n_nodes, int* shared_bytes) {
  const mesh::MeshStaging plan = mesh::plan_mesh(n_tri_rows, n_nodes, n_instances);
  *shared_bytes = static_cast<int>(plan.bytes);
  const Kernel kernel = kernel_for(group);
  if (kernel == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  int blocks_per_sm = 0;
  const cudaError_t status = mesh::blocks_per_sm(kernel, kThreads, plan.bytes, &blocks_per_sm);
  return status == cudaSuccess ? blocks_per_sm : -static_cast<int>(status);
}

extern "C" const char* occluded_instances_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
