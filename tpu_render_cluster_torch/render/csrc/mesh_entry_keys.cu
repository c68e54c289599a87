// The coherence key of the per-bounce TLAS mesh kernel on the octant-ordered
// walk, for Hopper (sm_90a): the pass after mesh_bounce_tlas.cu on a BVH
// with octant tables.
//
// Replaces the key epilogue of the TPU kernel `_mesh_bounce_io` /
// `_mesh_trace_kernel_factory` with state_io=True, use_tlas=True and
// tlas_ordered (tpu_render_cluster/render/pallas_kernels.py:2974-3115): the
// entry walk that gives each lane's key its candidate takes the TLAS table
// of its packet's vote over the lanes' NEW directions, `tlas_base(edx, edy,
// edz)` (:3044), so it cannot start before every lane of the packet has
// bounced; on the canonical walk the key stays the bounce kernel's fused
// epilogue. The key is mesh_bounce_tlas.cu's, lane for lane:
//   - a lane alive after the bounce and below the live count keys with the
//     slot its new ray enters first (the entry walk over the slots' world
//     boxes alone), or K where the ray overlaps none;
//   - every other lane keys with K, and so does every lane of the last
//     bounce, whose key no sort reads;
//   - the key itself is mesh::coherence_key (dead flag at bit 29, frame id
//     0) in the frame's key window.
// A packet is 256 lanes (tlas_block_r()) in launch order; every lane votes
// with the direction the bounce left it (a dead lane's and a lane's past the
// live count unchanged), a lane past the launch with (0, 1, 0).
//
// Bound: operations: the entry walk, about 2 ceil(log2 K) node tests and
// the world boxes of the leaves entered per live lane, against 28 bytes of
// state read and 4 of key written per lane. Design: one block of 256
// threads a packet, a thread a lane: the vote is a warp sum and a barrier;
// the block stages its octant's M TLAS rows and the K slot rows in shared
// memory (about 5.7 KB for 48 instances) and each thread walks its lane
// (mesh::GroupTlas with G = 1). Built with --fmad=false.

#include "mesh_common.cuh"

namespace {

using path::float3v;
constexpr int kThreads = 256;  // the reference's TLAS packet

__global__ void __launch_bounds__(kThreads)
mesh_entry_keys_kernel(const float* __restrict__ origins, const float* __restrict__ directions,
                       const uint8_t* __restrict__ alive, int n_rays,
                       const int* __restrict__ live_count, const float* __restrict__ slots,
                       int n_instances, const float4* __restrict__ tlas_bounds,
                       const int4* __restrict__ tlas_links, int tlas_nodes,
                       const float* __restrict__ key_window, bool last, int* __restrict__ keys) {
  extern __shared__ float4 staging[];  // bounds [2 M], links [M], slot rows [22 K]
  __shared__ int votes[3];
  if (threadIdx.x < 3) votes[threadIdx.x] = 0;
  __syncthreads();
  const int live = *live_count;
  const int64_t ray = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const bool in_launch = ray < n_rays;
  float3v o = {0.0f, 0.0f, 0.0f};
  float3v d = {0.0f, 1.0f, 0.0f};  // a lane past the launch: the reference's pad ray
  bool is_alive = false;
  if (in_launch) {
    o = path::load3(origins, ray);
    d = path::load3(directions, ray);
    is_alive = alive[ray] != 0;
  }
  int candidate = n_instances;
  // Uniform per block: a packet past the live count, or the last bounce,
  // keys every lane with K.
  if (!last && static_cast<int64_t>(blockIdx.x) * kThreads < live) {
    const int row = mesh::block_octant(d, votes, 0) * tlas_nodes;
    float4* bounds = staging;
    int4* links = reinterpret_cast<int4*>(bounds + 2 * tlas_nodes);
    float* inst = reinterpret_cast<float*>(links + tlas_nodes);
    for (int i = threadIdx.x; i < 2 * tlas_nodes; i += kThreads) {
      bounds[i] = tlas_bounds[2 * row + i];
    }
    for (int i = threadIdx.x; i < tlas_nodes; i += kThreads) links[i] = tlas_links[row + i];
    for (int i = threadIdx.x; i < mesh::kInstanceWidth * n_instances; i += kThreads) {
      inst[i] = slots[i];
    }
    __syncthreads();
    if (is_alive && ray < live) {
      const mesh::MeshTables m = {inst, nullptr, nullptr, nullptr, n_instances, 0};
      const mesh::GroupTlas<1> walk = {mesh::Group<1>::of_thread(), bounds, links, 0, 0, 0,
                                       tlas_nodes};
      candidate = walk.entry_candidate(m, o, d, 0, n_instances);
    }
  }
  if (in_launch) {
    keys[ray] = mesh::coherence_key(o, d, !is_alive, 0, candidate, key_window);
  }
}

}  // namespace

// Plain C entry for ctypes: the keys [n_rays] int32 of a mesh_bounce_tlas
// launch's outputs (origins and directions [n_rays, 3], alive [n_rays]
// uint8) below *live_count (one int32 on the device), over the frame's
// instances in slot order [n_instances, 22] and its TLAS's eight octant
// orders stacked (bounds [8 tlas_nodes, 8], links [8 tlas_nodes, 4] int32,
// kernels.tlas_octant_links), in the key window [6]; `bounce` of
// `total_bounces`. Launches on `stream` and returns cudaGetLastError().
extern "C" int mesh_entry_keys_launch(const float* origins, const float* directions,
                                      const unsigned char* alive, int n_rays,
                                      const int* live_count, const float* slots,
                                      int n_instances, const float* tlas_bounds,
                                      const int* tlas_links, int tlas_nodes,
                                      const float* key_window, int bounce, int total_bounces,
                                      int* keys, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaSuccess);
  if (n_instances < 1 || tlas_nodes < 1 || bounce < 0 || bounce >= total_bounces) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t shared_bytes = (2 * sizeof(float4) + sizeof(int4)) * tlas_nodes +
                              sizeof(float) * mesh::kInstanceWidth * n_instances;
  if (shared_bytes > static_cast<size_t>(path::kMaxStagedBytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t status = path::allow_shared(mesh_entry_keys_kernel, shared_bytes);
  if (status != cudaSuccess) return static_cast<int>(status);
  const int blocks = static_cast<int>((static_cast<int64_t>(n_rays) + kThreads - 1) / kThreads);
  mesh_entry_keys_kernel<<<blocks, kThreads, shared_bytes, static_cast<cudaStream_t>(stream)>>>(
      origins, directions, alive, n_rays, live_count, slots, n_instances,
      reinterpret_cast<const float4*>(tlas_bounds), reinterpret_cast<const int4*>(tlas_links),
      tlas_nodes, key_window, bounce == total_bounces - 1, keys);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mesh_entry_keys_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
