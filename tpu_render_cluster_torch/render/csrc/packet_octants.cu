// The packet vote of the octant-ordered walk, for Hopper (sm_90a): the
// pre-pass of the per-bounce and pool mesh kernels (mesh_bounce.cu,
// mesh_bounce_tlas.cu, pool_mesh_bounce.cu, pool_mesh_bounce_tlas.cu) on a
// BVH with octant tables.
//
// Replaces the votes of the TPU kernel `_mesh_trace_kernel_factory`
// (tpu_render_cluster/render/pallas_kernels.py): `_octant_of` (:2263-2275)
// as `blas_base` takes it for the nearest BLAS walk of each instance
// (:2451-2455, the packet's object-space directions) and as `tlas_base`
// takes it for the nearest TLAS walk (:2572, the world directions). A
// packet is `block` consecutive lanes of the launch in launch order (the
// TPU kernel's ray block: tlas_block_r() = 256 for the TLAS variants,
// BVH_BLOCK_R = 1024 for the flat ones); every lane counts with the
// direction it carries (dead, parked, past the live count, of another
// frame), and the last packet's lanes past the launch as the reference's
// pad rays, direction (0, 1, 0). Bit i of an octant is set when strictly
// more than half of the packet's lanes have component i > 0. Output, one
// byte each: the packet's world octant [P] and its octant in the object
// space of each instance row [P, K] (mesh::to_object, the walk's own FMA
// chain, so a component near 0 keeps the walk's sign). A packet at or past
// the live count is walked by no kernel and votes 0.
//
// Bound: operations: 2 K + 1 direction tests a lane, each a 3 x 3 transform
// (about 12 flops) and three compares, against 12 bytes of directions read
// per lane. Design: one block of 256 threads a packet, a thread one lane
// (four of a 1024-lane packet); per instance row each warp sums its
// threads' counts with __reduce_add_sync and its first thread keeps them in
// shared memory (a [warps, rows, 3] table of shorts), summed over the warps
// at the end; the three axes' counts ride one warp sum, in fields of 10
// bits; the rows' rotations and 1/s are staged in shared memory, 512 rows
// at a time (a pool's window stacks up to 32 frames' rows). Built with
// --fmad=false.

#include "mesh_common.cuh"

namespace {

using path::float3v;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLanesPerThread = 4;  // a packet of at most 1024 lanes

// A row's operands of mesh::to_object: its rotation (9) and 1/s; the rows
// a block takes at a time (their operands and counts fit in 46 KB).
constexpr int kTurn = 10;
constexpr int kChunk = 512;

// mesh::to_object of a direction, from a row's staged operands (the same
// expressions, so the same bits).
__device__ __forceinline__ float3v to_object(const float* turn, float3v v) {
  const float inv_s = turn[9];
  return {mesh::sum3(v.x, turn[0], v.y, turn[3], v.z, turn[6]) * inv_s,
          mesh::sum3(v.x, turn[1], v.y, turn[4], v.z, turn[7]) * inv_s,
          mesh::sum3(v.x, turn[2], v.y, turn[5], v.z, turn[8]) * inv_s};
}

// One lane's positive components as 1s in three fields of 10 bits.
__device__ __forceinline__ unsigned positive_bits(float3v v) {
  return (v.x > 0.0f ? 1u : 0u) | (v.y > 0.0f ? 1u << 10 : 0u) | (v.z > 0.0f ? 1u << 20 : 0u);
}

__global__ void __launch_bounds__(kThreads)
packet_octants_kernel(const float* __restrict__ directions, int n_rays,
                      const int* __restrict__ live_count, int block,
                      const float* __restrict__ instances, int n_instances,
                      uint8_t* __restrict__ tlas_out, uint8_t* __restrict__ slot_out) {
  // The rows of one chunk: their operands and each warp's counts.
  __shared__ float turns[kChunk * kTurn];
  __shared__ unsigned short warp_counts[kWarps * kChunk * 3];
  __shared__ int world[3];
  const int packet = blockIdx.x;
  const int64_t first = static_cast<int64_t>(packet) * block;
  uint8_t* votes =
      slot_out == nullptr ? nullptr : slot_out + static_cast<int64_t>(packet) * n_instances;
  if (first >= *live_count) {  // uniform per block: no kernel walks this packet
    if (tlas_out != nullptr && threadIdx.x == 0) tlas_out[packet] = 0;
    if (votes != nullptr) {
      for (int k = threadIdx.x; k < n_instances; k += kThreads) votes[k] = 0;
    }
    return;
  }
  const int lanes = block / kThreads;
  float3v d[kMaxLanesPerThread];
#pragma unroll
  for (int j = 0; j < kMaxLanesPerThread; ++j) {
    const int64_t ray = first + threadIdx.x + static_cast<int64_t>(j) * kThreads;
    d[j] = {0.0f, 1.0f, 0.0f};  // a lane past the launch: the reference's pad ray
    if (j < lanes && ray < n_rays) d[j] = path::load3(directions, ray);
  }
  const int warp = static_cast<int>(threadIdx.x / 32);
  const bool leader = (threadIdx.x & 31u) == 0;
  // A warp's counts of the three axes ride one sum, in fields of 10 bits
  // (at most 32 threads x 4 lanes = 128 a field).
  if (tlas_out != nullptr) {
    if (threadIdx.x < 3) world[threadIdx.x] = 0;
    __syncthreads();
    unsigned packed = 0;
    for (int j = 0; j < lanes; ++j) packed += positive_bits(d[j]);
    const unsigned sum = __reduce_add_sync(0xffffffffu, packed);
    if (leader) {
      for (int a = 0; a < 3; ++a) atomicAdd(&world[a], static_cast<int>((sum >> (10 * a)) & 1023u));
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      tlas_out[packet] = static_cast<uint8_t>((2 * world[0] > block ? 1 : 0) |
                                              (2 * world[1] > block ? 2 : 0) |
                                              (2 * world[2] > block ? 4 : 0));
    }
  }
  if (votes == nullptr) return;
  for (int base = 0; base < n_instances; base += kChunk) {
    const int rows = min(kChunk, n_instances - base);
    // Each row's rotation and 1/s (to_object's operands).
    for (int i = threadIdx.x; i < kTurn * rows; i += kThreads) {
      const int k = i / kTurn, c = i % kTurn;
      turns[i] = instances[mesh::kInstanceWidth * (base + k) + (c < 9 ? c : 12)];
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < rows; ++k) {
      const float* turn = turns + kTurn * k;
      unsigned packed = 0;
      for (int j = 0; j < lanes; ++j) packed += positive_bits(to_object(turn, d[j]));
      const unsigned sum = __reduce_add_sync(0xffffffffu, packed);
      if (leader) {
        for (int a = 0; a < 3; ++a) {
          warp_counts[(warp * kChunk + k) * 3 + a] =
              static_cast<unsigned short>((sum >> (10 * a)) & 1023u);
        }
      }
    }
    __syncthreads();
    for (int k = threadIdx.x; k < rows; k += kThreads) {
      int c[3] = {0, 0, 0};
      for (int w = 0; w < kWarps; ++w) {
        for (int a = 0; a < 3; ++a) c[a] += warp_counts[(w * kChunk + k) * 3 + a];
      }
      votes[base + k] = static_cast<uint8_t>((2 * c[0] > block ? 1 : 0) |
                                             (2 * c[1] > block ? 2 : 0) |
                                             (2 * c[2] > block ? 4 : 0));
    }
    __syncthreads();  // the next chunk reuses turns and warp_counts
  }
}

}  // namespace

// Plain C entry for ctypes: the votes of the ceil(n_rays / block) packets of
// `directions` [n_rays, 3] (block 256, 512 or 1024), those at or past
// *live_count (one int32 on the device) 0. `tlas_out` [P] (nullptr: no
// world vote) and `slot_out` [P, n_instances] row-major (nullptr: no
// instance votes) for the rows of `instances` [n_instances, 22]. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int packet_octants_launch(const float* directions, int n_rays, const int* live_count,
                                     int block, const float* instances, int n_instances,
                                     unsigned char* tlas_out, unsigned char* slot_out,
                                     void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaSuccess);
  if (block < kThreads || block > kMaxLanesPerThread * kThreads || block % kThreads ||
      n_instances < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int packets = static_cast<int>((static_cast<int64_t>(n_rays) + block - 1) / block);
  packet_octants_kernel<<<packets, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      directions, n_rays, live_count, block, instances, n_instances, tlas_out, slot_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* packet_octants_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
