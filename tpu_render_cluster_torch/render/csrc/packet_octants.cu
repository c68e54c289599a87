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
// TPU kernel's ray block: tlas_block_r() for the TLAS variants, 256 by
// default, 128 to 1,024 by TRC_TLAS_BLOCK; BVH_BLOCK_R = 1024 for the flat
// ones); every lane counts with the
// direction it carries (dead, parked, past the live count, of another
// frame), and the last packet's lanes past the launch as the reference's
// pad rays, direction (0, 1, 0). Bit i of an octant is set when strictly
// more than half of the packet's lanes have component i > 0. Output, one
// byte each: the packet's world octant [P] and its octant in the object
// space of each instance row [P, K] (mesh::to_object, the walk's own FMA
// chain, so a component near 0 keeps the walk's sign). A packet at or past
// the live count is walked by no kernel and votes 0.
//
// Rows a packet cannot read (a pool launch, `frames` given): the stacked
// table holds `per_frame` rows per frame, and a lane of frame f reads only
// rows [f per_frame, (f + 1) per_frame). A packet's entry of a row of a
// frame that none of its lanes below the launch's lane count carries (the
// lane's frame id, the pool state's column) is 0, not its vote: no walk
// reads it, so the walks' outputs are those of the votes of every row.
//
// Bound: operations: 2 K + 1 direction tests a lane (K the rows voted),
// each a 3 x 3 transform (about 12 flops) and three compares, against 12
// bytes of directions read per lane; about 20 instructions a lane and row,
// so at full width the instruction issue rate. Design:
//   - a warp per packet: each thread holds block / 32 of its lanes in
//     registers (8 of a 256-lane packet) and adds their positive components
//     locally, so a row costs the warp one packed sum (the three axes in
//     fields of 10 bits; 16-bit fields over two sums for a 1,024-lane
//     packet, whose counts pass 1,023), with no barrier and no shared
//     table of counts; kRows rows at a time, for instruction-level
//     parallelism (32 independent chains a thread);
//   - a packet's rows split over `shares` warps (the launch's work units
//     are packet x share), so a narrow launch (a pool's 256 packets) still
//     gives every SM scheduler several warps;
//   - with `frames`, a warp first ORs its packet's frame bits and votes only
//     the rows of those frames;
//   - persistent blocks of 8 warps, as many as are resident at once (fewer
//     for a narrow launch), each staging the instance rows once by bulk copy
//     (mesh::stage_ranges; a table past the staging budget is read from
//     global memory), the warps taking units strided over the launch.
// Built with --fmad=false.

#include <algorithm>

#include "mesh_common.cuh"

namespace {

using path::float3v;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// A launch gives each SM at least this many warps where its packets allow
// (four a scheduler), and each share at least kMinShareRows rows.
constexpr int kWarpsPerSm = 16;
constexpr int kMinShareRows = 4;
// Rows a warp votes at once: independent chains for the issue slots (4: 2%
// faster than 1 or 2 at row 4 TLAS's widest launch, PERF.md section 6).
constexpr int kRows = 4;

// The octant of a packet of L x 32 lanes from each thread's counts of its
// L lanes (`packed`, fields of 10 bits): every lane of the warp gets it.
template <int L>
__device__ __forceinline__ uint8_t warp_octant(unsigned packed) {
  constexpr int kBlock = 32 * L;
  if constexpr (kBlock <= 1023) {
    return mesh::octant_of_counts(__reduce_add_sync(0xffffffffu, packed), kBlock);
  } else {
    // Counts up to 1,024: x and y in fields of 16 bits, z alone.
    const unsigned xy =
        __reduce_add_sync(0xffffffffu, (packed & 1023u) | (((packed >> 10) & 1023u) << 16));
    const int cz = static_cast<int>(__reduce_add_sync(0xffffffffu, packed >> 20));
    const int cx = static_cast<int>(xy & 0xffffu), cy = static_cast<int>(xy >> 16);
    return static_cast<uint8_t>((2 * cx > kBlock ? 1 : 0) | (2 * cy > kBlock ? 2 : 0) |
                                (2 * cz > kBlock ? 4 : 0));
  }
}

// A thread's counts of its L lanes' positive components in the object space
// of one row (`packed` fields of 10 bits), through mesh::to_object's FMA
// chain as the walk takes it.
template <int L>
__device__ __forceinline__ unsigned row_counts(const float* row, const float3v (&d)[L]) {
  unsigned packed = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    packed += mesh::positive_bits(mesh::to_object(row, d[j].x, d[j].y, d[j].z));
  }
  return packed;
}

// L lanes a thread: a packet of 32 L lanes a warp.
template <int L>
__global__ void __launch_bounds__(kThreads)
packet_octants_kernel(const float* __restrict__ directions, int n_rays,
                      const int* __restrict__ live_count, const int* __restrict__ frames,
                      int per_frame, const float* __restrict__ instances, int n_instances,
                      int shares, uint32_t staged_bytes, uint8_t* __restrict__ tlas_out,
                      uint8_t* __restrict__ slot_out) {
  __shared__ uint64_t barrier;
  extern __shared__ float4 staging[];
  const float* rows = instances;
  if (staged_bytes > 0) {
    const mesh::Range range[1] = {
        {reinterpret_cast<char*>(staging), reinterpret_cast<const char*>(instances),
         static_cast<uint32_t>(sizeof(float) * mesh::kInstanceWidth * n_instances)}};
    mesh::stage_ranges(range, &barrier);
    rows = reinterpret_cast<const float*>(range[0].staged());
  }
  constexpr int kBlock = 32 * L;
  const int live = *live_count;
  const int lane = static_cast<int>(threadIdx.x & 31u);
  const int packets = static_cast<int>((static_cast<int64_t>(n_rays) + kBlock - 1) / kBlock);
  // Without frame ids, one "frame" of every row.
  const int rows_per_frame = frames == nullptr ? n_instances : per_frame;
  const int n_frames = rows_per_frame > 0 ? n_instances / rows_per_frame : 0;
  const int64_t units = static_cast<int64_t>(packets) * shares;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t unit = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32; unit < units;
       unit += stride) {
    const int packet = static_cast<int>(unit / shares);
    const int share = static_cast<int>(unit % shares);
    const int64_t first = static_cast<int64_t>(packet) * kBlock;
    uint8_t* votes =
        slot_out == nullptr ? nullptr : slot_out + static_cast<int64_t>(packet) * n_instances;
    const bool walked = first < live;  // uniform per warp: no kernel walks this packet
    float3v d[L];
    unsigned carried = 0;  // the frames of the packet's lanes, a bit each
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const int64_t ray = first + lane + 32 * j;
      d[j] = {0.0f, 1.0f, 0.0f};  // a lane past the launch: the reference's pad ray
      if (walked && ray < n_rays) {
        d[j] = path::load3(directions, ray);
        if (frames != nullptr) {
          const int f = frames[ray];
          if (f >= 0 && f < n_frames) carried |= 1u << f;
        }
      }
    }
    if (frames == nullptr) {
      carried = walked && n_frames > 0 ? 1u : 0u;
    } else {
      carried = __reduce_or_sync(0xffffffffu, carried);
    }
    if (tlas_out != nullptr && share == 0) {
      unsigned packed = 0;
#pragma unroll
      for (int j = 0; j < L; ++j) packed += mesh::positive_bits(d[j]);
      const uint8_t octant = warp_octant<L>(packed);
      if (lane == 0) tlas_out[packet] = walked ? octant : 0;
    }
    if (votes == nullptr) continue;
    // The rows of frames the packet does not carry: 0, this share's part.
    const int zero_lo = static_cast<int>(static_cast<int64_t>(n_instances) * share / shares);
    const int zero_hi = static_cast<int>(static_cast<int64_t>(n_instances) * (share + 1) / shares);
    for (int k = zero_lo + lane; k < zero_hi; k += 32) {
      if (!((carried >> (k / rows_per_frame)) & 1u)) votes[k] = 0;
    }
    // The rows of the carried frames, in order, frame by frame: this
    // share's part, kRows rows at a time.
    const int needed = __popc(carried) * rows_per_frame;
    const int lo = static_cast<int>(static_cast<int64_t>(needed) * share / shares);
    const int hi = static_cast<int>(static_cast<int64_t>(needed) * (share + 1) / shares);
    for (int r = lo; r < hi;) {
      const int rank = r / rows_per_frame;
      const int end = min(hi, (rank + 1) * rows_per_frame);
      int row =
          mesh::nth_bit(carried, rank) * rows_per_frame + (r - rank * rows_per_frame);
      const int row_end = row + (end - r);
      for (; row + kRows <= row_end; row += kRows) {
        const float* first_row = rows + mesh::kInstanceWidth * row;
        unsigned counts[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          counts[i] = row_counts<L>(first_row + mesh::kInstanceWidth * i, d);
        }
        uint8_t octants[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) octants[i] = warp_octant<L>(counts[i]);
        if (lane == 0) {
#pragma unroll
          for (int i = 0; i < kRows; ++i) votes[row + i] = octants[i];
        }
      }
      for (; row < row_end; ++row) {
        const uint8_t octant = warp_octant<L>(row_counts<L>(rows + mesh::kInstanceWidth * row, d));
        if (lane == 0) votes[row] = octant;
      }
      r = end;
    }
  }
}

using Kernel = decltype(&packet_octants_kernel<8>);

// The kernel of a packet of `block` lanes (nullptr for another size).
Kernel kernel_for(int block) {
  switch (block) {
    case 128: return packet_octants_kernel<4>;
    case 256: return packet_octants_kernel<8>;
    case 512: return packet_octants_kernel<16>;
    case 1024: return packet_octants_kernel<32>;
    default: return nullptr;
  }
}

}  // namespace

// Plain C entry for ctypes: the votes of the ceil(n_rays / block) packets of
// `directions` [n_rays, 3] (block 128, 256, 512 or 1024: the TLAS variants'
// widths, tlas_block_r(), and the flat ones' 1,024), those at or past
// *live_count (one int32 on the device) 0. `frames`: nullptr (every row
// voted) or the lanes' frame ids [n_rays] int32, the rows then `per_frame`
// per frame (n_instances a multiple of it, at most 32 frames), a row of a
// frame that no lane of the packet carries 0. `tlas_out` [P] (nullptr: no
// world vote) and `slot_out` [P, n_instances] row-major (nullptr: no
// instance votes) for the rows of `instances` [n_instances, 22]. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int packet_octants_launch(const float* directions, int n_rays, const int* live_count,
                                     int block, const int* frames, int per_frame,
                                     const float* instances, int n_instances,
                                     unsigned char* tlas_out, unsigned char* slot_out,
                                     void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaSuccess);
  const Kernel kernel = kernel_for(block);
  if (kernel == nullptr || n_instances < 0 ||
      (frames != nullptr && (per_frame < 1 || n_instances % per_frame != 0 ||
                             n_instances / per_frame > 32))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int packets = static_cast<int>((static_cast<int64_t>(n_rays) + block - 1) / block);
  const size_t table = sizeof(float) * mesh::kInstanceWidth * static_cast<size_t>(n_instances);
  const uint32_t staged_bytes =
      slot_out != nullptr && n_instances > 0 &&
              mesh::stage_region(table) <= static_cast<size_t>(path::kMaxStagedBytes)
          ? static_cast<uint32_t>(mesh::stage_region(table))
          : 0u;
  int device = 0, sms = 0, resident = 0;
  cudaError_t status = cudaGetDevice(&device);
  if (status == cudaSuccess) {
    status = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (status == cudaSuccess) status = mesh::card_blocks(kernel, kThreads, staged_bytes, &resident);
  if (status != cudaSuccess) return static_cast<int>(status);
  // Shares of a packet's rows: enough warps for the card, each of at least
  // kMinShareRows rows of a frame.
  int shares = 1;
  if (slot_out != nullptr) {
    const int frame_rows = frames != nullptr ? per_frame : n_instances;
    const int wanted = (sms * kWarpsPerSm + packets - 1) / packets;
    shares = std::max(1, std::min(wanted, frame_rows / kMinShareRows));
  }
  const int64_t units = static_cast<int64_t>(packets) * shares;
  const int64_t needed = (units + kWarps - 1) / kWarps;
  const int blocks = static_cast<int>(needed < resident ? needed : resident);
  kernel<<<blocks, kThreads, staged_bytes, static_cast<cudaStream_t>(stream)>>>(
      directions, n_rays, live_count, frames, per_frame, instances, n_instances, shares,
      staged_bytes, tlas_out, slot_out);
  return static_cast<int>(cudaGetLastError());
}

// The blocks of the kernel of a `block`-lane packet resident on one SM with
// `n_instances` rows staged (a negative CUDA error code on failure).
extern "C" int packet_octants_occupancy(int block, int n_instances) {
  const Kernel kernel = kernel_for(block);
  if (kernel == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  const size_t table =
      mesh::stage_region(sizeof(float) * mesh::kInstanceWidth * static_cast<size_t>(n_instances));
  const uint32_t bytes =
      table <= static_cast<size_t>(path::kMaxStagedBytes) ? static_cast<uint32_t>(table) : 0u;
  int blocks_per_sm = 0;
  const cudaError_t status = mesh::blocks_per_sm(kernel, kThreads, bytes, &blocks_per_sm);
  return status == cudaSuccess ? blocks_per_sm : -static_cast<int>(status);
}

extern "C" const char* packet_octants_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
