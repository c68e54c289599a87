// Mesh-scene path-trace megakernel, two-level instance walk, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_trace_fused_mesh` / `_mesh_trace_kernel_factory`
// with state_io=False and use_tlas=True, the reference's default for a
// field of more instances than one TLAS leaf holds
// (tpu_render_cluster/render/pallas_kernels.py): trace_fused_mesh.cu's
// megakernel with the flat instance sweep replaced by the TLAS walk of
// mesh_common.cuh (TlasInstances). Per bounce and ray, the nearest-hit walk
// visits the frame's TLAS nodes in preorder, skipping a subtree whose union
// box the ray misses or enters at or past its best t, and at a leaf tests
// the leaf's instance slots as the flat sweep tests an instance (world box,
// then the BLAS walk); the shadow walk the same, unbounded, to the first
// occluder. The instance table arrives in Morton slot order
// (kernels.tlas_frame), so a ray's instance order is the slots', not the
// table's: the nearest hit is the flat sweep's, exact ties aside.
//
// Walk order: on a BVH with octant tables (every sah build; the
// reference's default) the launch's tables hold the BVH's and the TLAS's
// eight octant orders stacked [8N] and [8M], and each walk takes the one of
// its packet's octant (mesh::Octants). A packet is the reference's ray
// block, kPacket lanes of the launch in launch order (tlas_block_r(): 256,
// or the width the library was built for, mesh::kTlasPacket): at every
// bounce all its lanes vote, each with the direction it carries (a finished
// path's last one, a lane past the launch (0, 1, 0)), on the TLAS's octant
// and, on a BVH of more than one node, on each instance's BLAS octant in
// object space; the shadow walks take the sun's octant. Without octant
// tables the canonical order.
//
// Bound: operations, as trace_fused_mesh.cu, with the instance search a
// two-level walk (about 2 ceil(log2 K) box tests per search where the
// flat sweep pays K). What held it back (one thread a ray, a block of 256 a
// packet): on the ordered walk every thread stayed in the bounce loop to
// each bounce's vote barrier, finished paths and lanes past the launch
// included; each warp ran as long as its slowest path at every bounce;
// __launch_bounds__(256) alone let ptxas settle on 64 registers and spill
// 108-144 bytes; every block of 256 rays staged the tables again. Design:
//   - persistent blocks, as many as are resident at once (fewer for a
//     narrow launch), each staging the BVH, the slot-ordered instance table
//     and the TLAS once by bulk copy (mesh::stage_ranges), then taking
//     packets from a work counter in global memory (a scratch int of the
//     caller's, cleared on the launch's stream before the kernel);
//   - a packet's carried state (origin, direction, throughput, radiance,
//     alive: 49 bytes a lane, 12.3 KB at 256 lanes, 50.2 KB at 1,024) in the
//     dynamic shared memory before the staged tables (past the 48 KB of
//     static shared memory at 1,024 lanes), so registers hold only the
//     bounce of the ray a thread is on;
//   - 128 threads a packet, 2 lanes a thread at 256, 7 blocks an SM (72
//     registers): a bounce waits at a barrier for its slowest warp, so more
//     packets in flight keep the SM busy (measured: 256 threads a packet at
//     3 blocks an SM ran 25% slower than the parent, 128 at 6-8 blocks
//     10-15% faster; PERF.md section 6);
//   - each bounce, the vote over the packet's staged directions (each
//     thread counting its kLanes positional lanes: packet_octant,
//     packet_instance_octants), whose barrier also publishes the packet's
//     live mask (a ballot a warp); the live lanes are then walked in lane
//     order, thread t taking the t-th, the (t + 128)-th... (nth_live), so
//     finished lanes hold no thread and walking warps are full; the packet
//     ends at the first bounce with no live lane. A path's bounce depends
//     only on its own lane index (its RNG counter) and state, so any thread
//     may take any lane and the result is the one-thread-a-ray kernel's,
//     bit for bit.
// The canonical order (no octant tables) runs the same structure without
// the votes: the compaction, the staging and the packets in flight serve it
// alike (as fast as the one-thread-a-ray kernel or up to 4% faster), and one
// kernel body keeps the two orders' walks the same code. Built with
// --fmad=false.
//
// Node format: the kernel is instantiated for the three formats of
// mesh::Nodes (fp32, and the reference's quantized tiers 1 and 2: the BLAS
// and the TLAS read 16 or 12 bytes a node in place of 48, both staged), the
// launch's `quant` picking one; a quantized box contains the fp32 one, so
// the radiance is the fp32 walk's.

#include "mesh_common.cuh"

namespace {

using path::float3v;
// The reference's ray block (tlas_block_r()): a packet of 256 lanes, or the
// library's width (128, 512 or 1,024).
constexpr int kPacket = mesh::kTlasPacket;
// A block walks one packet at a time with kThreads threads, each voting for
// kLanes positional lanes (lane t + j kThreads) and walking up to kLanes of
// the packet's live lanes a bounce.
constexpr int kThreads = 128;
constexpr int kLanes = kPacket / kThreads;
constexpr int kWords = kPacket / 32;  // the packet's live mask, a word a 32 lanes
// A vote's counts: one word at 128 to 512 lanes, two at 1,024.
using Counts = mesh::PacketCounts<kPacket>;
constexpr int kVoteWords = Counts::kWords;
// Resident blocks an SM: ptxas keeps a thread within 72 registers.
constexpr int kMinBlocks = 7;

// A packet's carried state, lane i at [i], and the bounce's live lanes: the
// origin and direction with the axes apart (neighbouring lanes in
// neighbouring banks), copied into registers for a bounce; the throughput
// and radiance as float3 (a stride of 3 words, free of bank conflicts),
// which the bounce reads and writes in place, so that registers do not hold
// them across the walk.
struct PacketState {
  float o[3][kPacket];
  float d[3][kPacket];
  float3v thr[kPacket];
  float3v rad[kPacket];
  uint8_t alive[kPacket];
  unsigned live[kWords];  // bit l of word w: lane 32 w + l is alive
  int packet;  // the block's packet
};

__device__ __forceinline__ float3v get(const float (&rows)[3][kPacket], int i) {
  return {rows[0][i], rows[1][i], rows[2][i]};
}

__device__ __forceinline__ void put(float (&rows)[3][kPacket], int i, float3v v) {
  rows[0][i] = v.x;
  rows[1][i] = v.y;
  rows[2][i] = v.z;
}

// The packet's world octant (`_octant_of`), every thread taking part with
// its kLanes positional lanes' directions. One barrier: each warp adds its
// packed counts to the counts of round % 3, and thread 0 clears those of
// the next round, which every thread read before this round's barrier.
// `counters`: 3 x kVoteWords words of shared memory, zero before round 0.
__device__ __forceinline__ int packet_octant(const PacketState& s, unsigned* counters,
                                             int round) {
  unsigned packed = 0;
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    packed += mesh::positive_bits(get(s.d, threadIdx.x + j * kThreads));
  }
  const unsigned sum = __reduce_add_sync(0xffffffffu, packed);
  unsigned* counts = counters + (round % 3) * kVoteWords;
  if ((threadIdx.x & 31u) == 0) Counts::add(counts, sum);
  if (threadIdx.x < kVoteWords) counters[((round + 1) % 3) * kVoteWords + threadIdx.x] = 0;
  __syncthreads();
  return Counts::octant(counts);
}

// The packet's octant in the object space of each instance row k of m
// (mesh::to_object, as the walk takes it) into octants[k]; counts, K x
// kVoteWords words of shared memory (counted as the world vote's), are
// zero on entry and on return.
template <int Q>
__device__ __forceinline__ void packet_instance_octants(const mesh::MeshTablesOf<Q>& m,
                                                        const PacketState& s, unsigned* counts,
                                                        uint8_t* octants) {
  float3v d[kLanes];
#pragma unroll
  for (int j = 0; j < kLanes; ++j) d[j] = get(s.d, threadIdx.x + j * kThreads);
  for (int k = 0; k < m.n_instances; ++k) {
    const float* row = m.inst + mesh::kInstanceWidth * k;
    unsigned packed = 0;
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      packed += mesh::positive_bits(mesh::to_object(row, d[j].x, d[j].y, d[j].z));
    }
    const unsigned sum = __reduce_add_sync(0xffffffffu, packed);
    if ((threadIdx.x & 31u) == 0) Counts::add(counts + k * kVoteWords, sum);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < m.n_instances; k += kThreads) {
    octants[k] = Counts::octant(counts + k * kVoteWords);
#pragma unroll
    for (int w = 0; w < kVoteWords; ++w) counts[k * kVoteWords + w] = 0;
  }
  __syncthreads();
}

// The n-th live lane of the packet (n from 0), in lane order.
__device__ __forceinline__ int nth_live(const unsigned (&live)[kWords], int n) {
  int w = 0;
  for (; w < kWords - 1; ++w) {
    const int c = __popc(live[w]);
    if (n < c) break;
    n -= c;
  }
  return 32 * w + mesh::nth_bit(live[w], n);
}

// The packet's state at byte 0 of the dynamic shared memory.
constexpr size_t kStateBytes = (sizeof(PacketState) + 15) / 16 * 16;

// Byte offsets in the dynamic shared memory (mesh::stage_region each): the
// packet's state at 0, the six table regions (staged false: the tables are
// read from global memory, and none is placed), then the per-instance
// vote's counts and octants.
struct Layout {
  uint32_t offset[6];
  bool staged;
  uint32_t vote;
  uint32_t bytes;
};

// The node tables' rows: N and M, or 8N and 8M for the octant orders. The
// tables are staged where they fit beside the packet's state and the votes
// in path::kMaxStagedBytes.
template <int Q>
Layout plan(int n_tri_rows, int n_node_rows, int n_instances, int n_tlas_rows,
            bool instance_votes) {
  const size_t sizes[6] = {
      sizeof(float4) * 4 * static_cast<size_t>(n_tri_rows),
      mesh::Nodes<Q>::part_bytes(0, n_node_rows),
      mesh::Nodes<Q>::part_bytes(1, n_node_rows),
      sizeof(float) * mesh::kInstanceWidth * static_cast<size_t>(n_instances),
      mesh::Nodes<Q>::part_bytes(0, n_tlas_rows),
      mesh::Nodes<Q>::part_bytes(1, n_tlas_rows),
  };
  Layout layout = {};
  size_t total = kStateBytes;
  for (int i = 0; i < 6; ++i) {
    layout.offset[i] = static_cast<uint32_t>(total);
    total += mesh::stage_region(sizes[i]);
  }
  // Per instance its counts (kVoteWords words) and its octant byte.
  const size_t vote_bytes =
      instance_votes
          ? ((4 * kVoteWords + 1) * static_cast<size_t>(n_instances) + 15) / 16 * 16
          : 0;
  layout.staged = total + vote_bytes <= static_cast<size_t>(path::kMaxStagedBytes);
  layout.vote = static_cast<uint32_t>(layout.staged ? total : kStateBytes);
  layout.bytes = layout.vote + static_cast<uint32_t>(vote_bytes);
  return layout;
}

// kOrdered: the octant-ordered walk, each bounce's per-instance votes in
// the vote region (`instance_votes`: the BVH has more than one node).
template <bool kOrdered, int Q>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
trace_fused_mesh_tlas_kernel(const float* __restrict__ origins,
                             const float* __restrict__ directions, int n_rays,
                             const float4* __restrict__ spheres, int n_spheres,
                             const float* __restrict__ params, mesh::MeshTablesOf<Q> tables,
                             mesh::TlasTablesOf<Q> tlas, int n_tri_rows, int n_node_rows,
                             Layout layout, bool instance_votes, uint32_t seed, int max_bounces,
                             float* __restrict__ radiance_out, int* __restrict__ next_packet) {
  __shared__ path::SceneShared scene;
  __shared__ unsigned world_votes[3 * kVoteWords];
  __shared__ uint64_t barrier;
  extern __shared__ float4 staging[];
  char* smem = reinterpret_cast<char*>(staging);
  PacketState& state = *reinterpret_cast<PacketState*>(smem);
  if (layout.staged) {
    const mesh::Range ranges[6] = {
        {smem + layout.offset[0], reinterpret_cast<const char*>(tables.tris),
         static_cast<uint32_t>(sizeof(float4) * 4 * n_tri_rows)},
        {smem + layout.offset[1], tables.nodes.part(0),
         static_cast<uint32_t>(mesh::Nodes<Q>::part_bytes(0, n_node_rows))},
        {smem + layout.offset[2], tables.nodes.part(1),
         static_cast<uint32_t>(mesh::Nodes<Q>::part_bytes(1, n_node_rows))},
        {smem + layout.offset[3], reinterpret_cast<const char*>(tables.inst),
         static_cast<uint32_t>(sizeof(float) * mesh::kInstanceWidth * tables.n_instances)},
        {smem + layout.offset[4], tlas.nodes.part(0),
         static_cast<uint32_t>(mesh::Nodes<Q>::part_bytes(0, tlas.n_rows))},
        {smem + layout.offset[5], tlas.nodes.part(1),
         static_cast<uint32_t>(mesh::Nodes<Q>::part_bytes(1, tlas.n_rows))},
    };
    mesh::stage_ranges(ranges, &barrier);
    tables.tris = reinterpret_cast<const float4*>(ranges[0].staged());
    tables.nodes.set_parts(ranges[1].staged(), ranges[2].staged());
    tables.inst = reinterpret_cast<const float*>(ranges[3].staged());
    tlas.nodes.set_parts(ranges[4].staged(), ranges[5].staged());
  }
  unsigned* counts = reinterpret_cast<unsigned*>(smem + layout.vote);
  uint8_t* octants = reinterpret_cast<uint8_t*>(counts + kVoteWords * tables.n_instances);
  if (kOrdered) {
    if (threadIdx.x < 3 * kVoteWords) world_votes[threadIdx.x] = 0;
    if (instance_votes) {
      for (int k = threadIdx.x; k < kVoteWords * tables.n_instances; k += kThreads) counts[k] = 0;
    }
  }
  path::load_scene(scene, spheres, n_spheres, params);  // ends with __syncthreads()

  const int t = static_cast<int>(threadIdx.x);
  const int packets = (n_rays + kPacket - 1) / kPacket;
  const uint32_t counter_stride = 2u * static_cast<uint32_t>(max_bounces) + 2u;
  const float3v sun = {scene.params[0], scene.params[1], scene.params[2]};
  const int sun_row = mesh::octant_of(sun) * tlas.n_nodes;
  int round = 0;  // the block's world votes so far
  for (;;) {
    if (t == 0) state.packet = atomicAdd(next_packet, 1);
    __syncthreads();  // also: the last packet's state is read and written
    const int packet = state.packet;
    if (packet >= packets) break;  // uniform per block
    const int first = packet * kPacket;  // the launch's lanes fit an int
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      // A lane past the launch: the reference's pad ray, never alive.
      const int lane = t + j * kThreads;
      const bool in_launch = first + lane < n_rays;
      put(state.o, lane,
          in_launch ? path::load3(origins, first + lane) : float3v{0.0f, 0.0f, 0.0f});
      put(state.d, lane,
          in_launch ? path::load3(directions, first + lane) : float3v{0.0f, 1.0f, 0.0f});
      state.thr[lane] = {1.0f, 1.0f, 1.0f};
      state.rad[lane] = {0.0f, 0.0f, 0.0f};
      state.alive[lane] = in_launch ? 1 : 0;
    }
    for (int bounce = 0; bounce < max_bounces; ++bounce) {
      // The live mask: positional lanes' alive flags (this thread's own
      // writes, or a walker's before the last barrier), a ballot a warp and
      // positional word.
#pragma unroll
      for (int j = 0; j < kLanes; ++j) {
        const int lane = t + j * kThreads;
        const unsigned word = __ballot_sync(0xffffffffu, state.alive[lane] != 0);
        if ((lane & 31) == 0) state.live[lane / 32] = word;
      }
      int tlas_row = 0;
      if constexpr (kOrdered) {
        // Every lane votes with the direction it carries; the vote's
        // barrier also publishes the live mask.
        tlas_row = packet_octant(state, world_votes, round++) * tlas.n_nodes;
        if (instance_votes) packet_instance_octants(tables, state, counts, octants);
      } else {
        __syncthreads();
      }
      int walkers = 0;
#pragma unroll
      for (int w = 0; w < kWords; ++w) walkers += __popc(state.live[w]);
      if (walkers == 0) break;  // uniform: no path of the packet is left
      // The live lanes in lane order, thread t taking the t-th, t + kThreads-th...
      for (int n = t; n < walkers; n += kThreads) {
        const int i = nth_live(state.live, n);
        float3v o = get(state.o, i), d = get(state.d, i);
        const uint32_t path_lane = static_cast<uint32_t>(first + i);
        bool still;
        if constexpr (kOrdered) {
          const mesh::TlasInstances<mesh::Octants, Q> instances = {
              tlas, 0, tlas.n_nodes, {instance_votes ? octants : nullptr, tlas_row, sun_row}};
          still = mesh::bounce(scene, 0, n_spheres, tables, instances, path_lane, bounce,
                               counter_stride, seed, o, d, state.thr[i], state.rad[i]);
        } else {
          const mesh::TlasInstances<mesh::Canonical, Q> instances = {tlas, 0, tlas.n_nodes};
          still = mesh::bounce(scene, 0, n_spheres, tables, instances, path_lane, bounce,
                               counter_stride, seed, o, d, state.thr[i], state.rad[i]);
        }
        put(state.o, i, o);
        put(state.d, i, d);
        state.alive[i] = still ? 1 : 0;
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      const int lane = t + j * kThreads;
      if (first + lane < n_rays) path::store3(radiance_out, first + lane, state.rad[lane]);
    }
    // Every thread has read state.packet before thread 0 takes the next
    // (at max_bounces 0 no barrier of the bounce loop stands between).
    __syncthreads();
  }
}

template <bool kOrdered, int Q>
int launch(const float* origins, const float* directions, int n_rays, const float* spheres,
           int n_spheres, const float* params, const mesh::MeshTablesOf<Q>& tables,
           const mesh::TlasTablesOf<Q>& tlas, int n_tri_rows, int n_node_rows, int seed,
           int max_bounces, float* radiance, int* work_counter, cudaStream_t stream) {
  const auto kernel = trace_fused_mesh_tlas_kernel<kOrdered, Q>;
  const bool instance_votes = kOrdered && tables.n_nodes > 1;
  const Layout layout =
      plan<Q>(n_tri_rows, n_node_rows, tables.n_instances, tlas.n_rows, instance_votes);
  int resident = 0;
  cudaError_t status = mesh::card_blocks(kernel, kThreads, layout.bytes, &resident);
  if (status != cudaSuccess) return static_cast<int>(status);
  // As many blocks as are resident at once, and no more than the packets.
  const int packets = (n_rays + kPacket - 1) / kPacket;
  const int blocks = packets < resident ? packets : resident;
  status = cudaMemsetAsync(work_counter, 0, sizeof(int), stream);
  if (status != cudaSuccess) return static_cast<int>(status);
  kernel<<<blocks, kThreads, layout.bytes, stream>>>(
      origins, directions, n_rays, reinterpret_cast<const float4*>(spheres), n_spheres, params,
      tables, tlas, n_tri_rows, n_node_rows, layout, instance_votes, static_cast<uint32_t>(seed),
      max_bounces, radiance, work_counter);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry for ctypes, as trace_fused_mesh_launch with the instances
// in slot order and, after the BVH, the frame's TLAS: node bounds
// [n_tlas_nodes, 8] (lo, 0, hi, 0) and links [n_tlas_nodes, 4] (int32 skip,
// first slot, slot count, 0; kernels.tlas_links), then `ordered`: nonzero
// when the BVH's and the TLAS's tables are their eight octant orders
// stacked, [8 n_nodes] and [8 n_tlas_nodes] rows (kernels.tlas_octant_links);
// after the radiance the work counter, one int32 in device memory that no
// other launch uses meanwhile (cleared here on `stream` before the kernel).
// Last, the node format: `quant` 1 or 2, `node_bounds` and `tlas_bounds`
// hold the quantized node words (kernels.QuantTable), the links are unused,
// and `blas_grid` and `tlas_grid` point at the tables' grids, 6 floats each
// in host memory.
extern "C" int trace_fused_mesh_tlas_launch(
    const float* origins, const float* directions, int n_rays, const float* spheres,
    int n_spheres, const float* params, const float* instances, int n_instances,
    const float* triangles, int n_tri_rows, const float* node_bounds, const int* node_links,
    int n_nodes, const float* tlas_bounds, const int* tlas_links, int n_tlas_nodes, int ordered,
    int seed, int max_bounces, float* radiance, int* work_counter, int quant,
    const float* blas_grid, const float* tlas_grid, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaSuccess);
  if (n_rays > INT32_MAX - kPacket || n_spheres < 1 || n_spheres > path::kMaxSpheres ||
      max_bounces < 0 || n_instances < 1 || n_tri_rows < 1 || n_nodes < 1 || n_tlas_nodes < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int orders = ordered ? 8 : 1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return mesh::with_format(quant, {blas_grid, tlas_grid}, [&](auto format) {
    constexpr int Q = decltype(format)::value;
    const mesh::MeshTablesOf<Q> tables = {
        instances, reinterpret_cast<const float4*>(triangles),
        mesh::nodes_of<Q>(node_bounds, node_links, blas_grid, mesh::kLeafRows), n_instances,
        n_nodes};
    const mesh::TlasTablesOf<Q> tlas = {mesh::nodes_of<Q>(tlas_bounds, tlas_links, tlas_grid, 1),
                                        n_tlas_nodes, orders * n_tlas_nodes};
    if (ordered) {
      return launch<true, Q>(origins, directions, n_rays, spheres, n_spheres, params, tables,
                             tlas, n_tri_rows, orders * n_nodes, seed, max_bounces, radiance,
                             work_counter, s);
    }
    return launch<false, Q>(origins, directions, n_rays, spheres, n_spheres, params, tables,
                            tlas, n_tri_rows, n_nodes, seed, max_bounces, radiance, work_counter,
                            s);
  });
}

// The blocks of the kernel of the walk order and node format `quant`
// resident on one SM at a launch of these tables (a negative CUDA error code
// on failure), with the launch's dynamic shared memory in *shared_bytes.
extern "C" int trace_fused_mesh_tlas_occupancy(int n_instances, int n_tri_rows, int n_nodes,
                                               int n_tlas_nodes, int ordered, int* shared_bytes,
                                               int quant) {
  if (quant < 0 || quant > 2) return -static_cast<int>(cudaErrorInvalidValue);
  const int orders = ordered ? 8 : 1;
  return mesh::with_format(quant, {}, [&](auto format) {
    constexpr int Q = decltype(format)::value;
    const Layout layout = plan<Q>(n_tri_rows, orders * n_nodes, n_instances,
                                  orders * n_tlas_nodes, ordered && n_nodes > 1);
    *shared_bytes = static_cast<int>(layout.bytes);
    int blocks_per_sm = 0;
    const cudaError_t status =
        ordered ? mesh::blocks_per_sm(trace_fused_mesh_tlas_kernel<true, Q>, kThreads,
                                      layout.bytes, &blocks_per_sm)
                : mesh::blocks_per_sm(trace_fused_mesh_tlas_kernel<false, Q>, kThreads,
                                      layout.bytes, &blocks_per_sm);
    return status == cudaSuccess ? blocks_per_sm : -static_cast<int>(status);
  });
}

// The packet width this library was built for (TRC_PACKET).
extern "C" int trace_fused_mesh_tlas_packet() { return kPacket; }

extern "C" const char* trace_fused_mesh_tlas_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
