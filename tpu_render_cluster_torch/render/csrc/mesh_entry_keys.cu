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
//     boxes alone; of equal entries the slot its packet's table meets
//     first), or K where the ray overlaps none;
//   - every other lane keys with K, and so does every lane of the last
//     bounce, whose key no sort reads;
//   - the key itself is mesh::coherence_key (dead flag at bit 29, frame id
//     0) in the frame's key window.
// A packet is kPacket lanes (tlas_block_r(): 256, or the width the library
// was built for, 128 to 1,024: a block of as many threads) in launch order;
// every lane votes with the direction the bounce left it (a dead lane's and
// a lane's past the live count unchanged), a lane past the launch with
// (0, 1, 0).
//
// Bound: bytes at full width: 24 bytes of origin and direction, 1 of alive
// read and 4 of key written a lane (29), against the entry walk's work,
// about 2 ceil(log2 K) node tests and the world boxes of the leaves entered
// per live lane. What holds it back is the walk: at the 03 wavefront's
// bounce 0 a walking lane tests 6.3 nodes and 2.8 slots on average, but the
// longest lane of a warp of 32 about 18 and 12; without the walk the pass
// takes a fifth of its time. Design, a thread a lane and a block of kPacket
// threads a packet (the vote a warp sum of the packed sign counts, then one
// barrier):
//   - the walk takes one box test a step (a node, or one slot of the leaf
//     it entered; `step`), so a warp's steps are its longest walk's box
//     tests, whatever leaves its lanes enter and when (the earlier design
//     ran each leaf's slot loop apart for the few lanes in a leaf);
//   - after the vote the block regroups its packet's lanes among its
//     threads (`regrouped_lane`): the walking lanes first, grouped by the
//     octant of their new direction, so a warp walks alike rays, and a
//     warp of lanes that do not walk only writes their keys;
//   - a walk reads of a slot only its world box: the blocks stage the
//     boxes alone, as float4 pairs like the node bounds (stage_boxes), so a
//     step loads two float4 whether it tests a node or a slot;
//   - a launch of at least kPacketsPerBlock packets a resident block (1,024
//     lanes a block: 4 packets of 256) runs
//     persistent blocks, as many as are resident at once, each staging the
//     slots' boxes and, by bulk copy (mesh::stage_ranges), the TLAS's eight
//     octant tables once (13.5 KB for 48 instances), and taking packets
//     from the caller's work counter (one atomicAdd a packet, cleared on the
//     launch's stream). The lanes of packets at or past the live count, and
//     every lane of the last bounce, key with K in a grid-stride loop first;
//   - a narrower launch (the later bounces, the tiles: a persistent block
//     would stage all eight tables for one to three packets), and any launch
//     whose eight tables pass path::kMaxStagedBytes, runs a block a packet,
//     which stages its octant's rows and the boxes (3.0 KB for 48 instances)
//     after its vote, as the earlier design staged its rows; so every (K,
//     nodes) the earlier design took is taken.
// Other designs measured, each bit-equal and slower (PERF.md, section 6): a
// warp a packet with its walkers compacted into rounds of 32 (no barrier
// after staging), those rounds walked in lockstep, walkers refilled as
// lanes finish, a packet split over 2-8 blocks, the node rows read through
// L1, the next packet fetched ahead; and each mode alone at every width.
// Built with --fmad=false.
//
// Node format: instantiated for the three formats of mesh::Nodes (fp32, the
// reference's quantized tiers 1 and 2: the eight octant tables staged at 16
// or 12 bytes a node in place of 48), the launch's `quant` picking one. On
// a quantized tier the key follows the reference's packed-key rule
// (pallas_kernels.py:3030-3036, :3089-3102), from the bounce's `hits`
// column (each lane's winning slot, K for none): a lane with a hit keys
// with it, on every bounce and past the live count alike, and walks no
// entry.

#include "mesh_common.cuh"

namespace {

using path::float3v;
// The reference's TLAS packet (tlas_block_r(): 256, or the library's width):
// a block.
constexpr int kPacket = mesh::kTlasPacket;
constexpr int kOrders = 8;  // the TLAS's octant tables
// A vote's counts: one word up to 512 lanes, two at 1,024.
using Counts = mesh::PacketCounts<kPacket>;
constexpr int kVoteWords = Counts::kWords;
// A launch of at least this many packets a resident block runs persistent
// blocks: at 256 lanes a packet 4 (03: 3,168 packets; PERF.md, section 6:
// the 03 wavefront's 8,192-packet launches 8-9% faster persistent, its and
// its tile's launches of 2,048 packets or fewer 5-18% faster a block a
// packet), and at the other widths the same 1,024 lanes a resident block.
constexpr int kPacketsPerBlock = kPacket >= 1024 ? 1 : 1024 / kPacket;

// The persistent kernel's staged tables: the slots' boxes (stage_boxes) at
// 0, the eight octant tables' node bounds and links at their byte offsets
// (mesh::stage_region each), and the total (0: they pass
// path::kMaxStagedBytes, and no persistent block runs).
struct Layout {
  uint32_t bounds, links;
  uint32_t bytes;
};

template <int Q>
Layout plan(int n_instances, int tlas_nodes) {
  const size_t boxes = sizeof(float4) * 2 * static_cast<size_t>(n_instances);
  const size_t rows = kOrders * static_cast<size_t>(tlas_nodes);
  const size_t bounds = mesh::stage_region(mesh::Nodes<Q>::part_bytes(0, rows));
  const size_t links = mesh::stage_region(mesh::Nodes<Q>::part_bytes(1, rows));
  if (boxes + bounds + links > static_cast<size_t>(path::kMaxStagedBytes)) return {0, 0, 0};
  return {static_cast<uint32_t>(boxes), static_cast<uint32_t>(boxes + bounds),
          static_cast<uint32_t>(boxes + bounds + links)};
}

// One lane's entry walk (mesh::GroupTlas<1>::entry_candidate, taken one
// box test a step): the node it tests next, or while `slot` < `slot_end`
// the leaf's slot it tests next, and the least entry so far.
struct Walker {
  float3v o, d, inv;
  float best_entry;
  int best, node, slot, slot_end;
};

// The walker's next box test, in the order of the walk: a leaf's slots in
// order (strict `<` on max(near, 0): the first met of equal entries stays),
// then the node the leaf skips to; a node entered before the best entry so
// far descends (a leaf: its slots next), else skips. Node and slot boxes
// share the slab arithmetic of mesh::slab and mesh::slot_box, so each test
// is the walk's own, bit for bit. True while the walk goes on.
template <int Q>
__device__ __forceinline__ bool step(Walker& w, const float4* boxes, const mesh::Nodes<Q>& nodes,
                                     int row, int tlas_nodes) {
  const bool in_leaf = w.slot < w.slot_end;
  int4 link = {0, 0, 0, 0};
  float3v lo, hi;
  if constexpr (Q == 0) {
    // One pointer, then two float4 loads, whichever box the step tests.
    const float4* box;
    if (in_leaf) {
      box = boxes + 2 * w.slot;
    } else {
      link = nodes.links[row + w.node];
      box = nodes.bounds + 2 * (row + w.node);
    }
    const float4 l = box[0];
    const float4 h = box[1];
    lo = {l.x, l.y, l.z};
    hi = {h.x, h.y, h.z};
  } else if (in_leaf) {
    const float4 l = boxes[2 * w.slot];
    const float4 h = boxes[2 * w.slot + 1];
    lo = {l.x, l.y, l.z};
    hi = {h.x, h.y, h.z};
  } else {
    link = nodes.link(row + w.node);
    nodes.corners(row + w.node, lo, hi);
  }
  const float lox = (lo.x - w.o.x) * w.inv.x, hix = (hi.x - w.o.x) * w.inv.x;
  const float loy = (lo.y - w.o.y) * w.inv.y, hiy = (hi.y - w.o.y) * w.inv.y;
  const float loz = (lo.z - w.o.z) * w.inv.z, hiz = (hi.z - w.o.z) * w.inv.z;
  const float tnear = fmaxf(fmaxf(fminf(lox, hix), fminf(loy, hiy)), fminf(loz, hiz));
  const float tfar = fminf(fminf(fmaxf(lox, hix), fmaxf(loy, hiy)), fmaxf(loz, hiz));
  const bool reached = tfar >= fmaxf(tnear, 0.0f);
  if (in_leaf) {
    const float entry = fmaxf(tnear, 0.0f);
    if (reached && entry < w.best_entry) {
      w.best_entry = entry;
      w.best = w.slot;
    }
    ++w.slot;
  } else if (!(reached && tnear < w.best_entry)) {
    w.node = link.x;
  } else if (link.z > 0) {
    w.slot = link.y;
    w.slot_end = link.y + link.z;
    w.node = link.x;
  } else {
    w.node = w.node + 1;
  }
  return w.slot < w.slot_end || w.node < tlas_nodes;
}

// The key of one lane of a packet whose table of the vote starts at node
// row `row` (walked only when alive below the live count).
// The lane's key: its candidate `hit` (K, or on a quantized tier the
// bounce's winning slot), or where it `walks` the entry walk's.
template <int Q>
__device__ __forceinline__ int lane_key(Walker& w, bool is_alive, bool walks, int hit,
                                        const float4* boxes, const mesh::Nodes<Q>& nodes,
                                        int row, int tlas_nodes,
                                        const float* __restrict__ window) {
  w.best = hit;
  if (walks) {
    w.inv = mesh::winv3(w.d);
    w.best_entry = path::kInf;
    w.node = 0;
    w.slot = w.slot_end = 0;
    while (step(w, boxes, nodes, row, tlas_nodes)) {
    }
  }
  return mesh::coherence_key(w.o, w.d, !is_alive, 0, w.best, window);
}

// A lane's candidate before its walk: its hit slot on a quantized tier (K
// where it hit none), else K.
__device__ __forceinline__ int hit_of(const int* __restrict__ hits, int64_t ray, int n_rays,
                                      int n_instances) {
  return hits == nullptr || ray >= n_rays ? n_instances : hits[ray];
}

// A lane's outputs of the bounce (a lane past the launch: the reference's
// pad ray, direction (0, 1, 0)); whether it is alive.
__device__ __forceinline__ bool load_lane(Walker& w, const float* __restrict__ origins,
                                          const float* __restrict__ directions,
                                          const uint8_t* __restrict__ alive, int64_t ray,
                                          int n_rays) {
  w.o = {0.0f, 0.0f, 0.0f};
  w.d = {0.0f, 1.0f, 0.0f};
  if (ray >= n_rays) return false;
  w.o = path::load3(origins, ray);
  w.d = path::load3(directions, ray);
  return alive[ray] != 0;
}

// The lane of its packet that this thread walks: the walking lanes first,
// grouped by the octant of their new direction (so a warp walks rays of
// one octant from neighbouring origins), then the others. Every thread of
// the block calls it after the vote's barrier, which follows the clearing
// of `counts` (9 ints); `perm` holds kPacket ints.
__device__ __forceinline__ int regrouped_lane(bool walks, float3v d, int* counts, int* perm) {
  const int bucket = walks ? mesh::octant_of(d) : 8;
  const int at = atomicAdd(&counts[bucket], 1);
  __syncthreads();
  int offset = 0;
  for (int b = 0; b < bucket; ++b) offset += counts[b];
  perm[offset + at] = threadIdx.x;
  __syncthreads();
  return perm[threadIdx.x];
}

// The slots' world boxes (floats 13-18 of their rows) as float4 pairs (lo,
// 0, hi, 0), like the node bounds, written by the block's threads: a walk
// reads nothing else of a slot.
__device__ __forceinline__ void stage_boxes(float4* boxes, const float* __restrict__ slots,
                                            int n_instances) {
  for (int i = threadIdx.x; i < 2 * n_instances; i += blockDim.x) {
    const float* row = slots + mesh::kInstanceWidth * (i >> 1) + 13 + 3 * (i & 1);
    boxes[i] = make_float4(row[0], row[1], row[2], 0.0f);
  }
}

// A block a packet (kPersistent false): after the vote the block stages its
// octant's node rows and the slots' boxes (bounds [2 M], links [M], boxes
// [2 K]); `layout` and `next_packet` are not read.
template <int Q>
__device__ __forceinline__ void packet_block(const float* __restrict__ origins,
                                             const float* __restrict__ directions,
                                             const uint8_t* __restrict__ alive, int n_rays,
                                             int live, const float* __restrict__ slots,
                                             int n_instances, const mesh::Nodes<Q>& tlas,
                                             int tlas_nodes, const int* __restrict__ hits,
                                             const float* __restrict__ key_window, bool last,
                                             int* __restrict__ keys, float4* staging,
                                             unsigned* votes) {
  __shared__ int counts[9];
  __shared__ int perm[kPacket];
  if (threadIdx.x < kVoteWords) votes[threadIdx.x] = 0;
  if (threadIdx.x < 9) counts[threadIdx.x] = 0;
  __syncthreads();
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kPacket;
  int64_t ray = first + threadIdx.x;
  Walker w;
  bool is_alive = load_lane(w, origins, directions, alive, ray, n_rays);
  int hit = hit_of(hits, ray, n_rays, n_instances);
  // The staged octant's two node-table parts, then the slots' boxes.
  char* part0 = reinterpret_cast<char*>(staging);
  char* part1 = part0 + mesh::round16(mesh::Nodes<Q>::part_bytes(0, tlas_nodes));
  float4* boxes = reinterpret_cast<float4*>(
      part1 + mesh::round16(mesh::Nodes<Q>::part_bytes(1, tlas_nodes)));
  mesh::Nodes<Q> staged = tlas;
  // Uniform per block: a packet past the live count, or the last bounce,
  // keys every lane with its hit (K where none).
  const bool walked = !last && first < live;
  if (walked) {
    const unsigned packed = __reduce_add_sync(0xffffffffu, mesh::positive_bits(w.d));
    if ((threadIdx.x & 31u) == 0) Counts::add(votes, packed);
    __syncthreads();
    const int row = Counts::octant(votes) * tlas_nodes;
    for (int part = 0; part < 2; ++part) {
      const char* rows = tlas.part(part);
      if (rows != nullptr) {
        mesh::copy_words(part == 0 ? part0 : part1,
                         rows + mesh::Nodes<Q>::part_bytes(part, row),
                         mesh::Nodes<Q>::part_bytes(part, tlas_nodes));
      }
    }
    staged.set_parts(part0, part1);
    stage_boxes(boxes, slots, n_instances);
    ray = first + regrouped_lane(is_alive && ray < live && hit >= n_instances, w.d, counts, perm);
    is_alive = load_lane(w, origins, directions, alive, ray, n_rays);
    hit = hit_of(hits, ray, n_rays, n_instances);
  }
  const int key = lane_key(w, is_alive, walked && is_alive && ray < live && hit >= n_instances,
                           hit, boxes, staged, 0, tlas_nodes, key_window);
  if (ray < n_rays) keys[ray] = key;
}

// A block a packet, or persistent blocks that stage the boxes and the eight
// octant tables once.
template <bool kPersistent, int Q>
__global__ void __launch_bounds__(kPacket)
mesh_entry_keys_kernel(const float* __restrict__ origins, const float* __restrict__ directions,
                       const uint8_t* __restrict__ alive, int n_rays,
                       const int* __restrict__ live_count, const float* __restrict__ slots,
                       int n_instances, mesh::Nodes<Q> tlas, int tlas_nodes,
                       const int* __restrict__ hits, const float* __restrict__ key_window,
                       bool last, Layout layout, int* __restrict__ keys,
                       int* __restrict__ next_packet) {
  __shared__ uint64_t barrier;
  __shared__ int packet_of[2];
  __shared__ unsigned votes[2 * kVoteWords];
  extern __shared__ float4 staging[];
  const int live = min(max(*live_count, 0), n_rays);
  if constexpr (!kPersistent) {
    packet_block(origins, directions, alive, n_rays, live, slots, n_instances, tlas, tlas_nodes,
                 hits, key_window, last, keys, staging, votes);
    return;
  }
  // Persistent blocks. The packets a walk reads: those below the live
  // count, none on the last bounce (uniform per launch).
  const int walked = last ? 0 : static_cast<int>((static_cast<int64_t>(live) + kPacket - 1) /
                                                 kPacket);
  // Every lane of the other packets keys with its hit (K where none):
  // grid-stride, no counter.
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kPacket;
  for (int64_t ray = static_cast<int64_t>(walked) * kPacket + blockIdx.x * kPacket + threadIdx.x;
       ray < n_rays; ray += stride) {
    keys[ray] = mesh::coherence_key(path::load3(origins, ray), path::load3(directions, ray),
                                    alive[ray] == 0, 0, hit_of(hits, ray, n_rays, n_instances),
                                    key_window);
  }
  if (walked == 0) return;
  const float4* boxes = staging;
  stage_boxes(staging, slots, n_instances);
  char* smem = reinterpret_cast<char*>(staging);
  const mesh::Range ranges[2] = {
      {smem + layout.bounds, tlas.part(0),
       static_cast<uint32_t>(mesh::Nodes<Q>::part_bytes(0, kOrders * tlas_nodes))},
      {smem + layout.links, tlas.part(1),
       static_cast<uint32_t>(mesh::Nodes<Q>::part_bytes(1, kOrders * tlas_nodes))},
  };
  mesh::stage_ranges(ranges, &barrier);  // ends with a barrier: the boxes too
  tlas.set_parts(ranges[0].staged(), ranges[1].staged());
  // Round r's packet and vote sit in slot r % 2: thread 0 fills the slot
  // of round r + 1 only after the second barrier of round r, which every
  // thread passes after its last read of the slot (from round r - 1). The
  // regrouping's counts are cleared before that round's vote barrier and
  // `perm` written after it, after every thread's last read of round r - 1's.
  __shared__ int counts[9];
  __shared__ int perm[kPacket];
  for (int round = 0;; ++round) {
    const int at = round & 1;
    if (threadIdx.x == 0) {
      packet_of[at] = atomicAdd(next_packet, 1);
#pragma unroll
      for (int v = 0; v < kVoteWords; ++v) votes[at * kVoteWords + v] = 0;
    }
    __syncthreads();
    const int packet = packet_of[at];
    if (packet >= walked) break;
    const int64_t first = static_cast<int64_t>(packet) * kPacket;
    int64_t ray = first + threadIdx.x;
    Walker w;
    bool is_alive = load_lane(w, origins, directions, alive, ray, n_rays);
    const unsigned packed = __reduce_add_sync(0xffffffffu, mesh::positive_bits(w.d));
    if ((threadIdx.x & 31u) == 0) Counts::add(votes + at * kVoteWords, packed);
    if (threadIdx.x < 9) counts[threadIdx.x] = 0;
    __syncthreads();
    const int row = Counts::octant(votes + at * kVoteWords) * tlas_nodes;
    int hit = hit_of(hits, ray, n_rays, n_instances);
    ray = first + regrouped_lane(is_alive && ray < live && hit >= n_instances, w.d, counts, perm);
    is_alive = load_lane(w, origins, directions, alive, ray, n_rays);
    hit = hit_of(hits, ray, n_rays, n_instances);
    const int key = lane_key(w, is_alive, is_alive && ray < live && hit >= n_instances, hit,
                             boxes, tlas, row, tlas_nodes, key_window);
    if (ray < n_rays) keys[ray] = key;
  }
}

template <int Q>
using Kernel = decltype(&mesh_entry_keys_kernel<true, Q>);

// A launch's kernel, grid and dynamic shared memory, by the width rule, and
// the kernel's resident blocks on one SM.
template <int Q>
struct Launch {
  bool persistent;
  Kernel<Q> kernel;
  Layout layout;  // the persistent kernel's staging
  size_t bytes;
  int blocks;
  int blocks_per_sm;
};

template <int Q>
cudaError_t plan_launch(int n_rays, int n_instances, int tlas_nodes, Launch<Q>* launch) {
  launch->layout = plan<Q>(n_instances, tlas_nodes);
  const size_t one_octant = mesh::round16(mesh::Nodes<Q>::part_bytes(0, tlas_nodes)) +
                            mesh::round16(mesh::Nodes<Q>::part_bytes(1, tlas_nodes)) +
                            sizeof(float4) * 2 * n_instances;
  if (one_octant > static_cast<size_t>(path::kMaxStagedBytes)) return cudaErrorInvalidValue;
  const int64_t packets = (static_cast<int64_t>(n_rays) + kPacket - 1) / kPacket;
  int resident = 0;
  launch->persistent = launch->layout.bytes > 0;
  if (launch->persistent) {
    const cudaError_t status = mesh::card_blocks(mesh_entry_keys_kernel<true, Q>, kPacket,
                                                 launch->layout.bytes, &resident);
    if (status != cudaSuccess) return status;
    launch->persistent = packets >= static_cast<int64_t>(kPacketsPerBlock) * resident;
  }
  if (launch->persistent) {
    launch->kernel = mesh_entry_keys_kernel<true, Q>;
    launch->bytes = launch->layout.bytes;
    launch->blocks = static_cast<int>(packets < resident ? packets : resident);
  } else {
    launch->kernel = mesh_entry_keys_kernel<false, Q>;
    launch->bytes = one_octant;
    launch->blocks = static_cast<int>(packets);
  }
  return mesh::blocks_per_sm(launch->kernel, kPacket, static_cast<uint32_t>(launch->bytes),
                             &launch->blocks_per_sm);
}

}  // namespace

// Plain C entry for ctypes: the keys [n_rays] int32 of a mesh_bounce_tlas
// launch's outputs (origins and directions [n_rays, 3], alive [n_rays]
// uint8) below *live_count (one int32 on the device), over the frame's
// instances in slot order [n_instances, 22] and its TLAS's eight octant
// orders stacked (bounds [8 tlas_nodes, 8], links [8 tlas_nodes, 4] int32,
// kernels.tlas_octant_links), in the key window [6]; `bounce` of
// `total_bounces`; `work_counter`, one int32 in device memory that no other
// launch uses meanwhile (the persistent blocks' packet counter, cleared
// here on `stream` before the kernel). Last, the node format: `quant` 1 or
// 2, `tlas_bounds` holds the quantized node words, `tlas_links` is unused,
// `grid` points at the table's grid (6 floats in host memory) and `hits`
// [n_rays] int32 holds the bounce's winning slots (K for none). Launches
// on `stream` and returns cudaGetLastError().
extern "C" int mesh_entry_keys_launch(const float* origins, const float* directions,
                                      const unsigned char* alive, int n_rays,
                                      const int* live_count, const float* slots,
                                      int n_instances, const float* tlas_bounds,
                                      const int* tlas_links, int tlas_nodes,
                                      const float* key_window, int bounce, int total_bounces,
                                      int* keys, int* work_counter, int quant,
                                      const float* grid, const int* hits, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaSuccess);
  if (n_instances < 1 || tlas_nodes < 1 || bounce < 0 || bounce >= total_bounces ||
      (quant != 0 && hits == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return mesh::with_format(quant, {grid}, [&](auto format) {
    constexpr int Q = decltype(format)::value;
    Launch<Q> launch;
    cudaError_t status = plan_launch<Q>(n_rays, n_instances, tlas_nodes, &launch);
    if (status != cudaSuccess) return static_cast<int>(status);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (launch.persistent) {
      status = cudaMemsetAsync(work_counter, 0, sizeof(int), s);
      if (status != cudaSuccess) return static_cast<int>(status);
    }
    launch.kernel<<<launch.blocks, kPacket, launch.bytes, s>>>(
        origins, directions, alive, n_rays, live_count, slots, n_instances,
        mesh::nodes_of<Q>(tlas_bounds, tlas_links, grid, 1), tlas_nodes,
        Q == 0 ? nullptr : hits, key_window, bounce == total_bounces - 1, launch.layout, keys,
        work_counter);
    return static_cast<int>(cudaGetLastError());
  });
}

// A launch of n_rays lanes over these tables: its kernel's resident blocks
// on one SM (a negative CUDA error code on failure), whether it runs
// persistent blocks in *persistent, its dynamic shared memory in
// *shared_bytes and its grid in *grid, at node format `quant`.
extern "C" int mesh_entry_keys_occupancy(int n_rays, int n_instances, int tlas_nodes,
                                         int* persistent, int* shared_bytes, int* grid,
                                         int quant) {
  if (n_rays < 1 || n_instances < 1 || tlas_nodes < 1 || quant < 0 || quant > 2) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  return mesh::with_format(quant, {}, [&](auto format) {
    constexpr int Q = decltype(format)::value;
    Launch<Q> launch;
    const cudaError_t status = plan_launch<Q>(n_rays, n_instances, tlas_nodes, &launch);
    if (status != cudaSuccess) return -static_cast<int>(status);
    *persistent = launch.persistent ? 1 : 0;
    *shared_bytes = static_cast<int>(launch.bytes);
    *grid = launch.blocks;
    return launch.blocks_per_sm;
  });
}

// The packet width this library was built for (TRC_PACKET).
extern "C" int mesh_entry_keys_packet() { return kPacket; }

extern "C" const char* mesh_entry_keys_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
