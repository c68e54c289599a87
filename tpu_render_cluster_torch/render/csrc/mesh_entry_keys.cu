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
// A packet is 256 lanes (tlas_block_r()) in launch order; every lane votes
// with the direction the bounce left it (a dead lane's and a lane's past the
// live count unchanged), a lane past the launch with (0, 1, 0).
//
// Bound: bytes at full width: 24 bytes of origin and direction, 1 of alive
// read and 4 of key written a lane (29), against the entry walk's work,
// about 2 ceil(log2 K) node tests and the world boxes of the leaves entered
// per live lane. What holds it back is the walk: at the 03 wavefront's
// bounce 0 a walking lane tests 6.3 nodes and 2.8 slots on average, but the
// longest lane of a warp of 32 about 18 and 12; without the walk the pass
// takes a fifth of its time. Design, a thread a lane and a block of 256
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
//   - a launch of at least kPacketsPerBlock packets a resident block runs
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

#include "mesh_common.cuh"

namespace {

using path::float3v;
constexpr int kPacket = 256;  // the reference's TLAS packet: a block
constexpr int kOrders = 8;  // the TLAS's octant tables
// A launch of at least this many packets a resident block (03: 3,168
// packets) runs persistent blocks (PERF.md, section 6: the 03 wavefront's
// 8,192-packet launches 8-9% faster persistent, its and its tile's launches
// of 2,048 packets or fewer 5-18% faster a block a packet).
constexpr int kPacketsPerBlock = 4;

// The persistent kernel's staged tables: the slots' boxes (stage_boxes) at
// 0, the eight octant tables' node bounds and links at their byte offsets
// (mesh::stage_region each), and the total (0: they pass
// path::kMaxStagedBytes, and no persistent block runs).
struct Layout {
  uint32_t bounds, links;
  uint32_t bytes;
};

Layout plan(int n_instances, int tlas_nodes) {
  const size_t boxes = sizeof(float4) * 2 * static_cast<size_t>(n_instances);
  const size_t bounds =
      mesh::stage_region(sizeof(float4) * 2 * kOrders * static_cast<size_t>(tlas_nodes));
  const size_t links = mesh::stage_region(sizeof(int4) * kOrders * static_cast<size_t>(tlas_nodes));
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
__device__ __forceinline__ bool step(Walker& w, const float4* boxes, const float4* bounds,
                                     const int4* links, int row, int tlas_nodes) {
  const bool in_leaf = w.slot < w.slot_end;
  int4 link = {0, 0, 0, 0};
  const float4* box;
  if (in_leaf) {
    box = boxes + 2 * w.slot;
  } else {
    link = links[row + w.node];
    box = bounds + 2 * (row + w.node);
  }
  const float4 lo = box[0];
  const float4 hi = box[1];
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
__device__ __forceinline__ int lane_key(Walker& w, bool is_alive, bool walks,
                                        const float4* boxes, const float4* bounds,
                                        const int4* links, int row,
                                        int tlas_nodes, int n_instances,
                                        const float* __restrict__ window) {
  w.best = n_instances;
  if (walks) {
    w.inv = mesh::winv3(w.d);
    w.best_entry = path::kInf;
    w.node = 0;
    w.slot = w.slot_end = 0;
    while (step(w, boxes, bounds, links, row, tlas_nodes)) {
    }
  }
  return mesh::coherence_key(w.o, w.d, !is_alive, 0, w.best, window);
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
__device__ __forceinline__ void packet_block(const float* __restrict__ origins,
                                             const float* __restrict__ directions,
                                             const uint8_t* __restrict__ alive, int n_rays,
                                             int live, const float* __restrict__ slots,
                                             int n_instances,
                                             const float4* __restrict__ tlas_bounds,
                                             const int4* __restrict__ tlas_links, int tlas_nodes,
                                             const float* __restrict__ key_window, bool last,
                                             int* __restrict__ keys, float4* staging,
                                             unsigned* votes) {
  __shared__ int counts[9];
  __shared__ int perm[kPacket];
  if (threadIdx.x == 0) *votes = 0;
  if (threadIdx.x < 9) counts[threadIdx.x] = 0;
  __syncthreads();
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kPacket;
  int64_t ray = first + threadIdx.x;
  Walker w;
  bool is_alive = load_lane(w, origins, directions, alive, ray, n_rays);
  float4* bounds = staging;
  int4* links = reinterpret_cast<int4*>(bounds + 2 * tlas_nodes);
  float4* boxes = reinterpret_cast<float4*>(links + tlas_nodes);
  // Uniform per block: a packet past the live count, or the last bounce,
  // keys every lane with K.
  const bool walked = !last && first < live;
  if (walked) {
    const unsigned packed = __reduce_add_sync(0xffffffffu, mesh::positive_bits(w.d));
    if ((threadIdx.x & 31u) == 0) atomicAdd(votes, packed);
    __syncthreads();
    const int row = mesh::octant_of_counts(*votes, kPacket) * tlas_nodes;
    for (int i = threadIdx.x; i < 2 * tlas_nodes; i += kPacket) {
      bounds[i] = tlas_bounds[2 * row + i];
    }
    for (int i = threadIdx.x; i < tlas_nodes; i += kPacket) links[i] = tlas_links[row + i];
    stage_boxes(boxes, slots, n_instances);
    ray = first + regrouped_lane(is_alive && ray < live, w.d, counts, perm);
    is_alive = load_lane(w, origins, directions, alive, ray, n_rays);
  }
  const int key = lane_key(w, is_alive, walked && is_alive && ray < live, boxes, bounds, links, 0,
                           tlas_nodes, n_instances, key_window);
  if (ray < n_rays) keys[ray] = key;
}

// A block a packet, or persistent blocks that stage the boxes and the eight
// octant tables once.
template <bool kPersistent>
__global__ void __launch_bounds__(kPacket)
mesh_entry_keys_kernel(const float* __restrict__ origins, const float* __restrict__ directions,
                       const uint8_t* __restrict__ alive, int n_rays,
                       const int* __restrict__ live_count, const float* __restrict__ slots,
                       int n_instances, const float4* __restrict__ tlas_bounds,
                       const int4* __restrict__ tlas_links, int tlas_nodes,
                       const float* __restrict__ key_window, bool last, Layout layout,
                       int* __restrict__ keys, int* __restrict__ next_packet) {
  __shared__ uint64_t barrier;
  __shared__ int packet_of[2];
  __shared__ unsigned votes[2];
  extern __shared__ float4 staging[];
  const int live = min(max(*live_count, 0), n_rays);
  if constexpr (!kPersistent) {
    packet_block(origins, directions, alive, n_rays, live, slots, n_instances, tlas_bounds,
                 tlas_links, tlas_nodes, key_window, last, keys, staging, votes);
    return;
  }
  // Persistent blocks. The packets a walk reads: those below the live
  // count, none on the last bounce (uniform per launch).
  const int walked = last ? 0 : static_cast<int>((static_cast<int64_t>(live) + kPacket - 1) /
                                                 kPacket);
  // Every lane of the other packets keys with K: grid-stride, no counter.
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kPacket;
  for (int64_t ray = static_cast<int64_t>(walked) * kPacket + blockIdx.x * kPacket + threadIdx.x;
       ray < n_rays; ray += stride) {
    keys[ray] = mesh::coherence_key(path::load3(origins, ray), path::load3(directions, ray),
                                    alive[ray] == 0, 0, n_instances, key_window);
  }
  if (walked == 0) return;
  const float4* boxes = staging;
  stage_boxes(staging, slots, n_instances);
  char* smem = reinterpret_cast<char*>(staging);
  const mesh::Range ranges[2] = {
      {smem + layout.bounds, reinterpret_cast<const char*>(tlas_bounds),
       static_cast<uint32_t>(sizeof(float4) * 2 * kOrders * tlas_nodes)},
      {smem + layout.links, reinterpret_cast<const char*>(tlas_links),
       static_cast<uint32_t>(sizeof(int4) * kOrders * tlas_nodes)},
  };
  mesh::stage_ranges(ranges, &barrier);  // ends with a barrier: the boxes too
  const float4* bounds = reinterpret_cast<const float4*>(ranges[0].staged());
  const int4* links = reinterpret_cast<const int4*>(ranges[1].staged());
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
      votes[at] = 0;
    }
    __syncthreads();
    const int packet = packet_of[at];
    if (packet >= walked) break;
    const int64_t first = static_cast<int64_t>(packet) * kPacket;
    int64_t ray = first + threadIdx.x;
    Walker w;
    bool is_alive = load_lane(w, origins, directions, alive, ray, n_rays);
    const unsigned packed = __reduce_add_sync(0xffffffffu, mesh::positive_bits(w.d));
    if ((threadIdx.x & 31u) == 0) atomicAdd(&votes[at], packed);
    if (threadIdx.x < 9) counts[threadIdx.x] = 0;
    __syncthreads();
    const int row = mesh::octant_of_counts(votes[at], kPacket) * tlas_nodes;
    ray = first + regrouped_lane(is_alive && ray < live, w.d, counts, perm);
    is_alive = load_lane(w, origins, directions, alive, ray, n_rays);
    const int key = lane_key(w, is_alive, is_alive && ray < live, boxes, bounds, links, row,
                             tlas_nodes, n_instances, key_window);
    if (ray < n_rays) keys[ray] = key;
  }
}

using Kernel = decltype(&mesh_entry_keys_kernel<true>);

// A launch's kernel, grid and dynamic shared memory, by the width rule, and
// the kernel's resident blocks on one SM.
struct Launch {
  bool persistent;
  Kernel kernel;
  Layout layout;  // the persistent kernel's staging
  size_t bytes;
  int blocks;
  int blocks_per_sm;
};

cudaError_t plan_launch(int n_rays, int n_instances, int tlas_nodes, Launch* launch) {
  launch->layout = plan(n_instances, tlas_nodes);
  const size_t one_octant = (2 * sizeof(float4) + sizeof(int4)) * tlas_nodes +
                            sizeof(float4) * 2 * n_instances;
  if (one_octant > static_cast<size_t>(path::kMaxStagedBytes)) return cudaErrorInvalidValue;
  const int64_t packets = (static_cast<int64_t>(n_rays) + kPacket - 1) / kPacket;
  int resident = 0;
  launch->persistent = launch->layout.bytes > 0;
  if (launch->persistent) {
    const cudaError_t status = mesh::card_blocks(mesh_entry_keys_kernel<true>, kPacket,
                                                 launch->layout.bytes, &resident);
    if (status != cudaSuccess) return status;
    launch->persistent = packets >= static_cast<int64_t>(kPacketsPerBlock) * resident;
  }
  if (launch->persistent) {
    launch->kernel = mesh_entry_keys_kernel<true>;
    launch->bytes = launch->layout.bytes;
    launch->blocks = static_cast<int>(packets < resident ? packets : resident);
  } else {
    launch->kernel = mesh_entry_keys_kernel<false>;
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
// here on `stream` before the kernel). Launches on `stream` and returns
// cudaGetLastError().
extern "C" int mesh_entry_keys_launch(const float* origins, const float* directions,
                                      const unsigned char* alive, int n_rays,
                                      const int* live_count, const float* slots,
                                      int n_instances, const float* tlas_bounds,
                                      const int* tlas_links, int tlas_nodes,
                                      const float* key_window, int bounce, int total_bounces,
                                      int* keys, int* work_counter, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaSuccess);
  if (n_instances < 1 || tlas_nodes < 1 || bounce < 0 || bounce >= total_bounces) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Launch launch;
  cudaError_t status = plan_launch(n_rays, n_instances, tlas_nodes, &launch);
  if (status != cudaSuccess) return static_cast<int>(status);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (launch.persistent) {
    status = cudaMemsetAsync(work_counter, 0, sizeof(int), s);
    if (status != cudaSuccess) return static_cast<int>(status);
  }
  launch.kernel<<<launch.blocks, kPacket, launch.bytes, s>>>(
      origins, directions, alive, n_rays, live_count, slots, n_instances,
      reinterpret_cast<const float4*>(tlas_bounds), reinterpret_cast<const int4*>(tlas_links),
      tlas_nodes, key_window, bounce == total_bounces - 1, launch.layout, keys, work_counter);
  return static_cast<int>(cudaGetLastError());
}

// A launch of n_rays lanes over these tables: its kernel's resident blocks
// on one SM (a negative CUDA error code on failure), whether it runs
// persistent blocks in *persistent, its dynamic shared memory in
// *shared_bytes and its grid in *grid.
extern "C" int mesh_entry_keys_occupancy(int n_rays, int n_instances, int tlas_nodes,
                                         int* persistent, int* shared_bytes, int* grid) {
  if (n_rays < 1 || n_instances < 1 || tlas_nodes < 1) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  Launch launch;
  const cudaError_t status = plan_launch(n_rays, n_instances, tlas_nodes, &launch);
  if (status != cudaSuccess) return -static_cast<int>(status);
  *persistent = launch.persistent ? 1 : 0;
  *shared_bytes = static_cast<int>(launch.bytes);
  *grid = launch.blocks;
  return launch.blocks_per_sm;
}

extern "C" const char* mesh_entry_keys_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
