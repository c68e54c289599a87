// Ray-pool mesh-scene bounce kernel, two-level instance walk, with the
// fused coherence-key epilogue, for Hopper (sm_90a).
//
// Replaces the TPU kernel `pool_mesh_bounce` / `_mesh_trace_kernel_factory`
// with pool_io=True and use_tlas=True, the reference's default
// (tpu_render_cluster/render/pallas_kernels.py): pool_mesh_bounce.cu's
// contract (pool_common.cuh: one bounce over a pool of lanes from several
// frames, each lane with its frame id, frame seed and bounce; lanes at or
// past the live count pass through) with each frame's instances in Morton
// slot order within the frame's rows of the stacked table, and one TLAS
// window per frame stacked the same way (frame f's M nodes at rows
// [f M, (f + 1) M), skip links offset by f M and leaf starts by f K:
// kernels.tlas_links, pallas_kernels.py:3903-3960). A lane walks only its
// own frame's window, which gives the hits of the reference's per-lane
// frame mask. After the bounce each lane writes its coherence key
// (mesh::coherence_key) for the pool's next sort:
//   - a lane alive after the bounce, below the live count and of a frame of
//     the window keys with the frame-local slot its new ray enters first
//     (the entry walk over its frame's window), or K where it overlaps none;
//   - every other lane keys with K;
//   - the frame id (clamped to 31) sits in the key; there is no last-bounce
//     rule: the pool's lanes sit at mixed depths and the next iteration
//     always sorts by this column.
// The TPU's dead lanes may pick up a packet-mate's candidate; the rule here
// is per lane, as in the plain version (kernels.pool_mesh_bounce_reference).
//
// Bound: operations, as pool_mesh_bounce.cu with the instance search a
// two-level walk of the lane's frame (and the entry walk per live lane),
// against 53 bytes of state in and 53 out per lane. What holds it back is
// latency: each lane's walk is a chain of dependent shared-memory loads,
// the pool (65,536 lanes at 512x512x8) fills a quarter of the card's
// thread slots at one thread a lane, and a block's slowest lane sets its
// time. Design:
//   - a group of G threads walks each lane (mesh::GroupTlas, G = 1, 2, 4 or
//     8, chosen per launch by the wrapper), splitting every leaf's triangle
//     rows and slot tests, so a launch runs G times the threads and each
//     lane's chain is shorter; the result is bit for bit the one-thread
//     walk's;
//   - the pool sorts lanes by the key, whose frame id sits above all but
//     the dead bit, so a block's live lanes hold one frame or two. A block
//     reduces its live lanes' frame ids to [lo, hi] and stages the BVH and
//     frames lo..hi of the sphere rows, slot table and TLAS windows, each
//     one contiguous range, by bulk copy (mesh::stage_ranges), up to
//     kStagedFrames frames (03_physics-2-mesh: 28 KB of BVH and 7 KB a
//     frame, against 82 KB for all 8 frames before). A block whose range
//     is wider reads the frame tables from global memory, and every block
//     does where the BVH alone passes 96 KB.
// Walk order: on a BVH with octant tables (every sah build; the
// reference's default) the staged BVH is its eight octant orders stacked,
// [8N] rows, and each lane's BLAS walks take the table of its packet (256
// lanes of the pool, tlas_block_r()): the packet's object-space octant per
// slot of the stacked table, voted by the pre-pass packet_octants.cu over
// all its lanes, other frames' included (mesh::Octants); the shadow walks
// take the sun's. The TLAS and the key's entry walk stay canonical, as the
// reference's pool kernel orders its BLAS only (pallas_kernels.py:4027).
// Built with --fmad=false.
//
// Node format: instantiated for the three formats of mesh::Nodes (fp32, the
// reference's quantized tiers 1 and 2), the launch's `quant` picking one. A
// quantized pool's stacked TLAS windows share one grid, their frame offsets
// inside the meta words (kernels.pool_tlas_quant); the key follows the
// reference's packed-key rule: a lane whose nearest hit was an instance
// keys with that slot of its frame (pallas_kernels.py:3029) and walks no
// entry.

#include <limits.h>

#include <type_traits>

#include "mesh_common.cuh"
#include "pool_common.cuh"

namespace {

using path::float3v;
constexpr int kThreads = 256;
// At least 3 resident blocks an SM: ptxas keeps a thread within 80
// registers. Without it ptxas takes 64 (4 blocks) and spills 104-196 bytes;
// with 1 or 2 it takes 94-108 registers, no spill, and 2 blocks run slower
// (PERF.md section 6).
constexpr int kMinBlocks = 3;
// Frames of per-frame tables a block stages at most.
constexpr int kStagedFrames = 2;

template <int Q>
struct Tables {
  mesh::MeshTablesOf<Q> mesh;  // instances: the stacked [F K, 22] slot tables
  mesh::Nodes<Q> tlas;  // the stacked windows [F M]
  int tlas_nodes;  // M
  int per_frame;  // K
  int n_tri_rows;
  const float* key_window;  // [6]
  int* keys;  // [P]
};

// The dynamic shared memory of a launch: byte offsets of the staged
// regions (mesh::stage_region each); bvh 0: nothing is staged.
struct Layout {
  int bvh;
  int frames;  // frames a block may stage, 0 to kStagedFrames
  uint32_t tris, bounds, links, spheres, slots, tlas_bounds, tlas_links;
  uint32_t bytes;
};

// n_node_rows: the BVH's node rows (8N for the octant orders).
template <int Q>
Layout plan(int n_tri_rows, int n_node_rows, int spheres_per_frame, int per_frame,
            int tlas_nodes, int n_frames) {
  for (int frames = kStagedFrames < n_frames ? kStagedFrames : n_frames; frames >= 0; --frames) {
    const size_t sizes[7] = {
        sizeof(float4) * 4 * static_cast<size_t>(n_tri_rows),
        mesh::Nodes<Q>::part_bytes(0, n_node_rows),
        mesh::Nodes<Q>::part_bytes(1, n_node_rows),
        sizeof(float4) * 4 * static_cast<size_t>(spheres_per_frame) * frames,
        sizeof(float) * mesh::kInstanceWidth * static_cast<size_t>(per_frame) * frames,
        mesh::Nodes<Q>::part_bytes(0, static_cast<size_t>(tlas_nodes) * frames),
        mesh::Nodes<Q>::part_bytes(1, static_cast<size_t>(tlas_nodes) * frames),
    };
    uint32_t offsets[7];
    size_t total = 0;
    for (int i = 0; i < 7; ++i) {
      offsets[i] = static_cast<uint32_t>(total);
      total += sizes[i] ? mesh::stage_region(sizes[i]) : 0;
    }
    if (total <= static_cast<size_t>(path::kMaxStagedBytes)) {
      return {1,          frames,     offsets[0], offsets[1], offsets[2], offsets[3],
              offsets[4], offsets[5], offsets[6], static_cast<uint32_t>(total)};
    }
  }
  return {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
}

// The reference's packet of the TLAS variants (tlas_block_r()): 256 lanes,
// or the library's width (mesh::kTlasPacket). A lane's votes are its
// packet's, whatever block of kThreads / G lanes walks it.
constexpr int kPacket = mesh::kTlasPacket;

// kOrdered: the octant-ordered BLAS walk, `slot_votes` [P, F K] the
// packets' votes (nullptr on a one-node BVH), the BVH's rows n_node_rows.
template <int G, bool kOrdered, int Q>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
pool_mesh_bounce_tlas_kernel(pool::State in, pool::Spheres spheres, Tables<Q> t, Layout layout,
                             int n_node_rows, const uint8_t* __restrict__ slot_votes,
                             int total_bounces, pool::Outputs out) {
  __shared__ float scene_params[path::kParams];
  __shared__ uint64_t barrier;
  __shared__ int warp_lo[kThreads / 32], warp_hi[kThreads / 32];
  extern __shared__ float4 staging[];
  const mesh::Group<G> g = mesh::Group<G>::of_thread();
  const int live = *in.live_count;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * (kThreads / G);
  const int64_t ray = first + threadIdx.x / G;
  float3v o, d, thr;
  bool is_alive;
  pool::load_lane(in, ray, o, d, thr, is_alive);
  float3v rad = {0.0f, 0.0f, 0.0f};
  int candidate = t.per_frame;

  // Uniform per block: a block wholly past the live count stages nothing.
  if (first < live) {
    const bool walks = is_alive && ray < live;
    const int fid = walks ? in.fids[ray] : -1;
    const bool in_window = fid >= 0 && fid < spheres.n_frames;
    int lo = __reduce_min_sync(0xffffffffu, in_window ? fid : INT_MAX);
    int hi = __reduce_max_sync(0xffffffffu, in_window ? fid : -1);
    if ((threadIdx.x & 31u) == 0) {
      warp_lo[threadIdx.x / 32] = lo;
      warp_hi[threadIdx.x / 32] = hi;
    }
    if (threadIdx.x < path::kParams) scene_params[threadIdx.x] = spheres.params[threadIdx.x];
    __syncthreads();
    for (int w = 0; w < kThreads / 32; ++w) {
      lo = min(lo, warp_lo[w]);
      hi = max(hi, warp_hi[w]);
    }
    // The frame tables of [lo, hi], staged where they fit, else global.
    const bool frames_staged = layout.frames > 0 && hi >= lo && hi - lo < layout.frames;
    const int base = frames_staged ? lo : 0;
    const uint32_t span = frames_staged ? static_cast<uint32_t>(hi - lo + 1) : 0u;
    mesh::MeshTablesOf<Q> m = t.mesh;
    const float4* sphere_rows = spheres.rows;
    mesh::Nodes<Q> tlas = t.tlas;
    if (layout.bvh) {
      char* smem = reinterpret_cast<char*>(staging);
      const size_t k_rows = static_cast<size_t>(t.per_frame) * base;
      const size_t m_rows = static_cast<size_t>(t.tlas_nodes) * base;
      const size_t s_rows = static_cast<size_t>(spheres.per_frame) * base;
      // A frame range's TLAS rows of each node-table part.
      const auto window = [&](int part) {
        const char* rows = t.tlas.part(part);
        return rows == nullptr ? rows : rows + mesh::Nodes<Q>::part_bytes(part, m_rows);
      };
      const mesh::Range ranges[7] = {
          {smem + layout.tris, reinterpret_cast<const char*>(m.tris),
           static_cast<uint32_t>(sizeof(float4) * 4 * t.n_tri_rows)},
          {smem + layout.bounds, m.nodes.part(0),
           static_cast<uint32_t>(mesh::Nodes<Q>::part_bytes(0, n_node_rows))},
          {smem + layout.links, m.nodes.part(1),
           static_cast<uint32_t>(mesh::Nodes<Q>::part_bytes(1, n_node_rows))},
          {smem + layout.spheres,
           reinterpret_cast<const char*>(spheres.rows + 4 * s_rows),
           static_cast<uint32_t>(sizeof(float4) * 4 * spheres.per_frame) * span},
          {smem + layout.slots,
           reinterpret_cast<const char*>(m.inst + mesh::kInstanceWidth * k_rows),
           static_cast<uint32_t>(sizeof(float) * mesh::kInstanceWidth * t.per_frame) * span},
          {smem + layout.tlas_bounds, window(0),
           static_cast<uint32_t>(mesh::Nodes<Q>::part_bytes(0, t.tlas_nodes)) * span},
          {smem + layout.tlas_links, window(1),
           static_cast<uint32_t>(mesh::Nodes<Q>::part_bytes(1, t.tlas_nodes)) * span},
      };
      mesh::stage_ranges(ranges, &barrier);  // ends with __syncthreads()
      m.tris = reinterpret_cast<const float4*>(ranges[0].staged());
      m.nodes.set_parts(ranges[1].staged(), ranges[2].staged());
      if (frames_staged) {
        sphere_rows = reinterpret_cast<const float4*>(ranges[3].staged());
        m.inst = reinterpret_cast<const float*>(ranges[4].staged());
        tlas.set_parts(ranges[5].staged(), ranges[6].staged());
      }
    }
    if (walks) {
      // A lane outside the window sees no sphere and no node.
      const int n = in_window ? spheres.per_frame : 0;
      using Order = std::conditional_t<kOrdered, mesh::Octants, mesh::Canonical>;
      Order order{};
      if constexpr (kOrdered) {
        const int64_t votes = (ray / kPacket) * m.n_instances;
        order = {slot_votes == nullptr ? nullptr : slot_votes + votes, 0, 0};
      }
      const mesh::GroupTlas<G, Order, Q> walk = {g,
                                                 tlas,
                                                 t.tlas_nodes * base,
                                                 t.per_frame * base,
                                                 in_window ? t.tlas_nodes * fid : 0,
                                                 in_window ? t.tlas_nodes * (fid + 1) : 0,
                                                 order};
      const path::SceneRows scene = {sphere_rows, scene_params};
      const uint32_t counter_stride = 2u * static_cast<uint32_t>(total_bounces) + 2u;
      int hit = -1;  // the winning row of m.inst (the packed-key rule, Q > 0)
      is_alive = mesh::bounce(scene, in_window ? (fid - base) * n : 0, n, m, walk,
                              static_cast<uint32_t>(in.lanes[ray]), in.bounces[ray],
                              counter_stride, static_cast<uint32_t>(in.seeds[ray]), o, d, thr,
                              rad, Q > 0 ? &hit : nullptr);
      if (hit >= 0) {
        candidate = hit - t.per_frame * (fid - base);  // its frame's slot
      } else if (is_alive && in_window) {
        candidate = walk.entry_candidate(m, o, d, t.per_frame * fid, t.per_frame);
      }
    }
  }
  if (ray >= in.n_rays || g.rank != 0) return;
  pool::store_lane(out, ray, rad, o, d, thr, is_alive);
  t.keys[ray] = mesh::coherence_key(o, d, !is_alive, in.fids[ray], candidate, t.key_window);
}

template <int G, bool kOrdered, int Q>
int launch_group(const pool::State& in, const pool::Spheres& spheres, const Tables<Q>& t,
                 const Layout& layout, int n_node_rows, const uint8_t* slot_votes,
                 int total_bounces, const pool::Outputs& out, cudaStream_t stream) {
  const auto kernel = pool_mesh_bounce_tlas_kernel<G, kOrdered, Q>;
  const cudaError_t status = path::allow_shared(kernel, layout.bytes);
  if (status != cudaSuccess) return static_cast<int>(status);
  const int64_t threads = static_cast<int64_t>(in.n_rays) * G;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  kernel<<<blocks, kThreads, layout.bytes, stream>>>(in, spheres, t, layout, n_node_rows,
                                                     slot_votes, total_bounces, out);
  return static_cast<int>(cudaGetLastError());
}

template <int G, int Q>
int launch_order(const pool::State& in, const pool::Spheres& spheres, const Tables<Q>& t,
                 const Layout& layout, int n_node_rows, bool ordered, const uint8_t* slot_votes,
                 int total_bounces, const pool::Outputs& out, cudaStream_t stream) {
  if (ordered) {
    return launch_group<G, true, Q>(in, spheres, t, layout, n_node_rows, slot_votes,
                                    total_bounces, out, stream);
  }
  return launch_group<G, false, Q>(in, spheres, t, layout, n_node_rows, nullptr, total_bounces,
                                   out, stream);
}

template <int G, bool kOrdered, int Q>
int occupancy_group(const Layout& layout) {
  const auto kernel = pool_mesh_bounce_tlas_kernel<G, kOrdered, Q>;
  const cudaError_t allowed = path::allow_shared(kernel, layout.bytes);
  if (allowed != cudaSuccess) return -static_cast<int>(allowed);
  int blocks = 0;
  const cudaError_t status =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, layout.bytes);
  return status == cudaSuccess ? blocks : -static_cast<int>(status);
}

}  // namespace

// Plain C entry for ctypes, as pool_mesh_bounce_launch with each frame's
// instances in slot order and, after the BVH, the stacked TLAS windows
// (node bounds [n_frames * tlas_nodes_per_frame, 8], links likewise [.., 4]
// int32) and the window's key window [6]; then `ordered` (nonzero: the
// BVH's node tables are its eight octant orders stacked, [8 n_nodes] rows)
// and the packets' votes per slot of packet_octants.cu, [P, n_frames *
// instances_per_frame] (nullptr on a one-node BVH); after the five outputs
// the key [n_rays] int32; then the group size G (1, 2, 4 or 8 threads a
// lane).
extern "C" int pool_mesh_bounce_tlas_launch(
    const float* origins, const float* directions, const float* throughput,
    const unsigned char* alive, const int* lanes, const int* fids, const int* seeds,
    const int* bounces, int n_rays, const int* live_count, const float* spheres,
    int spheres_per_frame, int n_frames, const float* params, const float* instances,
    int instances_per_frame, const float* triangles, int n_tri_rows, const float* node_bounds,
    const int* node_links, int n_nodes, const float* tlas_bounds, const int* tlas_links,
    int tlas_nodes_per_frame, const float* key_window, int ordered,
    const unsigned char* slot_votes, int total_bounces, float* contribution, float* origins_out,
    float* directions_out, float* throughput_out, unsigned char* alive_out, int* key_out,
    int group, int quant, const float* blas_grid, const float* tlas_grid, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaSuccess);
  if (spheres_per_frame < 1 || n_frames < 1 || total_bounces < 1 || instances_per_frame < 1 ||
      n_tri_rows < 1 || n_nodes < 1 || tlas_nodes_per_frame < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const pool::State in = {origins, directions, throughput, alive, lanes, fids,
                          seeds,   bounces,    n_rays,     live_count};
  const pool::Spheres table = {reinterpret_cast<const float4*>(spheres), spheres_per_frame,
                               n_frames, params};
  const int n_node_rows = (ordered ? 8 : 1) * n_nodes;
  const pool::Outputs out = {contribution, origins_out, directions_out, throughput_out,
                             alive_out};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool o = ordered != 0;
  return mesh::with_format(quant, {blas_grid, tlas_grid}, [&](auto format) {
    constexpr int Q = decltype(format)::value;
    const Tables<Q> t = {{instances, reinterpret_cast<const float4*>(triangles),
                          mesh::nodes_of<Q>(node_bounds, node_links, blas_grid, mesh::kLeafRows),
                          n_frames * instances_per_frame, n_nodes},
                         mesh::nodes_of<Q>(tlas_bounds, tlas_links, tlas_grid, 1),
                         tlas_nodes_per_frame,
                         instances_per_frame,
                         n_tri_rows,
                         key_window,
                         key_out};
    const Layout layout = plan<Q>(n_tri_rows, n_node_rows, spheres_per_frame,
                                  instances_per_frame, tlas_nodes_per_frame, n_frames);
    switch (group) {
      case 1: return launch_order<1, Q>(in, table, t, layout, n_node_rows, o, slot_votes,
                                        total_bounces, out, s);
      case 2: return launch_order<2, Q>(in, table, t, layout, n_node_rows, o, slot_votes,
                                        total_bounces, out, s);
      case 4: return launch_order<4, Q>(in, table, t, layout, n_node_rows, o, slot_votes,
                                        total_bounces, out, s);
      case 8: return launch_order<8, Q>(in, table, t, layout, n_node_rows, o, slot_votes,
                                        total_bounces, out, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  });
}

// The blocks of the group-G kernel resident on one SM at a launch of these
// tables (`ordered`: the octant-ordered walk's kernel and tables;
// cudaOccupancyMaxActiveBlocksPerMultiprocessor; a negative CUDA error code
// on failure), with the launch's dynamic shared memory in *shared_bytes and
// the frames a block may stage in *staged_frames (-1: the BVH is not
// staged, nothing is).
extern "C" int pool_mesh_bounce_tlas_occupancy(int group, int spheres_per_frame, int n_frames,
                                               int instances_per_frame, int n_tri_rows,
                                               int n_nodes, int tlas_nodes_per_frame,
                                               int ordered, int* shared_bytes,
                                               int* staged_frames, int quant) {
  if (quant < 0 || quant > 2) return -static_cast<int>(cudaErrorInvalidValue);
  return mesh::with_format(quant, {}, [&](auto format) {
    constexpr int Q = decltype(format)::value;
    const Layout layout = plan<Q>(n_tri_rows, (ordered ? 8 : 1) * n_nodes, spheres_per_frame,
                                  instances_per_frame, tlas_nodes_per_frame, n_frames);
    *shared_bytes = static_cast<int>(layout.bytes);
    *staged_frames = layout.bvh ? layout.frames : -1;
    const bool o = ordered != 0;
    switch (group) {
      case 1: return o ? occupancy_group<1, true, Q>(layout) : occupancy_group<1, false, Q>(layout);
      case 2: return o ? occupancy_group<2, true, Q>(layout) : occupancy_group<2, false, Q>(layout);
      case 4: return o ? occupancy_group<4, true, Q>(layout) : occupancy_group<4, false, Q>(layout);
      case 8: return o ? occupancy_group<8, true, Q>(layout) : occupancy_group<8, false, Q>(layout);
      default: return -static_cast<int>(cudaErrorInvalidValue);
    }
  });
}

// The packet width this library was built for (TRC_PACKET).
extern "C" int pool_mesh_bounce_tlas_packet() { return kPacket; }

extern "C" const char* pool_mesh_bounce_tlas_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
