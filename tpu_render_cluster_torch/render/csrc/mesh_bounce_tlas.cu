// Per-bounce mesh-scene path-trace kernel, two-level instance walk, with
// the fused coherence-key epilogue, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_mesh_bounce_io` / `_mesh_trace_kernel_factory`
// with state_io=True and use_tlas=True, the reference's default
// (tpu_render_cluster/render/pallas_kernels.py): mesh_bounce.cu's contract
// (one bounce, the path state streamed in and out, lanes at or past the
// live count passed through) with the instances walked through the frame's
// TLAS (the instance table in Morton slot order), and one more output, each
// lane's coherence sort key of its state after the bounce (`key_out_ref`,
// pallas_kernels.py:2974-3115), so the caller's next sort is one argsort of
// this column:
//   - a lane alive after the bounce and below the live count keys with the
//     slot its new ray enters first (the TLAS entry walk over the slots'
//     world boxes alone), or K where the ray overlaps none;
//   - every other lane keys with K, and so does every lane of the last
//     bounce (bounce == total_bounces - 1), whose key no sort reads;
//   - the key itself is mesh::coherence_key (dead flag at bit 29, frame id
//     0) in the frame's key window.
// On the TPU a dead lane of a partly live block may pick up a packet-mate's
// candidate; the rule here is per lane, so kernel and plain version
// (kernels.mesh_bounce_reference) agree on every lane.
//
// Bound: operations, as mesh_bounce.cu with the instance search a
// two-level walk (about 2 ceil(log2 K) box tests per search, the entry walk
// one more search per live lane), against 90 bytes of state and 4 of key
// per ray. What holds it back: the work per ray varies widely (sky rays
// against rays that enter several instances), and the narrow launches of
// the later bounces leave most of the card idle. Design:
//   - persistent blocks: the launch starts as many blocks as are resident
//     at once (occupancy x SMs, fewer for a narrow launch); each stages the
//     BVH, the slot-ordered instance table and the TLAS (about 34 KB for 48
//     icospheres) once, by bulk copy (mesh::stage_ranges), and each warp
//     then takes the next 32 / G rays from a counter in global memory until
//     the launch's rays run out, so a slow warp holds no block slot and a
//     launch stages its tables a few hundred times, not once per 256 rays.
//     The counter is a scratch int of the caller's, cleared on the launch's
//     stream before the kernel;
//   - a group of G threads walks each ray (mesh::GroupTlas, G = 1, 2, 4 or
//     8, chosen per launch by the wrapper from the launch's width), bit for
//     bit the one-thread walk.
// The key window is read from global memory.
//
// Walk order: on a BVH with octant tables (every sah build; the
// reference's default) the staged BVH and TLAS are their eight octant orders
// stacked, [8N] and [8M] rows, and each ray's walks take the tables of its
// packet (kPacket lanes of the launch, tlas_block_r(): 256, or the width
// the library was built for; at 128 a block of 256 threads spans two
// packets, at 1,024 a packet spans four blocks, and the votes are the
// packet's either way): the packet's votes come
// from the pre-pass packet_octants.cu, its world octant for the TLAS and
// its object-space octant per slot for the BLAS (mesh::Octants); the shadow
// walks take the sun's. The key's entry walk votes over the packet's new
// directions, known only when all its lanes have bounced, so on this walk
// the key is written by the pass after this kernel (mesh_entry_keys.cu) and
// this kernel writes none. Built with --fmad=false.
//
// Node format: instantiated for the three formats of mesh::Nodes (fp32, the
// reference's quantized tiers 1 and 2, 16 or 12 bytes a node staged in
// place of 48), the launch's `quant` picking one. On a quantized tier the
// key follows the reference's packed-key rule (pallas_kernels.py:3030-3036,
// :3089-3102): a lane whose nearest hit was an instance keys with that slot,
// on every bounce, and walks no entry; the ordered walk writes each lane's
// winning slot (K for none) to `hits_out` for its key pass.

#include "mesh_common.cuh"

namespace {

using path::float3v;
constexpr int kThreads = 256;
// At least 3 resident blocks an SM: ptxas keeps a thread within 80
// registers. Without it ptxas takes 64 (4 blocks) and spills 104-196 bytes;
// with 1 or 2 it takes 94-108 registers, no spill, and 2 blocks run slower
// (PERF.md section 6).
constexpr int kMinBlocks = 3;

// Byte offsets of the staged regions in the dynamic shared memory
// (mesh::stage_region each); bytes 0: nothing is staged.
struct Layout {
  uint32_t tris, bounds, links, slots, tlas_bounds, tlas_links;
  uint32_t bytes;
};

// The node tables' rows: N and M, or 8N and 8M for the octant orders.
template <int Q>
Layout plan(int n_tri_rows, int n_node_rows, int n_instances, int n_tlas_rows) {
  const size_t sizes[6] = {
      sizeof(float4) * 4 * static_cast<size_t>(n_tri_rows),
      mesh::Nodes<Q>::part_bytes(0, n_node_rows),
      mesh::Nodes<Q>::part_bytes(1, n_node_rows),
      sizeof(float) * mesh::kInstanceWidth * static_cast<size_t>(n_instances),
      mesh::Nodes<Q>::part_bytes(0, n_tlas_rows),
      mesh::Nodes<Q>::part_bytes(1, n_tlas_rows),
  };
  uint32_t offsets[6];
  size_t total = 0;
  for (int i = 0; i < 6; ++i) {
    offsets[i] = static_cast<uint32_t>(total);
    total += mesh::stage_region(sizes[i]);
  }
  if (total > static_cast<size_t>(path::kMaxStagedBytes)) return {0, 0, 0, 0, 0, 0, 0};
  return {offsets[0], offsets[1], offsets[2], offsets[3], offsets[4], offsets[5],
          static_cast<uint32_t>(total)};
}

// The reference's packet of the TLAS variants (tlas_block_r()): 256 lanes,
// or the library's width (mesh::kTlasPacket).
constexpr int kPacket = mesh::kTlasPacket;

// The packet votes of an ordered launch (packet_octants.cu): per packet its
// world octant, and its octant per slot (nullptr on a one-node BVH).
struct Votes {
  const uint8_t* tlas;  // [P]
  const uint8_t* slots;  // [P, K]
};

// kOrdered: the octant-ordered walk (`votes`; node rows 8N and 8M), no key.
template <int G, bool kOrdered, int Q>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
mesh_bounce_tlas_kernel(const float* __restrict__ origins, const float* __restrict__ directions,
                        const float* __restrict__ throughput, const uint8_t* __restrict__ alive,
                        const int* __restrict__ lanes, int n_rays,
                        const int* __restrict__ live_count, const float4* __restrict__ spheres,
                        int n_spheres, const float* __restrict__ params,
                        mesh::MeshTablesOf<Q> tables, mesh::TlasTablesOf<Q> tlas,
                        const float* __restrict__ key_window,
                        int n_tri_rows, int n_node_rows, Layout layout, Votes votes,
                        uint32_t seed, int bounce, int total_bounces,
                        float* __restrict__ contribution, float* __restrict__ origins_out,
                        float* __restrict__ directions_out, float* __restrict__ throughput_out,
                        uint8_t* __restrict__ alive_out, int* __restrict__ key_out,
                        int* __restrict__ next_ray, int* __restrict__ hits_out) {
  __shared__ path::SceneShared scene;
  __shared__ uint64_t barrier;
  extern __shared__ float4 staging[];
  const int live = *live_count;

  // Uniform per launch: with no live lane every ray passes through.
  if (live > 0 && layout.bytes > 0) {
    char* smem = reinterpret_cast<char*>(staging);
    const mesh::Range ranges[6] = {
        {smem + layout.tris, reinterpret_cast<const char*>(tables.tris),
         static_cast<uint32_t>(sizeof(float4) * 4 * n_tri_rows)},
        {smem + layout.bounds, tables.nodes.part(0),
         static_cast<uint32_t>(mesh::Nodes<Q>::part_bytes(0, n_node_rows))},
        {smem + layout.links, tables.nodes.part(1),
         static_cast<uint32_t>(mesh::Nodes<Q>::part_bytes(1, n_node_rows))},
        {smem + layout.slots, reinterpret_cast<const char*>(tables.inst),
         static_cast<uint32_t>(sizeof(float) * mesh::kInstanceWidth * tables.n_instances)},
        {smem + layout.tlas_bounds, tlas.nodes.part(0),
         static_cast<uint32_t>(mesh::Nodes<Q>::part_bytes(0, tlas.n_rows))},
        {smem + layout.tlas_links, tlas.nodes.part(1),
         static_cast<uint32_t>(mesh::Nodes<Q>::part_bytes(1, tlas.n_rows))},
    };
    mesh::stage_ranges(ranges, &barrier);
    tables.tris = reinterpret_cast<const float4*>(ranges[0].staged());
    tables.nodes.set_parts(ranges[1].staged(), ranges[2].staged());
    tables.inst = reinterpret_cast<const float*>(ranges[3].staged());
    tlas.nodes.set_parts(ranges[4].staged(), ranges[5].staged());
  }
  path::load_scene(scene, spheres, n_spheres, params);  // ends with __syncthreads()

  const mesh::Group<G> g = mesh::Group<G>::of_thread();
  const uint32_t counter_stride = 2u * static_cast<uint32_t>(total_bounces) + 2u;
  const float3v sun = {scene.params[0], scene.params[1], scene.params[2]};
  const int sun_row = mesh::octant_of(sun) * tlas.n_nodes;
  const int lane_in_warp = static_cast<int>(threadIdx.x & 31u);
  for (;;) {
    // The warp's next 32 / G rays.
    int start = 0;
    if (lane_in_warp == 0) start = atomicAdd(next_ray, 32 / G);
    start = __shfl_sync(0xffffffffu, start, 0);
    if (start >= n_rays) break;
    const int64_t ray = static_cast<int64_t>(start) + lane_in_warp / G;
    if (ray < n_rays) {
      float3v o = path::load3(origins, ray);
      float3v d = path::load3(directions, ray);
      float3v thr = path::load3(throughput, ray);
      bool is_alive = alive[ray] != 0;
      float3v rad = {0.0f, 0.0f, 0.0f};
      int candidate = tables.n_instances;
      int hit = -1;  // the winning slot of the packed-key rule (Q > 0)
      if (is_alive && ray < live) {
        if constexpr (kOrdered) {
          const int64_t packet = ray / kPacket;
          const mesh::GroupTlas<G, mesh::Octants, Q> walk = {
              g, tlas.nodes, 0, 0, 0, tlas.n_nodes,
              {votes.slots == nullptr ? nullptr : votes.slots + packet * tables.n_instances,
               votes.tlas[packet] * tlas.n_nodes, sun_row}};
          is_alive = mesh::bounce(scene, 0, n_spheres, tables, walk,
                                  static_cast<uint32_t>(lanes[ray]), bounce, counter_stride,
                                  seed, o, d, thr, rad, Q > 0 ? &hit : nullptr);
        } else {
          const mesh::GroupTlas<G, mesh::Canonical, Q> walk = {g, tlas.nodes, 0, 0, 0,
                                                               tlas.n_nodes};
          is_alive = mesh::bounce(scene, 0, n_spheres, tables, walk,
                                  static_cast<uint32_t>(lanes[ray]), bounce, counter_stride,
                                  seed, o, d, thr, rad, Q > 0 ? &hit : nullptr);
          if (hit >= 0) {
            candidate = hit;
          } else if (is_alive && bounce < total_bounces - 1) {
            candidate = walk.entry_candidate(tables, o, d, 0, tables.n_instances);
          }
        }
      }
      if (g.rank == 0) {
        path::store3(contribution, ray, rad);
        path::store3(origins_out, ray, o);
        path::store3(directions_out, ray, d);
        path::store3(throughput_out, ray, thr);
        alive_out[ray] = is_alive ? 1 : 0;
        if (!kOrdered) {
          key_out[ray] = mesh::coherence_key(o, d, !is_alive, 0, candidate, key_window);
        } else if (Q > 0) {
          hits_out[ray] = hit >= 0 ? hit : tables.n_instances;
        }
      }
    }
    __syncwarp();
  }
}

template <int Q>
using Kernel = decltype(&mesh_bounce_tlas_kernel<1, false, Q>);

// The group-G kernel of the walk order and node format (nullptr for another
// G).
template <bool kOrdered, int Q>
Kernel<Q> kernel_of(int group) {
  switch (group) {
    case 1: return mesh_bounce_tlas_kernel<1, kOrdered, Q>;
    case 2: return mesh_bounce_tlas_kernel<2, kOrdered, Q>;
    case 4: return mesh_bounce_tlas_kernel<4, kOrdered, Q>;
    case 8: return mesh_bounce_tlas_kernel<8, kOrdered, Q>;
    default: return nullptr;
  }
}

template <int Q>
Kernel<Q> kernel_for(int group, bool ordered) {
  return ordered ? kernel_of<true, Q>(group) : kernel_of<false, Q>(group);
}

}  // namespace

// Plain C entry for ctypes, as mesh_bounce_launch with the instances in
// slot order and, after the BVH, the frame's TLAS (node bounds
// [n_tlas_nodes, 8], links [n_tlas_nodes, 4] int32) and its key window
// [6] (lo, 1 / span); then the packet votes of packet_octants.cu, the world
// octants [P] and the slots' [P, n_instances] (slots nullptr on a one-node
// BVH), both nullptr on the canonical walk: given, the node tables are the
// eight octant orders stacked, [8 n_nodes] and [8 n_tlas_nodes] rows, and
// the kernel writes no key (mesh_entry_keys.cu does); after the five
// outputs the key [n_rays] int32; then the group size G (1, 2, 4 or 8
// threads a ray) and the work counter, one int32 in device memory that no
// other launch uses meanwhile (cleared here on `stream` before the kernel).
// Last, the node format: `quant` 1 or 2, `node_bounds` and `tlas_bounds`
// hold the quantized node words, the links are unused, `blas_grid` and
// `tlas_grid` point at the tables' grids (6 floats each in host memory),
// and on the ordered walk `hits_out` [n_rays] int32 receives each lane's
// winning slot, K for none (the key pass's packed-key rule).
extern "C" int mesh_bounce_tlas_launch(
    const float* origins, const float* directions, const float* throughput,
    const unsigned char* alive, const int* lanes, int n_rays, const int* live_count,
    const float* spheres, int n_spheres, const float* params, const float* instances,
    int n_instances, const float* triangles, int n_tri_rows, const float* node_bounds,
    const int* node_links, int n_nodes, const float* tlas_bounds, const int* tlas_links,
    int n_tlas_nodes, const float* key_window, const unsigned char* tlas_votes,
    const unsigned char* slot_votes, int seed, int bounce, int total_bounces,
    float* contribution, float* origins_out, float* directions_out, float* throughput_out,
    unsigned char* alive_out, int* key_out, int group, int* work_counter, int quant,
    const float* blas_grid, const float* tlas_grid, int* hits_out, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaSuccess);
  const bool ordered = tlas_votes != nullptr;
  if (n_spheres < 1 || n_spheres > path::kMaxSpheres || bounce < 0 ||
      bounce >= total_bounces || n_instances < 1 || n_tri_rows < 1 || n_nodes < 1 ||
      n_tlas_nodes < 1 || (ordered && quant != 0 && hits_out == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int orders = ordered ? 8 : 1;
  return mesh::with_format(quant, {blas_grid, tlas_grid}, [&](auto format) {
    constexpr int Q = decltype(format)::value;
    const mesh::MeshTablesOf<Q> tables = {
        instances, reinterpret_cast<const float4*>(triangles),
        mesh::nodes_of<Q>(node_bounds, node_links, blas_grid, mesh::kLeafRows), n_instances,
        n_nodes};
    const mesh::TlasTablesOf<Q> tlas = {mesh::nodes_of<Q>(tlas_bounds, tlas_links, tlas_grid, 1),
                                        n_tlas_nodes, orders * n_tlas_nodes};
    const Layout layout =
        plan<Q>(n_tri_rows, orders * n_nodes, n_instances, orders * n_tlas_nodes);
    const Kernel<Q> kernel = kernel_for<Q>(group, ordered);
    if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    int resident = 0;
    cudaError_t status = mesh::card_blocks(kernel, kThreads, layout.bytes, &resident);
    if (status != cudaSuccess) return static_cast<int>(status);
    // As many blocks as are resident at once, and no more than the rays need.
    const int64_t needed = (static_cast<int64_t>(n_rays) * group + kThreads - 1) / kThreads;
    const int blocks = static_cast<int>(needed < resident ? needed : resident);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    status = cudaMemsetAsync(work_counter, 0, sizeof(int), s);
    if (status != cudaSuccess) return static_cast<int>(status);
    kernel<<<blocks, kThreads, layout.bytes, s>>>(
        origins, directions, throughput, alive, lanes, n_rays, live_count,
        reinterpret_cast<const float4*>(spheres), n_spheres, params, tables, tlas, key_window,
        n_tri_rows, orders * n_nodes, layout, Votes{tlas_votes, slot_votes},
        static_cast<uint32_t>(seed), bounce, total_bounces, contribution, origins_out,
        directions_out, throughput_out, alive_out, key_out, work_counter, hits_out);
    return static_cast<int>(cudaGetLastError());
  });
}

// The blocks of the group-G kernel resident on one SM at a launch of these
// tables (`ordered`: the octant-ordered walk's kernel and tables; a
// negative CUDA error code on failure), with the launch's dynamic shared
// memory in *shared_bytes (0: the tables are read from global memory), at
// node format `quant`.
extern "C" int mesh_bounce_tlas_occupancy(int group, int n_instances, int n_tri_rows,
                                          int n_nodes, int n_tlas_nodes, int ordered,
                                          int* shared_bytes, int quant) {
  if (quant < 0 || quant > 2) return -static_cast<int>(cudaErrorInvalidValue);
  const int orders = ordered ? 8 : 1;
  return mesh::with_format(quant, {}, [&](auto format) {
    constexpr int Q = decltype(format)::value;
    const Layout layout =
        plan<Q>(n_tri_rows, orders * n_nodes, n_instances, orders * n_tlas_nodes);
    *shared_bytes = static_cast<int>(layout.bytes);
    const Kernel<Q> kernel = kernel_for<Q>(group, ordered != 0);
    if (kernel == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
    int blocks_per_sm = 0;
    const cudaError_t status =
        mesh::blocks_per_sm(kernel, kThreads, layout.bytes, &blocks_per_sm);
    return status == cudaSuccess ? blocks_per_sm : -static_cast<int>(status);
  });
}

// The packet width this library was built for (TRC_PACKET).
extern "C" int mesh_bounce_tlas_packet() { return kPacket; }

extern "C" const char* mesh_bounce_tlas_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
