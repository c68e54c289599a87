// Mesh-scene path-trace megakernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `_trace_fused_mesh` / `_mesh_trace_kernel_factory`
// with state_io=False (tpu_render_cluster/render/pallas_kernels.py): one
// launch runs the whole bounce loop for every ray and writes radiance once.
// Per bounce, in the reference's order: nearest sphere and ground-plane hit
// (path_common.cuh), then the nearest hit over
// K rigid instances of one mesh, each walked through its threaded BVH
// seeded with the sphere/plane t; sky on escape; emission and albedo of
// the sphere, plane or instance hit; sun next-event estimation with the
// sphere any-hit and the mesh any-hit; and the counter-PCG cosine resample.
//
// Bound: operations. A path-bounce costs a world-AABB slab test per
// instance (about 24 flops), a transform into object space per instance it
// enters (about 40), a slab test per BVH node visited and a Moller-Trumbore
// test per triangle row (about 50), against 36 bytes of rays and radiance
// per path. Design for this card, not the TPU's block layout:
//   - one thread per ray; path state stays in registers for all bounces;
//   - the tables (spheres, the [K, 22] instance table, node bounds and
//     links, 64-byte triangle rows) are staged once per block in shared
//     memory when they fit (the box mesh is 1 KB of triangles, the
//     icosphere 26 KB), else read from device memory through L1;
//   - the TPU's block-wide `any` packet culls become per-thread tests:
//     per ray, the nearest hit does not depend on how many other rays
//     visit a node, and instances and nodes are visited in table order
//     (instances) and the DFS preorder of the walk's node table (nodes:
//     below, the walk order), with strict `<` updates and the first tying
//     row of a leaf winning;
//   - a ray whose path escaped leaves the loop, the shadow any-hits stop at
//     the first occluder and are skipped where the sun is below the
//     surface: each such term is a finite value times alive = 0 (or
//     cos = 0) in the reference, so leaving adds exactly zero.
//
// Walk order: on a BVH with octant tables (every sah build; the
// reference's default) the BLAS tables are its eight octant orders stacked
// [8N], and each instance's walk takes the one of its packet's vote
// (mesh::Octants). The reference's packet here is BVH_BLOCK_R = 1024 lanes
// in launch order, so the ordered kernel runs blocks of 1024 threads: at
// every bounce all of a block's threads vote on each instance's octant of
// their directions in object space (block_instance_octants; a finished
// path's last direction, a lane past the launch (0, 1, 0)), on a BVH of
// more than one node (the eight tables of one node are alike); the shadow
// walks take the sun's octant. Without octant tables the canonical order
// in blocks of 256, the kernel as before.
//
// The bounce itself (mesh::bounce), the walks, the table staging and their
// rounding are in mesh_common.cuh, shared with the per-bounce mesh kernel
// (mesh_bounce.cu). Built with --fmad=false, so nvcc contracts nothing but
// the fmaf written out there.
//
// Node format: the kernel is instantiated for the three formats of
// mesh::Nodes (fp32, and the reference's quantized tiers 1 and 2, whose
// staged tables take 16 or 12 bytes a node in place of 48); the launch's
// `quant` picks one.

#include "mesh_common.cuh"

namespace {

using path::float3v;
// Threads a block: the canonical kernel's, and the ordered one's (the
// reference's packet, BVH_BLOCK_R).
constexpr int kThreads = 256;
constexpr int kPacket = 1024;

template <bool kOrdered, int Q>
__global__ void __launch_bounds__(kOrdered ? kPacket : kThreads)
trace_fused_mesh_kernel(const float* __restrict__ origins,
                        const float* __restrict__ directions, int n_rays,
                        const float4* __restrict__ spheres, int n_spheres,
                        const float* __restrict__ params, mesh::MeshTablesOf<Q> tables,
                        int n_tri_rows, int n_node_rows, bool staged, size_t vote_offset,
                        bool instance_votes, uint32_t seed, int max_bounces,
                        float* __restrict__ radiance_out) {
  __shared__ path::SceneShared scene;
  extern __shared__ float4 staging[];
  if (staged) mesh::stage_tables(tables, staging, n_tri_rows, n_node_rows);
  int* counts = reinterpret_cast<int*>(reinterpret_cast<char*>(staging) + vote_offset);
  uint8_t* octants = reinterpret_cast<uint8_t*>(counts + 3 * tables.n_instances);
  if (kOrdered && instance_votes) {
    for (int i = threadIdx.x; i < 3 * tables.n_instances; i += blockDim.x) counts[i] = 0;
  }
  path::load_scene(scene, spheres, n_spheres, params);  // ends with __syncthreads()

  const int64_t ray = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool in_launch = ray < n_rays;
  if (!kOrdered && !in_launch) return;
  const uint32_t lane = static_cast<uint32_t>(ray);

  float3v o = {0.0f, 0.0f, 0.0f};
  float3v d = {0.0f, 1.0f, 0.0f};  // a lane past the launch: the reference's pad ray
  if (in_launch) {
    o = path::load3(origins, ray);
    d = path::load3(directions, ray);
  }
  float3v thr = {1.0f, 1.0f, 1.0f};
  float3v rad = {0.0f, 0.0f, 0.0f};
  const uint32_t counter_stride = 2u * static_cast<uint32_t>(max_bounces) + 2u;

  if constexpr (kOrdered) {
    bool alive = in_launch;
    for (int bounce = 0; bounce < max_bounces; ++bounce) {
      if (instance_votes) mesh::block_instance_octants(tables, d, counts, octants);
      const mesh::FlatInstances<mesh::Octants> instances = {
          0, tables.n_instances, {instance_votes ? octants : nullptr, 0, 0}};
      if (alive) {
        alive = mesh::bounce(scene, 0, n_spheres, tables, instances, lane, bounce,
                             counter_stride, seed, o, d, thr, rad);
      }
    }
    if (in_launch) path::store3(radiance_out, ray, rad);
  } else {
    const mesh::FlatInstances<> instances = {0, tables.n_instances};
    for (int bounce = 0; bounce < max_bounces; ++bounce) {
      if (!mesh::bounce(scene, 0, n_spheres, tables, instances, lane, bounce, counter_stride,
                        seed, o, d, thr, rad)) {
        break;  // the path escaped
      }
    }
    path::store3(radiance_out, ray, rad);
  }
}

template <bool kOrdered, int Q>
int launch(const float* origins, const float* directions, int n_rays, const float* spheres,
           int n_spheres, const float* params, const mesh::MeshTablesOf<Q>& tables,
           int n_tri_rows, int n_node_rows, int seed, int max_bounces, float* radiance,
           cudaStream_t stream) {
  const auto kernel = trace_fused_mesh_kernel<kOrdered, Q>;
  const int threads = kOrdered ? kPacket : kThreads;
  const bool instance_votes = kOrdered && tables.n_nodes > 1;
  size_t shared_bytes, vote_offset;
  bool staged;
  const cudaError_t status = mesh::megakernel_shared(
      kernel, mesh::table_bytes<Q>(n_tri_rows, n_node_rows, tables.n_instances),
      mesh::instance_vote_bytes(instance_votes, tables.n_instances), &shared_bytes, &staged,
      &vote_offset);
  if (status != cudaSuccess) return static_cast<int>(status);
  const int blocks = (n_rays + threads - 1) / threads;
  kernel<<<blocks, threads, shared_bytes, stream>>>(
      origins, directions, n_rays, reinterpret_cast<const float4*>(spheres), n_spheres, params,
      tables, n_tri_rows, n_node_rows, staged, vote_offset, instance_votes,
      static_cast<uint32_t>(seed), max_bounces, radiance);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry for ctypes. Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() so the caller sees a refused launch at once.
// Tables as render/kernels.py builds them: spheres [n_spheres, 16],
// params [18], instances [n_instances, 22], triangle rows [n_tri_rows, 16],
// node bounds [n_nodes, 8] and node links [n_nodes, 4] (int32); `ordered`
// nonzero: the node tables are the eight octant orders stacked, 8 n_nodes
// rows. `quant` 1 or 2: `node_bounds` holds the quantized node words
// (kernels.QuantTable), `node_links` is unused and `grid` points at the
// table's grid, 6 floats in host memory.
extern "C" int trace_fused_mesh_launch(const float* origins, const float* directions,
                                       int n_rays, const float* spheres, int n_spheres,
                                       const float* params, const float* instances,
                                       int n_instances, const float* triangles,
                                       int n_tri_rows, const float* node_bounds,
                                       const int* node_links, int n_nodes, int ordered,
                                       int seed, int max_bounces, float* radiance, int quant,
                                       const float* grid, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaSuccess);
  if (n_spheres < 1 || n_spheres > path::kMaxSpheres || max_bounces < 0 ||
      n_instances < 0 || n_tri_rows < 1 || n_nodes < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return mesh::with_format(quant, {grid}, [&](auto format) {
    constexpr int Q = decltype(format)::value;
    const mesh::MeshTablesOf<Q> tables = {
        instances, reinterpret_cast<const float4*>(triangles),
        mesh::nodes_of<Q>(node_bounds, node_links, grid, mesh::kLeafRows), n_instances,
        n_nodes};
    if (ordered) {
      return launch<true, Q>(origins, directions, n_rays, spheres, n_spheres, params, tables,
                             n_tri_rows, 8 * n_nodes, seed, max_bounces, radiance, s);
    }
    return launch<false, Q>(origins, directions, n_rays, spheres, n_spheres, params, tables,
                            n_tri_rows, n_nodes, seed, max_bounces, radiance, s);
  });
}

extern "C" const char* trace_fused_mesh_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
