// Per-bounce mesh-scene path-trace kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `_mesh_bounce_io` / `_mesh_trace_kernel_factory`
// with state_io=True, flat instance variant
// (tpu_render_cluster/render/pallas_kernels.py): ONE bounce of the mesh
// megakernel per launch, with the path state streamed in and out, so the
// caller can re-sort or compact the rays between bounces (the deep-mesh
// loop of render/integrator.py and the wavefront driver of
// render/compaction.py). Per ray:
//   in:  origin, direction, throughput [R, 3], alive [R] (bytes 0/1), the
//        ray's original lane [R] (int32, its RNG counter), the live count;
//   out: this bounce's radiance contribution (from zero), origin,
//        direction, throughput and alive after the bounce.
// RNG counter: lane * (2 * total_bounces + 2) + 2 * bounce, hashed with the
// seed, as in the megakernel, so a ray's stream does not depend on where a
// sort or compaction put it.
//
// Live count: callers sort dead lanes to the tail, so every lane at or past
// *live_count is dead; such lanes pass their state through with a zero
// contribution (the TPU kernel skips whole blocks past the count). A block
// whose first lane is past the count copies its state and stages no table.
// A dead lane below the count also passes through: in the reference every
// term of a dead lane is finite times alive = 0 and its state is kept by a
// masked select.
//
// Bound: operations, as the mesh megakernel (trace_fused_mesh.cu), for one
// bounce: world-AABB slab tests per instance, object-space transforms,
// node slab tests and Moller-Trumbore tests, against 41 bytes of state in
// and 49 out per ray. Design: one thread per ray, the tables staged in
// shared memory per block (the icosphere's 416 triangle rows, 39 nodes and
// 48 instances come to about 33 KB), the bounce itself is mesh::bounce
// (mesh_common.cuh), the megakernel's loop body. Instances are walked in
// table order: the reference's near-first instance order changes which
// instances a ray block culls, never a ray's nearest hit, ties aside.
//
// Walk order: on a BVH with octant tables (every sah build; the
// reference's default) the node tables are its eight octant orders stacked,
// [8N] rows, and each ray's BLAS walks take the table of its packet (1024
// lanes of the launch, BVH_BLOCK_R): the packet's object-space octant per
// instance, voted by the pre-pass packet_octants.cu over all its lanes
// (mesh::Octants); the shadow walks take the sun's. Built with
// --fmad=false. Node format: instantiated for the three formats of
// mesh::Nodes (fp32, the reference's quantized tiers 1 and 2), the launch's
// `quant` picking one.

#include "mesh_common.cuh"

namespace {

using path::float3v;
constexpr int kThreads = 256;
// The reference's packet of the flat variants (BVH_BLOCK_R).
constexpr int kPacket = 1024;

// kOrdered: the octant-ordered walk, `slot_votes` [P, K] the packets'
// votes (nullptr on a one-node BVH), the node tables' rows n_node_rows.
template <bool kOrdered, int Q>
__global__ void __launch_bounds__(kThreads)
mesh_bounce_kernel(const float* __restrict__ origins, const float* __restrict__ directions,
                   const float* __restrict__ throughput, const uint8_t* __restrict__ alive,
                   const int* __restrict__ lanes, int n_rays, const int* __restrict__ live_count,
                   const float4* __restrict__ spheres, int n_spheres,
                   const float* __restrict__ params, mesh::MeshTablesOf<Q> tables, int n_tri_rows,
                   int n_node_rows, const uint8_t* __restrict__ slot_votes, bool staged,
                   uint32_t seed, int bounce, int total_bounces,
                   float* __restrict__ contribution, float* __restrict__ origins_out,
                   float* __restrict__ directions_out, float* __restrict__ throughput_out,
                   uint8_t* __restrict__ alive_out) {
  __shared__ path::SceneShared scene;
  extern __shared__ float4 staging[];
  const int live = *live_count;
  const int64_t ray = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  float3v o = {0.0f, 0.0f, 0.0f}, d = o, thr = o;
  bool is_alive = false;
  if (ray < n_rays) {
    o = path::load3(origins, ray);
    d = path::load3(directions, ray);
    thr = path::load3(throughput, ray);
    is_alive = alive[ray] != 0;
  }
  float3v rad = {0.0f, 0.0f, 0.0f};

  // Uniform per block: a block wholly past the live count skips the tables.
  if (static_cast<int64_t>(blockIdx.x) * blockDim.x < live) {
    if (staged) mesh::stage_tables(tables, staging, n_tri_rows, n_node_rows);
    path::load_scene(scene, spheres, n_spheres, params);  // ends with __syncthreads()
    if (is_alive && ray < live) {
      const uint32_t counter_stride = 2u * static_cast<uint32_t>(total_bounces) + 2u;
      if constexpr (kOrdered) {
        const uint8_t* votes =
            slot_votes == nullptr ? nullptr : slot_votes + (ray / kPacket) * tables.n_instances;
        const mesh::FlatInstances<mesh::Octants> instances = {0, tables.n_instances,
                                                              {votes, 0, 0}};
        is_alive = mesh::bounce(scene, 0, n_spheres, tables, instances,
                                static_cast<uint32_t>(lanes[ray]), bounce, counter_stride, seed,
                                o, d, thr, rad);
      } else {
        const mesh::FlatInstances<> instances = {0, tables.n_instances};
        is_alive = mesh::bounce(scene, 0, n_spheres, tables, instances,
                                static_cast<uint32_t>(lanes[ray]), bounce, counter_stride, seed,
                                o, d, thr, rad);
      }
    }
  }
  if (ray >= n_rays) return;
  path::store3(contribution, ray, rad);
  path::store3(origins_out, ray, o);
  path::store3(directions_out, ray, d);
  path::store3(throughput_out, ray, thr);
  alive_out[ray] = is_alive ? 1 : 0;
}

}  // namespace

namespace {

template <bool kOrdered, int Q>
int launch(const float* origins, const float* directions, const float* throughput,
           const unsigned char* alive, const int* lanes, int n_rays, const int* live_count,
           const float* spheres, int n_spheres, const float* params,
           const mesh::MeshTablesOf<Q>& tables, int n_tri_rows, int n_node_rows,
           const unsigned char* slot_votes, int seed, int bounce, int total_bounces,
           float* contribution, float* origins_out, float* directions_out,
           float* throughput_out, unsigned char* alive_out, cudaStream_t stream) {
  const auto kernel = mesh_bounce_kernel<kOrdered, Q>;
  size_t shared_bytes;
  bool staged;
  const cudaError_t status = path::staging_for(
      kernel, mesh::table_bytes<Q>(n_tri_rows, n_node_rows, tables.n_instances), &shared_bytes,
      &staged);
  if (status != cudaSuccess) return static_cast<int>(status);
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, shared_bytes, stream>>>(
      origins, directions, throughput, alive, lanes, n_rays, live_count,
      reinterpret_cast<const float4*>(spheres), n_spheres, params, tables, n_tri_rows,
      n_node_rows, slot_votes, staged, static_cast<uint32_t>(seed), bounce, total_bounces,
      contribution, origins_out, directions_out, throughput_out, alive_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry for ctypes. Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() so the caller sees a refused launch at once.
// State as render/kernels.py passes it: origins, directions, throughput
// [n_rays, 3] float32, alive [n_rays] bytes, lanes [n_rays] int32, and
// live_count, one int32 in device memory. Tables as for
// trace_fused_mesh_launch, then `ordered` (nonzero: the node tables are the
// eight octant orders stacked, [8 n_nodes] rows) and the packets' votes per
// instance of packet_octants.cu, [P, n_instances] (nullptr on a one-node
// BVH). Outputs are [n_rays, 3] float32 and [n_rays] bytes and may not
// alias the inputs. Last, the node format: `quant` 1 or 2, `node_bounds`
// holds the quantized node words, `node_links` is unused and `grid` points
// at the table's grid, 6 floats in host memory.
extern "C" int mesh_bounce_launch(const float* origins, const float* directions,
                                  const float* throughput, const unsigned char* alive,
                                  const int* lanes, int n_rays, const int* live_count,
                                  const float* spheres, int n_spheres, const float* params,
                                  const float* instances, int n_instances,
                                  const float* triangles, int n_tri_rows,
                                  const float* node_bounds, const int* node_links, int n_nodes,
                                  int ordered, const unsigned char* slot_votes, int seed,
                                  int bounce, int total_bounces, float* contribution,
                                  float* origins_out, float* directions_out,
                                  float* throughput_out, unsigned char* alive_out, int quant,
                                  const float* grid, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaSuccess);
  if (n_spheres < 1 || n_spheres > path::kMaxSpheres || bounce < 0 ||
      bounce >= total_bounces || n_instances < 0 || n_tri_rows < 1 || n_nodes < 1) {
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
      return launch<true, Q>(origins, directions, throughput, alive, lanes, n_rays, live_count,
                             spheres, n_spheres, params, tables, n_tri_rows, 8 * n_nodes,
                             slot_votes, seed, bounce, total_bounces, contribution, origins_out,
                             directions_out, throughput_out, alive_out, s);
    }
    return launch<false, Q>(origins, directions, throughput, alive, lanes, n_rays, live_count,
                            spheres, n_spheres, params, tables, n_tri_rows, n_nodes, nullptr,
                            seed, bounce, total_bounces, contribution, origins_out,
                            directions_out, throughput_out, alive_out, s);
  });
}

extern "C" const char* mesh_bounce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
