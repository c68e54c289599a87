// Ray-pool mesh-scene bounce kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `pool_mesh_bounce` / `_mesh_trace_kernel_factory`
// with pool_io=True, flat instance variant (use_tlas=False;
// tpu_render_cluster/render/pallas_kernels.py): one mesh bounce over a
// pool of lanes from several frames of one mesh scene. The contract, the
// staging and the body are pool_common.cuh's; the bounce is mesh::bounce
// over the lane's own frame's spheres and instances, with one BVH shared by
// every frame and the window's instance tables stacked frame-major, frame
// f's K instances at rows [f K, (f + 1) K) of a [F K, 22] table (the layout
// of mesh_bounce.cu's, see kernels.instance_table).
//
// The reference bounds each block's sweep to the window of frame ids its
// lanes carry and masks every instance test per lane by frame id; a lane
// here sweeps only its own frame's K instances. Instances are walked in
// table order: the reference's near-first order within each frame changes
// which instances a ray block culls, never a ray's nearest hit, ties aside.
//
// Bound: operations, as mesh_bounce.cu for one bounce (world-AABB slab
// tests over the lane's frame's instances, object-space transforms, node
// slab tests, Moller-Trumbore tests), against 53 bytes of state in and 49
// out per lane. The sphere rows and the mesh tables are staged when they
// fit in 96 KB (8 frames of 03_physics-2-mesh: 8 KB of spheres, 33 KB of
// instances, 28 KB of BVH; 32 frames do not fit).
//
// Walk order: on a BVH with octant tables (every sah build; the
// reference's default) the BVH's node tables are its eight octant orders
// stacked, [8N] rows, and each lane's BLAS walks take the table of its
// packet (1024 lanes of the pool, BVH_BLOCK_R): the packet's object-space
// octant per row of the stacked table, voted by the pre-pass
// packet_octants.cu over all its lanes (mesh::Octants); the shadow walks take
// the sun's. Built with --fmad=false. Node format: instantiated for the
// three formats of mesh::Nodes (fp32, the reference's quantized tiers 1 and
// 2), the launch's `quant` picking one.

#include "mesh_common.cuh"
#include "pool_common.cuh"

namespace {

using path::float3v;

// The reference's packet of the flat variants (BVH_BLOCK_R).
constexpr int kPacket = 1024;

// kOrdered: the octant-ordered walk, `slot_votes` [P, F K] the packets'
// votes (nullptr on a one-node BVH).
template <bool kOrdered, int Q>
struct MeshBounce {
  mesh::MeshTablesOf<Q> tables;  // instances: the stacked [F K, 22] table
  int per_frame;  // K
  int n_tri_rows;
  int n_node_rows;  // N, or 8N for the octant orders
  const uint8_t* slot_votes;
  size_t bytes() const {
    return mesh::table_bytes<Q>(n_tri_rows, n_node_rows, tables.n_instances);
  }
  __device__ __forceinline__ void stage(float4* staging) {
    mesh::stage_tables(tables, staging, n_tri_rows, n_node_rows);
  }
  template <typename Scene>
  __device__ __forceinline__ bool run(const Scene& scene, int sphere_first, int n_spheres,
                                      int frame, int64_t ray, uint32_t lane, int bounce,
                                      uint32_t counter_stride, uint32_t seed, float3v& o,
                                      float3v& d, float3v& thr, float3v& rad) const {
    const int first = frame >= 0 ? frame * per_frame : 0;
    const int count = frame >= 0 ? per_frame : 0;
    if constexpr (kOrdered) {
      const uint8_t* votes =
          slot_votes == nullptr ? nullptr : slot_votes + (ray / kPacket) * tables.n_instances;
      const mesh::FlatInstances<mesh::Octants> instances = {first, count, {votes, 0, 0}};
      return mesh::bounce(scene, sphere_first, n_spheres, tables, instances, lane, bounce,
                          counter_stride, seed, o, d, thr, rad);
    } else {
      const mesh::FlatInstances<> instances = {first, count};
      return mesh::bounce(scene, sphere_first, n_spheres, tables, instances, lane, bounce,
                          counter_stride, seed, o, d, thr, rad);
    }
  }
};

template <bool kOrdered, int Q>
__global__ void __launch_bounds__(pool::kThreads)
pool_mesh_bounce_kernel(pool::State in, pool::Spheres spheres, MeshBounce<kOrdered, Q> bounce,
                        bool staged, int total_bounces, pool::Outputs out) {
  __shared__ float scene_params[path::kParams];
  extern __shared__ float4 staging[];
  pool::bounce_lanes(in, spheres, bounce, staged, total_bounces, out, staging, scene_params);
}

}  // namespace

// Plain C entry for ctypes, as pool_sphere_bounce_launch plus the mesh:
// instances [n_frames * instances_per_frame, 22] (frame-major), the shared
// BVH as for mesh_bounce_launch, then `ordered` (nonzero: the node tables
// are the eight octant orders stacked, [8 n_nodes] rows) and the packets'
// votes per instance row of packet_octants.cu, [P, n_frames *
// instances_per_frame] (nullptr on a one-node BVH). Last, the node format
// as for mesh_bounce_launch.
extern "C" int pool_mesh_bounce_launch(
    const float* origins, const float* directions, const float* throughput,
    const unsigned char* alive, const int* lanes, const int* fids, const int* seeds,
    const int* bounces, int n_rays, const int* live_count, const float* spheres,
    int spheres_per_frame, int n_frames, const float* params, const float* instances,
    int instances_per_frame, const float* triangles, int n_tri_rows, const float* node_bounds,
    const int* node_links, int n_nodes, int ordered, const unsigned char* slot_votes,
    int total_bounces, float* contribution, float* origins_out, float* directions_out,
    float* throughput_out, unsigned char* alive_out, int quant, const float* grid,
    void* stream) {
  if (n_rays > 0 && (instances_per_frame < 0 || n_tri_rows < 1 || n_nodes < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const pool::State in = {origins, directions, throughput, alive, lanes, fids,
                          seeds,   bounces,    n_rays,     live_count};
  const pool::Spheres table = {reinterpret_cast<const float4*>(spheres), spheres_per_frame,
                               n_frames, params};
  const pool::Outputs out = {contribution, origins_out, directions_out, throughput_out,
                             alive_out};
  return mesh::with_format(quant, {grid}, [&](auto format) {
    constexpr int Q = decltype(format)::value;
    const mesh::MeshTablesOf<Q> tables = {
        instances, reinterpret_cast<const float4*>(triangles),
        mesh::nodes_of<Q>(node_bounds, node_links, grid, mesh::kLeafRows),
        n_frames * instances_per_frame, n_nodes};
    if (ordered) {
      const MeshBounce<true, Q> bounce = {tables, instances_per_frame, n_tri_rows, 8 * n_nodes,
                                          slot_votes};
      return pool::launch(pool_mesh_bounce_kernel<true, Q>, in, table, bounce, total_bounces, out,
                          stream);
    }
    const MeshBounce<false, Q> bounce = {tables, instances_per_frame, n_tri_rows, n_nodes,
                                         nullptr};
    return pool::launch(pool_mesh_bounce_kernel<false, Q>, in, table, bounce, total_bounces, out,
                        stream);
  });
}

extern "C" const char* pool_mesh_bounce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
