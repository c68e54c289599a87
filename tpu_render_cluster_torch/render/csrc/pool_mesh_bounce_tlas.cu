// Ray-pool mesh-scene bounce kernel, two-level instance walk, with the
// fused coherence-key epilogue, for Hopper (sm_90a).
//
// Replaces the TPU kernel `pool_mesh_bounce` / `_mesh_trace_kernel_factory`
// with pool_io=True and use_tlas=True, the reference's default
// (tpu_render_cluster/render/pallas_kernels.py): pool_mesh_bounce.cu's
// contract and body (pool_common.cuh) with each frame's instances in Morton
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
// against 53 bytes of state in and 53 out per lane. The sphere rows, the
// BVH, the stacked slot tables and TLAS windows (an 8-frame window of
// 03_physics-2-mesh: about 8 + 28 + 34 + 12 KB) are staged when they fit in
// 96 KB. Built with --fmad=false.

#include "mesh_common.cuh"
#include "pool_common.cuh"

namespace {

using path::float3v;

struct TlasMeshBounce {
  mesh::MeshTables tables;  // instances: the stacked [F K, 22] slot tables
  mesh::TlasTables tlas;  // the stacked windows: n_nodes M per frame, n_rows F M
  const float* key_window;  // [6]
  int* keys;  // [P]
  int per_frame;  // K
  int n_tri_rows;
  size_t bytes() const {
    return mesh::two_level_bytes(n_tri_rows, tables.n_nodes, tables.n_instances, tlas.n_rows);
  }
  __device__ __forceinline__ void stage(float4* staging) {
    mesh::stage_two_level(tables, tlas, staging, n_tri_rows);
  }
  __device__ __forceinline__ mesh::TlasInstances window(int frame) const {
    return {tlas, frame * tlas.n_nodes, (frame + 1) * tlas.n_nodes};
  }
  template <typename Scene>
  __device__ __forceinline__ bool run(const Scene& scene, int sphere_first, int n_spheres,
                                      int frame, uint32_t lane, int bounce,
                                      uint32_t counter_stride, uint32_t seed, float3v& o,
                                      float3v& d, float3v& thr, float3v& rad) const {
    // A lane outside the window sees no node (frame -1: the empty range).
    const mesh::TlasInstances instances =
        frame >= 0 ? window(frame) : mesh::TlasInstances{tlas, 0, 0};
    return mesh::bounce(scene, sphere_first, n_spheres, tables, instances, lane, bounce,
                        counter_stride, seed, o, d, thr, rad);
  }
  __device__ __forceinline__ void finish(const pool::State& in, int64_t ray, int frame,
                                         float3v o, float3v d, bool alive) const {
    const int candidate =
        frame >= 0 ? window(frame).entry_candidate(tables, o, d, frame * per_frame, per_frame)
                   : per_frame;
    keys[ray] = mesh::coherence_key(o, d, !alive, in.fids[ray], candidate, key_window);
  }
};

__global__ void __launch_bounds__(pool::kThreads)
pool_mesh_bounce_tlas_kernel(pool::State in, pool::Spheres spheres, TlasMeshBounce bounce,
                             bool staged, int total_bounces, pool::Outputs out) {
  __shared__ float scene_params[path::kParams];
  extern __shared__ float4 staging[];
  pool::bounce_lanes(in, spheres, bounce, staged, total_bounces, out, staging, scene_params);
}

}  // namespace

// Plain C entry for ctypes, as pool_mesh_bounce_launch with each frame's
// instances in slot order and, after the BVH, the stacked TLAS windows
// (node bounds [n_frames * tlas_nodes_per_frame, 8], links likewise [.., 4]
// int32) and the window's key window [6]; after the five outputs the key
// [n_rays] int32.
extern "C" int pool_mesh_bounce_tlas_launch(
    const float* origins, const float* directions, const float* throughput,
    const unsigned char* alive, const int* lanes, const int* fids, const int* seeds,
    const int* bounces, int n_rays, const int* live_count, const float* spheres,
    int spheres_per_frame, int n_frames, const float* params, const float* instances,
    int instances_per_frame, const float* triangles, int n_tri_rows, const float* node_bounds,
    const int* node_links, int n_nodes, const float* tlas_bounds, const int* tlas_links,
    int tlas_nodes_per_frame, const float* key_window, int total_bounces, float* contribution,
    float* origins_out, float* directions_out, float* throughput_out, unsigned char* alive_out,
    int* key_out, void* stream) {
  if (n_rays > 0 && (instances_per_frame < 1 || n_tri_rows < 1 || n_nodes < 1 ||
                     tlas_nodes_per_frame < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const pool::State in = {origins, directions, throughput, alive, lanes, fids,
                          seeds,   bounces,    n_rays,     live_count};
  const pool::Spheres table = {reinterpret_cast<const float4*>(spheres), spheres_per_frame,
                               n_frames, params};
  const TlasMeshBounce bounce = {{instances, reinterpret_cast<const float4*>(triangles),
                                  reinterpret_cast<const float4*>(node_bounds),
                                  reinterpret_cast<const int4*>(node_links),
                                  n_frames * instances_per_frame, n_nodes},
                                 {reinterpret_cast<const float4*>(tlas_bounds),
                                  reinterpret_cast<const int4*>(tlas_links), tlas_nodes_per_frame,
                                  n_frames * tlas_nodes_per_frame},
                                 key_window,
                                 key_out,
                                 instances_per_frame,
                                 n_tri_rows};
  const pool::Outputs out = {contribution, origins_out, directions_out, throughput_out,
                             alive_out};
  return pool::launch(pool_mesh_bounce_tlas_kernel, in, table, bounce, total_bounces, out,
                      stream);
}

extern "C" const char* pool_mesh_bounce_tlas_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
