// Per-bounce mesh-scene path-trace kernel, two-level instance walk, with
// the fused coherence-key epilogue, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_mesh_bounce_io` / `_mesh_trace_kernel_factory`
// with state_io=True and use_tlas=True, the reference's default
// (tpu_render_cluster/render/pallas_kernels.py): mesh_bounce.cu's contract
// (one bounce, the path state streamed in and out, lanes at or past the
// live count passed through) with the instances walked through the frame's
// TLAS (mesh_common.cuh, TlasInstances; the instance table in Morton slot
// order), and one more output, each lane's coherence sort key of its state
// after the bounce (`key_out_ref`, pallas_kernels.py:2974-3115), so the
// caller's next sort is one argsort of this column:
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
// per ray. Design: one thread per ray, no stack; the BVH, the slot-ordered
// instance table and the TLAS (about 1.5 KB for 48 instances) staged per
// block; the key window read from global memory. Built with --fmad=false.

#include "mesh_common.cuh"

namespace {

using path::float3v;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
mesh_bounce_tlas_kernel(const float* __restrict__ origins, const float* __restrict__ directions,
                        const float* __restrict__ throughput, const uint8_t* __restrict__ alive,
                        const int* __restrict__ lanes, int n_rays,
                        const int* __restrict__ live_count, const float4* __restrict__ spheres,
                        int n_spheres, const float* __restrict__ params, mesh::MeshTables tables,
                        mesh::TlasTables tlas, const float* __restrict__ key_window,
                        int n_tri_rows, bool staged, uint32_t seed, int bounce,
                        int total_bounces, float* __restrict__ contribution,
                        float* __restrict__ origins_out, float* __restrict__ directions_out,
                        float* __restrict__ throughput_out, uint8_t* __restrict__ alive_out,
                        int* __restrict__ key_out) {
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
  int candidate = tables.n_instances;

  // Uniform per block: a block wholly past the live count skips the tables.
  if (static_cast<int64_t>(blockIdx.x) * blockDim.x < live) {
    if (staged) mesh::stage_two_level(tables, tlas, staging, n_tri_rows);
    path::load_scene(scene, spheres, n_spheres, params);  // ends with __syncthreads()
    if (is_alive && ray < live) {
      const uint32_t counter_stride = 2u * static_cast<uint32_t>(total_bounces) + 2u;
      const mesh::TlasInstances instances = {tlas, 0, tlas.n_nodes};
      is_alive = mesh::bounce(scene, 0, n_spheres, tables, instances,
                              static_cast<uint32_t>(lanes[ray]), bounce, counter_stride, seed,
                              o, d, thr, rad);
      if (is_alive && bounce < total_bounces - 1) {
        candidate = instances.entry_candidate(tables, o, d, 0, tables.n_instances);
      }
    }
  }
  if (ray >= n_rays) return;
  path::store3(contribution, ray, rad);
  path::store3(origins_out, ray, o);
  path::store3(directions_out, ray, d);
  path::store3(throughput_out, ray, thr);
  alive_out[ray] = is_alive ? 1 : 0;
  key_out[ray] = mesh::coherence_key(o, d, !is_alive, 0, candidate, key_window);
}

}  // namespace

// Plain C entry for ctypes, as mesh_bounce_launch with the instances in
// slot order and, after the BVH, the frame's TLAS (node bounds
// [n_tlas_nodes, 8], links [n_tlas_nodes, 4] int32) and its key window
// [6] (lo, 1 / span); after the five outputs the key [n_rays] int32.
extern "C" int mesh_bounce_tlas_launch(
    const float* origins, const float* directions, const float* throughput,
    const unsigned char* alive, const int* lanes, int n_rays, const int* live_count,
    const float* spheres, int n_spheres, const float* params, const float* instances,
    int n_instances, const float* triangles, int n_tri_rows, const float* node_bounds,
    const int* node_links, int n_nodes, const float* tlas_bounds, const int* tlas_links,
    int n_tlas_nodes, const float* key_window, int seed, int bounce, int total_bounces,
    float* contribution, float* origins_out, float* directions_out, float* throughput_out,
    unsigned char* alive_out, int* key_out, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaSuccess);
  if (n_spheres < 1 || n_spheres > path::kMaxSpheres || bounce < 0 ||
      bounce >= total_bounces || n_instances < 1 || n_tri_rows < 1 || n_nodes < 1 ||
      n_tlas_nodes < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const mesh::MeshTables tables = {instances,
                                   reinterpret_cast<const float4*>(triangles),
                                   reinterpret_cast<const float4*>(node_bounds),
                                   reinterpret_cast<const int4*>(node_links),
                                   n_instances,
                                   n_nodes};
  const mesh::TlasTables tlas = {reinterpret_cast<const float4*>(tlas_bounds),
                                 reinterpret_cast<const int4*>(tlas_links), n_tlas_nodes,
                                 n_tlas_nodes};
  size_t shared_bytes;
  bool staged;
  const cudaError_t status = path::staging_for(
      mesh_bounce_tlas_kernel,
      mesh::two_level_bytes(n_tri_rows, n_nodes, n_instances, n_tlas_nodes), &shared_bytes,
      &staged);
  if (status != cudaSuccess) return static_cast<int>(status);
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  mesh_bounce_tlas_kernel<<<blocks, kThreads, shared_bytes, static_cast<cudaStream_t>(stream)>>>(
      origins, directions, throughput, alive, lanes, n_rays, live_count,
      reinterpret_cast<const float4*>(spheres), n_spheres, params, tables, tlas, key_window,
      n_tri_rows, staged, static_cast<uint32_t>(seed), bounce, total_bounces, contribution,
      origins_out, directions_out, throughput_out, alive_out, key_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mesh_bounce_tlas_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
