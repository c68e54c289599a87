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
// Bound: operations, as trace_fused_mesh.cu, with the instance search a
// two-level walk (about 2 ceil(log2 K) box tests per search where the
// flat sweep pays K). Design: one thread per ray, no stack (the links are
// threaded); the BVH, the slot-ordered instance table and the TLAS (about
// 0.7 KB for 24 instances) staged once per block in shared memory beside
// the spheres. The TPU's packet culls (a subtree skipped when no lane of a
// 256-ray block wants it) become per-thread culls, which change which
// nodes a ray visits, never its nearest hit. Built with --fmad=false.

#include "mesh_common.cuh"

namespace {

using path::float3v;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
trace_fused_mesh_tlas_kernel(const float* __restrict__ origins,
                             const float* __restrict__ directions, int n_rays,
                             const float4* __restrict__ spheres, int n_spheres,
                             const float* __restrict__ params, mesh::MeshTables tables,
                             mesh::TlasTables tlas, int n_tri_rows, bool staged, uint32_t seed,
                             int max_bounces, float* __restrict__ radiance_out) {
  __shared__ path::SceneShared scene;
  extern __shared__ float4 staging[];
  if (staged) mesh::stage_two_level(tables, tlas, staging, n_tri_rows);
  path::load_scene(scene, spheres, n_spheres, params);  // ends with __syncthreads()

  const int64_t ray = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (ray >= n_rays) return;
  const uint32_t lane = static_cast<uint32_t>(ray);

  float3v o = path::load3(origins, ray);
  float3v d = path::load3(directions, ray);
  float3v thr = {1.0f, 1.0f, 1.0f};
  float3v rad = {0.0f, 0.0f, 0.0f};
  const uint32_t counter_stride = 2u * static_cast<uint32_t>(max_bounces) + 2u;

  const mesh::TlasInstances instances = {tlas, 0, tlas.n_nodes};
  for (int bounce = 0; bounce < max_bounces; ++bounce) {
    if (!mesh::bounce(scene, 0, n_spheres, tables, instances, lane, bounce, counter_stride, seed,
                      o, d, thr, rad)) {
      break;  // the path escaped
    }
  }
  path::store3(radiance_out, ray, rad);
}

}  // namespace

// Plain C entry for ctypes, as trace_fused_mesh_launch with the instances
// in slot order and, after the BVH, the frame's TLAS: node bounds
// [n_tlas_nodes, 8] (lo, 0, hi, 0) and links [n_tlas_nodes, 4] (int32 skip,
// first slot, slot count, 0; kernels.tlas_links).
extern "C" int trace_fused_mesh_tlas_launch(
    const float* origins, const float* directions, int n_rays, const float* spheres,
    int n_spheres, const float* params, const float* instances, int n_instances,
    const float* triangles, int n_tri_rows, const float* node_bounds, const int* node_links,
    int n_nodes, const float* tlas_bounds, const int* tlas_links, int n_tlas_nodes, int seed,
    int max_bounces, float* radiance, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaSuccess);
  if (n_spheres < 1 || n_spheres > path::kMaxSpheres || max_bounces < 0 ||
      n_instances < 1 || n_tri_rows < 1 || n_nodes < 1 || n_tlas_nodes < 1) {
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
      trace_fused_mesh_tlas_kernel,
      mesh::two_level_bytes(n_tri_rows, n_nodes, n_instances, n_tlas_nodes), &shared_bytes,
      &staged);
  if (status != cudaSuccess) return static_cast<int>(status);
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  trace_fused_mesh_tlas_kernel<<<blocks, kThreads, shared_bytes,
                                 static_cast<cudaStream_t>(stream)>>>(
      origins, directions, n_rays, reinterpret_cast<const float4*>(spheres), n_spheres, params,
      tables, tlas, n_tri_rows, staged, static_cast<uint32_t>(seed), max_bounces, radiance);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* trace_fused_mesh_tlas_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
