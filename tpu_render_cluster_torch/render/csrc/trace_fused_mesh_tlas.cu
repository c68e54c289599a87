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
// nodes a ray visits, never its nearest hit.
//
// Walk order: on a BVH with octant tables (every sah build; the
// reference's default) the launch's tables hold the BVH's and the TLAS's
// eight octant orders stacked [8N] and [8M], and each walk takes the one of
// its packet's octant (mesh::Octants). A block of 256 threads is the
// reference's packet (tlas_block_r() lanes in launch order): at every
// bounce all its threads vote, each with the direction its lane carries (a
// finished path's last one, a lane past the launch (0, 1, 0)), on the
// TLAS's octant (block_octant: a warp sum and one barrier) and, on a BVH of
// more than one node, on each instance's BLAS octant in object space
// (block_instance_octants: a ballot per warp, K x 3 counters in shared
// memory); the shadow walks take the sun's octant. Without octant tables
// the canonical order, the kernel as before. Built with --fmad=false.

#include "mesh_common.cuh"

namespace {

using path::float3v;
constexpr int kThreads = 256;

// kOrdered: the octant-ordered walk, its votes in `vote` (counters and
// octants of block_instance_octants; nullptr on a one-node BVH).
template <bool kOrdered>
__global__ void __launch_bounds__(kThreads)
trace_fused_mesh_tlas_kernel(const float* __restrict__ origins,
                             const float* __restrict__ directions, int n_rays,
                             const float4* __restrict__ spheres, int n_spheres,
                             const float* __restrict__ params, mesh::MeshTables tables,
                             mesh::TlasTables tlas, int n_tri_rows, int n_node_rows, bool staged,
                             size_t vote_offset, bool instance_votes, uint32_t seed,
                             int max_bounces, float* __restrict__ radiance_out) {
  __shared__ path::SceneShared scene;
  __shared__ int world_votes[3];
  extern __shared__ float4 staging[];
  if (staged) mesh::stage_two_level(tables, tlas, staging, n_tri_rows, n_node_rows);
  if (kOrdered && threadIdx.x < 3) world_votes[threadIdx.x] = 0;
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
    const float3v sun = {scene.params[0], scene.params[1], scene.params[2]};
    const int sun_row = mesh::octant_of(sun) * tlas.n_nodes;
    bool alive = in_launch;
    for (int bounce = 0; bounce < max_bounces; ++bounce) {
      const int tlas_row = mesh::block_octant(d, world_votes, bounce) * tlas.n_nodes;
      if (instance_votes) mesh::block_instance_octants(tables, d, counts, octants);
      const mesh::TlasInstances<mesh::Octants> instances = {
          tlas, 0, tlas.n_nodes, {instance_votes ? octants : nullptr, tlas_row, sun_row}};
      if (alive) {
        alive = mesh::bounce(scene, 0, n_spheres, tables, instances, lane, bounce,
                             counter_stride, seed, o, d, thr, rad);
      }
    }
    if (in_launch) path::store3(radiance_out, ray, rad);
  } else {
    const mesh::TlasInstances<> instances = {tlas, 0, tlas.n_nodes};
    for (int bounce = 0; bounce < max_bounces; ++bounce) {
      if (!mesh::bounce(scene, 0, n_spheres, tables, instances, lane, bounce, counter_stride,
                        seed, o, d, thr, rad)) {
        break;  // the path escaped
      }
    }
    path::store3(radiance_out, ray, rad);
  }
}

template <bool kOrdered>
int launch(const float* origins, const float* directions, int n_rays, const float* spheres,
           int n_spheres, const float* params, const mesh::MeshTables& tables,
           const mesh::TlasTables& tlas, int n_tri_rows, int n_node_rows, int seed,
           int max_bounces, float* radiance, cudaStream_t stream) {
  const auto kernel = trace_fused_mesh_tlas_kernel<kOrdered>;
  const bool instance_votes = kOrdered && tables.n_nodes > 1;
  size_t shared_bytes, vote_offset;
  bool staged;
  const cudaError_t status = mesh::megakernel_shared(
      kernel, mesh::two_level_bytes(n_tri_rows, n_node_rows, tables.n_instances, tlas.n_rows),
      mesh::instance_vote_bytes(instance_votes, tables.n_instances), &shared_bytes, &staged,
      &vote_offset);
  if (status != cudaSuccess) return static_cast<int>(status);
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, shared_bytes, stream>>>(
      origins, directions, n_rays, reinterpret_cast<const float4*>(spheres), n_spheres, params,
      tables, tlas, n_tri_rows, n_node_rows, staged, vote_offset, instance_votes,
      static_cast<uint32_t>(seed), max_bounces, radiance);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry for ctypes, as trace_fused_mesh_launch with the instances
// in slot order and, after the BVH, the frame's TLAS: node bounds
// [n_tlas_nodes, 8] (lo, 0, hi, 0) and links [n_tlas_nodes, 4] (int32 skip,
// first slot, slot count, 0; kernels.tlas_links), then `ordered`: nonzero
// when the BVH's and the TLAS's tables are their eight octant orders
// stacked, [8 n_nodes] and [8 n_tlas_nodes] rows (kernels.tlas_octant_links).
extern "C" int trace_fused_mesh_tlas_launch(
    const float* origins, const float* directions, int n_rays, const float* spheres,
    int n_spheres, const float* params, const float* instances, int n_instances,
    const float* triangles, int n_tri_rows, const float* node_bounds, const int* node_links,
    int n_nodes, const float* tlas_bounds, const int* tlas_links, int n_tlas_nodes, int ordered,
    int seed, int max_bounces, float* radiance, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaSuccess);
  if (n_spheres < 1 || n_spheres > path::kMaxSpheres || max_bounces < 0 ||
      n_instances < 1 || n_tri_rows < 1 || n_nodes < 1 || n_tlas_nodes < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int orders = ordered ? 8 : 1;
  const mesh::MeshTables tables = {instances,
                                   reinterpret_cast<const float4*>(triangles),
                                   reinterpret_cast<const float4*>(node_bounds),
                                   reinterpret_cast<const int4*>(node_links),
                                   n_instances,
                                   n_nodes};
  const mesh::TlasTables tlas = {reinterpret_cast<const float4*>(tlas_bounds),
                                 reinterpret_cast<const int4*>(tlas_links), n_tlas_nodes,
                                 orders * n_tlas_nodes};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ordered) {
    return launch<true>(origins, directions, n_rays, spheres, n_spheres, params, tables, tlas,
                        n_tri_rows, orders * n_nodes, seed, max_bounces, radiance, s);
  }
  return launch<false>(origins, directions, n_rays, spheres, n_spheres, params, tables, tlas,
                       n_tri_rows, n_nodes, seed, max_bounces, radiance, s);
}

extern "C" const char* trace_fused_mesh_tlas_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
