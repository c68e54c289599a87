// Per-bounce sphere-scene path-trace kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `_sphere_bounce` / `_trace_kernel_factory` with
// state_io=True (tpu_render_cluster/render/pallas_kernels.py): ONE bounce of
// the sphere megakernel per launch, with the path state streamed in and
// out, for the wavefront driver (render/compaction.py), which compacts the
// live rays to the front between bounces. The contract is mesh_bounce.cu's
// without the mesh: per ray origin, direction, throughput, alive and the
// original lane (the RNG counter) in; the bounce's contribution (from zero)
// and the new state out; lanes at or past *live_count, and dead lanes,
// pass their state through with a zero contribution.
//
// Bound: operations, as trace_fused.cu for one bounce (about 26 flops per
// sphere for the nearest hit, 17 per shadow test), against 41 bytes of
// state in and 49 out per ray. Design: one thread per ray, the spheres in
// shared memory, the bounce itself is path::sphere_bounce (path_common.cuh),
// the megakernel's loop body. Built with --fmad=false.

#include "path_common.cuh"

namespace {

using path::float3v;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
sphere_bounce_kernel(const float* __restrict__ origins, const float* __restrict__ directions,
                     const float* __restrict__ throughput, const uint8_t* __restrict__ alive,
                     const int* __restrict__ lanes, int n_rays,
                     const int* __restrict__ live_count, const float4* __restrict__ spheres,
                     int n_spheres, const float* __restrict__ params, uint32_t seed, int bounce,
                     int total_bounces, float* __restrict__ contribution,
                     float* __restrict__ origins_out, float* __restrict__ directions_out,
                     float* __restrict__ throughput_out, uint8_t* __restrict__ alive_out) {
  __shared__ path::SceneShared scene;
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

  // Uniform per block: a block wholly past the live count loads no scene.
  if (static_cast<int64_t>(blockIdx.x) * blockDim.x < live) {
    path::load_scene(scene, spheres, n_spheres, params);  // ends with __syncthreads()
    if (is_alive && ray < live) {
      const uint32_t counter_stride = 2u * static_cast<uint32_t>(total_bounces) + 2u;
      is_alive = path::sphere_bounce(scene, 0, n_spheres, static_cast<uint32_t>(lanes[ray]),
                                     bounce, counter_stride, seed, o, d, thr, rad);
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

// Plain C entry for ctypes, as mesh_bounce_launch without the mesh tables.
extern "C" int sphere_bounce_launch(const float* origins, const float* directions,
                                    const float* throughput, const unsigned char* alive,
                                    const int* lanes, int n_rays, const int* live_count,
                                    const float* spheres, int n_spheres, const float* params,
                                    int seed, int bounce, int total_bounces, float* contribution,
                                    float* origins_out, float* directions_out,
                                    float* throughput_out, unsigned char* alive_out,
                                    void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaSuccess);
  if (n_spheres < 1 || n_spheres > path::kMaxSpheres || bounce < 0 || bounce >= total_bounces) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  sphere_bounce_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      origins, directions, throughput, alive, lanes, n_rays, live_count,
      reinterpret_cast<const float4*>(spheres), n_spheres, params, static_cast<uint32_t>(seed),
      bounce, total_bounces, contribution, origins_out, directions_out, throughput_out,
      alive_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sphere_bounce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
