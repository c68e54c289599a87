// Sphere-scene path-trace megakernel for Hopper (sm_90a), lane mode.
//
// Replaces the TPU kernel `_trace_fused` / `_trace_kernel_factory`
// (tpu_render_cluster/render/pallas_kernels.py) in its lane_io mode: the
// positional kernel of trace_fused.cu with one more operand, an int32 lane
// row. Ray i's random numbers come from counter
// lanes[i] * (2 * max_bounces + 2) + 2 * bounce instead of i * (...), so the
// region path of a tile (integrator.render_frame_region) traces each of its
// rays with the lane that ray has in the whole frame and reproduces the
// whole frame's radiance on the tile's pixels, bit for bit.
//
// Everything else is the positional kernel's: the body in trace_fused.cuh,
// the spheres in shared memory, path::sphere_bounce. The lane row adds 4
// bytes read per ray (40 B per ray against the positional kernel's 36); the
// kernel stays bound by operations.

#include "trace_fused.cuh"

namespace {

__global__ void __launch_bounds__(trace_fused::kThreads)
trace_fused_lanes_kernel(const float* __restrict__ origins,
                         const float* __restrict__ directions,
                         const int* __restrict__ lanes, int n_rays,
                         const float4* __restrict__ spheres, int n_spheres,
                         const float* __restrict__ params, uint32_t seed,
                         int max_bounces, float* __restrict__ radiance_out) {
  __shared__ path::SceneShared scene;
  trace_fused::trace_ray<true>(scene, origins, directions, lanes, n_rays, spheres, n_spheres,
                               params, seed, max_bounces, radiance_out);
}

}  // namespace

// Plain C entry for ctypes. Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() so the caller sees a refused launch at once.
extern "C" int trace_fused_lanes_launch(const float* origins, const float* directions,
                                        const int* lanes, int n_rays, const float* spheres,
                                        int n_spheres, const float* params, int seed,
                                        int max_bounces, float* radiance, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaSuccess);
  if (!trace_fused::valid_launch(n_spheres, max_bounces)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  trace_fused_lanes_kernel<<<trace_fused::blocks_for(n_rays), trace_fused::kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      origins, directions, lanes, n_rays, reinterpret_cast<const float4*>(spheres), n_spheres,
      params, static_cast<uint32_t>(seed), max_bounces, radiance);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* trace_fused_lanes_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
