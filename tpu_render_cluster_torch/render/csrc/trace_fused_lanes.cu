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
// Everything else is the positional kernel's: the body in trace_fused.cuh
// (persistent blocks that regenerate paths from a work counter, the
// spheres in shared memory, path::sphere_bounce); a thread that takes ray
// i reads lanes[i]. The lane row adds 4 bytes read per ray (40 B per ray
// against the positional kernel's 36); the kernel stays bound by
// operations. A tile's 524,288 rays filled 2,048 blocks of one ray a
// thread, 3.1 waves whose last was a tenth full; the persistent grid runs
// them on 660 blocks, 3.1 rays a thread. Measured by chip_ab.py on an
// NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6), alone on tile 0 of
// 04 frame 1: 0.191 ms for the first design, 0.149 now.

#include "trace_fused.cuh"

namespace {

__global__ void __launch_bounds__(trace_fused::kThreads)
trace_fused_lanes_kernel(const float* __restrict__ origins,
                         const float* __restrict__ directions,
                         const int* __restrict__ lanes, int n_rays,
                         const float4* __restrict__ spheres, int n_spheres,
                         const float* __restrict__ params, uint32_t seed,
                         int max_bounces, float* __restrict__ radiance_out,
                         int* __restrict__ next_ray) {
  __shared__ path::SceneShared scene;
  trace_fused::trace_rays<true>(scene, origins, directions, lanes, n_rays, spheres, n_spheres,
                                params, seed, max_bounces, radiance_out, next_ray);
}

}  // namespace

// Plain C entry for ctypes. Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() so the caller sees a refused launch at once.
// After the radiance, the work counter, as trace_fused_launch's.
extern "C" int trace_fused_lanes_launch(const float* origins, const float* directions,
                                        const int* lanes, int n_rays, const float* spheres,
                                        int n_spheres, const float* params, int seed,
                                        int max_bounces, float* radiance, int* work_counter,
                                        void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaSuccess);
  if (!trace_fused::valid_launch(n_spheres, max_bounces)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return trace_fused::launch(trace_fused_lanes_kernel, n_rays, work_counter,
                             static_cast<cudaStream_t>(stream), origins, directions, lanes,
                             n_rays, reinterpret_cast<const float4*>(spheres), n_spheres, params,
                             static_cast<uint32_t>(seed), max_bounces, radiance);
}

// The kernel's blocks resident on one SM, with the grid of a launch over
// n_rays in *grid_blocks (a negative CUDA error code on failure).
extern "C" int trace_fused_lanes_occupancy(int n_rays, int* grid_blocks) {
  return trace_fused::occupancy(trace_fused_lanes_kernel, n_rays, grid_blocks);
}

extern "C" const char* trace_fused_lanes_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
