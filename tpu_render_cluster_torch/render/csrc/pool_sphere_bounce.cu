// Ray-pool sphere-scene bounce kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `pool_sphere_bounce` / `_trace_kernel_factory`
// with pool_io=True (tpu_render_cluster/render/pallas_kernels.py): one
// bounce over a pool of lanes from several frames of one sphere scene. The
// contract, the staging and the body are pool_common.cuh's; the bounce is
// path::sphere_bounce over the lane's own frame's spheres.
//
// Bound: operations, as sphere_bounce.cu for one bounce over one frame's
// spheres (about 26 flops per nearest-hit sphere test, 17 per shadow
// test), against 53 bytes of state in and 49 out per lane. The stacked
// table is staged when it fits in 96 KB (8 frames of 64 spheres: 32 KB).
// Built with --fmad=false.

#include "pool_common.cuh"

namespace {

__global__ void __launch_bounds__(pool::kThreads)
pool_sphere_bounce_kernel(pool::State in, pool::Spheres spheres, pool::SphereBounce bounce,
                          bool staged, int total_bounces, pool::Outputs out) {
  __shared__ float scene_params[path::kParams];
  extern __shared__ float4 staging[];
  pool::bounce_lanes(in, spheres, bounce, staged, total_bounces, out, staging, scene_params);
}

}  // namespace

// Plain C entry for ctypes. Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() so the caller sees a refused launch at once.
// State as sphere_bounce_launch plus the per-lane fids, seeds and bounces
// [n_rays] int32; spheres is the stacked table [n_frames * spheres_per_frame,
// 16] float32 and params its 18 scene parameters. Outputs may not alias the
// inputs.
extern "C" int pool_sphere_bounce_launch(
    const float* origins, const float* directions, const float* throughput,
    const unsigned char* alive, const int* lanes, const int* fids, const int* seeds,
    const int* bounces, int n_rays, const int* live_count, const float* spheres,
    int spheres_per_frame, int n_frames, const float* params, int total_bounces,
    float* contribution, float* origins_out, float* directions_out, float* throughput_out,
    unsigned char* alive_out, void* stream) {
  const pool::State in = {origins, directions, throughput, alive, lanes, fids,
                          seeds,   bounces,    n_rays,     live_count};
  const pool::Spheres table = {reinterpret_cast<const float4*>(spheres), spheres_per_frame,
                               n_frames, params};
  const pool::Outputs out = {contribution, origins_out, directions_out, throughput_out,
                             alive_out};
  return pool::launch(pool_sphere_bounce_kernel, in, table, pool::SphereBounce{},
                      total_bounces, out, stream);
}

extern "C" const char* pool_sphere_bounce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
