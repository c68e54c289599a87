// Sphere-scene path-trace megakernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `_trace_fused` / `_trace_kernel_factory`
// (tpu_render_cluster/render/pallas_kernels.py) in its positional-counter
// mode (its lane_io mode: trace_fused_lanes.cu; the body both share:
// trace_fused.cuh): one launch runs the whole bounce loop for every ray and writes
// radiance once. Per bounce, in the reference's order: nearest sphere and
// ground-plane hit, sky plus sun disc on escape, emission, checker albedo,
// sun next-event estimation (any-hit against the spheres), and a cosine
// resample driven by the counter PCG hash.
//
// Bound: operations. Per path-bounce the nearest-hit test costs about 26
// flops per sphere and the shadow test about 16, against 24 bytes of rays
// read and 12 bytes of radiance written per path, so device memory is
// never the limit. Design for this card, not the TPU's block layout:
//   - one thread per ray; path state stays in registers for all bounces;
//   - the scene's spheres (at most 128, 64 bytes each) are loaded once per
//     block into shared memory, where every lane of a warp reads the same
//     sphere at the same time (a broadcast, no bank conflicts);
//   - a lane whose path escaped leaves the loop: the reference multiplies
//     every later contribution of a dead lane by alive = 0, and all those
//     terms are finite, so they add exactly zero;
//   - the shadow test stops at the first occluder and is skipped where the
//     sun is below the surface (cos = 0): both add exactly zero in the
//     reference too.
//
// Parity with the reference (and with the plain PyTorch version in
// render/kernels.py) is kept deliberately: the quadratic uses the same
// expanded algebra (d.c - o.d, |o|^2 - 2 o.c + |c|^2), ties take the lowest
// sphere index, the checker parity uses `& 1` (floor-mod, also for negative
// sums), PCG wraps mod 2^32, and only IEEE-accurate math is used (no fast
// math). The bounce itself, rounded as the reference's compiler rounds, is
// path::sphere_bounce in path_common.cuh, shared with the per-bounce sphere
// kernel (sphere_bounce.cu).

#include "trace_fused.cuh"

namespace {

__global__ void __launch_bounds__(trace_fused::kThreads)
trace_fused_kernel(const float* __restrict__ origins,
                   const float* __restrict__ directions, int n_rays,
                   const float4* __restrict__ spheres, int n_spheres,
                   const float* __restrict__ params, uint32_t seed,
                   int max_bounces, float* __restrict__ radiance_out) {
  __shared__ path::SceneShared scene;
  trace_fused::trace_ray<false>(scene, origins, directions, nullptr, n_rays, spheres, n_spheres,
                                params, seed, max_bounces, radiance_out);
}

}  // namespace

// Plain C entry for ctypes. Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() so the caller sees a refused launch at once.
extern "C" int trace_fused_launch(const float* origins, const float* directions,
                                  int n_rays, const float* spheres, int n_spheres,
                                  const float* params, int seed, int max_bounces,
                                  float* radiance, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaSuccess);
  if (!trace_fused::valid_launch(n_spheres, max_bounces)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  trace_fused_kernel<<<trace_fused::blocks_for(n_rays), trace_fused::kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      origins, directions, n_rays, reinterpret_cast<const float4*>(spheres), n_spheres,
      params, static_cast<uint32_t>(seed), max_bounces, radiance);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* trace_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
