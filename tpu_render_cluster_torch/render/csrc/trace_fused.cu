// Sphere-scene path-trace megakernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `_trace_fused` / `_trace_kernel_factory`
// (tpu_render_cluster/render/pallas_kernels.py) in its positional-counter
// mode: one launch runs the whole bounce loop for every ray and writes
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

#include "path_common.cuh"

namespace {

using path::float3v;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
trace_fused_kernel(const float* __restrict__ origins,
                   const float* __restrict__ directions, int n_rays,
                   const float4* __restrict__ spheres, int n_spheres,
                   const float* __restrict__ params, uint32_t seed,
                   int max_bounces, float* __restrict__ radiance_out) {
  __shared__ path::SceneShared scene;
  path::load_scene(scene, spheres, n_spheres, params);

  const int64_t ray = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (ray >= n_rays) return;
  const uint32_t lane = static_cast<uint32_t>(ray);

  float3v o = path::load3(origins, ray);
  float3v d = path::load3(directions, ray);
  float3v thr = {1.0f, 1.0f, 1.0f};
  float3v rad = {0.0f, 0.0f, 0.0f};
  const uint32_t counter_stride = 2u * static_cast<uint32_t>(max_bounces) + 2u;

  for (int bounce = 0; bounce < max_bounces; ++bounce) {
    if (!path::sphere_bounce(scene, 0, n_spheres, lane, bounce, counter_stride, seed, o, d, thr,
                             rad)) {
      break;  // the path escaped
    }
  }
  path::store3(radiance_out, ray, rad);
}

}  // namespace

// Plain C entry for ctypes. Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() so the caller sees a refused launch at once.
extern "C" int trace_fused_launch(const float* origins, const float* directions,
                                  int n_rays, const float* spheres, int n_spheres,
                                  const float* params, int seed, int max_bounces,
                                  float* radiance, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaSuccess);
  if (n_spheres < 1 || n_spheres > path::kMaxSpheres || max_bounces < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  trace_fused_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      origins, directions, n_rays, reinterpret_cast<const float4*>(spheres), n_spheres,
      params, static_cast<uint32_t>(seed), max_bounces, radiance);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* trace_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
