// Rays x spheres shadow any-hit kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `_any_hit` / `_any_hit_kernel`
// (tpu_render_cluster/render/pallas_kernels.py), the sphere shadow test of
// the per-bounce scan renderer (the reference's geometry.occluded_sun,
// called from render/integrator.py `_shade_bounce`). Per ray:
//   in:  origin, direction [R, 3] float32, the scene's padded sphere table;
//   out: [R] bytes, 1 where some real sphere has its far root past EPS
//        ahead of the origin (the plane is not tested).
//
// Bound: operations, about 22 flops per sphere tested (two 3-dots, the
// quadratic, sqrt, the far root, compares), a ray's tests ending at its
// first occluder, against 24 bytes in and 1 out per ray. Design: one thread
// per ray, the sphere table in shared memory, the sweep is
// path::sphere_any_hit (path_common.cuh), the megakernels' sun shadow test
// along the ray's own direction. The TPU's OR-reduction over the sphere
// axis becomes a loop that stops at the first occluder. Built with
// --fmad=false.

#include "path_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
occluded_spheres_kernel(const float* __restrict__ origins, const float* __restrict__ directions,
                        int n_rays, const float4* __restrict__ spheres, int n_spheres,
                        const float* __restrict__ params, uint8_t* __restrict__ hit_out) {
  __shared__ path::SceneShared scene;
  path::load_scene(scene, spheres, n_spheres, params);  // ends with __syncthreads()
  const int64_t ray = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (ray >= n_rays) return;
  hit_out[ray] = path::sphere_any_hit(scene, 0, n_spheres, path::load3(origins, ray),
                                      path::load3(directions, ray))
                     ? 1
                     : 0;
}

}  // namespace

// Plain C entry for ctypes. Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() so the caller sees a refused launch at once.
// Rays [n_rays, 3] float32; spheres and params as for trace_fused_launch;
// the output is [n_rays] bytes (a torch.bool tensor).
extern "C" int occluded_spheres_launch(const float* origins, const float* directions, int n_rays,
                                       const float* spheres, int n_spheres, const float* params,
                                       unsigned char* hit_out, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaSuccess);
  if (n_spheres < 1 || n_spheres > path::kMaxSpheres) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  occluded_spheres_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      origins, directions, n_rays, reinterpret_cast<const float4*>(spheres), n_spheres, params,
      hit_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* occluded_spheres_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
