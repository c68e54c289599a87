// Rays x spheres nearest-hit kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `_nearest_hit` / `_nearest_hit_kernel`
// (tpu_render_cluster/render/pallas_kernels.py), the sphere pass of the
// per-bounce scan renderer (the reference's geometry.intersect_spheres,
// called from render/geometry.py `intersect_scene`). Per ray:
//   in:  origin, direction [R, 3] float32, the scene's padded sphere table;
//   out: t [R] float32 (1e30 on a miss) and index [R] int32, the first
//        index reaching the minimum and 0 for a ray that misses every
//        sphere, as jnp.argmin gives it.
// The TPU kernel's algebra, which path::nearest_sphere follows: d . (c - o)
// as c.d - o.d, |o - c|^2 as |o|^2 - 2 o.c + |c|^2, the discriminant as one
// FMA; a pad slot (radius 0) never hits.
//
// Bound: operations, about 26 flops per ray and real sphere (two 3-dots, the
// quadratic, sqrt, both roots, the selects), against 24 bytes in and 8 out
// per ray. Design: one thread per ray, the sphere table in shared memory,
// the sweep is path::nearest_sphere (path_common.cuh), the megakernels' own
// sphere pass. The TPU's [N, block] MXU contractions and its min/argmin
// reductions over the sphere axis become one register loop per thread.
// Built with --fmad=false.

#include "path_common.cuh"

namespace {

using path::float3v;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
intersect_spheres_kernel(const float* __restrict__ origins, const float* __restrict__ directions,
                         int n_rays, const float4* __restrict__ spheres, int n_spheres,
                         const float* __restrict__ params, float* __restrict__ t_out,
                         int* __restrict__ index_out) {
  __shared__ path::SceneShared scene;
  path::load_scene(scene, spheres, n_spheres, params);  // ends with __syncthreads()
  const int64_t ray = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (ray >= n_rays) return;
  int index;
  t_out[ray] = path::nearest_sphere(scene, 0, n_spheres, path::load3(origins, ray),
                                    path::load3(directions, ray), &index);
  index_out[ray] = index;
}

}  // namespace

// Plain C entry for ctypes. Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() so the caller sees a refused launch at once.
// Rays [n_rays, 3] float32; spheres and params as for trace_fused_launch.
extern "C" int intersect_spheres_launch(const float* origins, const float* directions, int n_rays,
                                        const float* spheres, int n_spheres, const float* params,
                                        float* t_out, int* index_out, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaSuccess);
  if (n_spheres < 1 || n_spheres > path::kMaxSpheres) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  intersect_spheres_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      origins, directions, n_rays, reinterpret_cast<const float4*>(spheres), n_spheres, params,
      t_out, index_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* intersect_spheres_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
