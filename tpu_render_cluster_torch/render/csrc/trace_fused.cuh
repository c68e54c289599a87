// The body of the sphere path-trace megakernel, shared by its two modes:
// trace_fused.cu (the RNG counter of ray i is i) and trace_fused_lanes.cu
// (the TPU kernel's lane_io mode: the counter of ray i is lanes[i], so a
// launch over one tile's rays, each with its lane in the whole frame, draws
// the whole frame's random numbers for those rays). One thread per ray; the
// spheres in shared memory; the bounce is path::sphere_bounce.
//
// kLaneIO is a compile-time switch: the positional instantiation reads no
// lane row, so it compiles to the code the positional kernel had before
// the lane mode existed.

#pragma once

#include "path_common.cuh"

namespace trace_fused {

constexpr int kThreads = 256;

template <bool kLaneIO>
__device__ __forceinline__ void trace_ray(path::SceneShared& scene,
                                          const float* __restrict__ origins,
                                          const float* __restrict__ directions,
                                          const int* __restrict__ lanes, int n_rays,
                                          const float4* __restrict__ spheres, int n_spheres,
                                          const float* __restrict__ params, uint32_t seed,
                                          int max_bounces, float* __restrict__ radiance_out) {
  path::load_scene(scene, spheres, n_spheres, params);

  const int64_t ray = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (ray >= n_rays) return;
  uint32_t lane;
  if constexpr (kLaneIO) {
    lane = static_cast<uint32_t>(lanes[ray]);
  } else {
    lane = static_cast<uint32_t>(ray);
  }

  path::float3v o = path::load3(origins, ray);
  path::float3v d = path::load3(directions, ray);
  path::float3v thr = {1.0f, 1.0f, 1.0f};
  path::float3v rad = {0.0f, 0.0f, 0.0f};
  const uint32_t counter_stride = 2u * static_cast<uint32_t>(max_bounces) + 2u;

  for (int bounce = 0; bounce < max_bounces; ++bounce) {
    if (!path::sphere_bounce(scene, 0, n_spheres, lane, bounce, counter_stride, seed, o, d, thr,
                             rad)) {
      break;  // the path escaped
    }
  }
  path::store3(radiance_out, ray, rad);
}

// The launch's argument check and grid, shared by both C entries.
inline bool valid_launch(int n_spheres, int max_bounces) {
  return n_spheres >= 1 && n_spheres <= path::kMaxSpheres && max_bounces >= 0;
}

inline int blocks_for(int n_rays) { return (n_rays + kThreads - 1) / kThreads; }

}  // namespace trace_fused
