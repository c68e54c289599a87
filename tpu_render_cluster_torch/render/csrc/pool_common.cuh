// Ray-pool device code shared by the pool kernels (pool_sphere_bounce.cu,
// pool_mesh_bounce.cu and pool_mesh_bounce_tlas.cu): ONE bounce over a
// fixed-width pool of lanes
// that come from several frames of one scene, for the device-resident ray
// pool of render/raypool.py. The contract is sphere_bounce.cu's, except
// that each lane carries its own frame id, its frame's trace seed and its
// own bounce depth, and the scene is the window's per-frame tables stacked
// frame-major: frame f's N spheres (the scene's count padded to 8) are
// rows [f N, (f + 1) N). Per lane:
//   in:  origin, direction, throughput [P, 3], alive [P] (bytes 0/1), the
//        ray's original lane, frame id, seed and bounce [P] (int32), the
//        live count;
//   out: this bounce's contribution (from zero), origin, direction,
//        throughput and alive after the bounce.
// RNG counter: lane * (2 * total_bounces + 2) + 2 * bounce, hashed with the
// lane's frame seed: the stream the lane has in its own frame's masked loop.
//
// The reference masks every test by frame id over the whole stack. A lane
// here sweeps only its own frame's rows: a masked row never hits, and ties
// still go to the lowest index within the frame, so the hits are the same
// at 1/F of the tests. A lane whose frame id lies outside [0, n_frames)
// sees no row, as a lane that matches no frame id does in the reference.
//
// Live count: the pool sorts dead lanes to the tail, so lanes at or past
// *live_count pass their state through with a zero contribution, and a
// block whose first lane is past it stages nothing.
//
// Design: one thread per lane. The stacked sphere rows, then the bounce's
// own tables, are staged together in dynamic shared memory when they fit
// (path::staging_for), else all are read from global memory. What a kernel
// adds is its Bounce: a type with
//   size_t bytes() const                  the bytes of its staged tables;
//   __device__ void stage(float4* dst)    stage them at dst (every thread);
//   __device__ bool run(scene, sphere_first, n_spheres, frame, ray, lane,
//                       bounce, counter_stride, seed, o, d, thr, rad)
//                                         one bounce of pool lane `ray` on
//                                         its frame (frame -1: none), as
//                                         path::sphere_bounce.
// pool_mesh_bounce_tlas.cu has a body of its own (G threads a lane, only a
// block's frames staged) and shares a lane's load and store (load_lane,
// store_lane).

#pragma once

#include "path_common.cuh"

namespace pool {

using path::float3v;
constexpr int kThreads = 256;

struct State {
  const float* origins;  // [P, 3]
  const float* directions;  // [P, 3]
  const float* throughput;  // [P, 3]
  const uint8_t* alive;  // [P]
  const int* lanes;  // [P]: the ray's lane in its frame
  const int* fids;  // [P]: its frame in the window
  const int* seeds;  // [P]: its frame's trace seed
  const int* bounces;  // [P]: its bounce depth
  int n_rays;
  const int* live_count;  // [1] on the device
};

struct Outputs {
  float* contribution;
  float* origins;
  float* directions;
  float* throughput;
  uint8_t* alive;
};

// The window's sphere rows in the wrappers' layout (four float4 per
// sphere), frame-major, and the scene parameters shared by every frame.
struct Spheres {
  const float4* rows;  // [n_frames * per_frame, 4]
  int per_frame;
  int n_frames;
  const float* params;  // [path::kParams]
};

// A sphere scene's bounce: no tables beyond the sphere rows.
struct SphereBounce {
  size_t bytes() const { return 0; }
  __device__ __forceinline__ void stage(float4*) {}
  template <typename Scene>
  __device__ __forceinline__ bool run(const Scene& scene, int sphere_first, int n_spheres, int,
                                      int64_t, uint32_t lane, int bounce, uint32_t counter_stride,
                                      uint32_t seed, float3v& o, float3v& d, float3v& thr,
                                      float3v& rad) const {
    return path::sphere_bounce(scene, sphere_first, n_spheres, lane, bounce, counter_stride,
                               seed, o, d, thr, rad);
  }
};

// A lane's state before the bounce; a ray past n_rays is zero and dead.
__device__ __forceinline__ void load_lane(const State& in, int64_t ray, float3v& o, float3v& d,
                                          float3v& thr, bool& is_alive) {
  o = {0.0f, 0.0f, 0.0f};
  d = o;
  thr = o;
  is_alive = false;
  if (ray < in.n_rays) {
    o = path::load3(in.origins, ray);
    d = path::load3(in.directions, ray);
    thr = path::load3(in.throughput, ray);
    is_alive = in.alive[ray] != 0;
  }
}

// A lane's five outputs.
__device__ __forceinline__ void store_lane(const Outputs& out, int64_t ray, float3v rad,
                                           float3v o, float3v d, float3v thr, bool is_alive) {
  path::store3(out.contribution, ray, rad);
  path::store3(out.origins, ray, o);
  path::store3(out.directions, ray, d);
  path::store3(out.throughput, ray, thr);
  out.alive[ray] = is_alive ? 1 : 0;
}

// The body of a pool kernel: `staging` is its dynamic shared memory and
// `scene_params` a __shared__ array of path::kParams floats.
template <typename Bounce>
__device__ __forceinline__ void bounce_lanes(const State& in, const Spheres& spheres,
                                             Bounce bounce, bool staged, int total_bounces,
                                             const Outputs& out, float4* staging,
                                             float* scene_params) {
  const int live = *in.live_count;
  const int64_t ray = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  float3v o, d, thr;
  bool is_alive;
  load_lane(in, ray, o, d, thr, is_alive);
  float3v rad = {0.0f, 0.0f, 0.0f};

  // Uniform per block: a block wholly past the live count stages nothing.
  if (static_cast<int64_t>(blockIdx.x) * blockDim.x < live) {
    const float4* rows = spheres.rows;
    if (staged) {
      const int n_rows = 4 * spheres.per_frame * spheres.n_frames;
      for (int i = threadIdx.x; i < n_rows; i += blockDim.x) staging[i] = spheres.rows[i];
      rows = staging;
      bounce.stage(staging + n_rows);
    }
    if (threadIdx.x < path::kParams) scene_params[threadIdx.x] = spheres.params[threadIdx.x];
    __syncthreads();
    if (is_alive && ray < live) {
      const int fid = in.fids[ray];
      const bool in_window = fid >= 0 && fid < spheres.n_frames;
      const path::SceneRows scene = {rows, scene_params};
      const uint32_t counter_stride = 2u * static_cast<uint32_t>(total_bounces) + 2u;
      is_alive = bounce.run(scene, in_window ? fid * spheres.per_frame : 0,
                            in_window ? spheres.per_frame : 0, in_window ? fid : -1, ray,
                            static_cast<uint32_t>(in.lanes[ray]), in.bounces[ray],
                            counter_stride, static_cast<uint32_t>(in.seeds[ray]), o, d, thr, rad);
    }
  }
  if (ray >= in.n_rays) return;
  store_lane(out, ray, rad, o, d, thr, is_alive);
}

// Launch `kernel` (a __global__ wrapper of bounce_lanes taking
// (State, Spheres, Bounce, bool staged, int total_bounces, Outputs)) on
// `stream` without synchronising; returns cudaGetLastError() so the caller
// sees a refused launch at once.
template <typename Kernel, typename Bounce>
inline int launch(Kernel kernel, const State& in, const Spheres& spheres, const Bounce& bounce,
                  int total_bounces, const Outputs& out, void* stream) {
  if (in.n_rays <= 0) return static_cast<int>(cudaSuccess);
  if (spheres.per_frame < 1 || spheres.n_frames < 1 || total_bounces < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t sphere_bytes = sizeof(float4) * 4 * static_cast<size_t>(spheres.per_frame) *
                              static_cast<size_t>(spheres.n_frames);
  size_t shared_bytes;
  bool staged;
  const cudaError_t status =
      path::staging_for(kernel, sphere_bytes + bounce.bytes(), &shared_bytes, &staged);
  if (status != cudaSuccess) return static_cast<int>(status);
  const int blocks = (in.n_rays + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, shared_bytes, static_cast<cudaStream_t>(stream)>>>(
      in, spheres, bounce, staged, total_bounces, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pool
