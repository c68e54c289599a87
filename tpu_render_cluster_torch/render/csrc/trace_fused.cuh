// The body of the sphere path-trace megakernel, shared by its two modes:
// trace_fused.cu (the RNG counter of ray i is i) and trace_fused_lanes.cu
// (the TPU kernel's lane_io mode: the counter of ray i is lanes[i], so a
// launch over one tile's rays, each with its lane in the whole frame, draws
// the whole frame's random numbers for those rays).
//
// Persistent blocks that regenerate paths: as many blocks as are resident
// at once (fewer for a narrow launch), each staging the spheres in shared
// memory once. A thread carries one path at a time and runs one sweep of
// the spheres for it an iteration; when the path ends (it escaped, or
// reached max_bounces with its last sun term settled) the thread writes
// that ray's radiance and takes the next unstarted ray. The lanes of a
// warp that need a ray take it together, with one atomicAdd a warp on a
// work counter in global memory (a scratch int of the caller's, cleared on
// the launch's stream before the kernel), lane k of them the k-th ray of
// the take, so neighbouring lanes load neighbouring rays. Every lane of a
// warp then sweeps for a live path every iteration, whatever bounce each
// is at, until the counter runs out.
//
// The sweep fuses a hit's shadow test into the path's next nearest test:
// the shadow ray starts at the offset hit point, where path::sphere_bounce
// starts the next ray, so both tests share c . o, |o - c|^2 - r^2 and the
// reads of each sphere; the hit's sun term waits in the path's state
// (Path::sun_thr, sun_term) and is added after that sweep, before the next
// bounce adds anything, so the sums run in the reference's order. A ray's
// arithmetic depends only on its origin, direction, lane, the seed and the
// scene, so the thread that traces it, and when, changes no bit of its
// radiance: it is path::sphere_bounce's loop, bit for bit.
//
// kLaneIO is a compile-time switch: the positional instantiation reads no
// lane row.

#pragma once

#include "mesh_common.cuh"

namespace trace_fused {

constexpr int kThreads = 256;
constexpr unsigned kWarp = 0xffffffffu;

// One sweep over the spheres from o: the nearest hit along d (t, kInf on
// a miss, and the lowest index among ties; path::nearest_sphere's
// arithmetic) and, with kShadows where `shadow`, whether a sphere occludes
// the sun from o (path::sphere_shadowed's). The shadow ray of a hit starts
// where the path's next ray does (path::sphere_bounce sets o to it), so
// the two tests share c . o, |o - c|^2 - r^2 and the reads of the sphere.
// A warp sweeps with kShadows where any of its lanes has a sun term
// pending; each lane then computes the shadow test's two terms of every
// sphere, and branches only for an occluder candidate.
template <bool kShadows>
__device__ __forceinline__ float sweep(const path::SceneShared& s, int count, path::float3v o,
                                       path::float3v d, bool shadow, int* idx_out,
                                       bool* shadowed_out) {
  using path::dot3;
  const float* p = s.params;
  const float od = dot3(o.x, o.y, o.z, d.x, d.y, d.z);
  const float o_sq = dot3(o.x, o.y, o.z, o.x, o.y, o.z);
  const float od_s = dot3(o.x, o.y, o.z, p[0], p[1], p[2]);
  float t_sphere = path::kInf;
  int idx = 0;
  bool shadowed = false;
  for (int i = 0; i < count; ++i) {
    const float4 g = s.geo[i];
    const float4 aux = s.aux[i];
    const float dc = dot3(g.x, g.y, g.z, d.x, d.y, d.z);
    const float oc = dot3(g.x, g.y, g.z, o.x, o.y, o.z);
    const float oc_dot_d = dc - od;
    const float oc_sq = o_sq - 2.0f * oc + aux.x;
    const float disc = fmaf(oc_dot_d, oc_dot_d, -(oc_sq - g.w));
    if (disc > 0.0f && g.w > 0.0f) {
      const float root = sqrtf(disc);
      const float t0 = oc_dot_d - root;
      const float t1 = oc_dot_d + root;
      const float t = t0 > path::kEps ? t0 : (t1 > path::kEps ? t1 : path::kInf);
      if (t < t_sphere) {  // strict: a tie keeps the lowest index
        t_sphere = t;
        idx = i;
      }
    }
    if (kShadows) {
      const float ocd_s = aux.y - od_s;
      const float disc_s = fmaf(ocd_s, ocd_s, -(oc_sq - g.w));
      if (shadow && !shadowed && disc_s > 0.0f && g.w > 0.0f) {
        shadowed = ocd_s + sqrtf(disc_s) > path::kEps;
      }
    }
  }
  *idx_out = idx;
  *shadowed_out = shadowed;
  return t_sphere;
}

// The state of the path a thread carries.
struct Path {
  int ray;  // -1: none
  uint32_t lane;
  int bounce;  // bounces begun
  path::float3v o, d, thr, rad;
  // A hit's sun term, added in the next sweep where no sphere occludes the
  // sun: rad += sun_thr * sun_term (path::add_direct's fma, its operands).
  bool sun_pending;
  path::float3v sun_thr, sun_term;
};

// path::sphere_bounce after its nearest sphere hit (t_sphere, idx), up to
// the shadow test: the escape's sky, or the hit's emission, its sun term
// left pending where the sun is above the surface, and the resample.
// Returns false when the path escaped.
__device__ __forceinline__ bool shade(const path::SceneShared& s, float t_sphere, int idx,
                                      uint32_t counter_stride, uint32_t seed, Path& q) {
  using namespace path;
  const float* sun = s.params;
  const float t_plane = plane_hit(q.o, q.d);
  const bool is_plane = t_plane < t_sphere;
  const float t = fminf(t_sphere, t_plane);
  if (!(t < kInf)) {
    add_sky(s, q.d, q.thr, &q.rad);
    return false;
  }
  const float3v p = {fmaf(q.d.x, t, q.o.x), fmaf(q.d.y, t, q.o.y), fmaf(q.d.z, t, q.o.z)};
  float3v normal, albedo;
  if (is_plane) {
    normal = {0.0f, 1.0f, 0.0f};
    albedo = plane_albedo(s, p);
  } else {
    shade_sphere(s, idx, p, q.thr, &q.rad, &normal, &albedo);
  }
  const float3v so = {fmaf(normal.x, kOffset, p.x), fmaf(normal.y, kOffset, p.y),
                      fmaf(normal.z, kOffset, p.z)};
  const float cos_sun = fmaxf(dot3(normal.x, normal.y, normal.z, sun[0], sun[1], sun[2]), 0.0f);
  q.sun_pending = cos_sun > 0.0f;
  if (q.sun_pending) {
    q.sun_thr = q.thr;
    q.sun_term = {albedo.x * sun[3] * cos_sun * kInvPi, albedo.y * sun[4] * cos_sun * kInvPi,
                  albedo.z * sun[5] * cos_sun * kInvPi};
  }
  q.thr = {q.thr.x * albedo.x, q.thr.y * albedo.y, q.thr.z * albedo.z};
  q.d = resample(normal, q.lane, q.bounce, counter_stride, seed);
  q.o = so;
  return true;
}

template <bool kLaneIO>
__device__ __forceinline__ void trace_rays(path::SceneShared& scene,
                                           const float* __restrict__ origins,
                                           const float* __restrict__ directions,
                                           const int* __restrict__ lanes, int n_rays,
                                           const float4* __restrict__ spheres, int n_spheres,
                                           const float* __restrict__ params, uint32_t seed,
                                           int max_bounces, float* __restrict__ radiance_out,
                                           int* __restrict__ next_ray) {
  path::load_scene(scene, spheres, n_spheres, params);

  const uint32_t counter_stride = 2u * static_cast<uint32_t>(max_bounces) + 2u;
  const unsigned below = (1u << (threadIdx.x & 31u)) - 1u;  // the lanes under this one
  Path q;
  q.ray = -1;
  bool more = true;  // uniform per warp: the counter may hold unstarted rays
  for (;;) {
    const unsigned idle = __ballot_sync(kWarp, q.ray < 0);
    if (more && idle != 0u) {
      const int leader = __ffs(idle) - 1;
      const int wanted = __popc(idle);
      int first = 0;
      if (static_cast<int>(threadIdx.x & 31u) == leader) first = atomicAdd(next_ray, wanted);
      first = __shfl_sync(kWarp, first, leader);
      more = first + wanted < n_rays;
      if (q.ray < 0 && first + __popc(idle & below) < n_rays) {
        q.ray = first + __popc(idle & below);
        q.lane = kLaneIO ? static_cast<uint32_t>(lanes[q.ray]) : static_cast<uint32_t>(q.ray);
        q.o = path::load3(origins, q.ray);
        q.d = path::load3(directions, q.ray);
        q.thr = {1.0f, 1.0f, 1.0f};
        q.rad = {0.0f, 0.0f, 0.0f};
        q.bounce = 0;
        q.sun_pending = false;
      }
    }
    if (__ballot_sync(kWarp, q.ray >= 0) == 0u) break;  // uniform: the warp is done
    const bool shadows = __any_sync(kWarp, q.ray >= 0 && q.sun_pending);
    if (q.ray >= 0) {
      int idx;
      bool shadowed;
      const float t_sphere =
          shadows ? sweep<true>(scene, n_spheres, q.o, q.d, q.sun_pending, &idx, &shadowed)
                  : sweep<false>(scene, n_spheres, q.o, q.d, false, &idx, &shadowed);
      if (q.sun_pending && !shadowed) {
        q.rad = {fmaf(q.sun_thr.x, q.sun_term.x, q.rad.x),
                 fmaf(q.sun_thr.y, q.sun_term.y, q.rad.y),
                 fmaf(q.sun_thr.z, q.sun_term.z, q.rad.z)};
      }
      q.sun_pending = false;
      // The path ends where it escapes, or at max_bounces once its last
      // hit's sun term is settled (at 0 before any bounce).
      bool ended = q.bounce == max_bounces;
      if (!ended) {
        ended = !shade(scene, t_sphere, idx, counter_stride, seed, q);
        ended = ended || (++q.bounce == max_bounces && !q.sun_pending);
      }
      if (ended) {
        path::store3(radiance_out, q.ray, q.rad);
        q.ray = -1;
      }
    }
  }
}

// The launch's argument check, shared by both C entries.
inline bool valid_launch(int n_spheres, int max_bounces) {
  return n_spheres >= 1 && n_spheres <= path::kMaxSpheres && max_bounces >= 0;
}

// The persistent grid of `kernel` over n_rays: as many blocks as are
// resident at once, and no more than the rays fill.
template <typename Kernel>
inline cudaError_t grid_for(Kernel kernel, int n_rays, int* blocks) {
  int resident = 0;
  const cudaError_t status = mesh::card_blocks(kernel, kThreads, 0, &resident);
  if (status != cudaSuccess) return status;
  const int64_t needed = (static_cast<int64_t>(n_rays) + kThreads - 1) / kThreads;
  *blocks = needed < resident ? static_cast<int>(needed) : resident;
  return cudaSuccess;
}

// Clears the work counter on `stream` and launches `kernel` over n_rays
// with its persistent grid.
template <typename Kernel, typename... Args>
inline int launch(Kernel kernel, int n_rays, int* work_counter, cudaStream_t stream,
                  Args... args) {
  int blocks = 0;
  cudaError_t status = grid_for(kernel, n_rays, &blocks);
  if (status != cudaSuccess) return static_cast<int>(status);
  // The counter passes n_rays by at most 32 a warp: a warp takes no more
  // once a take reaches it.
  if (n_rays > INT32_MAX - blocks * kThreads) return static_cast<int>(cudaErrorInvalidValue);
  status = cudaMemsetAsync(work_counter, 0, sizeof(int), stream);
  if (status != cudaSuccess) return static_cast<int>(status);
  kernel<<<blocks, kThreads, 0, stream>>>(args..., work_counter);
  return static_cast<int>(cudaGetLastError());
}

// The blocks of `kernel` resident on one SM, with the grid of a launch over
// n_rays in *grid_blocks (a negative CUDA error code on failure).
template <typename Kernel>
inline int occupancy(Kernel kernel, int n_rays, int* grid_blocks) {
  int blocks = 0;
  cudaError_t status = mesh::blocks_per_sm(kernel, kThreads, 0, &blocks);
  if (status == cudaSuccess) status = grid_for(kernel, n_rays, grid_blocks);
  return status == cudaSuccess ? blocks : -static_cast<int>(status);
}

}  // namespace trace_fused
