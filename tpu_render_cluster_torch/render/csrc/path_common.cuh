// Per-path device code shared by the path-trace kernels (the megakernels
// trace_fused.cu and trace_fused_mesh.cu, the per-bounce kernels
// sphere_bounce.cu and mesh_bounce.cu, the ray-pool kernels
// pool_sphere_bounce.cu and pool_mesh_bounce.cu, the unit kernels of the
// bounce scan intersect_spheres.cu, occluded_spheres.cu,
// intersect_instances.cu and occluded_instances.cu): the sphere tables, the
// staging rule for tables in shared memory,
// nearest sphere and ground-plane hits, the sky, the sphere shadow any-hit,
// the emission/albedo shading of a sphere or plane hit, the counter-PCG
// cosine resample, and the whole sphere-scene bounce built from them. One
// thread owns one path; every function works on that thread's registers
// and a sphere table (SceneShared or SceneRows), of which it sweeps the
// range [first, first + count): the whole table for one frame's scene, the
// lane's own frame's rows of a ray pool's stacked multi-frame table.
//
// Rounding follows the reference's compiler (XLA on the CPU): every product
// that feeds one add is an explicit fmaf, dot products are fma chains, the
// division by pi is a multiplication by its float32 reciprocal, and cos and
// sin are correctly rounded through double. Libraries that include this
// header are built with --fmad=false, so nvcc contracts nothing else
// (render/fp32.py).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace path {

constexpr int kMaxSpheres = 128;
constexpr float kEps = 1e-3f;
constexpr float kInf = 1e30f;
constexpr float kInvPi = 0.318309873f;  // float32(1 / float32(pi))
constexpr float kTwoPi = 6.28318548f;  // float32(2 pi)
constexpr float kOffset = 0.004f;  // EPS * 4: surface offset
constexpr int kParams = 18;
// Stage a kernel's tables in dynamic shared memory up to this many bytes
// (above the default 48 KB the launcher raises the kernel's limit).
constexpr int kMaxStagedBytes = 96 * 1024;

__device__ __forceinline__ uint32_t pcg_hash(uint32_t x) {
  const uint32_t state = x * 747796405u + 2891336453u;
  const uint32_t shift = (state >> 28) + 4u;
  const uint32_t word = ((state >> shift) ^ state) * 277803737u;
  return (word >> 22) ^ word;
}

// a . b as the reference sums it: fma(a2, b2, fma(a1, b1, a0 * b0)).
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0,
                                      float b1, float b2) {
  return fmaf(a2, b2, fmaf(a1, b1, a0 * b0));
}

__device__ __forceinline__ float uniform_from_hash(uint32_t h) {
  return static_cast<float>(static_cast<int>(h >> 8)) * (1.0f / 16777216.0f);
}

struct float3v {
  float x, y, z;
};

// The sphere table in shared memory, four float4 per sphere, as the
// wrappers build it:
//   geo      = (cx, cy, cz, r^2)         r^2 = 0 marks a pad slot
//   aux      = (|c|^2, c.sun, radius, 0)
//   albedo   = (r, g, b, 0)
//   emission = (r, g, b, 0)
// params: sun_direction, sun_color, sky_horizon, sky_zenith,
//         plane_albedo_a, plane_albedo_b (3 floats each).
struct SceneShared {
  float4 geo[kMaxSpheres];
  float4 aux[kMaxSpheres];
  float4 albedo[kMaxSpheres];
  float4 emission[kMaxSpheres];
  float params[kParams];
  __device__ __forceinline__ float4 geo_at(int i) const { return geo[i]; }
  __device__ __forceinline__ float4 aux_at(int i) const { return aux[i]; }
  __device__ __forceinline__ float4 albedo_at(int i) const { return albedo[i]; }
  __device__ __forceinline__ float4 emission_at(int i) const { return emission[i]; }
};

// A stacked table of any length in the wrappers' layout (four float4 per
// sphere, in the order above), in shared or global memory, with the same
// accessors as SceneShared.
struct SceneRows {
  const float4* rows;  // [n, 4]
  const float* params;  // [kParams]
  __device__ __forceinline__ float4 geo_at(int i) const { return rows[4 * i + 0]; }
  __device__ __forceinline__ float4 aux_at(int i) const { return rows[4 * i + 1]; }
  __device__ __forceinline__ float4 albedo_at(int i) const { return rows[4 * i + 2]; }
  __device__ __forceinline__ float4 emission_at(int i) const { return rows[4 * i + 3]; }
};

// Every thread of the block takes part; ends with __syncthreads().
__device__ __forceinline__ void load_scene(SceneShared& s, const float4* spheres,
                                           int n_spheres, const float* params) {
  for (int i = threadIdx.x; i < n_spheres; i += blockDim.x) {
    s.geo[i] = spheres[4 * i + 0];
    s.aux[i] = spheres[4 * i + 1];
    s.albedo[i] = spheres[4 * i + 2];
    s.emission[i] = spheres[4 * i + 3];
  }
  if (threadIdx.x < kParams) s.params[threadIdx.x] = params[threadIdx.x];
  __syncthreads();
}

// Nearest hit among spheres [first, first + count): t (kInf on a miss) and
// the lowest index among ties.
template <typename Scene>
__device__ __forceinline__ float nearest_sphere(const Scene& s, int first, int count,
                                               float3v o, float3v d, int* idx_out) {
  const float od = dot3(o.x, o.y, o.z, d.x, d.y, d.z);
  const float o_sq = dot3(o.x, o.y, o.z, o.x, o.y, o.z);
  float t_sphere = kInf;
  int idx = first;
  for (int i = first; i < first + count; ++i) {
    const float4 g = s.geo_at(i);
    const float csq = s.aux_at(i).x;
    const float dc = dot3(g.x, g.y, g.z, d.x, d.y, d.z);
    const float oc = dot3(g.x, g.y, g.z, o.x, o.y, o.z);
    const float oc_dot_d = dc - od;
    const float oc_sq = o_sq - 2.0f * oc + csq;
    const float disc = fmaf(oc_dot_d, oc_dot_d, -(oc_sq - g.w));
    if (disc > 0.0f && g.w > 0.0f) {
      const float root = sqrtf(disc);
      const float t0 = oc_dot_d - root;
      const float t1 = oc_dot_d + root;
      const float t = t0 > kEps ? t0 : (t1 > kEps ? t1 : kInf);
      if (t < t_sphere) {  // strict: a tie keeps the lowest index
        t_sphere = t;
        idx = i;
      }
    }
  }
  *idx_out = idx;
  return t_sphere;
}

// Ground plane y = 0: t, or kInf on a miss.
__device__ __forceinline__ float plane_hit(float3v o, float3v d) {
  const float abs_dy = fabsf(d.y);
  const float denom = abs_dy < 1e-8f ? 1e-8f : d.y;
  const float t_plane = -o.y / denom;
  return (t_plane > kEps && abs_dy >= 1e-8f) ? t_plane : kInf;
}

// Sky gradient plus sun disc seen along d, weighted by the throughput.
template <typename Scene>
__device__ __forceinline__ void add_sky(const Scene& s, float3v d, float3v thr,
                                        float3v* rad) {
  const float* p = s.params;
  const float blend = fminf(fmaxf(d.y, 0.0f), 1.0f);
  const float sun_cos_dir = dot3(d.x, d.y, d.z, p[0], p[1], p[2]);
  const float disc_light = sun_cos_dir > 0.9995f ? 8.0f : 0.0f;
  const float sky_r = fmaf(1.0f - blend, p[6], blend * p[9]) + disc_light * p[3];
  const float sky_g = fmaf(1.0f - blend, p[7], blend * p[10]) + disc_light * p[4];
  const float sky_b = fmaf(1.0f - blend, p[8], blend * p[11]) + disc_light * p[5];
  rad->x = rad->x + thr.x * sky_r;
  rad->y = rad->y + thr.y * sky_g;
  rad->z = rad->z + thr.z * sky_b;
}

// Checker albedo of the plane at p; normal (0, 1, 0).
template <typename Scene>
__device__ __forceinline__ float3v plane_albedo(const Scene& s, float3v p) {
  const uint32_t cell = static_cast<uint32_t>(__float2int_rd(p.x)) +
                        static_cast<uint32_t>(__float2int_rd(p.z));
  const int base = (cell & 1u) == 0u ? 12 : 15;
  return {s.params[base], s.params[base + 1], s.params[base + 2]};
}

// Sphere idx hit at p: its normal and albedo; adds its emission.
template <typename Scene>
__device__ __forceinline__ void shade_sphere(const Scene& s, int idx, float3v p,
                                             float3v thr, float3v* rad, float3v* normal,
                                             float3v* albedo) {
  const float4 g = s.geo_at(idx);
  const float radius = fmaxf(s.aux_at(idx).z, 1e-6f);
  *normal = {(p.x - g.x) / radius, (p.y - g.y) / radius, (p.z - g.z) / radius};
  const float4 a = s.albedo_at(idx);
  const float4 e = s.emission_at(idx);
  *albedo = {a.x, a.y, a.z};
  rad->x = rad->x + thr.x * e.x;
  rad->y = rad->y + thr.y * e.y;
  rad->z = rad->z + thr.z * e.z;
}

// Any sphere of [first, first + count) between the shadow origin and the
// (uniform) sun? Stops at the first occluder.
template <typename Scene>
__device__ __forceinline__ bool sphere_shadowed(const Scene& s, int first, int count,
                                                float3v so) {
  const float* p = s.params;
  const float od_s = dot3(so.x, so.y, so.z, p[0], p[1], p[2]);
  const float osq_s = dot3(so.x, so.y, so.z, so.x, so.y, so.z);
  for (int i = first; i < first + count; ++i) {
    const float4 g = s.geo_at(i);
    const float4 aux = s.aux_at(i);
    const float oc_s = dot3(g.x, g.y, g.z, so.x, so.y, so.z);
    const float ocd_s = aux.y - od_s;
    const float ocsq_s = osq_s - 2.0f * oc_s + aux.x;
    const float disc_s = fmaf(ocd_s, ocd_s, -(ocsq_s - g.w));
    if (disc_s > 0.0f && g.w > 0.0f && ocd_s + sqrtf(disc_s) > kEps) return true;
  }
  return false;
}

// Any sphere of [first, first + count) ahead of o along d (its far root
// past kEps)? The shadow test of sphere_shadowed along any direction, with
// c . d computed per sphere; stops at the first such sphere.
template <typename Scene>
__device__ __forceinline__ bool sphere_any_hit(const Scene& s, int first, int count, float3v o,
                                               float3v d) {
  const float od = dot3(o.x, o.y, o.z, d.x, d.y, d.z);
  const float o_sq = dot3(o.x, o.y, o.z, o.x, o.y, o.z);
  for (int i = first; i < first + count; ++i) {
    const float4 g = s.geo_at(i);
    const float dc = dot3(g.x, g.y, g.z, d.x, d.y, d.z);
    const float oc = dot3(g.x, g.y, g.z, o.x, o.y, o.z);
    const float oc_dot_d = dc - od;
    const float oc_sq = o_sq - 2.0f * oc + s.aux_at(i).x;
    const float disc = fmaf(oc_dot_d, oc_dot_d, -(oc_sq - g.w));
    if (disc > 0.0f && g.w > 0.0f && oc_dot_d + sqrtf(disc) > kEps) return true;
  }
  return false;
}

// The sun's direct term at an unshadowed hit.
template <typename Scene>
__device__ __forceinline__ void add_direct(const Scene& s, float3v albedo,
                                           float cos_sun, float3v thr, float3v* rad) {
  const float* p = s.params;
  rad->x = fmaf(thr.x, albedo.x * p[3] * cos_sun * kInvPi, rad->x);
  rad->y = fmaf(thr.y, albedo.y * p[4] * cos_sun * kInvPi, rad->y);
  rad->z = fmaf(thr.z, albedo.z * p[5] * cos_sun * kInvPi, rad->z);
}

// Cosine-weighted direction about the normal from the counter PCG stream
// of (lane, bounce, seed): the ray's own lane, depth and frame seed, which
// a ray pool carries per lane.
__device__ __forceinline__ float3v resample(float3v n, uint32_t lane, int bounce,
                                            uint32_t counter_stride, uint32_t seed) {
  const uint32_t counter = lane * counter_stride + 2u * static_cast<uint32_t>(bounce);
  const float u1 = uniform_from_hash(pcg_hash(counter ^ seed));
  const float u2 = uniform_from_hash(pcg_hash((counter + 1u) ^ seed));
  const float r = sqrtf(u1);
  const float phi = kTwoPi * u2;
  const float lx = r * static_cast<float>(cos(static_cast<double>(phi)));
  const float ly = r * static_cast<float>(sin(static_cast<double>(phi)));
  const float lz = sqrtf(fmaxf(0.0f, 1.0f - u1));
  const float hx = fabsf(n.x) > 0.9f ? 0.0f : 1.0f;
  const float hy = 1.0f - hx;
  float tx = hy * n.z;
  float ty = -hx * n.z;
  float tz = hx * n.y - hy * n.x;
  const float t_len = fmaxf(sqrtf(dot3(tx, ty, tz, tx, ty, tz)), 1e-8f);
  tx = tx / t_len;
  ty = ty / t_len;
  tz = tz / t_len;
  const float bx = fmaf(n.y, tz, -(n.z * ty));
  const float by = fmaf(n.z, tx, -(n.x * tz));
  const float bz = fmaf(n.x, ty, -(n.y * tx));
  return {fmaf(lz, n.x, fmaf(lx, tx, ly * bx)), fmaf(lz, n.y, fmaf(lx, ty, ly * by)),
          fmaf(lz, n.z, fmaf(lx, tz, ly * bz))};
}

// One bounce of a sphere-scene path, in the reference's order: nearest
// sphere and ground-plane hit, sky plus sun disc on escape, emission,
// checker albedo, sun NEE (any-hit against the spheres), cosine resample.
// Adds this bounce's radiance into rad and advances o, d and thr. Returns
// false when the path escaped: o, d and thr are then left as they were,
// which is what the reference's masked update leaves in a lane that dies.
// The path sees spheres [first, first + n_spheres); `lane` is the ray's
// original lane (its RNG counter).
template <typename Scene>
__device__ __forceinline__ bool sphere_bounce(const Scene& s, int first, int n_spheres,
                                              uint32_t lane, int bounce, uint32_t counter_stride,
                                              uint32_t seed, float3v& o, float3v& d,
                                              float3v& thr, float3v& rad) {
  const float* sun = s.params;
  int idx;
  const float t_sphere = nearest_sphere(s, first, n_spheres, o, d, &idx);
  const float t_plane = plane_hit(o, d);
  const bool is_plane = t_plane < t_sphere;
  const float t = fminf(t_sphere, t_plane);

  if (!(t < kInf)) {
    add_sky(s, d, thr, &rad);
    return false;
  }

  const float3v p = {fmaf(d.x, t, o.x), fmaf(d.y, t, o.y), fmaf(d.z, t, o.z)};
  float3v normal, albedo;
  if (is_plane) {
    normal = {0.0f, 1.0f, 0.0f};
    albedo = plane_albedo(s, p);
  } else {
    shade_sphere(s, idx, p, thr, &rad, &normal, &albedo);
  }

  const float3v so = {fmaf(normal.x, kOffset, p.x), fmaf(normal.y, kOffset, p.y),
                      fmaf(normal.z, kOffset, p.z)};
  const float cos_sun = fmaxf(dot3(normal.x, normal.y, normal.z, sun[0], sun[1], sun[2]), 0.0f);
  if (cos_sun > 0.0f && !sphere_shadowed(s, first, n_spheres, so)) {
    add_direct(s, albedo, cos_sun, thr, &rad);
  }

  thr = {thr.x * albedo.x, thr.y * albedo.y, thr.z * albedo.z};
  d = resample(normal, lane, bounce, counter_stride, seed);
  o = so;
  return true;
}

__device__ __forceinline__ float3v load3(const float* rows, int64_t i) {
  return {rows[3 * i + 0], rows[3 * i + 1], rows[3 * i + 2]};
}

__device__ __forceinline__ void store3(float* rows, int64_t i, float3v v) {
  rows[3 * i + 0] = v.x;
  rows[3 * i + 1] = v.y;
  rows[3 * i + 2] = v.z;
}

// Lets a launch of `kernel` take `bytes` of dynamic shared memory: where
// they and its static shared memory pass the default 48 KB a block, raises
// the kernel's limit to `limit` (at least `bytes`).
template <typename Kernel>
inline cudaError_t allow_shared(Kernel kernel, size_t bytes, size_t limit = 0) {
  cudaFuncAttributes attributes;
  const cudaError_t status = cudaFuncGetAttributes(&attributes, kernel);
  if (status != cudaSuccess) return status;
  if (attributes.sharedSizeBytes + bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(limit > bytes ? limit : bytes));
}

// The dynamic shared memory a launch of `kernel` takes to stage `bytes` of
// tables: all of them when they fit in kMaxStagedBytes (then *staged is
// true), else none, the tables then read from global memory; the kernel's
// limit raised where needed (allow_shared).
template <typename Kernel>
inline cudaError_t staging_for(Kernel kernel, size_t bytes, size_t* shared_bytes, bool* staged) {
  *staged = bytes <= static_cast<size_t>(kMaxStagedBytes);
  *shared_bytes = *staged ? bytes : 0;
  return allow_shared(kernel, *shared_bytes);
}

}  // namespace path
