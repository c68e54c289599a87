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
// math). Rounding follows the reference's compiler: every product that
// feeds one add is an explicit fmaf, dot products are fma chains, the
// division by pi is a multiplication by its float32 reciprocal, and cos
// and sin are correctly rounded through double. The library is built with
// --fmad=false, so nvcc contracts nothing else (render/fp32.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSpheres = 128;
constexpr int kThreads = 256;
constexpr float kEps = 1e-3f;
constexpr float kInf = 1e30f;
constexpr float kInvPi = 0.318309873f;  // float32(1 / float32(pi))
constexpr float kTwoPi = 6.28318548f;  // float32(2 pi)
constexpr float kOffset = 0.004f;  // EPS * 4: surface offset

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

// Sphere table, four float4 per sphere, built by the wrapper:
//   geo      = (cx, cy, cz, r^2)         r^2 = 0 marks a pad slot
//   aux      = (|c|^2, c.sun, radius, 0)
//   albedo   = (r, g, b, 0)
//   emission = (r, g, b, 0)
// params: sun_direction, sun_color, sky_horizon, sky_zenith,
//         plane_albedo_a, plane_albedo_b (3 floats each).
__global__ void __launch_bounds__(kThreads)
trace_fused_kernel(const float* __restrict__ origins,
                   const float* __restrict__ directions, int n_rays,
                   const float4* __restrict__ spheres, int n_spheres,
                   const float* __restrict__ params, uint32_t seed,
                   int max_bounces, float* __restrict__ radiance_out) {
  __shared__ float4 s_geo[kMaxSpheres];
  __shared__ float4 s_aux[kMaxSpheres];
  __shared__ float4 s_albedo[kMaxSpheres];
  __shared__ float4 s_emission[kMaxSpheres];
  __shared__ float s_params[18];
  for (int i = threadIdx.x; i < n_spheres; i += blockDim.x) {
    s_geo[i] = spheres[4 * i + 0];
    s_aux[i] = spheres[4 * i + 1];
    s_albedo[i] = spheres[4 * i + 2];
    s_emission[i] = spheres[4 * i + 3];
  }
  if (threadIdx.x < 18) s_params[threadIdx.x] = params[threadIdx.x];
  __syncthreads();

  const int64_t ray = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (ray >= n_rays) return;
  const uint32_t lane = static_cast<uint32_t>(ray);

  const float sun_x = s_params[0], sun_y = s_params[1], sun_z = s_params[2];
  const float sun_r = s_params[3], sun_g = s_params[4], sun_b = s_params[5];

  float ox = origins[3 * ray + 0], oy = origins[3 * ray + 1], oz = origins[3 * ray + 2];
  float dx = directions[3 * ray + 0], dy = directions[3 * ray + 1], dz = directions[3 * ray + 2];
  float thr_r = 1.0f, thr_g = 1.0f, thr_b = 1.0f;
  float rad_r = 0.0f, rad_g = 0.0f, rad_b = 0.0f;
  const uint32_t counter_stride = 2u * static_cast<uint32_t>(max_bounces) + 2u;

  for (int bounce = 0; bounce < max_bounces; ++bounce) {
    // -- nearest sphere hit ------------------------------------------------
    const float od = dot3(ox, oy, oz, dx, dy, dz);
    const float o_sq = dot3(ox, oy, oz, ox, oy, oz);
    float t_sphere = kInf;
    int idx = 0;
    for (int i = 0; i < n_spheres; ++i) {
      const float4 g = s_geo[i];
      const float csq = s_aux[i].x;
      const float dc = dot3(g.x, g.y, g.z, dx, dy, dz);
      const float oc = dot3(g.x, g.y, g.z, ox, oy, oz);
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

    // -- ground plane y = 0 --------------------------------------------------
    const float abs_dy = fabsf(dy);
    const float denom = abs_dy < 1e-8f ? 1e-8f : dy;
    float t_plane = -oy / denom;
    if (!(t_plane > kEps && abs_dy >= 1e-8f)) t_plane = kInf;
    const bool is_plane = t_plane < t_sphere;
    const float t = fminf(t_sphere, t_plane);

    // -- sky on escape: the path ends here -----------------------------------
    if (!(t < kInf)) {
      const float blend = fminf(fmaxf(dy, 0.0f), 1.0f);
      const float sun_cos_dir = dot3(dx, dy, dz, sun_x, sun_y, sun_z);
      const float disc_light = sun_cos_dir > 0.9995f ? 8.0f : 0.0f;
      const float sky_r = fmaf(1.0f - blend, s_params[6], blend * s_params[9]) + disc_light * sun_r;
      const float sky_g = fmaf(1.0f - blend, s_params[7], blend * s_params[10]) + disc_light * sun_g;
      const float sky_b = fmaf(1.0f - blend, s_params[8], blend * s_params[11]) + disc_light * sun_b;
      rad_r = rad_r + thr_r * sky_r;
      rad_g = rad_g + thr_g * sky_g;
      rad_b = rad_b + thr_b * sky_b;
      break;
    }

    const float px = fmaf(dx, t, ox), py = fmaf(dy, t, oy), pz = fmaf(dz, t, oz);
    float nx, ny, nz, alb_r, alb_g, alb_b;
    if (is_plane) {
      nx = 0.0f;
      ny = 1.0f;
      nz = 0.0f;
      const uint32_t cell = static_cast<uint32_t>(__float2int_rd(px)) +
                            static_cast<uint32_t>(__float2int_rd(pz));
      const int base = (cell & 1u) == 0u ? 12 : 15;
      alb_r = s_params[base];
      alb_g = s_params[base + 1];
      alb_b = s_params[base + 2];
    } else {
      const float4 g = s_geo[idx];
      const float radius = fmaxf(s_aux[idx].z, 1e-6f);
      nx = (px - g.x) / radius;
      ny = (py - g.y) / radius;
      nz = (pz - g.z) / radius;
      const float4 albedo = s_albedo[idx];
      const float4 emission = s_emission[idx];
      alb_r = albedo.x;
      alb_g = albedo.y;
      alb_b = albedo.z;
      rad_r = rad_r + thr_r * emission.x;
      rad_g = rad_g + thr_g * emission.y;
      rad_b = rad_b + thr_b * emission.z;
    }

    // -- sun NEE: one any-hit shadow ray toward the (uniform) sun ----------
    const float sx = fmaf(nx, kOffset, px), sy = fmaf(ny, kOffset, py), sz = fmaf(nz, kOffset, pz);
    const float cos_sun = fmaxf(dot3(nx, ny, nz, sun_x, sun_y, sun_z), 0.0f);
    if (cos_sun > 0.0f) {
      const float od_s = dot3(sx, sy, sz, sun_x, sun_y, sun_z);
      const float osq_s = dot3(sx, sy, sz, sx, sy, sz);
      bool shadowed = false;
      for (int i = 0; i < n_spheres; ++i) {
        const float4 g = s_geo[i];
        const float4 aux = s_aux[i];
        const float oc_s = dot3(g.x, g.y, g.z, sx, sy, sz);
        const float ocd_s = aux.y - od_s;
        const float ocsq_s = osq_s - 2.0f * oc_s + aux.x;
        const float disc_s = fmaf(ocd_s, ocd_s, -(ocsq_s - g.w));
        if (disc_s > 0.0f && g.w > 0.0f && ocd_s + sqrtf(disc_s) > kEps) {
          shadowed = true;
          break;
        }
      }
      if (!shadowed) {
        rad_r = fmaf(thr_r, alb_r * sun_r * cos_sun * kInvPi, rad_r);
        rad_g = fmaf(thr_g, alb_g * sun_g * cos_sun * kInvPi, rad_g);
        rad_b = fmaf(thr_b, alb_b * sun_b * cos_sun * kInvPi, rad_b);
      }
    }

    // -- continue the path: cosine-weighted resample --------------------------
    thr_r = thr_r * alb_r;
    thr_g = thr_g * alb_g;
    thr_b = thr_b * alb_b;
    const uint32_t counter = lane * counter_stride + 2u * static_cast<uint32_t>(bounce);
    const float u1 = uniform_from_hash(pcg_hash(counter ^ seed));
    const float u2 = uniform_from_hash(pcg_hash((counter + 1u) ^ seed));
    const float r = sqrtf(u1);
    const float phi = kTwoPi * u2;
    const float lx = r * static_cast<float>(cos(static_cast<double>(phi)));
    const float ly = r * static_cast<float>(sin(static_cast<double>(phi)));
    const float lz = sqrtf(fmaxf(0.0f, 1.0f - u1));
    const float hx = fabsf(nx) > 0.9f ? 0.0f : 1.0f;
    const float hy = 1.0f - hx;
    float tx = hy * nz;
    float ty = -hx * nz;
    float tz = hx * ny - hy * nx;
    const float t_len = fmaxf(sqrtf(dot3(tx, ty, tz, tx, ty, tz)), 1e-8f);
    tx = tx / t_len;
    ty = ty / t_len;
    tz = tz / t_len;
    const float bx = fmaf(ny, tz, -(nz * ty));
    const float by = fmaf(nz, tx, -(nx * tz));
    const float bz = fmaf(nx, ty, -(ny * tx));
    dx = fmaf(lz, nx, fmaf(lx, tx, ly * bx));
    dy = fmaf(lz, ny, fmaf(lx, ty, ly * by));
    dz = fmaf(lz, nz, fmaf(lx, tz, ly * bz));
    ox = sx;
    oy = sy;
    oz = sz;
  }

  radiance_out[3 * ray + 0] = rad_r;
  radiance_out[3 * ray + 1] = rad_g;
  radiance_out[3 * ray + 2] = rad_b;
}

}  // namespace

// Plain C entry for ctypes. Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() so the caller sees a refused launch at once.
extern "C" int trace_fused_launch(const float* origins, const float* directions,
                                  int n_rays, const float* spheres, int n_spheres,
                                  const float* params, int seed, int max_bounces,
                                  float* radiance, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaSuccess);
  if (n_spheres < 1 || n_spheres > kMaxSpheres || max_bounces < 0) {
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
