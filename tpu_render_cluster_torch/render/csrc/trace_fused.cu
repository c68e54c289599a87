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
// flops per sphere and the shadow test about 17, against 24 bytes of rays
// read and 12 bytes of radiance written per path, so device memory is
// never the limit (04_very-simple frame 1 at 512x512 x 8 spp: 0.1749 ms).
// What held the first design back (one thread a ray for all its bounces,
// a block of 256 rays, 0.808 ms alone on that frame): a warp ran while any
// of its 32 lanes lived, so it issued 3.26 nearest sweeps a ray where 2.38
// were needed (27% of its lane-slots on finished paths); every warp with a
// lit hit ran the separate shadow loop as long as its slowest lane; and
// each of the 8,192 blocks staged the scene again, in 12.4 waves. Design
// for this card, not the TPU's block layout (trace_fused.cuh):
//   - persistent blocks, as many as are resident at once, each staging the
//     spheres (at most 128, 64 bytes each) in shared memory once, where
//     every lane of a warp reads the same sphere at the same time (a
//     broadcast, no bank conflicts);
//   - path regeneration: a thread carries one path at a time, its state in
//     registers, and sweeps the spheres once an iteration; a path that
//     ends writes its radiance and the thread takes the next unstarted ray
//     from a work counter (one atomicAdd a warp for all its lanes that
//     need a ray), so every lane of a warp sweeps for a live path every
//     iteration, at whatever bounce it is;
//   - a hit's shadow test rides in the path's next sweep, which starts at
//     the same point: it shares the nearest test's c . o, |o - c|^2 - r^2
//     and shared-memory reads, and the separate shadow loop is gone; the
//     hit's sun term is added after that sweep, before anything else, in
//     the reference's order;
//   - a path that escaped ends there: the reference multiplies every later
//     contribution of a dead lane by alive = 0, and all those terms are
//     finite, so they add exactly zero; likewise the shadow test is made
//     only where the sun is above the surface (cos = 0 adds exactly zero).
// A ray's radiance depends only on its origin, direction, lane, the seed
// and the scene (the TPU kernel: "no sequential state, so any ray block
// computes identically regardless of grid position"), so it is the one
// thread-a-ray kernel's, bit for bit. Measured by chip_ab.py on an NVIDIA
// H100 80GB HBM3 at 700 W (PERF.md section 6), alone on 04 frame 1: 0.807
// ms for the first design, 0.665 with regeneration alone, 0.513 with the
// fused shadow test; 48 registers, 5 blocks of 256 an SM, 660 blocks.
//
// Parity with the reference (and with the plain PyTorch version in
// render/kernels.py) is kept deliberately: the quadratic uses the same
// expanded algebra (d.c - o.d, |o|^2 - 2 o.c + |c|^2), ties take the lowest
// sphere index, the checker parity uses `& 1` (floor-mod, also for negative
// sums), PCG wraps mod 2^32, and only IEEE-accurate math is used (no fast
// math). The bounce is built from path_common.cuh's functions, rounded as
// the reference's compiler rounds (shared with the per-bounce sphere
// kernel, sphere_bounce.cu); trace_fused.cuh splits path::sphere_bounce at
// its shadow test and fuses the test into the next sweep.

#include "trace_fused.cuh"

namespace {

__global__ void __launch_bounds__(trace_fused::kThreads)
trace_fused_kernel(const float* __restrict__ origins,
                   const float* __restrict__ directions, int n_rays,
                   const float4* __restrict__ spheres, int n_spheres,
                   const float* __restrict__ params, uint32_t seed,
                   int max_bounces, float* __restrict__ radiance_out,
                   int* __restrict__ next_ray) {
  __shared__ path::SceneShared scene;
  trace_fused::trace_rays<false>(scene, origins, directions, nullptr, n_rays, spheres, n_spheres,
                                 params, seed, max_bounces, radiance_out, next_ray);
}

}  // namespace

// Plain C entry for ctypes. Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() so the caller sees a refused launch at once.
// After the radiance, the work counter: one int32 in device memory that no
// other launch uses meanwhile (cleared here on `stream` before the kernel).
extern "C" int trace_fused_launch(const float* origins, const float* directions,
                                  int n_rays, const float* spheres, int n_spheres,
                                  const float* params, int seed, int max_bounces,
                                  float* radiance, int* work_counter, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaSuccess);
  if (!trace_fused::valid_launch(n_spheres, max_bounces)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return trace_fused::launch(trace_fused_kernel, n_rays, work_counter,
                             static_cast<cudaStream_t>(stream), origins, directions, n_rays,
                             reinterpret_cast<const float4*>(spheres), n_spheres, params,
                             static_cast<uint32_t>(seed), max_bounces, radiance);
}

// The kernel's blocks resident on one SM, with the grid of a launch over
// n_rays in *grid_blocks (a negative CUDA error code on failure).
extern "C" int trace_fused_occupancy(int n_rays, int* grid_blocks) {
  return trace_fused::occupancy(trace_fused_kernel, n_rays, grid_blocks);
}

extern "C" const char* trace_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
