// Kernel K3s: the staged volume tracer of independent rays, one thread per
// ray.
//
// Replaces the Pallas TPU kernel raytrace_tpu/ops/trace_vol_pallas.py
// `_make_vol_kernel` (:254-429) as `trace_rays_vol` (:799-1200) runs it,
// together with the XLA work around it: the rounds of a kernel pass (at
// most `cap` coarse steps, two per test of the step counter) and one
// in-brick voxel march `resolve_mixed` (:437-579) of every parked ray, over
// up to `rounds` rounds (the plain round loop, :924-1006).  Its plain
// PyTorch version is `march_rays_vol_plain` in ops/trace_vol.py; the two
// run the same float32 operations in the same order (built with
// --fmad=false, so no multiply-add is contracted), and every ray's outputs
// are the same bits.  The march code is K3's (vol_march.cuh).  The TPU's
// (rows, 128) tiles, padding rays, lane-shuffle lookups, the round loop's
// early exit and the straggler cascade have no counterpart: a thread
// simply stops when its ray is done.
//
// A ray: up to `steps` coarse steps a round (escape and window tests, hit
// in an all-solid brick, park in a mixed brick, else move to the nearest
// 8/16/32/64-aligned boundary); a parked ray then walks its brick's 16-word
// detail row, at most 23 crossings (a solid voxel is a hit, leaving the
// window is air, leaving the brick or running out of crossings ends the
// round).  A ray still live after `rounds` rounds is exhausted and keeps
// its resume position and entry normal; an inactive ray is born done at its
// origin with normal 0.  The hit voxel's material and the nudge are
// PyTorch work in the wrapper, as in JAX.
//
// What bounds it on the H100: not memory (a ray reads 24-25 bytes and
// writes 18; the 9 KB pyramid sits in shared memory, the 2 MiB detail rows
// in L2 and the read-only cache), nor the float32 rate, but the work per
// move and the latency of each warp's longest ray: a warp runs until its
// last lane's ray is done, and a grazing bounce ray can take many rounds.
// This first form keeps each ray's state in registers, copies the pyramid
// into shared memory once per block and reads a crossing's detail word with
// `__ldg`.  Keeping every lane of a warp busy (persistent lanes, as K3 and
// K4 have) and starting the longest rays first are the next steps.

#include <cuda_runtime.h>
#include <stdint.h>

#include "vol_march.cuh"

namespace {

constexpr int kThreads = 256;

// The rounds of one traced ray.  -> kDone (a hit), kDone | kAir (air) or 0
// (exhausted: still live after `rounds` rounds).
__device__ __forceinline__ int trace_ray(Ray& r, const Tables& t, const Scalars& c,
                                         const int32_t* __restrict__ detail,
                                         int rounds, int steps) {
  for (int round = 0; round < rounds; ++round) {
    int status = 0;
    int32_t tx = 0, ty = 0, tz = 0, b = 0;
    for (int k = 0; k < steps; ++k) {
      tx = texel(r.px);
      ty = texel(r.py);
      tz = texel(r.pz);
      b = brick_of(tx, ty, tz);
      int32_t step = 0;
      status = coarse_classify(r, t, c, tx, ty, tz, b, step);
      if (status != 0) break;
      move_to_boundary(r, step);
      if (out_of_window(r, c)) {
        status = kDone | kAir;
        break;
      }
    }
    if (status == kParked) {
      // resolve_mixed: the crossings of brick b (the ray parked at its
      // entry); leaving it, or 23 crossings, ends the round live.
      const int32_t b0 = b;
      status = 0;
      for (int k = 0; k < kMaxCrossings; ++k) {
        if (out_of_window(r, c)) {
          status = kDone | kAir;
          break;
        }
        tx = texel(r.px);
        ty = texel(r.py);
        tz = texel(r.pz);
        if (brick_of(tx, ty, tz) != b0) break;
        if (voxel_solid(detail, b0, tx, ty, tz)) {
          status = kDone;
          break;
        }
        move_to_boundary(r, 1);
      }
    }
    if (status != 0) return status;
  }
  return 0;
}

__global__ void __launch_bounds__(kThreads)
    trace_rays_vol_kernel(const float* __restrict__ origin,
                          const float* __restrict__ direction,
                          const uint8_t* __restrict__ active,
                          const int32_t* __restrict__ iscal,
                          const int32_t* __restrict__ any8,
                          const int32_t* __restrict__ all8,
                          const int32_t* __restrict__ any_hi,
                          const int32_t* __restrict__ detail,
                          float* __restrict__ pos_out,
                          int32_t* __restrict__ normal_out,
                          uint8_t* __restrict__ air_out,
                          uint8_t* __restrict__ done_out, int n, int rounds,
                          int steps) {
  __shared__ Tables t;
  Scalars c;
  load_tables(t, c, any8, all8, any_hi, iscal);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  Ray r;
  r.px = origin[3 * i];
  r.py = origin[3 * i + 1];
  r.pz = origin[3 * i + 2];
  r.normal = 0;
  int status = kDone;  // an inactive ray is born done at its origin
  if (active == nullptr || active[i]) {
    set_direction(r, direction[3 * i], direction[3 * i + 1], direction[3 * i + 2]);
    status = trace_ray(r, t, c, detail, rounds, steps);
  }
  pos_out[3 * i] = r.px;
  pos_out[3 * i + 1] = r.py;
  pos_out[3 * i + 2] = r.pz;
  normal_out[i] = r.normal;
  air_out[i] = (status & kAir) != 0;
  done_out[i] = (status & kDone) != 0;
}

}  // namespace

extern "C" int rt_trace_rays_vol(const float* origin, const float* direction,
                                 const uint8_t* active, const int32_t* iscal,
                                 const int32_t* any8, const int32_t* all8,
                                 const int32_t* any_hi, const int32_t* detail,
                                 float* pos, int32_t* normal, uint8_t* air,
                                 uint8_t* done, int n, int rounds, int steps,
                                 void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  trace_rays_vol_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      origin, direction, active, iscal, any8, all8, any_hi, detail, pos, normal,
      air, done, n, rounds, steps);
  return (int)cudaGetLastError();
}
