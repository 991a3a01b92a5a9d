// Kernel K3s: the staged volume tracer of independent rays, on persistent
// lanes that refill, one move per loop iteration.
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
// are the same bits whichever lane computes them.  The march code is K3's
// (vol_march.cuh).  The TPU's (rows, 128) tiles, padding rays, lane-shuffle
// lookups, the round loop's early exit and the straggler cascade have no
// counterpart.
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
// in L2) nor the float32 rate, but the work per move, the latency of each
// move's dependent chain, and each warp's longest ray.  One thread per ray
// in index order (the first form, the nested round loop) held a warp until
// its last lane was done and kept the lanes of inactive rays idle for a
// warp's whole life: a bounce pair batch holds a slot for every pixel,
// active or not.  So:
//  - persistent lanes (lanes.cuh): a grid that fills the card, each warp
//    drawing windows of 32 ray indices from a counter; an inactive ray is
//    written born done as its window is drawn and never takes a lane;
//  - for a batch with an active mask (the bounce pairs), one move per
//    iteration (`step_ray`, the form of K3's `step_path`): each pass of the
//    loop makes one coarse step or one voxel crossing of every busy lane,
//    through one shared `move_to_boundary`, the round loop's budget is lane
//    state (the round, the steps spent in it, the parked brick and its
//    crossings), and idle lanes refill once 16 are idle;
//  - for a batch without one (the primaries: coherent, all live), each lane
//    walks its ray whole in the nested round loop (`trace_ray`), and the
//    warp draws its next window when all 32 are done: a refill mid-flight
//    stalls the warp on its new rays' loads.
// At the volume_fast view's three 1024² batches (NVIDIA H100 80GB HBM3,
// 700 W; apps/march_lanes.py --part k3s, in turns) this takes 1.08 ms
// against the first form's 1.49 (0.15 / 0.63 / 0.30 against 0.16 / 0.87 /
// 0.47).  The alternatives that lost are in PERF.md section 5 with their
// times: one move per iteration on every batch, every ray whole, one ray
// per thread, a parked brick's detail row copied to shared memory once
// (ptxas spilled), the coarse step's pyramid words loaded together.  The
// refill rule (refill_now) is the one alternative kept as an edit point:
// apps/march_lanes.py times rules i and ii against it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lanes.cuh"
#include "vol_march.cuh"

namespace {

constexpr int kThreads = 256;

// The refill rule: the idle lanes of a warp take new rays once at least 16
// of its 32 lanes are idle.
__device__ __forceinline__ bool refill_now(unsigned idle) {
  return __popc(idle) >= 16;
}

// The round loop's budget of one ray: the round `r`, the coarse steps `k`
// spent in it, the brick being resolved (-1 while coarse-marching) and the
// crossings made in it.
struct Budget {
  int32_t r, k, b0, crossings;
};

// One iteration of a ray: exactly one move (a coarse step, or one voxel
// crossing of the parked brick) unless the ray finishes; coarse-stepping
// and resolving lanes share `move_to_boundary`.  The order of the tests is
// that of the plain round loop (`trace_ray`) with the round ended where
// that loop ends it.  -> -1 while the ray is live, else its status: kDone
// (a hit), kDone | kAir (air) or 0 (exhausted: still live after `rounds`
// rounds).
__device__ __forceinline__ int step_ray(Ray& r, Budget& s, const Tables& t,
                                        const Scalars& c,
                                        const int32_t* __restrict__ detail, int rounds,
                                        int steps) {
  const int32_t tx = texel(r.px), ty = texel(r.py), tz = texel(r.pz);
  const int32_t b = brick_of(tx, ty, tz);
  // The tests that open a crossing of resolve_mixed: after 23 crossings,
  // or out of the brick, the round ends live; out of the window is air.
  if (s.b0 >= 0) {
    if (s.crossings != kMaxCrossings && out_of_window(r, c)) return kDone | kAir;
    if (s.crossings == kMaxCrossings || b != s.b0) {
      s.b0 = -1;
      s.k = 0;
      if (++s.r == rounds) return 0;
    }
  }
  int32_t step = 1;  // the move: 1 a voxel crossing, 8-64 a coarse step
  if (s.b0 < 0) {
    const int status = coarse_classify(r, t, c, tx, ty, tz, b, step);
    ++s.k;
    if (status == kParked) {
      // The first crossing's window and brick tests hold here.
      s.b0 = b;
      s.crossings = 0;
    } else if (status != 0) {
      return status;
    }
  }
  if (s.b0 >= 0) {
    if (voxel_solid(detail, s.b0, tx, ty, tz)) return kDone;
    ++s.crossings;
  }
  move_to_boundary(r, step);
  if (s.b0 < 0) {
    if (out_of_window(r, c)) return kDone | kAir;
    if (s.k == steps) {
      s.k = 0;
      if (++s.r == rounds) return 0;
    }
  }
  return -1;
}

// The rounds of one ray, whole, in the plain round loop's nested form: up
// to `steps` coarse steps a round, then after a park one resolve of <= 23
// crossings; `trips` counts the loops' iterations.  -> its status, as
// step_ray's.
__device__ __forceinline__ int trace_ray(Ray& r, const Tables& t, const Scalars& c,
                                         const int32_t* __restrict__ detail, int rounds,
                                         int steps, int& trips) {
  for (int round = 0; round < rounds; ++round) {
    int status = 0;
    int32_t b = 0;
    for (int k = 0; k < steps; ++k) {
      ++trips;
      const int32_t tx = texel(r.px), ty = texel(r.py), tz = texel(r.pz);
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
      const int32_t b0 = b;
      status = 0;
      for (int k = 0; k < kMaxCrossings; ++k) {
        ++trips;
        if (out_of_window(r, c)) {
          status = kDone | kAir;
          break;
        }
        const int32_t tx = texel(r.px), ty = texel(r.py), tz = texel(r.pz);
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

__device__ __forceinline__ void start_ray(int i, Ray& r, Budget& s,
                                          const float* __restrict__ origin,
                                          const float* __restrict__ direction) {
  r.px = origin[3 * i];
  r.py = origin[3 * i + 1];
  r.pz = origin[3 * i + 2];
  r.normal = 0;
  set_direction(r, direction[3 * i], direction[3 * i + 1], direction[3 * i + 2]);
  s.r = 0;
  s.k = 0;
  s.b0 = -1;
  s.crossings = 0;
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
                          int steps, int32_t* __restrict__ next,
                          long long* __restrict__ census) {
  __shared__ Tables t;
  Scalars c;
  load_tables(t, c, any8, all8, any_hi, iscal);

  // A ray that takes no lane: an inactive ray is born done at its origin
  // with normal 0; with no rounds, an active ray is exhausted there.
  const auto live = [=](int k) {
    return rounds > 0 && (active == nullptr || active[k] != 0);
  };
  const auto skip = [=](int k) {
    pos_out[3 * k] = origin[3 * k];
    pos_out[3 * k + 1] = origin[3 * k + 1];
    pos_out[3 * k + 2] = origin[3 * k + 2];
    normal_out[k] = 0;
    air_out[k] = 0;
    done_out[k] = active != nullptr && active[k] == 0;
  };

  Ray r;
  Budget s;
  Window w;
  int i = -1;  // this lane's ray, -1 while idle
  // A launch without an active mask (the primaries: coherent, every ray
  // live) walks each ray whole: the warp refills only between windows.
  const bool whole = active == nullptr;
  int iterations = 0;  // the warp's loop iterations
  for (;;) {
    if (refill_now(__ballot_sync(kFullMask, i < 0))) {
      const int held = i;
      i = refill(i, w, next, n, live, skip);
      if (held < 0 && i >= 0) start_ray(i, r, s, origin, direction);
    }
    if (!__any_sync(kFullMask, i >= 0)) break;
    int status = -1, trips = 1;
    if (i >= 0) {
      if (whole) {
        trips = 0;
        status = trace_ray(r, t, c, detail, rounds, steps, trips);
      } else {
        status = step_ray(r, s, t, c, detail, rounds, steps);
      }
    }
    // Whole rays: a window counts as its lane's most loop iterations.
    iterations += whole ? __reduce_max_sync(kFullMask, trips) : 1;
    if (status >= 0) {
      pos_out[3 * i] = r.px;
      pos_out[3 * i + 1] = r.py;
      pos_out[3 * i + 2] = r.pz;
      normal_out[i] = r.normal;
      air_out[i] = (status & kAir) != 0;
      done_out[i] = (status & kDone) != 0;
      i = -1;
    }
  }
  add_census(census, iterations);
}

int grid_cache = 0;

}  // namespace

extern "C" int rt_trace_rays_vol(const float* origin, const float* direction,
                                 const uint8_t* active, const int32_t* iscal,
                                 const int32_t* any8, const int32_t* all8,
                                 const int32_t* any_hi, const int32_t* detail,
                                 float* pos, int32_t* normal, uint8_t* air,
                                 uint8_t* done, int n, int rounds, int steps,
                                 int32_t* next, long long* census, void* stream) {
  if (n <= 0) return 0;
  int blocks = (n + kThreads - 1) / kThreads;
  int err = persistent_grid(trace_rays_vol_kernel, kThreads, n, grid_cache, blocks);
  if (err != 0) return err;
  // The lanes' ray counter, zeroed on the launching stream.
  err = (int)cudaMemsetAsync(next, 0, sizeof(int32_t), (cudaStream_t)stream);
  if (err != 0) return err;
  trace_rays_vol_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      origin, direction, active, iscal, any8, all8, any_hi, detail, pos, normal,
      air, done, n, rounds, steps, next, census);
  return (int)cudaGetLastError();
}
