// Kernel K3: the volume_fast light path of every pixel, on persistent lanes.
//
// Replaces the Pallas TPU kernel raytrace_tpu/ops/trace_vol_pallas.py
// `_make_vol_kernel` (:254-429) together with the XLA work the JAX package
// runs around it in every round of path_vol.render_gbuffers_path: the
// in-brick voxel march `resolve_mixed` (trace_vol_pallas.py:437-579) and the
// leg transition `_transition` (path_vol.py:161-302).  Its plain PyTorch
// version is `march_paths_vol_plain` in ops/trace_vol.py; the two run the
// same float32 operations in the same order (built with --fmad=false, so no
// multiply-add is contracted), and every path's outputs are the same bits
// whichever lane computes them.
//
// A path: coarse steps over the brick pyramid (escape and window tests, hit
// in an all-solid brick, park in a mixed brick, else move to the nearest
// 8/16/32/64-aligned boundary); for a parked ray, the voxel march through
// that brick's 16-word detail row (at most 23 crossings); for a completed
// ray, the leg transition (primary -> sun1 -> dif1 -> sun2 -> dif2).  The
// TPU's rounds, step caps, slotted views and state trimming have no
// counterpart.  The march code K3 shares with the staged tracer K3s
// (trace_rays_vol.cu) is in vol_march.cuh.
//
// What bounds it on the H100 is neither memory (each pixel reads 72 bytes
// and writes 16; the 9 KB pyramid sits in shared memory, the 2 MiB detail
// rows in L2) nor the float32 rate, but the work per move and the latency
// of the longest paths.  At the volume_fast path's 1024² view, bounces=2
// (NVIDIA H100 80GB HBM3, 700 W), the paths make 73.0M moves; one thread
// per pixel, 32 consecutive pixels to a warp, kept 0.44 of the lanes busy
// (5.19M warp-iterations), and a lane taking a coarse step waited while a
// neighbour walked up to 23 crossings of a nested resolve loop.  So:
//  - one move per iteration: each pass of the loop makes exactly one move
//    of every busy lane, a coarse step or one voxel crossing of the parked
//    brick, and coarse-marching and resolving lanes share
//    `move_to_boundary` (modulus 8-64 or 1);
//  - less work per move: 1/|v|, the sign multipliers and the face-normal
//    ids are computed once per leg; the floor modulo is
//    `s - floor(s * (1/m)) * m` with the exact reciprocal of the
//    power-of-two modulus instead of `fmodf`; nothing lives in local
//    memory: a crossing reads its one detail word with `__ldg`, and a
//    transition reads the pixel's jittered sun direction or sphere point
//    from global memory;
//  - persistent lanes (lanes.cuh): a grid that fills the card, each warp
//    refilling its idle lanes from a window of path indices, and the
//    pyramid tables copied into shared memory once per block.
// There, the lanes are 0.63 busy (3.60M warp-iterations) and the kernel
// takes 1.83 ms against 2.94 for one thread per pixel.  The refill rule was
// measured with apps/march_lanes.py: refilling once 16 lanes are idle took
// 1.649 ms, once all 32 are 1.689, whenever one is 1.794 (lane use 0.62,
// 0.43, 0.78).  A refill is a divergent branch the whole warp waits for,
// so the fullest warps are not the fastest.  The floor is the longest
// paths: the 32 longest (545 moves) take 0.51 ms alone, and the same paths
// started longest first take 1.22 ms against 1.65 in index order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lanes.cuh"
#include "vol_march.cuh"

namespace {

constexpr int kThreads = 256;  // at 128 a block, ptxas spilled registers
constexpr int kInv = 12;

constexpr int kLegShift = 6;
constexpr int kLegDone = 5;
constexpr int kPrimNormalShift = 9;
constexpr int kDif1NormalShift = 12;
constexpr int kSkyShift = 15;

// The refill rule: the idle lanes of a warp take new paths once at least
// 16 of its 32 lanes are idle.
__device__ __forceinline__ bool refill_now(unsigned idle) {
  return __popc(idle) >= 16;
}

// Per-path state besides the ray: the outputs, the bounce anchor, the
// budgets, and the brick being resolved (-1 while coarse-marching) with the
// crossings made in it.
struct Path {
  int32_t meta, prim_lin, dif1_lin;
  float prim_dist, ax, ay, az;
  int32_t coarse_left, bricks_left, b0, crossings;
};

__device__ __forceinline__ void face_normal(int32_t id, float& x, float& y,
                                            float& z) {
  float sign = (id % 2 == 0) ? 1.0f : -1.0f;
  int32_t axis = id / 2;
  x = axis == 0 ? sign : 0.0f;
  y = axis == 1 ? sign : 0.0f;
  z = axis == 2 ? sign : 0.0f;
}

// ops/shading.py diffuse_from_sphere, with its degenerate guard; `sp` is the
// pixel's unit-sphere point in global memory.
__device__ __forceinline__ void diffuse_from_sphere(const float* __restrict__ sp,
                                                    int32_t id, float& x,
                                                    float& y, float& z) {
  float nx, ny, nz;
  face_normal(id, nx, ny, nz);
  float dx = __ldg(sp) + nx, dy = __ldg(sp + 1) + ny, dz = __ldg(sp + 2) + nz;
  float norm = sqrtf(dx * dx + dy * dy + dz * dz);
  if (norm < 1e-6f) {
    x = nx;
    y = ny;
    z = nz;
    return;
  }
  norm = fmaxf(norm, 1e-20f);
  x = dx / norm;
  y = dy / norm;
  z = dz / norm;
}

// The leg transition of path_vol._transition for a ray that completed
// (`air`: reached sky, else hit at its position).  Starts the next leg, with
// entry normal 0, from the pixel's invariants `inv` (sd1, sp1, sd2, sp2 in
// global memory), or marks the path done.  -> true when the path is done.
__device__ __forceinline__ bool transition(Ray& r, Path& s, bool air,
                           const float* __restrict__ inv, const Scalars& c,
                           int legs) {
  int32_t leg = (s.meta >> kLegShift) & 7;
  int32_t nrm = r.normal;
  int32_t lx = ((int32_t)floorf(r.px + kHalf)) & (kN - 1);
  int32_t ly = ((int32_t)floorf(r.py + kHalf)) & (kN - 1);
  int32_t lz = ((int32_t)floorf(r.pz + kHalf)) & (kN - 1);
  int32_t lin = (lz * kN + ly) * kN + lx;
  float nx, ny, nz;
  face_normal(nrm, nx, ny, nz);
  float hx = r.px + 0.001f * nx;
  float hy = r.py + 0.001f * ny;
  float hz = r.pz + 0.001f * nz;
  int32_t m = s.meta;
  if (leg == 0) {
    if (air) {
      m |= 1 << kSkyShift;
    } else {
      m |= nrm << kPrimNormalShift;
      s.prim_lin = lin;
      float ex = hx - c.ox, ey = hy - c.oy, ez = hz - c.oz;
      s.prim_dist = sqrtf(ex * ex + ey * ey + ez * ez);
    }
  } else if (air) {
    m |= 1 << (kSkyShift + leg);
  }
  int32_t next;
  if (legs == 1) {
    next = kLegDone;
  } else {
    if (leg == 2 && !air && legs >= 5) {
      m |= nrm << kDif1NormalShift;
      s.dif1_lin = lin;
    }
    next = leg == 0   ? (air ? kLegDone : 1)
           : leg == 1 ? 2
           : leg == 2 ? (air ? kLegDone : 3)
           : leg == 3 ? 4
                      : kLegDone;
    if (next >= legs) next = kLegDone;
  }
  s.meta = (m & ~(7 << kLegShift)) | (next << kLegShift);
  if (next == kLegDone) return true;

  r.normal = 0;
  float dx, dy, dz;
  if (leg == 0 || leg == 2) {
    // sun1 / sun2 from the nudged hit, which anchors the next diffuse leg.
    const float* sd = inv + (leg == 0 ? 0 : 6);
    dx = __ldg(sd);
    dy = __ldg(sd + 1);
    dz = __ldg(sd + 2);
    r.px = hx;
    r.py = hy;
    r.pz = hz;
    s.ax = hx;
    s.ay = hy;
    s.az = hz;
  } else {
    // dif1 / dif2 from the anchor, around the recorded hit normal.
    int32_t id = leg == 1 ? (m >> kPrimNormalShift) & 7 : (m >> kDif1NormalShift) & 7;
    diffuse_from_sphere(inv + (leg == 1 ? 3 : 9), id, dx, dy, dz);
    r.px = s.ax;
    r.py = s.ay;
    r.pz = s.az;
  }
  set_direction(r, dx, dy, dz);
  return false;
}

// One iteration of a path: exactly one move (a coarse step, or one voxel
// crossing of the parked ray's brick) or the completion of a leg.  The
// order of tests is that of the per-path loop
//   while (leg < done) { coarse step; if parked: resolve (<= 23 crossings);
//                        if completed: transition }
// with the budgets spent where it spends them.  An iteration that makes no
// move (a leg completed without one, a budget's halt) takes one from
// `moves`.  -> true when the path is finished: done, or halted by its
// budget.
__device__ __forceinline__ bool step_path(Ray& r, Path& s, const Tables& t,
                                          const int32_t* __restrict__ detail,
                                          const float* __restrict__ inv,
                                          const Scalars& c, int legs,
                                          unsigned& moves) {
  const int32_t tx = texel(r.px), ty = texel(r.py), tz = texel(r.pz);
  const int32_t b = brick_of(tx, ty, tz);
  int status = 0;
  // The tests that open a crossing of resolve_mixed: after 23 crossings, or
  // out of the brick, the coarse march resumes; out of the window is air.
  if (s.b0 >= 0) {
    if (s.crossings == kMaxCrossings) {
      s.b0 = -1;
    } else if (out_of_window(r, c)) {
      status = kDone | kAir;
      s.b0 = -1;
    } else if (b != s.b0) {
      s.b0 = -1;
    }
  }
  int32_t step = 0;  // the move: 0 none, 1 a voxel crossing, 8-64 a coarse step
  if (s.b0 < 0 && status == 0) {
    if (s.coarse_left == 0) {
      --moves;
      return true;
    }
    --s.coarse_left;
    status = coarse_classify(r, t, c, tx, ty, tz, b, step);
    if (status == kParked) {
      if (s.bricks_left == 0) {
        --moves;
        return true;
      }
      --s.bricks_left;
      s.b0 = b;
      s.crossings = 0;
      status = 0;
    }
  }
  if (s.b0 >= 0 && status == 0) {
    if (voxel_solid(detail, s.b0, tx, ty, tz)) {
      status = kDone;
      s.b0 = -1;
    } else {
      step = 1;
      ++s.crossings;
    }
  }
  if (step != 0) {
    move_to_boundary(r, step);
    if (s.b0 < 0 && out_of_window(r, c)) status = kDone | kAir;
  }
  if (status & kDone) {
    if (step == 0) --moves;
    return transition(r, s, (status & kAir) != 0, inv, c, legs);
  }
  return false;
}

__device__ __forceinline__ void start_path(int i, Ray& r, Path& s,
                                           const float* __restrict__ origin,
                                           const float* __restrict__ direction,
                                           int budget) {
  r.px = origin[3 * i];
  r.py = origin[3 * i + 1];
  r.pz = origin[3 * i + 2];
  r.normal = 0;
  set_direction(r, direction[3 * i], direction[3 * i + 1], direction[3 * i + 2]);
  s.meta = 0;
  s.prim_lin = -1;
  s.dif1_lin = -1;
  s.prim_dist = 0.0f;
  s.ax = s.ay = s.az = 0.0f;
  s.coarse_left = budget;
  s.bricks_left = budget;
  s.b0 = -1;
  s.crossings = 0;
}

__global__ void __launch_bounds__(kThreads)
    march_paths_vol_kernel(const float* __restrict__ origin,
                           const float* __restrict__ direction,
                           const float* __restrict__ inv_in,
                           const int32_t* __restrict__ iscal,
                           const float* __restrict__ fscal,
                           const int32_t* __restrict__ any8,
                           const int32_t* __restrict__ all8,
                           const int32_t* __restrict__ any_hi,
                           const int32_t* __restrict__ detail,
                           int32_t* __restrict__ meta_out,
                           int32_t* __restrict__ prim_lin_out,
                           int32_t* __restrict__ dif1_lin_out,
                           float* __restrict__ prim_dist_out, int n, int budget,
                           int legs, int32_t* __restrict__ next,
                           long long* __restrict__ census) {
  __shared__ Tables t;
  Scalars c;
  load_tables(t, c, any8, all8, any_hi, iscal);
  c.ox = fscal[0];
  c.oy = fscal[1];
  c.oz = fscal[2];

  Ray r;
  Path s;
  Window w;
  int i = -1;  // this lane's path, -1 while idle
  long long iterations = 0;
  // This lane's moves, counted only where a path starts or ends and where
  // an iteration makes none: a path adds the warp's iterations while it
  // held the lane, less those without a move (step_path); unsigned, so the
  // sums wrap to the count.
  unsigned moves = 0;
  for (;;) {
    if (refill_now(__ballot_sync(kFullMask, i < 0))) {
      const int held = i;
      i = refill(i, w, next, n, [](int) { return true; }, [](int) {});
      if (held < 0 && i >= 0) {
        start_path(i, r, s, origin, direction, budget);
        moves -= (unsigned)iterations;
      }
    }
    if (!__any_sync(kFullMask, i >= 0)) break;
    ++iterations;
    if (i >= 0 &&
        step_path(r, s, t, detail, inv_in + (size_t)kInv * i, c, legs, moves)) {
      meta_out[i] = s.meta;
      prim_lin_out[i] = s.prim_lin;
      dif1_lin_out[i] = s.dif1_lin;
      prim_dist_out[i] = s.prim_dist;
      moves += (unsigned)iterations;
      i = -1;
    }
  }
  add_census(census, iterations, moves);
}

int grid_cache = 0;

}  // namespace

extern "C" int rt_march_paths_vol(const float* origin, const float* direction,
                                  const float* inv, const int32_t* iscal,
                                  const float* fscal, const int32_t* any8,
                                  const int32_t* all8, const int32_t* any_hi,
                                  const int32_t* detail, int32_t* meta,
                                  int32_t* prim_lin, int32_t* dif1_lin,
                                  float* prim_dist, int n, int budget, int legs,
                                  int32_t* next, long long* census,
                                  void* stream) {
  if (n <= 0) return 0;
  int blocks = 0;
  int err = persistent_grid(march_paths_vol_kernel, kThreads, n, grid_cache, blocks);
  if (err != 0) return err;
  march_paths_vol_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      origin, direction, inv, iscal, fscal, any8, all8, any_hi, detail, meta,
      prim_lin, dif1_lin, prim_dist, n, budget, legs, next, census);
  return (int)cudaGetLastError();
}
