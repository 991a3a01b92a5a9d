// Kernel K1: the whole light path of every pixel, one thread per pixel.
//
// Replaces the Pallas TPU kernel raytrace_tpu/ops/lighting_pallas.py
// `_make_kernel` (:143-796), launched from `render_gbuffers_fused` (:930-959).
// Its plain PyTorch version is `march_paths_plain` in ops/lighting.py; the
// two run the same float32 operations in the same order (built with
// --fmad=false, so no multiply-add is contracted), and every path's outputs
// are the same bits whichever lane computes them.
//
// A path walks primary -> sun1 -> dif1 -> sun2 -> dif2 (capped at `legs`
// rays) over the 2-D column-height pyramid of the streamed region.  One
// step is the JAX unified body `body_u` (:495-572): classify from the
// packed h3/hsub words with the rising-ray rule, test the sky escape
// against maxh, read the exact column height (only where the pyramid says
// the step is fine), and either start the next leg (`apply_transition`,
// :315-388) or move to the nearest boundary (`bdist` with exact
// power-of-two reciprocals, :238-254; the fine z distance `lzf`, :563-568;
// `move`, :390-415).  The path has a budget of `max_steps` steps.  The
// TPU's sort cascade, step caps, unrolling, lazy transitions and
// lane-shuffle table lookups have no counterpart.  The pyramid
// classification and `bdist` live in heightfield.cuh, shared with K4.
//
// What bounds it on the H100 is neither memory (each pixel reads 28 bytes
// and writes 8; the 8 KB pyramid sits in shared memory, the 128 KB column
// table and the 2 KB sin/cos table of the sphere points in L1 and L2) nor
// the float32 rate, but the latency of each move's dependent chain and of
// the longest paths.  One thread per pixel took 1.25 ms at the fused
// path's 1024² view, bounces=2 (NVIDIA H100 80GB HBM3, 700 W; PERF.md): a
// fine step (37% of the 37M moves) evaluated the column height from the
// lattice words (a perlin octave, two divisions and a powf), and every move
// took three divisions for 1/|d|.  So:
//  - a fine step reads the column's height from the region's column table
//    (ops/hf_tables.py column_heights, 65,536 int16 at ry * 256 + rx, built
//    with the region's other tables), one `__ldg`;
//  - 1/|d|, the sign multipliers and the face-normal ids are computed once
//    per leg, from the same direction, so the distances keep their bits;
//  - the sphere points' sin and cos come from a 256-entry table: no call
//    to the trigonometric slow path, so no stack frame.
// There it takes 0.68-0.73 ms.  Persistent lanes that refill (lanes.cuh,
// as K3 and K4 run them) raised lane use from 0.51 to 0.62 and saved
// nothing: apps/march_lanes.py measured 0.685-0.694 ms refilling once 16
// lanes are idle, 0.692-0.693 for one thread per pixel, 0.68-0.77 once all
// 32 are idle and 0.851 whenever one is.  So K1 keeps the plain launch.
// The floor is the longest paths: the 32 longest (392 moves) take 0.26 ms
// alone, and all paths started longest first take 0.44 ms.  The bounce
// legs cost twice as much a move as the primaries (0.21 ms for the 16.6M
// primary moves, 0.48 for the 19.9M others).

#include "heightfield.cuh"
#include "lanes.cuh"
#include "shading.cuh"

namespace {

constexpr int kLegDone = 5;
constexpr int kThreads = 128;

// lighting_pallas._mat_code: the voxel's material band as a 2-bit code
// (1 grass, 2 rock, 3 snow).
__device__ int32_t mat_code(int32_t xi, int32_t yi, int32_t zi, int32_t seed) {
  int32_t band = material_band(xi, yi, zi, seed);
  return band == 2 ? 1 : (band == 5 ? 2 : 3);
}

// A path: the current ray (position, direction and its per-leg move terms:
// 1/|d|, the sign multiplier and the entry-face normal ids packed 3 bits
// apart), the bounce anchor q, the primary distance, the leg, the normals,
// the accumulated meta bits, the steps taken and those of them that did not
// move (a leg's completion, the step past the budget).
struct Path {
  float px, py, pz, dx, dy, dz, qx, qy, qz, pd;
  float lpx, lpy, lpz, mulx, muly, mulz;
  int32_t nids, leg, cn, pn, nn, acc, it, still;
};

struct Scalars {
  int32_t r0x, r0y, maxh, seed, legs;
  float lrx, lry, lrz;
};

// The pixel's jittered sun directions and unit-sphere points.
struct Hoisted {
  Vec3 sj1, sj2, sp1, sp2;
};

// The pyramid words of the region, in shared memory.
struct Pyramid {
  int32_t h3[kWords], hsub[kWords];
};

__device__ __forceinline__ void set_leg_terms(Path& s) {
  s.lpx = 1.0f / fabsf(s.dx);
  s.lpy = 1.0f / fabsf(s.dy);
  s.lpz = 1.0f / fabsf(s.dz);
  s.mulx = s.dx > 0.0f ? -1.0f : 1.0f;
  s.muly = s.dy > 0.0f ? -1.0f : 1.0f;
  s.mulz = s.dz > 0.0f ? -1.0f : 1.0f;
  s.nids = (s.dx > 0.0f ? 1 : 0) | ((s.dy > 0.0f ? 3 : 2) << 3) |
           ((s.dz > 0.0f ? 5 : 4) << 6);
}

// One step of the path.  Returns with the path either transitioned (its
// ray completed: air out of the region or by the sky-escape rule, or a hit
// inside a column) or, when `allow_move`, moved to the next boundary.  A
// step that does not move adds one to `still`.
__device__ __forceinline__ void step(Path& s, const Pyramid& t,
                                     const int16_t* __restrict__ hc,
                                     const Scalars& c, const Hoisted& hz,
                                     bool allow_move) {
  int32_t xi = (int32_t)floorf(s.px);
  int32_t yi = (int32_t)floorf(s.py);
  int32_t zi = (int32_t)floorf(s.pz);
  int32_t rx, ry;
  int32_t i3 = block_index(xi, yi, c.r0x, c.r0y, rx, ry);
  bool up = s.dz >= 0.0f;
  int32_t stp = pyramid_step(t.h3, t.hsub, i3, rx, ry, zi, up);
  bool fine = stp == 0;
  bool oob = fabsf(s.px - c.lrx) >= kHalf || fabsf(s.py - c.lry) >= kHalf ||
             fabsf(s.pz - c.lrz) >= kHalf || (up && zi >= c.maxh);
  int32_t hcol = 0;
  bool hit = false;
  if (!oob && fine) {
    // In the region (|p - lr| < 128) block_index clamps nothing: (rx, ry)
    // is the step's own column.
    hcol = __ldg(hc + ry * kRegion + rx);
    hit = zi < hcol;
  }

  if (oob || hit) {
    // apply_transition: start the next leg from the nudged hit point.
    Vec3 n = face_normal(s.cn);
    float hx = s.px + 0.001f * n.x;
    float hy = s.py + 0.001f * n.y;
    float hzv = s.pz + 0.001f * n.z;
    int32_t leg = s.leg;
    bool c0h = hit && leg == 0;
    bool c2h = hit && leg == 2;
    if (c0h) s.pn = s.cn;
    if (c2h) s.nn = s.cn;
    if (oob) s.acc |= 1 << leg;
    if (c0h) s.acc |= mat_code(xi, yi, zi, c.seed) << 5;
    if (c2h) s.acc |= mat_code(xi, yi, zi, c.seed) << 7;
    int32_t next = leg == 0   ? (hit ? 1 : kLegDone)
                   : leg == 1 ? 2
                   : leg == 2 ? (hit ? 3 : kLegDone)
                   : leg == 3 ? 4
                              : kLegDone;
    if (next >= c.legs) next = kLegDone;
    if (c0h || c2h) {
      s.qx = hx;
      s.qy = hy;
      s.qz = hzv;
    }
    Vec3 d;
    bool starting = true;
    if (c0h) {
      d = hz.sj1;
    } else if (leg == 1) {
      d = diffuse_from_sphere(hz.sp1, s.pn);
    } else if (c2h) {
      d = hz.sj2;
    } else if (leg == 3) {
      d = diffuse_from_sphere(hz.sp2, s.nn);
    } else {
      starting = false;
    }
    if (starting) {
      s.px = s.qx;
      s.py = s.qy;
      s.pz = s.qz;
      s.dx = d.x;
      s.dy = d.y;
      s.dz = d.z;
      set_leg_terms(s);
    }
    s.leg = next;
    ++s.still;
    return;
  }
  if (!allow_move) {
    ++s.still;
    return;
  }

  float lx, ly, lz;
  if (fine) {
    lx = bdist(s.px, s.mulx, s.lpx, 1.0f, 1.0f);
    ly = bdist(s.py, s.muly, s.lpy, 1.0f, 1.0f);
    float ztop = (float)hcol;
    lz = (s.dz < 0.0f && s.pz >= ztop) ? (kEps + (s.pz - ztop)) * s.lpz
                                       : __int_as_float(0x7f800000);
  } else {
    float step_f = (float)stp;
    float inv_step = step_reciprocal(stp);
    lx = bdist(s.px, s.mulx, s.lpx, step_f, inv_step);
    ly = bdist(s.py, s.muly, s.lpy, step_f, inv_step);
    lz = bdist(s.pz, s.mulz, s.lpz, step_f, inv_step);
  }
  bool use_x = (lx < ly) && (lx < lz);
  bool use_y = !(lx < ly) && (ly < lz);
  float lmin = use_x ? lx : (use_y ? ly : lz);
  s.cn = (s.nids >> (use_x ? 0 : (use_y ? 3 : 6))) & 7;
  s.px = s.px + s.dx * lmin;
  s.py = s.py + s.dy * lmin;
  s.pz = s.pz + s.dz * lmin;
  if (s.leg == 0) s.pd = s.pd + lmin;
}

__device__ __forceinline__ void start_path(int i, Path& s, Hoisted& hz,
                                           const float* __restrict__ origin,
                                           const float* __restrict__ direction,
                                           const int32_t* __restrict__ nw,
                                           const float* __restrict__ trig,
                                           float sunx, float suny, float sunz) {
  // Per-pixel noise, exact k/255 from the packed bytes.
  int32_t word = nw[i];
  int32_t k1 = word & 255, k2 = (word >> 16) & 255;
  float n1r = (float)k1 / 255.0f;
  float n1g = (float)((word >> 8) & 255) / 255.0f;
  float n2r = (float)k2 / 255.0f;
  float n2g = (float)((word >> 24) & 255) / 255.0f;
  hz.sj1 = norm3(sunx + n1r * 0.05f, suny + n1g * 0.05f, sunz);
  hz.sj2 = norm3(sunx + n2r * 0.05f, suny + n2g * 0.05f, sunz);
  hz.sp1 = sphere_point(__ldg(trig + 2 * k1), __ldg(trig + 2 * k1 + 1), n1g);
  hz.sp2 = sphere_point(__ldg(trig + 2 * k2), __ldg(trig + 2 * k2 + 1), n2g);

  s.px = origin[3 * i];
  s.py = origin[3 * i + 1];
  s.pz = origin[3 * i + 2];
  s.dx = direction[3 * i];
  s.dy = direction[3 * i + 1];
  s.dz = direction[3 * i + 2];
  set_leg_terms(s);
  s.qx = s.qy = s.qz = s.pd = 0.0f;
  s.leg = s.cn = s.pn = s.nn = s.acc = s.it = s.still = 0;
}

__global__ void __launch_bounds__(kThreads)
    march_paths_kernel(const float* __restrict__ origin,
                       const float* __restrict__ direction,
                       const int32_t* __restrict__ nw,
                       const int32_t* __restrict__ iscal,
                       const float* __restrict__ fscal,
                       const float* __restrict__ trig,
                       const int32_t* __restrict__ hsub,
                       const int32_t* __restrict__ h3,
                       const int16_t* __restrict__ hc,
                       int32_t* __restrict__ meta_out,
                       float* __restrict__ pd_out, int n, int max_steps,
                       int seed, int legs, long long* __restrict__ census) {
  __shared__ Pyramid t;
  for (int k = threadIdx.x; k < kWords; k += blockDim.x) {
    t.h3[k] = h3[k];
    t.hsub[k] = hsub[k];
  }
  __syncthreads();

  Scalars c;
  c.r0x = iscal[0];
  c.r0y = iscal[1];
  c.lrx = (float)iscal[2];
  c.lry = (float)iscal[3];
  c.lrz = (float)iscal[4];
  c.maxh = iscal[5];
  c.seed = seed;
  c.legs = legs;
  const float sunx = fscal[0], suny = fscal[1], sunz = fscal[2];

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool live = i < n;
  Path s;
  Hoisted hz;
  if (live) start_path(i, s, hz, origin, direction, nw, trig, sunx, suny, sunz);
  // Every lane stays in the loop until its warp is done, so the warp runs
  // as many iterations as its lanes' most steps.
  while (__any_sync(kFullMask, live)) {
    if (!live) continue;
    // Budget spent: one more step without a move, so that completions from
    // the last move still count.
    const bool last = s.it == max_steps;
    step(s, t, hc, c, hz, !last);
    ++s.it;
    if (last || s.leg >= kLegDone) {
      meta_out[i] = s.leg | (s.cn << 3) | (s.pn << 6) | (s.nn << 9) | (s.acc << 12);
      pd_out[i] = s.pd;
      live = false;
    }
  }
  // The census, taken at exit: nothing in the loop counts for it.
  const bool path = i < n;
  add_census(census, __reduce_max_sync(kFullMask, path ? (unsigned)s.it : 0u),
             path ? (unsigned)(s.it - s.still) : 0u);
}

}  // namespace

extern "C" int rt_march_paths(const float* origin, const float* direction,
                              const int32_t* nw, const int32_t* iscal,
                              const float* fscal, const float* trig,
                              const int32_t* hsub, const int32_t* h3,
                              const int16_t* hcol,
                              int32_t* meta, float* pd, int n, int max_steps,
                              int seed, int legs, long long* census,
                              void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  march_paths_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      origin, direction, nw, iscal, fscal, trig, hsub, h3, hcol, meta, pd, n,
      max_steps, seed, legs, census);
  return (int)cudaGetLastError();
}
