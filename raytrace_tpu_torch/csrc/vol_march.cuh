// Brick-pyramid march code shared by kernel K3 (trace_vol.cu, every pixel's
// whole path) and kernel K3s (trace_rays_vol.cu, independent rays): the
// ray's per-leg move terms, the coarse step over the occupancy pyramid
// (trace_vol_pallas.py `_make_vol_kernel`, :254-429), the move to the next
// step-aligned boundary, and the voxel test of one crossing of the in-brick
// march `resolve_mixed` (:437-579).  The plain PyTorch counterparts are
// `_coarse`, `_nearest` and `_resolve` in ops/trace_vol.py; all are built
// with --fmad=false, so every multiply and add rounds separately, as
// PyTorch computes them.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN = 256;
constexpr float kHalf = 128.0f;
constexpr int kNB = 32;
constexpr int kWords8 = 1024;
constexpr int kWordsHi = 256;
constexpr int kDetailWords = 16;
constexpr float kEps = 1e-4f;

constexpr int kDone = 1, kAir = 2, kParked = 32;
constexpr int kMaxCrossings = 23;  // voxel crossings of one brick resolve

// The pyramid's packed bit tables (any8, all8, any_hi), in shared memory.
struct Tables {
  int32_t any8[kWords8], all8[kWords8], hi[kWordsHi];
};

// The region centre lr, the occupancy escape bounds and (K3) the camera
// origin.
struct Scalars {
  float lrx, lry, lrz;
  float bxmin, bxmax, bymin, bymax, bzmin, bzmax;
  float ox, oy, oz;
};

// A ray: position, normalized direction, the per-leg terms of a move
// (1/|v| and the sign multiplier per axis, the three entry-face normal ids
// packed 3 bits apart) and the entry-face normal of its last move.
struct Ray {
  float px, py, pz, vx, vy, vz;
  float lpx, lpy, lpz, mulx, muly, mulz;
  int32_t nids, normal;
};

// The pyramid tables copied into the block's shared memory, and the
// scalars (lr xyz, escape bounds xmin xmax ymin ymax zmin zmax) from the
// (10,) int32 iscal.  Every thread of the block must call it.
__device__ __forceinline__ void load_tables(Tables& t, Scalars& c,
                                            const int32_t* __restrict__ any8,
                                            const int32_t* __restrict__ all8,
                                            const int32_t* __restrict__ any_hi,
                                            const int32_t* __restrict__ iscal) {
  for (int k = threadIdx.x; k < kWords8; k += blockDim.x) {
    t.any8[k] = any8[k];
    t.all8[k] = all8[k];
  }
  for (int k = threadIdx.x; k < kWordsHi; k += blockDim.x) t.hi[k] = any_hi[k];
  __syncthreads();
  c.lrx = (float)iscal[0];
  c.lry = (float)iscal[1];
  c.lrz = (float)iscal[2];
  c.bxmin = (float)iscal[3];
  c.bxmax = (float)iscal[4];
  c.bymin = (float)iscal[5];
  c.bymax = (float)iscal[6];
  c.bzmin = (float)iscal[7];
  c.bzmax = (float)iscal[8];
}

__device__ __forceinline__ bool out_of_window(const Ray& r, const Scalars& c) {
  return fabsf(r.px - c.lrx) >= kHalf || fabsf(r.py - c.lry) >= kHalf ||
         fabsf(r.pz - c.lrz) >= kHalf;
}

__device__ __forceinline__ int32_t texel(float p) {
  return ((int32_t)floorf(p) + (int32_t)kHalf) & (kN - 1);
}

__device__ __forceinline__ int32_t brick_of(int32_t tx, int32_t ty, int32_t tz) {
  return ((tz >> 3) * kNB + (ty >> 3)) * kNB + (tx >> 3);
}

__device__ __forceinline__ int32_t bit(const int32_t* words, int32_t i) {
  return (words[i >> 5] >> (i & 31)) & 1;
}

// ops/rays.py normalize: v / sqrt(max(|v|^2, 1e-20)), then the leg's move
// terms: 1/|v| (inf on a zero axis), -1 where v > 0 else 1, and the normal
// id of a move along each axis.
__device__ __forceinline__ void set_direction(Ray& r, float dx, float dy,
                                              float dz) {
  float inv = 1.0f / sqrtf(fmaxf(dx * dx + dy * dy + dz * dz, 1e-20f));
  r.vx = dx * inv;
  r.vy = dy * inv;
  r.vz = dz * inv;
  r.lpx = 1.0f / fabsf(r.vx);
  r.lpy = 1.0f / fabsf(r.vy);
  r.lpz = 1.0f / fabsf(r.vz);
  r.mulx = r.vx > 0.0f ? -1.0f : 1.0f;
  r.muly = r.vy > 0.0f ? -1.0f : 1.0f;
  r.mulz = r.vz > 0.0f ? -1.0f : 1.0f;
  r.nids = (r.vx > 0.0f ? 1 : 0) | ((r.vy > 0.0f ? 3 : 2) << 3) |
           ((r.vz > 0.0f ? 5 : 4) << 6);
}

// (eps + mod((p + 128) * mul, m)) * lp, the floor modulo written as
// shifted - floor(shifted * inv_m) * m: for a power-of-two m (inv_m its
// exact reciprocal) both products are exact and the difference is the exact
// floor modulo rounded once, as torch.remainder rounds it (a zero may take
// the other sign, which kEps + absorbs).  p + 128 is 0 or at least 2^-17 in
// magnitude, so shifted * inv_m never underflows.
__device__ __forceinline__ float bdist(float p, float mul, float lp, float m,
                                       float inv_m) {
  float shifted = (p + kHalf) * mul;
  return (kEps + (shifted - floorf(shifted * inv_m) * m)) * lp;
}

// Move to the nearest boundary of the `step` grid (1, 8, 16, 32 or 64)
// along the ray, with the entry-face normal of the axis crossed
// (trace_vol_pallas.py:300-302, :378-389 and :531-540).
__device__ __forceinline__ void move_to_boundary(Ray& r, int32_t step) {
  const float m = (float)step;
  const float inv_m = __int_as_float((128 - __ffs(step)) << 23);  // 2^-log2(step)
  float lx = bdist(r.px, r.mulx, r.lpx, m, inv_m);
  float ly = bdist(r.py, r.muly, r.lpy, m, inv_m);
  float lz = bdist(r.pz, r.mulz, r.lpz, m, inv_m);
  bool use_x = (lx < ly) && (lx < lz);
  bool use_y = !(lx < ly) && (ly < lz);
  float lmin = use_x ? lx : (use_y ? ly : lz);
  r.normal = (r.nids >> (use_x ? 0 : (use_y ? 3 : 6))) & 7;
  r.px = r.px + r.vx * lmin;
  r.py = r.py + r.vy * lmin;
  r.pz = r.pz + r.vz * lmin;
}

// The classification of one coarse step (one iteration of the Pallas
// kernel's loop) at texel (tx, ty, tz) of brick b.  -> kDone | kAir (out of
// the window, or past the occupancy bounds moving away), kDone (an
// all-solid brick), kParked (a mixed brick), or 0 with `step` the size of
// the largest empty level to move by.
__device__ __forceinline__ int coarse_classify(const Ray& r, const Tables& t,
                                               const Scalars& c, int32_t tx,
                                               int32_t ty, int32_t tz,
                                               int32_t b, int32_t& step) {
  if (out_of_window(r, c)) return kDone | kAir;
  bool esc = (r.vx >= 0.0f && r.px >= c.bxmax) || (r.vx <= 0.0f && r.px < c.bxmin) ||
             (r.vy >= 0.0f && r.py >= c.bymax) || (r.vy <= 0.0f && r.py < c.bymin) ||
             (r.vz >= 0.0f && r.pz >= c.bzmax) || (r.vz <= 0.0f && r.pz < c.bzmin);
  if (esc) return kDone | kAir;
  if (bit(t.all8, b)) return kDone;
  if (bit(t.any8, b)) return kParked;
  if (!bit(t.hi, 192 * 32 + ((tz >> 6) * 4 + (ty >> 6)) * 4 + (tx >> 6))) {
    step = 64;
  } else if (!bit(t.hi, 128 * 32 + ((tz >> 5) * 8 + (ty >> 5)) * 8 + (tx >> 5))) {
    step = 32;
  } else if (!bit(t.hi, ((tz >> 4) * 16 + (ty >> 4)) * 16 + (tx >> 4))) {
    step = 16;
  } else {
    step = 8;
  }
  return 0;
}

// The voxel test of one crossing of resolve_mixed (:521-529): is voxel
// (tx, ty, tz), which lies in brick b0, solid?  One detail word, read
// through the read-only cache (the 2 MiB detail rows stay in L2).
__device__ __forceinline__ bool voxel_solid(const int32_t* __restrict__ detail,
                                            int32_t b0, int32_t tx, int32_t ty,
                                            int32_t tz) {
  int32_t v = ((tz & 7) << 6) | ((ty & 7) << 3) | (tx & 7);
  int32_t word = __ldg(detail + (size_t)b0 * kDetailWords + (v >> 5));
  return (word >> (v & 31)) & 1;
}

}  // namespace
