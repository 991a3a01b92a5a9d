// Kernel K3: the volume_fast light path of every pixel, one thread per pixel.
//
// Replaces the Pallas TPU kernel raytrace_tpu/ops/trace_vol_pallas.py
// `_make_vol_kernel` (:254-429) together with the XLA work the JAX package
// runs around it in every round of path_vol.render_gbuffers_path: the
// in-brick voxel march `resolve_mixed` (trace_vol_pallas.py:437-579) and the
// leg transition `_transition` (path_vol.py:161-302).  Its plain PyTorch
// version is `march_paths_vol_plain` in ops/trace_vol.py; the two run the
// same float32 operations in the same order (built with --fmad=false, so no
// multiply-add is contracted).
//
// Each thread loops over its own path until it is done or its budget is
// spent: a coarse step over the brick pyramid (escape and window tests,
// hit in an all-solid brick, park in a mixed brick, else move to the
// nearest 8/16/32/64-aligned boundary); for a parked ray, the voxel march
// through that brick's 16-word detail row (at most 23 crossings); for a
// completed ray, the leg transition (primary -> sun1 -> dif1 -> sun2 ->
// dif2).  The TPU's rounds, step caps, slotted views and state trimming
// have no counterpart.
//
// What bounds it on Hopper: the per-step integer and float ALU work and the
// divergence between neighbouring paths of very different length, then the
// detail-row reads.  The pyramid tables (any8, all8, any_hi: 9 KB) sit in
// shared memory, loaded once per block; the 2 MiB detail table is read from
// global memory through the read-only path and stays in the 50 MB L2.  Each
// pixel reads 72 bytes of rays and invariants and writes 16.

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
constexpr int kThreads = 128;
constexpr int kInv = 12;

constexpr int kDone = 1, kAir = 2, kParked = 32;
constexpr int kLegShift = 6;
constexpr int kLegDone = 5;
constexpr int kPrimNormalShift = 9;
constexpr int kDif1NormalShift = 12;
constexpr int kSkyShift = 15;
constexpr int kMaxCrossings = 23;

struct Tables {
  int32_t any8[kWords8], all8[kWords8], hi[kWordsHi];
};

struct Scalars {
  float lrx, lry, lrz;
  float bxmin, bxmax, bymin, bymax, bzmin, bzmax;
  float ox, oy, oz;
  int legs;
};

// A ray's position, its normalized direction and its entry-face normal.
struct Ray {
  float px, py, pz, vx, vy, vz;
  int32_t normal;
};

// torch.remainder / jnp.mod for float32: the exact fmodf, then the sign
// fix that makes the result take the sign of the divisor.
__device__ __forceinline__ float floor_mod(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) m += b;
  return m;
}

__device__ __forceinline__ bool out_of_window(float px, float py, float pz,
                                              const Scalars& c) {
  return fabsf(px - c.lrx) >= kHalf || fabsf(py - c.lry) >= kHalf ||
         fabsf(pz - c.lrz) >= kHalf;
}

__device__ __forceinline__ int32_t texel(float p) {
  return ((int32_t)floorf(p) + (int32_t)kHalf) & (kN - 1);
}

__device__ __forceinline__ int32_t bit(const int32_t* words, int32_t i) {
  return (words[i >> 5] >> (i & 31)) & 1;
}

// ops/rays.py normalize: v / sqrt(max(|v|^2, 1e-20)).
__device__ __forceinline__ void set_direction(Ray& r, float dx, float dy,
                                              float dz) {
  float inv = 1.0f / sqrtf(fmaxf(dx * dx + dy * dy + dz * dz, 1e-20f));
  r.vx = dx * inv;
  r.vy = dy * inv;
  r.vz = dz * inv;
}

// Move to the nearest boundary of the `modulus` grid along the ray, with
// the entry-face normal of the axis crossed (trace_vol_pallas.py:300-302,
// :378-389 and :531-540).
__device__ __forceinline__ void move_to_boundary(Ray& r, float modulus) {
  float mulx = r.vx > 0.0f ? -1.0f : 1.0f;
  float muly = r.vy > 0.0f ? -1.0f : 1.0f;
  float mulz = r.vz > 0.0f ? -1.0f : 1.0f;
  float lx = (kEps + floor_mod((r.px + kHalf) * mulx, modulus)) * (1.0f / fabsf(r.vx));
  float ly = (kEps + floor_mod((r.py + kHalf) * muly, modulus)) * (1.0f / fabsf(r.vy));
  float lz = (kEps + floor_mod((r.pz + kHalf) * mulz, modulus)) * (1.0f / fabsf(r.vz));
  bool use_x = (lx < ly) && (lx < lz);
  bool use_y = !(lx < ly) && (ly < lz);
  float lmin = use_x ? lx : (use_y ? ly : lz);
  r.normal = use_x ? (r.vx > 0.0f ? 1 : 0)
                   : (use_y ? (r.vy > 0.0f ? 3 : 2) : (r.vz > 0.0f ? 5 : 4));
  r.px = r.px + r.vx * lmin;
  r.py = r.py + r.vy * lmin;
  r.pz = r.pz + r.vz * lmin;
}

// One coarse step of the brick-pyramid march (one iteration of the Pallas
// kernel's loop).  Returns 0 (moved, still live), kDone (hit in an
// all-solid brick), kDone | kAir, or kParked (entered a mixed brick).
__device__ int coarse_step(Ray& r, const Tables& t, const Scalars& c) {
  if (out_of_window(r.px, r.py, r.pz, c)) return kDone | kAir;
  bool esc = (r.vx >= 0.0f && r.px >= c.bxmax) || (r.vx <= 0.0f && r.px < c.bxmin) ||
             (r.vy >= 0.0f && r.py >= c.bymax) || (r.vy <= 0.0f && r.py < c.bymin) ||
             (r.vz >= 0.0f && r.pz >= c.bzmax) || (r.vz <= 0.0f && r.pz < c.bzmin);
  if (esc) return kDone | kAir;
  int32_t tx = texel(r.px), ty = texel(r.py), tz = texel(r.pz);
  int32_t b = ((tz >> 3) * kNB + (ty >> 3)) * kNB + (tx >> 3);
  if (bit(t.all8, b)) return kDone;
  if (bit(t.any8, b)) return kParked;
  int32_t step;
  if (!bit(t.hi, 192 * 32 + ((tz >> 6) * 4 + (ty >> 6)) * 4 + (tx >> 6))) {
    step = 64;
  } else if (!bit(t.hi, 128 * 32 + ((tz >> 5) * 8 + (ty >> 5)) * 8 + (tx >> 5))) {
    step = 32;
  } else if (!bit(t.hi, ((tz >> 4) * 16 + (ty >> 4)) * 16 + (tx >> 4))) {
    step = 16;
  } else {
    step = 8;
  }
  move_to_boundary(r, (float)step);
  return out_of_window(r.px, r.py, r.pz, c) ? (kDone | kAir) : 0;
}

// The voxel march of a parked ray through its brick (resolve_mixed).
// Returns kDone (hit a solid voxel), kDone | kAir (left the window) or 0
// (left the brick, or 23 crossings: the coarse march resumes).
__device__ int resolve(Ray& r, const int32_t* __restrict__ detail,
                       const Scalars& c) {
  int32_t tx = texel(r.px), ty = texel(r.py), tz = texel(r.pz);
  int32_t b0 = ((tz >> 3) * kNB + (ty >> 3)) * kNB + (tx >> 3);
  int32_t words[kDetailWords];
  const int4* row = reinterpret_cast<const int4*>(detail + (size_t)b0 * kDetailWords);
#pragma unroll
  for (int k = 0; k < kDetailWords / 4; ++k) {
    int4 w = __ldg(row + k);
    words[4 * k] = w.x;
    words[4 * k + 1] = w.y;
    words[4 * k + 2] = w.z;
    words[4 * k + 3] = w.w;
  }
  for (int i = 0; i < kMaxCrossings; ++i) {
    tx = texel(r.px);
    ty = texel(r.py);
    tz = texel(r.pz);
    if (out_of_window(r.px, r.py, r.pz, c)) return kDone | kAir;
    if (((tz >> 3) * kNB + (ty >> 3)) * kNB + (tx >> 3) != b0) return 0;
    int32_t v = ((tz & 7) << 6) | ((ty & 7) << 3) | (tx & 7);
    int32_t word = 0;
#pragma unroll
    for (int k = 0; k < kDetailWords; ++k) word = (v >> 5) == k ? words[k] : word;
    if ((word >> (v & 31)) & 1) return kDone;
    move_to_boundary(r, 1.0f);
  }
  return 0;
}

// Per-path state besides the ray.
struct Path {
  int32_t meta, prim_lin, dif1_lin;
  float prim_dist, ax, ay, az;
};

__device__ __forceinline__ void face_normal(int32_t id, float& x, float& y,
                                            float& z) {
  float sign = (id % 2 == 0) ? 1.0f : -1.0f;
  int32_t axis = id / 2;
  x = axis == 0 ? sign : 0.0f;
  y = axis == 1 ? sign : 0.0f;
  z = axis == 2 ? sign : 0.0f;
}

// ops/shading.py diffuse_from_sphere, with its degenerate guard.
__device__ __forceinline__ void diffuse_from_sphere(const float* sp, int32_t id,
                                                    float& x, float& y, float& z) {
  float nx, ny, nz;
  face_normal(id, nx, ny, nz);
  float dx = sp[0] + nx, dy = sp[1] + ny, dz = sp[2] + nz;
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
// (`air`: reached sky, else hit at its position).  Starts the next leg,
// with entry normal 0, or marks the path done.
__device__ void transition(Ray& r, Path& s, bool air, const float* inv,
                           const Scalars& c) {
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
  if (c.legs == 1) {
    next = kLegDone;
  } else {
    if (leg == 2 && !air && c.legs >= 5) {
      m |= nrm << kDif1NormalShift;
      s.dif1_lin = lin;
    }
    next = leg == 0   ? (air ? kLegDone : 1)
           : leg == 1 ? 2
           : leg == 2 ? (air ? kLegDone : 3)
           : leg == 3 ? 4
                      : kLegDone;
    if (next >= c.legs) next = kLegDone;
  }
  s.meta = (m & ~(7 << kLegShift)) | (next << kLegShift);
  if (next == kLegDone) return;

  r.normal = 0;
  float dx, dy, dz;
  if (leg == 0 || leg == 2) {
    // sun1 / sun2 from the nudged hit, which anchors the next diffuse leg.
    const float* sd = inv + (leg == 0 ? 0 : 6);
    dx = sd[0];
    dy = sd[1];
    dz = sd[2];
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
                           int legs) {
  __shared__ Tables t;
  for (int k = threadIdx.x; k < kWords8; k += blockDim.x) {
    t.any8[k] = any8[k];
    t.all8[k] = all8[k];
  }
  for (int k = threadIdx.x; k < kWordsHi; k += blockDim.x) t.hi[k] = any_hi[k];
  __syncthreads();
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  Scalars c;
  c.lrx = (float)iscal[0];
  c.lry = (float)iscal[1];
  c.lrz = (float)iscal[2];
  c.bxmin = (float)iscal[3];
  c.bxmax = (float)iscal[4];
  c.bymin = (float)iscal[5];
  c.bymax = (float)iscal[6];
  c.bzmin = (float)iscal[7];
  c.bzmax = (float)iscal[8];
  c.ox = fscal[0];
  c.oy = fscal[1];
  c.oz = fscal[2];
  c.legs = legs;

  float inv[kInv];
#pragma unroll
  for (int k = 0; k < kInv; ++k) inv[k] = inv_in[(size_t)kInv * i + k];

  Ray r;
  r.px = origin[3 * i];
  r.py = origin[3 * i + 1];
  r.pz = origin[3 * i + 2];
  r.normal = 0;
  set_direction(r, direction[3 * i], direction[3 * i + 1], direction[3 * i + 2]);
  Path s;
  s.meta = 0;
  s.prim_lin = -1;
  s.dif1_lin = -1;
  s.prim_dist = 0.0f;
  s.ax = s.ay = s.az = 0.0f;

  int coarse_left = budget, bricks_left = budget;
  while (((s.meta >> kLegShift) & 7) < kLegDone) {
    if (coarse_left == 0) break;
    --coarse_left;
    int status = coarse_step(r, t, c);
    if (status == kParked) {
      if (bricks_left == 0) break;
      --bricks_left;
      status = resolve(r, detail, c);
    }
    if (status & kDone) transition(r, s, (status & kAir) != 0, inv, c);
  }

  meta_out[i] = s.meta;
  prim_lin_out[i] = s.prim_lin;
  dif1_lin_out[i] = s.dif1_lin;
  prim_dist_out[i] = s.prim_dist;
}

}  // namespace

extern "C" int rt_march_paths_vol(const float* origin, const float* direction,
                                  const float* inv, const int32_t* iscal,
                                  const float* fscal, const int32_t* any8,
                                  const int32_t* all8, const int32_t* any_hi,
                                  const int32_t* detail, int32_t* meta,
                                  int32_t* prim_lin, int32_t* dif1_lin,
                                  float* prim_dist, int n, int budget, int legs,
                                  void* stream) {
  if (n <= 0) return 0;
  int blocks = (n + kThreads - 1) / kThreads;
  march_paths_vol_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      origin, direction, inv, iscal, fscal, any8, all8, any_hi, detail, meta,
      prim_lin, dif1_lin, prim_dist, n, budget, legs);
  return (int)cudaGetLastError();
}
