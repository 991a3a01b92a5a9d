// Kernel K1: the whole light path of every pixel, one thread per pixel.
//
// Replaces the Pallas TPU kernel raytrace_tpu/ops/lighting_pallas.py
// `_make_kernel` (:143-796), launched from `render_gbuffers_fused` (:930-959).
// Its plain PyTorch version is `march_paths_plain` in ops/lighting.py; the
// two run the same float32 operations in the same order (built with
// --fmad=false, so no multiply-add is contracted).
//
// Each thread walks primary -> sun1 -> dif1 -> sun2 -> dif2 (capped at
// `legs` rays) over the 2-D column-height pyramid of the streamed region.
// One step is the JAX unified body `body_u` (:495-572): classify from the
// packed h3/hsub words with the rising-ray rule, test the sky escape
// against maxh, evaluate the exact column height from the lattice-corner
// words (only where the pyramid says the step is fine), and either start
// the next leg (`apply_transition`, :315-388) or move to the nearest
// boundary (`bdist` with exact power-of-two reciprocals, :238-254; the fine
// z distance `lzf`, :563-568; `move`, :390-415).  The path has a budget of
// `max_steps` steps.  The TPU's sort cascade, step caps, unrolling, lazy
// transitions and lane-shuffle table lookups have no counterpart: a thread
// simply loops until its own path is done.
//
// What bounds it on Hopper: the step loop's integer and float ALU work and
// the divergence between neighbouring paths of very different length, not
// memory.  The six 1,024-word tables (24 KB) sit in shared memory, loaded
// once per block, and each pixel reads about 48 bytes (origin, direction,
// noise word) and writes 8 (meta word and primary distance).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRegion = 256;
constexpr float kHalf = 128.0f;
constexpr int kWords = 1024;
constexpr float kEps = 1e-4f;
constexpr int kLegDone = 5;
constexpr int kThreads = 128;

constexpr int32_t kHA = 374761393;
constexpr int32_t kHB = 668265263;
constexpr int32_t kHZ = -1262997521;
constexpr uint32_t kHSeed = 1440662683u;
constexpr int32_t kHMix = 1274126177;

// float32 values of the JAX package's constants (lacunarity^5 * 2,
// persistence^5, sqrt 2, 2 pi), written exactly.
constexpr float kTopFreq = 0x1.42642p+6f;
constexpr float kTopAmp = 0.03125f;
constexpr float kSqrt2 = 0x1.6a09e6p+0f;
constexpr float kTwoPi = 0x1.921fb6p+2f;

// int32 arithmetic that wraps, through uint32: signed overflow is
// undefined in C++.
__device__ __forceinline__ int32_t wmul(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a * (uint32_t)b);
}
__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int32_t seed_term(int32_t seed) {
  return (int32_t)((uint32_t)seed * kHSeed);
}
__device__ __forceinline__ int32_t mix(int32_t h) {
  h = wmul(h ^ (h >> 13), kHMix);  // >> on int32 is arithmetic
  return h ^ (h >> 16);
}

__device__ __forceinline__ float grad_dot(int32_t hv, float dx, float dy) {
  int h = hv & 7;
  float u = h < 6 ? ((h & 1) == 0 ? dx : -dx) : 0.0f;
  float v = h < 4 ? ((h & 2) == 0 ? dy : -dy)
                  : (h >= 6 ? ((h & 1) == 0 ? dy : -dy) : 0.0f);
  return u + v;
}

// world/noise.py perlin2
__device__ float perlin2(float x, float y, int32_t seed) {
  float x0 = floorf(x), y0 = floorf(y);
  int32_t xi = (int32_t)x0, yi = (int32_t)y0;
  float xf = x - x0, yf = y - y0;
  float u = xf * xf * xf * (xf * (xf * 6.0f - 15.0f) + 10.0f);
  float v = yf * yf * yf * (yf * (yf * 6.0f - 15.0f) + 10.0f);
  int32_t hb = wadd(wadd(wmul(xi, kHA), wmul(yi, kHB)), seed_term(seed));
  float n00 = grad_dot(mix(hb), xf, yf);
  float n10 = grad_dot(mix(wadd(hb, kHA)), xf - 1.0f, yf);
  float n01 = grad_dot(mix(wadd(hb, kHB)), xf, yf - 1.0f);
  float n11 = grad_dot(mix(wadd(hb, kHA + kHB)), xf - 1.0f, yf - 1.0f);
  float nx0 = n00 + u * (n10 - n00);
  float nx1 = n01 + u * (n11 - n01);
  float n = nx0 + v * (nx1 - nx0);
  return n * kSqrt2;
}

// ops/hf_tables.py height_from_corners (world/heightmap.py
// dequant_lattice + height_from_lattice).
__device__ int32_t height_from_corners(int32_t ca, int32_t cb, int32_t cc,
                                       int32_t cd, int32_t xi, int32_t yi,
                                       int32_t seed) {
  float tx = (float)(xi & 7) * 0.125f;
  float ty = (float)(yi & 7) * 0.125f;
  const int32_t w[4] = {ca, cb, cc, cd};
  float r[4], e[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    r[k] = -4.0f + (float)(w[k] & 0xFFFF) * 0x1p-13f;
    e[k] = -2.0f + (float)((w[k] >> 16) & 0xFFFF) * 0x1p-14f;
  }
  float rt = r[0] + tx * (r[1] - r[0]);
  float rb = r[2] + tx * (r[3] - r[2]);
  float rr = rt + ty * (rb - rt);
  float et = e[0] + tx * (e[1] - e[0]);
  float eb = e[2] + tx * (e[3] - e[2]);
  float ee = et + ty * (eb - et);
  float fx = (float)xi / 600.0f;
  float fy = (float)yi / 600.0f;
  float q = 1.0f + perlin2(fx * kTopFreq, fy * kTopFreq, seed + 5) * kTopAmp;
  float base = rr * q * 0.5f + 0.5f;
  float eroded = base + ee;
  float n = eroded >= 0.0f ? powf(fabsf(eroded) / 1.5f, 2.6f) : 0.0f;
  float h = n * 120.0f + 10.0f;
  return (int32_t)floorf(h);
}

// lighting_pallas._mat_code: world/generate.py material_band of the
// voxel's hash as a 2-bit code (1 grass, 2 rock, 3 snow).
__device__ int32_t mat_code(int32_t xi, int32_t yi, int32_t zi, int32_t seed) {
  int32_t h = wadd(wadd(wmul(xi, kHA), wmul(yi, kHB)), wmul(zi, kHZ));
  h = wadd(h, seed_term(seed + 1));
  h = mix(h);
  uint32_t bits = (uint32_t)h;
  int32_t r60 = (int32_t)(bits % 60u);
  int32_t r80 = (int32_t)(bits % 80u);
  int32_t mid = r60 < zi - 20 ? 5 : 2;
  int32_t high = r80 < zi - 80 ? 6 : 5;
  int32_t band = zi < 20 ? 2 : (zi < 80 ? mid : (zi < 160 ? high : 6));
  return band == 2 ? 1 : (band == 5 ? 2 : 3);
}

struct Vec3 {
  float x, y, z;
};

__device__ __forceinline__ Vec3 face_normal(int32_t id) {
  float sign = (id % 2 == 0) ? 1.0f : -1.0f;
  int32_t axis = id / 2;
  return {axis == 0 ? sign : 0.0f, axis == 1 ? sign : 0.0f,
          axis == 2 ? sign : 0.0f};
}

__device__ __forceinline__ Vec3 norm3(float x, float y, float z) {
  float inv = 1.0f / sqrtf(fmaxf(x * x + y * y + z * z, 1e-20f));
  return {x * inv, y * inv, z * inv};
}

// ops/shading.py sphere_point
__device__ __forceinline__ Vec3 sphere_point(float nr, float ng) {
  float theta1 = kTwoPi * nr;
  float cos_t2 = fminf(fmaxf(1.0f - 2.0f * ng, -1.0f), 1.0f);
  float sin_t2 = sqrtf(fmaxf(1.0f - cos_t2 * cos_t2, 0.0f));
  return {sinf(theta1) * sin_t2, cosf(theta1) * sin_t2, cos_t2};
}

// ops/shading.py diffuse_from_sphere, with its degenerate guard.
__device__ __forceinline__ Vec3 diffuse_from_sphere(Vec3 sp, int32_t id) {
  Vec3 n = face_normal(id);
  float dx = sp.x + n.x, dy = sp.y + n.y, dz = sp.z + n.z;
  float norm = sqrtf(dx * dx + dy * dy + dz * dz);
  if (norm < 1e-6f) return n;
  norm = fmaxf(norm, 1e-20f);
  return {dx / norm, dy / norm, dz / norm};
}

__device__ __forceinline__ float bdist(float p, float mul, float lp,
                                      float step_f, float inv_step) {
  float shifted = (p + kHalf) * mul;
  float m = shifted - floorf(shifted * inv_step) * step_f;
  return (kEps + m) * lp;
}

struct Tables {
  int32_t h3[kWords], hsub[kWords], ca[kWords], cb[kWords], cc[kWords],
      cd[kWords];
};

struct Path {
  float px, py, pz, dx, dy, dz, qx, qy, qz, pd;
  int32_t leg, cn, pn, nn, acc;
};

struct Scalars {
  int32_t r0x, r0y, maxh, seed, legs;
  float lrx, lry, lrz;
};

struct Hoisted {
  Vec3 sj1, sj2, sp1, sp2;
};

// One step of the path.  Returns with the path either transitioned (its
// ray completed: air out of the region or by the sky-escape rule, or a hit
// inside a column) or, when `allow_move`, moved to the next boundary.
__device__ void step(Path& s, const Tables& t, const Scalars& c,
                     const Hoisted& hz, bool allow_move) {
  int32_t xi = (int32_t)floorf(s.px);
  int32_t yi = (int32_t)floorf(s.py);
  int32_t zi = (int32_t)floorf(s.pz);
  int32_t rx = min(max(xi - c.r0x, 0), kRegion - 1);
  int32_t ry = min(max(yi - c.r0y, 0), kRegion - 1);
  int32_t i3 = (ry >> 3) * 32 + (rx >> 3);
  int32_t w = t.h3[i3];
  int32_t h8 = w & 511;
  // Rising rays compare the voxel itself, not the aligned slab floor.
  bool up = s.dz >= 0.0f;
  int32_t z32 = up ? zi : (zi & ~31);
  int32_t z16 = up ? zi : (zi & ~15);
  int32_t z8 = up ? zi : (zi & ~7);
  int32_t z4 = up ? zi : (zi & ~3);
  int32_t stp = z32 >= ((w >> 18) & 511)   ? 32
                : z16 >= ((w >> 9) & 511) ? 16
                : z8 >= h8                ? 8
                                          : 0;
  if (stp == 0) {
    int32_t quad = (((ry >> 2) & 1) << 1) | ((rx >> 2) & 1);
    int32_t delta = (t.hsub[i3] >> (quad << 3)) & 255;
    if (z4 >= h8 - delta) stp = 4;
  }
  bool fine = stp == 0;
  bool oob = fabsf(s.px - c.lrx) >= kHalf || fabsf(s.py - c.lry) >= kHalf ||
             fabsf(s.pz - c.lrz) >= kHalf || (up && zi >= c.maxh);
  int32_t hcol = 0;
  bool hit = false;
  if (!oob && fine) {
    hcol = max(height_from_corners(t.ca[i3], t.cb[i3], t.cc[i3], t.cd[i3], xi,
                                   yi, c.seed),
               0);
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
    }
    s.leg = next;
    return;
  }
  if (!allow_move) return;

  float step_f = (float)max(stp, 1);
  float inv_step = stp == 32 ? 0.03125f
                   : stp == 16 ? 0.0625f
                   : stp == 8  ? 0.125f
                   : stp == 4  ? 0.25f
                               : 1.0f;
  float mulx = s.dx > 0.0f ? -1.0f : 1.0f;
  float muly = s.dy > 0.0f ? -1.0f : 1.0f;
  float mulz = s.dz > 0.0f ? -1.0f : 1.0f;
  float lpx = 1.0f / fabsf(s.dx);
  float lpy = 1.0f / fabsf(s.dy);
  float lpz = 1.0f / fabsf(s.dz);
  float lx, ly, lz;
  if (fine) {
    lx = bdist(s.px, mulx, lpx, 1.0f, 1.0f);
    ly = bdist(s.py, muly, lpy, 1.0f, 1.0f);
    float ztop = (float)hcol;
    lz = (s.dz < 0.0f && s.pz >= ztop) ? (kEps + (s.pz - ztop)) * lpz
                                       : __int_as_float(0x7f800000);
  } else {
    lx = bdist(s.px, mulx, lpx, step_f, inv_step);
    ly = bdist(s.py, muly, lpy, step_f, inv_step);
    lz = bdist(s.pz, mulz, lpz, step_f, inv_step);
  }
  bool use_x = (lx < ly) && (lx < lz);
  bool use_y = !(lx < ly) && (ly < lz);
  float lmin = use_x ? lx : (use_y ? ly : lz);
  s.cn = use_x ? (s.dx > 0.0f ? 1 : 0)
                : (use_y ? (s.dy > 0.0f ? 3 : 2) : (s.dz > 0.0f ? 5 : 4));
  s.px = s.px + s.dx * lmin;
  s.py = s.py + s.dy * lmin;
  s.pz = s.pz + s.dz * lmin;
  if (s.leg == 0) s.pd = s.pd + lmin;
}

__global__ void __launch_bounds__(kThreads)
    march_paths_kernel(const float* __restrict__ origin,
                       const float* __restrict__ direction,
                       const int32_t* __restrict__ nw,
                       const int32_t* __restrict__ iscal,
                       const float* __restrict__ fscal,
                       const int32_t* __restrict__ hsub,
                       const int32_t* __restrict__ h3,
                       const int32_t* __restrict__ ca,
                       const int32_t* __restrict__ cb,
                       const int32_t* __restrict__ cc,
                       const int32_t* __restrict__ cd,
                       int32_t* __restrict__ meta_out,
                       float* __restrict__ pd_out, int n, int max_steps,
                       int seed, int legs) {
  __shared__ Tables t;
  for (int k = threadIdx.x; k < kWords; k += blockDim.x) {
    t.h3[k] = h3[k];
    t.hsub[k] = hsub[k];
    t.ca[k] = ca[k];
    t.cb[k] = cb[k];
    t.cc[k] = cc[k];
    t.cd[k] = cd[k];
  }
  __syncthreads();
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  Scalars c;
  c.r0x = iscal[0];
  c.r0y = iscal[1];
  c.lrx = (float)iscal[2];
  c.lry = (float)iscal[3];
  c.lrz = (float)iscal[4];
  c.maxh = iscal[5];
  c.seed = seed;
  c.legs = legs;
  float sunx = fscal[0], suny = fscal[1], sunz = fscal[2];

  // Per-pixel noise, exact k/255 from the packed bytes.
  int32_t word = nw[i];
  float n1r = (float)(word & 255) / 255.0f;
  float n1g = (float)((word >> 8) & 255) / 255.0f;
  float n2r = (float)((word >> 16) & 255) / 255.0f;
  float n2g = (float)((word >> 24) & 255) / 255.0f;
  Hoisted hz;
  hz.sj1 = norm3(sunx + n1r * 0.05f, suny + n1g * 0.05f, sunz);
  hz.sj2 = norm3(sunx + n2r * 0.05f, suny + n2g * 0.05f, sunz);
  hz.sp1 = sphere_point(n1r, n1g);
  hz.sp2 = sphere_point(n2r, n2g);

  Path s;
  s.px = origin[3 * i];
  s.py = origin[3 * i + 1];
  s.pz = origin[3 * i + 2];
  s.dx = direction[3 * i];
  s.dy = direction[3 * i + 1];
  s.dz = direction[3 * i + 2];
  s.qx = s.qy = s.qz = s.pd = 0.0f;
  s.leg = s.cn = s.pn = s.nn = s.acc = 0;

  for (int it = 0; it < max_steps && s.leg < kLegDone; ++it) {
    step(s, t, c, hz, true);
  }
  // Budget spent: completions from the last move still count.
  if (s.leg < kLegDone) step(s, t, c, hz, false);

  meta_out[i] = s.leg | (s.cn << 3) | (s.pn << 6) | (s.nn << 9) | (s.acc << 12);
  pd_out[i] = s.pd;
}

}  // namespace

extern "C" int rt_march_paths(const float* origin, const float* direction,
                              const int32_t* nw, const int32_t* iscal,
                              const float* fscal, const int32_t* hsub,
                              const int32_t* h3, const int32_t* ca,
                              const int32_t* cb, const int32_t* cc,
                              const int32_t* cd, int32_t* meta, float* pd,
                              int n, int max_steps, int seed, int legs,
                              void* stream) {
  if (n <= 0) return 0;
  int blocks = (n + kThreads - 1) / kThreads;
  march_paths_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      origin, direction, nw, iscal, fscal, hsub, h3, ca, cb, cc, cd, meta, pd,
      n, max_steps, seed, legs);
  return (int)cudaGetLastError();
}
