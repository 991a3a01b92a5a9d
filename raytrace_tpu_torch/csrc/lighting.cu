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
// simply loops until its own path is done.  The world math, the pyramid
// classification and `bdist` live in heightfield.cuh, shared with K4.
//
// What bounds it on Hopper: the step loop's integer and float ALU work and
// the divergence between neighbouring paths of very different length, not
// memory.  The six 1,024-word tables (24 KB) sit in shared memory, loaded
// once per block, and each pixel reads about 48 bytes (origin, direction,
// noise word) and writes 8 (meta word and primary distance).

#include "heightfield.cuh"

namespace {

constexpr int kLegDone = 5;
constexpr int kThreads = 128;

// lighting_pallas._mat_code: the voxel's material band as a 2-bit code
// (1 grass, 2 rock, 3 snow).
__device__ int32_t mat_code(int32_t xi, int32_t yi, int32_t zi, int32_t seed) {
  int32_t band = material_band(xi, yi, zi, seed);
  return band == 2 ? 1 : (band == 5 ? 2 : 3);
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
  int32_t rx, ry;
  int32_t i3 = block_index(xi, yi, c.r0x, c.r0y, rx, ry);
  bool up = s.dz >= 0.0f;
  int32_t stp = pyramid_step(t, i3, rx, ry, zi, up);
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
  float inv_step = step_reciprocal(stp);
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
  load_tables(t, h3, hsub, ca, cb, cc, cd);
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
