// Kernel R1: a frame's primary rays, per-pixel noise and march scalars,
// one launch.
//
// Replaces the XLA-fused front of the JAX frame programs, which XLA fuses
// into a few loops inside one jitted dispatch and which the port ran as
// dozens of PyTorch operations: the camera rays of
// raytrace_tpu/ops/trace_jax.py `camera_rays` (:168-191, with its `below`
// clause), the frame noise's offset, roll and tile
// (raytrace_tpu/ops/lighting_pallas.py:849-858 in `render_gbuffers_fused`,
// trace_jax.py `frame_noise` :220-265 in `render_gbuffers_path`), and the
// scalars of the march: the sun and its colour, `fscal` and `iscal`
// (lighting_pallas.py:860-899; raytrace_tpu/ops/path_vol.py:373-392 and
// :437-440).  It is not a Pallas kernel.  Its plain PyTorch version is
// `frame_rays_plain` in ops/rays.py; both run the same float32 operations
// in the same order (built with --fmad=false), so every output is the
// plain version's bit for bit.
//
// Four forms, one per frame program (ops/rays.py FORMS, in that order):
//  - fused (K1 reads it): origin and direction (N, 3) f32 and the packed
//    noise word `nw` (N,) int32 (the four noise bytes K1 and S1 rebuild as
//    k / 255); `sun` (8,) f32 = sun xyz, sunlight rgb, 0, 0 (K1's fscal);
//    `iscal` (8,) int32 = r0 xy, lr xyz, maxh (the max of h3 & 511 over
//    the region's 1024 pyramid words), 0, 0.
//  - volume_fast (K3 reads it): origin and direction, and the invariants
//    `inv` (N, 12) f32: the jittered sun directions and unit-sphere points
//    sd1, sp1, sd2, sp2 of the two noise texels; `sun` as above; `fscal`
//    (4,) f32 = camera origin, 0; `iscal` (10,) int32 = lr xyz, the
//    occupancy bounds of ops/vol_tables.py `occupancy_world_bounds` (from
//    any8b, (32, 32, 32) bool), 0.  The staged volume frame (K3s, P1, S2)
//    reads it too: its `iscal` is K3s's scalars with the escape bounds.
//  - hf (K4, P1 and S2 read it, the staged heightfield frame): the fused
//    form's origin, direction, `nw` and `sun`, with K4's `iscal` (8,)
//    int32 = r0 xy, lr xyz, and the packed grass, rock and snow words of
//    the material bands (launch arguments), in place of maxh.
//  - dda (D1, P1 and S2 read it, the exact DDA's frame): origin,
//    direction, `nw` and `sun` alone.  The exact DDA reads no tables, so
//    this form reads none and writes no march scalars: D1 reads lr from
//    the uniforms.
// Pixels are image rows row0 .. row0 + rows of a width x height frame, one
// thread each in the grid's blocks 1 ..; a band's values are the whole
// frame's rows.  Block 0 writes the frame scalars (the sun, and the
// reduction over h3 or any8b) while the pixels' blocks run: in the grid's last block, a
// chain of byte loads and serial bounds would trail the grid (PERF.md §6).
// The uniforms, the texture and the tables are read on the device: no host
// value enters the launch, and the kernel sits inside the frame's CUDA
// graph.
//
// The sphere points' sin and cos come from the 256-entry table of
// ops/shading.py `sphere_trig` at the texel's byte k = rint(v * 255): the
// texture holds exact k / 255 values (utils/blue_noise.py), so the table's
// angle is the plain version's.  The sun's own sinf and cosf are the
// functions PyTorch's `torch.sin`/`torch.cos` call on a float32 tensor.
//
// What bounds it on the H100: the bytes it writes, 28 a pixel (fused) or
// 72 (volume_fast), and the two texel reads; its arithmetic is ~30 float
// operations a pixel (~120 with the invariants).  The scalars' block is
// a few microseconds of wide loads and warp reductions beside them.

#include "shading.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kNB = 32;  // bricks per side of the occupancy tables
constexpr int32_t kBig = 1 << 30;
constexpr int kInv = 12;        // invariants a pixel
constexpr int kInvStride = 13;  // their stride in shared memory: no bank conflicts
// The forms, as ops/rays.py FORMS orders them.
constexpr int kFused = 0, kVolume = 1, kHf = 2, kDda = 3;

struct FrameRaysArgs {
  // the uniforms: camera origin, forward, up, right (3,) f32 each, the sun
  // angle () f32, the frame seed () int32, the region centre lr (3,) f32
  const float *cam, *forward, *up, *right, *sun_angle;
  const int32_t* seed;
  const float* lr;
  const float* blue;  // (nh, nw, nch) f32 texture
  const float* trig;  // (256, 2) f32 sphere-point sin and cos
  const int32_t *h3, *r0;  // fused, hf: the region's pyramid words and r0
  const uint8_t* any8b;    // volume_fast: the occupied 8-bricks
  float *origin, *direction;
  int32_t* nw;  // fused, hf, dda
  float* inv;   // volume_fast
  int32_t* iscal;  // all but dda
  float* fscal;  // volume_fast
  float* sun;
  int width, height, row0, rows, nh, nwid, nch;
  int form;                   // kFused, kVolume, kHf or kDda
  int32_t grass, rock, snow;  // the hf form's packed band words
};

// Python's // and % for a positive divisor (torch.floor_divide and
// torch.remainder on integers).
__device__ __forceinline__ int32_t floordiv(int32_t a, int32_t b) {
  int32_t q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}
__device__ __forceinline__ int32_t pymod(int32_t a, int32_t b) {
  int32_t r = a % b;
  return r < 0 ? r + b : r;
}

// rays.py `_byte`: round half to even of v * 255.
__device__ __forceinline__ uint32_t byte_of(float v) {
  return (uint32_t)(int32_t)rintf(v * 255.0f);
}

// vol_tables.occupancy_world_bounds along one axis, by one warp, lane bt
// for brick slot bt: the world extent [min, max) of the occupied slots
// `occ` (bit bt: slot bt) in the window [lr - 128, lr + 128); a slot that
// straddles the wrap gives both of its pieces.  Integer minima and maxima,
// so the order of the lanes is free.
__device__ __forceinline__ int2 axis_bounds(uint32_t occ, int32_t lr, int lane) {
  const unsigned all = 0xffffffffu;
  const int32_t lo = lr - 128, hi = lo + 256;
  const bool occupied = ((occ >> lane) & 1u) != 0u;
  const int32_t w0 = pymod(8 * lane - lr, 256) + lo;
  const int32_t rem = w0 + 8 - hi;
  const bool wraps = occupied && rem > 0;
  int32_t mn = __reduce_min_sync(all, occupied ? w0 : kBig);
  const int32_t mx = __reduce_max_sync(all, occupied ? min(w0 + 8, hi) : -kBig);
  const int32_t wmx = __reduce_max_sync(all, wraps ? lo + rem : -kBig);
  if (__any_sync(all, wraps)) mn = min(mn, lo);
  return make_int2(mn, max(mx, wmx));
}

// Bit b (0-3) set where byte b of `w` is not 0.
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t w) {
  const uint32_t high = (((w & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | w) & 0x80808080u;
  return (((high >> 7) * 0x00204081u) >> 21) & 0xFu;
}

// The frame scalars, by the grid's first block, so that they overlap the
// pixels' blocks instead of trailing them.  Its loads are 16 bytes wide and
// independent, with no branch between them: the fused form's 1,024 h3
// words are one load a thread, the volume form's 32 KB of any8b eight.  Warp
// reductions and shared-memory ORs combine them, and one warp per axis
// takes the occupancy bounds.
__device__ void frame_scalars(const FrameRaysArgs& a) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kOccLoads = kNB * kNB * kNB / 16 / kThreads;
  static_assert(kWords == 4 * kThreads && kOccLoads * 16 * kThreads == kNB * kNB * kNB,
                "one int4 of h3 a thread, kOccLoads uint4 of any8b");
  __shared__ uint32_t occ[3];
  __shared__ int32_t warp_max[kWarps];
  const unsigned all = 0xffffffffu;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const bool fused = a.form == kFused;
  const bool volume = a.form == kVolume;
  if (t < 3) occ[t] = 0u;
  __syncthreads();
  if (fused) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(a.h3) + t);
    const int32_t m = max(max(v.x & 511, v.y & 511), max(v.z & 511, v.w & 511));
    const int32_t wm = __reduce_max_sync(all, m);
    if (lane == 0) warp_max[warp] = wm;
  } else if (volume) {
    const uint4* words = reinterpret_cast<const uint4*>(a.any8b);
    uint4 v[kOccLoads];
#pragma unroll
    for (int m = 0; m < kOccLoads; ++m) v[m] = __ldg(words + t + m * kThreads);
    uint32_t ox = 0u, oy = 0u, oz = 0u;
#pragma unroll
    for (int m = 0; m < kOccLoads; ++m) {
      // Bytes 16q .. 16q + 15 are (bz, by, bx) = (q >> 6, (q >> 1) & 31,
      // 16 (q & 1) ..).
      const int q = t + m * kThreads;
      const uint32_t bits = nonzero_bytes(v[m].x) | (nonzero_bytes(v[m].y) << 4) |
                            (nonzero_bytes(v[m].z) << 8) | (nonzero_bytes(v[m].w) << 12);
      ox |= bits << (16 * (q & 1));
      const uint32_t any = bits != 0u ? 1u : 0u;
      oy |= any << ((q >> 1) & 31);
      oz |= any << (q >> 6);
    }
    ox = __reduce_or_sync(all, ox);
    oy = __reduce_or_sync(all, oy);
    oz = __reduce_or_sync(all, oz);
    if (lane == 0) {
      atomicOr(&occ[0], ox);
      atomicOr(&occ[1], oy);
      atomicOr(&occ[2], oz);
    }
  }
  __syncthreads();
  const int32_t lr[3] = {(int32_t)a.lr[0], (int32_t)a.lr[1], (int32_t)a.lr[2]};
  if (volume && warp < 3) {
    const int2 b =
        axis_bounds(occ[warp], warp == 0 ? lr[0] : (warp == 1 ? lr[1] : lr[2]), lane);
    if (lane == 0) {
      a.iscal[3 + 2 * warp] = b.x;
      a.iscal[4 + 2 * warp] = b.y;
    }
  }
  if (t != 0) return;
  Vec3 sun = sun_direction(*a.sun_angle);
  Vec3 light = sun_color(sun);
  const float sv[8] = {sun.x, sun.y, sun.z, light.x, light.y, light.z, 0.0f, 0.0f};
  for (int k = 0; k < 8; ++k) a.sun[k] = sv[k];
  if (a.form == kDda) return;
  if (a.form == kHf) {
    const int32_t iv[8] = {a.r0[0], a.r0[1], lr[0], lr[1], lr[2], a.grass, a.rock, a.snow};
    for (int k = 0; k < 8; ++k) a.iscal[k] = iv[k];
    return;
  }
  if (fused) {
    int32_t maxh = 0;
    for (int k = 0; k < kWarps; ++k) maxh = max(maxh, warp_max[k]);
    const int32_t iv[8] = {a.r0[0], a.r0[1], lr[0], lr[1], lr[2], maxh, 0, 0};
    for (int k = 0; k < 8; ++k) a.iscal[k] = iv[k];
    return;
  }
  for (int k = 0; k < 3; ++k) {
    a.iscal[k] = lr[k];
    a.fscal[k] = a.cam[k];
  }
  a.iscal[9] = 0;
  a.fscal[3] = 0.0f;
}

__global__ void __launch_bounds__(kThreads) frame_rays_kernel(const FrameRaysArgs a) {
  if (blockIdx.x == 0) {
    frame_scalars(a);
    return;
  }
  // The volume_fast form's invariants pass through shared memory, so that
  // the block's 12 KB of them leave in whole rows; its sun is computed once
  // a block.
  __shared__ float stage[kThreads * kInvStride];
  __shared__ Vec3 sun;
  const bool volume = a.inv != nullptr;
  if (volume && threadIdx.x == 0) sun = sun_direction(*a.sun_angle);
  const int n = a.width * a.rows;
  const int base = (blockIdx.x - 1) * kThreads;
  const int i = base + threadIdx.x;
  const bool live = i < n;
  float nr[2] = {0.0f, 0.0f}, ng[2] = {0.0f, 0.0f};
  if (live) {
    const int x = i % a.width, y = a.row0 + i / a.width;

    // trace_jax.camera_rays.
    float sx = (float)x / (float)a.width * 2.0f - 1.0f;
    float sy = (float)y / (float)a.height * 2.0f - 1.0f;
    Vec3 d = norm3(a.forward[0] + sx * a.right[0] + sy * a.up[0],
                   a.forward[1] + sx * a.right[1] + sy * a.up[1],
                   a.forward[2] + sx * a.right[2] + sy * a.up[2]);
    Vec3 o = {a.cam[0], a.cam[1], a.cam[2]};
    if (-o.y > kHalf) {  // below the region: start the ray on its floor
      float t = (-o.y - kHalf) / d.y + kEps;
      o = {o.x + t * d.x, o.y + t * d.y, o.z + t * d.z};
    }
    a.origin[3 * i] = o.x;
    a.origin[3 * i + 1] = o.y;
    a.origin[3 * i + 2] = o.z;
    a.direction[3 * i] = d.x;
    a.direction[3 * i + 1] = d.y;
    a.direction[3 * i + 2] = d.z;

    // The frame's noise offset (the texel at the seed), then the pixel's
    // two texels, the second two texels on along both axes.
    const int32_t seed = *a.seed;
    const int32_t at = pymod(floordiv(seed, a.nwid), a.nh) * a.nwid + pymod(seed, a.nwid);
    const float* off = a.blue + (size_t)at * a.nch;
    const int32_t ox = (int32_t)floorf(off[0] * 255.0f + 0.5f);
    const int32_t oy = (int32_t)floorf(off[1] * 255.0f + 0.5f);
    const float* t1 =
        a.blue + ((size_t)pymod(y + oy, a.nh) * a.nwid + pymod(x + ox, a.nwid)) * a.nch;
    const float* t2 =
        a.blue + ((size_t)pymod(y + oy + 2, a.nh) * a.nwid + pymod(x + ox + 2, a.nwid)) * a.nch;
    nr[0] = t1[0];
    ng[0] = t1[1];
    nr[1] = t2[0];
    ng[1] = t2[1];
    if (!volume)
      a.nw[i] = (int32_t)(byte_of(nr[0]) | (byte_of(ng[0]) << 8) | (byte_of(nr[1]) << 16) |
                          (byte_of(ng[1]) << 24));
  }
  if (!volume) return;
  __syncthreads();
  // path_vol's invariants: each texel's jittered sun direction and its
  // unit-sphere point.
  if (live) {
    float* v = stage + threadIdx.x * kInvStride;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      Vec3 sd = norm3(sun.x + nr[k] * 0.05f, sun.y + ng[k] * 0.05f, 0.0f + sun.z);
      const int32_t b = (int32_t)byte_of(nr[k]);
      Vec3 sp = sphere_point(__ldg(a.trig + 2 * b), __ldg(a.trig + 2 * b + 1), ng[k]);
      v[6 * k] = sd.x;
      v[6 * k + 1] = sd.y;
      v[6 * k + 2] = sd.z;
      v[6 * k + 3] = sp.x;
      v[6 * k + 4] = sp.y;
      v[6 * k + 5] = sp.z;
    }
  }
  __syncthreads();
  const int count = min(kThreads, n - base) * kInv;
  float* out = a.inv + (size_t)base * kInv;
  for (int j = threadIdx.x; j < count; j += kThreads)
    out[j] = stage[(j / kInv) * kInvStride + j % kInv];
}

}  // namespace

// `form`: 0 fused, 1 volume_fast, 2 hf, 3 dda.  Exactly one of `nw` (the
// fused, hf and dda forms) and `inv` (the volume_fast form: `any8b`,
// `trig` and `fscal` given) is non-null; the fused and hf forms read `h3`
// and `r0`, and hf's iscal holds the band words `grass`, `rock` and
// `snow`; every form but dda writes `iscal`.  `h3` and `any8b` are
// 16-byte aligned.
extern "C" int rt_frame_rays(const float* cam, const float* forward, const float* up,
                             const float* right, const float* sun_angle,
                             const int32_t* seed, const float* lr, const float* blue,
                             const float* trig, const int32_t* h3, const int32_t* r0,
                             const uint8_t* any8b, float* origin, float* direction,
                             int32_t* nw, float* inv, int32_t* iscal, float* fscal,
                             float* sun, int width, int height, int row0, int rows,
                             int nh, int nwid, int nch, int form, int grass, int rock,
                             int snow, void* stream) {
  const bool volume = form == kVolume;
  const bool tables = form == kFused || form == kHf;
  if (form < kFused || form > kDda || (nw != nullptr) == volume ||
      (inv != nullptr) != volume || (tables && (h3 == nullptr || r0 == nullptr)) ||
      (volume && (any8b == nullptr || trig == nullptr || fscal == nullptr)) ||
      (form != kDda && iscal == nullptr) || width <= 0 || rows <= 0 || nch < 2 ||
      ((uintptr_t)h3 & 15u) != 0u || ((uintptr_t)any8b & 15u) != 0u)
    return (int)cudaErrorInvalidValue;
  FrameRaysArgs a{cam,    forward, up,    right,     sun_angle, seed,  lr,   blue, trig,
                  h3,     r0,      any8b, origin,    direction, nw,    inv,  iscal, fscal,
                  sun,    width,   height, row0,     rows,      nh,    nwid, nch,
                  form,   grass,   rock,   snow};
  const int blocks = 1 + (width * rows + kThreads - 1) / kThreads;
  frame_rays_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
