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
// Three forms, one per frame program:
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
// Pixels are image rows row0 .. row0 + rows of a width x height frame, one
// thread each; a band's values are the whole frame's rows.  The last block
// of the grid writes the frame scalars (the reduction over h3 or any8b),
// so they overlap the pixels.  The uniforms, the texture and the tables
// are read on the device: no host value enters the launch, and the kernel
// sits inside the frame's CUDA graph.
//
// The sphere points' sin and cos come from the 256-entry table of
// ops/shading.py `sphere_trig` at the texel's byte k = rint(v * 255): the
// texture holds exact k / 255 values (utils/blue_noise.py), so the table's
// angle is the plain version's.  The sun's own sinf and cosf are the
// functions PyTorch's `torch.sin`/`torch.cos` call on a float32 tensor.
//
// What bounds it on the H100: the bytes it writes, 28 a pixel (fused) or
// 72 (volume_fast), and the two texel reads; its arithmetic is ~30 float
// operations a pixel (~120 with the invariants).

#include "shading.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kNB = 32;  // bricks per side of the occupancy tables
constexpr int32_t kBig = 1 << 30;
constexpr int kInv = 12;        // invariants a pixel
constexpr int kInvStride = 13;  // their stride in shared memory: no bank conflicts

struct FrameRaysArgs {
  // the uniforms: camera origin, forward, up, right (3,) f32 each, the sun
  // angle () f32, the frame seed () int32, the region centre lr (3,) f32
  const float *cam, *forward, *up, *right, *sun_angle;
  const int32_t* seed;
  const float* lr;
  const float* blue;  // (nh, nw, nch) f32 texture
  const float* trig;  // (256, 2) f32 sphere-point sin and cos
  const int32_t *h3, *r0;  // fused: the region's pyramid words and r0
  const uint8_t* any8b;    // volume_fast: the occupied 8-bricks
  float *origin, *direction;
  int32_t* nw;  // fused
  float* inv;   // volume_fast
  int32_t* iscal;
  float* fscal;  // volume_fast
  float* sun;
  int width, height, row0, rows, nh, nwid, nch;
  bool hf;                     // the hf form: iscal holds the band words
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

// vol_tables.occupancy_world_bounds along one axis: the world extent
// [min, max) of the occupied brick slots `occ` (bit bt: slot bt) in the
// window [lr - 128, lr + 128); a slot that straddles the wrap gives both
// of its pieces.
__device__ void axis_bounds(uint32_t occ, int32_t lr, int32_t* mn_out, int32_t* mx_out) {
  const int32_t lo = lr - 128, hi = lo + 256;
  int32_t mn = kBig, mx = -kBig, wmx = -kBig;
  bool wrapped = false;
  for (int bt = 0; bt < kNB; ++bt) {
    if (!((occ >> bt) & 1u)) continue;
    int32_t w0 = pymod(8 * bt - lr, 256) + lo;
    int32_t rem = w0 + 8 - hi;
    mn = min(mn, w0);
    mx = max(mx, min(w0 + 8, hi));
    if (rem > 0) {
      wrapped = true;
      wmx = max(wmx, lo + rem);
    }
  }
  if (wrapped) mn = min(mn, lo);
  *mn_out = mn;
  *mx_out = max(mx, wmx);
}

// The frame scalars, by the grid's last block.
__device__ void frame_scalars(const FrameRaysArgs& a) {
  __shared__ int32_t red[kThreads];
  __shared__ uint32_t occ[3];
  const int t = threadIdx.x;
  const bool fused = a.nw != nullptr && !a.hf;
  if (fused) {
    int32_t m = 0;
    for (int k = t; k < kWords; k += kThreads) m = max(m, a.h3[k] & 511);
    red[t] = m;
  } else if (!a.hf) {
    if (t < 3) occ[t] = 0u;
    __syncthreads();
    uint32_t ox = 0u, oy = 0u, oz = 0u;
    for (int k = t; k < kNB * kNB * kNB; k += kThreads) {
      if (a.any8b[k]) {
        ox |= 1u << (k % kNB);
        oy |= 1u << ((k / kNB) % kNB);
        oz |= 1u << (k / (kNB * kNB));
      }
    }
    atomicOr(&occ[0], ox);
    atomicOr(&occ[1], oy);
    atomicOr(&occ[2], oz);
  }
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (fused && t < s) red[t] = max(red[t], red[t + s]);
    __syncthreads();
  }
  if (t != 0) return;
  Vec3 sun = sun_direction(*a.sun_angle);
  Vec3 light = sun_color(sun);
  const float sv[8] = {sun.x, sun.y, sun.z, light.x, light.y, light.z, 0.0f, 0.0f};
  for (int k = 0; k < 8; ++k) a.sun[k] = sv[k];
  const int32_t lr[3] = {(int32_t)a.lr[0], (int32_t)a.lr[1], (int32_t)a.lr[2]};
  if (a.hf) {
    const int32_t iv[8] = {a.r0[0], a.r0[1], lr[0], lr[1], lr[2], a.grass, a.rock, a.snow};
    for (int k = 0; k < 8; ++k) a.iscal[k] = iv[k];
    return;
  }
  if (fused) {
    const int32_t iv[8] = {a.r0[0], a.r0[1], lr[0], lr[1], lr[2], red[0], 0, 0};
    for (int k = 0; k < 8; ++k) a.iscal[k] = iv[k];
    return;
  }
  for (int k = 0; k < 3; ++k) {
    a.iscal[k] = lr[k];
    axis_bounds(occ[k], lr[k], a.iscal + 3 + 2 * k, a.iscal + 4 + 2 * k);
    a.fscal[k] = a.cam[k];
  }
  a.iscal[9] = 0;
  a.fscal[3] = 0.0f;
}

__global__ void __launch_bounds__(kThreads) frame_rays_kernel(const FrameRaysArgs a) {
  if (blockIdx.x == gridDim.x - 1) {
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
  const int base = blockIdx.x * kThreads;
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

// Exactly one of `nw` (the fused and hf forms: `h3` and `r0` given) and
// `inv` (the volume_fast form: `any8b`, `trig` and `fscal` given) is
// non-null; `hf` nonzero (with `nw`) asks for the hf form's iscal, the
// band words `grass`, `rock` and `snow`.
extern "C" int rt_frame_rays(const float* cam, const float* forward, const float* up,
                             const float* right, const float* sun_angle,
                             const int32_t* seed, const float* lr, const float* blue,
                             const float* trig, const int32_t* h3, const int32_t* r0,
                             const uint8_t* any8b, float* origin, float* direction,
                             int32_t* nw, float* inv, int32_t* iscal, float* fscal,
                             float* sun, int width, int height, int row0, int rows,
                             int nh, int nwid, int nch, int hf, int grass, int rock,
                             int snow, void* stream) {
  const bool fused = nw != nullptr;
  if (fused == (inv != nullptr) || (fused && (h3 == nullptr || r0 == nullptr)) ||
      (!fused && (any8b == nullptr || trig == nullptr || fscal == nullptr)) ||
      (hf && !fused) || width <= 0 || rows <= 0 || nch < 2)
    return (int)cudaErrorInvalidValue;
  FrameRaysArgs a{cam,    forward, up,    right,     sun_angle, seed,  lr,   blue, trig,
                  h3,     r0,      any8b, origin,    direction, nw,    inv,  iscal, fscal,
                  sun,    width,   height, row0,     rows,      nh,    nwid, nch,
                  hf != 0, grass,  rock,   snow};
  const int blocks = (width * rows + kThreads - 1) / kThreads + 1;
  frame_rays_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
