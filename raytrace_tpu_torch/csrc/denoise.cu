// Kernel K2: one à-trous denoise pass, with finalize fused into the last;
// and kernel F1, finalize alone (`finalize_kernel`, below K2).
//
// Replaces the Pallas TPU kernel raytrace_tpu/ops/denoise_pallas.py
// `_make_pass_kernel` (:132-246), launched from `_pallas_pass` (:249-269).
// Its plain PyTorch version is `denoise_pass_plain` in ops/denoise.py.
//
// One output pixel is the center tap plus 36 taps at dilation `size`, each
// weighted base / (|dc - dt| / 64 + (normal equal ? 1 : 11)) from the
// packed geometry depth * 32 + normal.  Sky pixels (normal >= 16) pass
// through.  Edges clamp: a tap outside the frame reads the nearest edge
// pixel, which is what the JAX chain's per-pass edge padding gives.  The
// TPU kernel's VMEM bands, column strips and window loads have no
// counterpart.
//
// Layout.  The chain keeps one working plane of float4 per pixel: the
// light (r, g, b) and the pixel's geometry key, the bits of depth / 64
// with the normal in the five low bits (depth < 2^17 is an integer, so
// depth / 64 is exact and its seven lowest mantissa bits are zero).  A tap
// is then one 16-byte load, |dc/64 - dt/64| is |dc - dt| / 64 bit for bit,
// and the normals compare in one integer test.  The first pass reads the
// G-buffers themselves (lighting (H, W, 3), depth u16, normal u8) and
// builds the key; each pass writes the plane; the last pass composites
// albedo * light * 16 + emission * 4, fogs terrain toward fog * 2 by depth,
// applies the filmic curve, adds the blue-noise dither / 128
// (finalize.comp:33-56) and writes the (H, W, 3) frame flipped vertically
// (finalize.comp:59).  It finalizes a window of input rows (first r0,
// count rows; the whole input by default): its albedo, emission and fog
// cover only those rows, its dither is that of image rows dither_row0 ..,
// and it flips the window over its own rows.  The tile split finalizes one
// band of a region that holds the band and its neighbours' halo rows.
//
// Tiling.  A dilated pass is a plain 7 x 7 stencil on each of the size²
// sub-lattices x = a + size * u, y = b + size * v.  A block takes a 32 x 8
// tile of one sub-lattice, loads it with a 3-pixel halo into shared memory
// (clamping the frame coordinates as it loads, which is the edge
// replication), and every tap reads the tile at an offset known at compile
// time (the kernel is instantiated per dilation): no clamps, no index
// arithmetic and no global load per tap.  The finalizing pass takes 32
// consecutive pixels of every size-th row instead (its tile holds the 3 *
// size columns on each side), so that its reads of albedo, emission, fog
// and noise and its writes of the frame are coalesced.
//
// What bounds it on the H100: instructions, not bytes.  One thread per
// pixel and pass reading four planes did 37 taps of about 40 instructions
// each (four loads, two clamps, the index, an unpack, an IEEE division) and
// took 0.072-0.088 ms a pass at 1024² (NVIDIA H100 80GB HBM3, 700 W)
// against a bound of 0.011 ms for its bytes.  This design takes 0.039-0.050
// ms a pass, 0.256 ms for the chain's six: about 1,000 issued instructions
// a pixel at the card's issue rate, of which the 36 IEEE divisions (each a
// reciprocal, its refinement and a range check) are the largest share.

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace {

// The (dx, dy, weight) taps of ops/denoise.py _TAPS, in that order.
constexpr int kTaps = 36;
constexpr float kCenterWeight = 0.146634f;
constexpr int8_t kTapDx[kTaps] = {
    0, 0, 1, -1, 1, -1, -1, 1, 2, -2, 0, 0,
    2, -2, -2, 2, 2, -2, -2, 2, 1, -1, -1, 1,
    3, -3, 0, 0, 3, -3, -3, 3, 1, -1, -1, 1,
};
constexpr int8_t kTapDy[kTaps] = {
    1, -1, 0, 0, 1, 1, -1, -1, 0, 0, 2, -2,
    2, 2, -2, -2, 1, 1, -1, -1, 2, 2, -2, -2,
    0, 0, 3, -3, 1, 1, -1, -1, 3, 3, -3, -3,
};
constexpr float kTapW[kTaps] = {
    0.092566f, 0.092566f, 0.092566f, 0.092566f, 0.058434f, 0.058434f,
    0.058434f, 0.058434f, 0.023205f, 0.023205f, 0.023205f, 0.023205f,
    0.003672f, 0.003672f, 0.003672f, 0.003672f, 0.014648f, 0.014648f,
    0.014648f, 0.014648f, 0.014648f, 0.014648f, 0.014648f, 0.014648f,
    0.002289f, 0.002289f, 0.002289f, 0.002289f, 0.001445f, 0.001445f,
    0.001445f, 0.001445f, 0.001445f, 0.001445f, 0.001445f, 0.001445f,
};

constexpr int kSky = 16;
constexpr int32_t kNormalBits = 31;
constexpr int kReach = 3;
constexpr int kTileW = 32, kTileH = 8;

// Elements of the tables, for use in constant expressions.
__host__ __device__ constexpr int tap_dx(int k) { return kTapDx[k]; }
__host__ __device__ constexpr int tap_dy(int k) { return kTapDy[k]; }
__host__ __device__ constexpr float tap_w(int k) { return kTapW[k]; }

__device__ __forceinline__ float filmic(float x) {
  float seg1 = x * x;
  float seg2 = x * 0.6f - 0.09f;
  float seg3 = 1.0f - 0.219512195116f * (x - 2.5f) * (x - 2.5f);
  return x < 0.3f ? seg1 : (x < 1.13333f ? seg2 : (x < 2.5f ? seg3 : 1.0f));
}

// finalize.comp:33-56 for one channel of one pixel (ops/finalize.py
// `finalize_planar`): composite albedo * light * 16 + emission * 4, fog
// terrain (depth_f < 65535, the u16 depth as float) toward fog * 2 by
// depth / 32768, the filmic curve, and the dither / 128.  K2's finalizing
// pass and F1 both call it.
__device__ __forceinline__ float finalize_channel(float albedo, float emission, float fog,
                                                  float light, float depth_f,
                                                  float dither) {
  const float fog_amount = fminf(depth_f * (1.0f / 32768.0f), 1.0f);
  float f = albedo * (light * 16.0f) + emission * 4.0f;
  if (depth_f < 65535.0f) f = f + (fog * 2.0f - f) * fog_amount;
  return filmic(f) + dither * 0.0078125f;
}

// The geometry key of the packed geometry g = depth * 32 + normal: unpacked
// as the plain pass unpacks it, then depth / 64 with the normal in the low
// bits.
__device__ __forceinline__ float geometry_key(float g) {
  float d = floorf(g * 0.03125f);
  float nrm = g - d * 32.0f;
  return __int_as_float(__float_as_int(d * 0.015625f) | (int32_t)nrm);
}

// Tap K of the pixel whose tile element is `c`, in a tile `width` elements
// wide whose neighbouring elements are `step` pixels apart along x.
template <int K, int width, int step>
__device__ __forceinline__ void tap(const float4* c, int32_t key, float dc,
                                    float& tw, float& a0, float& a1,
                                    float& a2) {
  constexpr int offset = tap_dy(K) * width + tap_dx(K) * step;
  constexpr float base = tap_w(K);
  const float4 v = c[offset];
  const int32_t kt = __float_as_int(v.w);
  const float dt = __int_as_float(kt & ~kNormalBits);
  const float same = ((kt ^ key) & kNormalBits) == 0 ? 1.0f : 11.0f;
  const float wgt = base / (fabsf(dc - dt) + same);
  tw = tw + wgt;
  a0 = a0 + v.x * wgt;
  a1 = a1 + v.y * wgt;
  a2 = a2 + v.z * wgt;
}

// The taps in table order, so the sums round as the plain pass's do.
template <int width, int step, int... K>
__device__ __forceinline__ void taps(std::integer_sequence<int, K...>,
                                     const float4* c, int32_t key, float dc,
                                     float& tw, float& a0, float& a1,
                                     float& a2) {
  (tap<K, width, step>(c, key, dc, tw, a0, a1, a2), ...);
}

// One pass at dilation S over input rows r0 .. r0 + rows.  A block's
// pixels are x = a + SX * u (u in 32 consecutive values) and
// y = r0 + b + S * v (v in 8): SX = S on one sub-lattice, SX = 1 on
// consecutive pixels of every S-th row.  Input: the G-buffers (`light`
// non-null: lighting (H, W, 3), depth, normal) or the working plane `in`,
// each over all h rows.  Output: the working plane `out` (r0 = 0, rows = h),
// or (`out` null) the finalized frame of the rows, flipped over them.
template <int S, int SX>
__global__ void __launch_bounds__(kTileW * kTileH)
    denoise_pass_kernel(const float* __restrict__ light,
                        const uint16_t* __restrict__ depth,
                        const uint8_t* __restrict__ normal,
                        const float4* __restrict__ in,
                        float4* __restrict__ out, float* __restrict__ frame,
                        int h, int w, int r0, int rows, int dither_row0,
                        const float* __restrict__ albedo,
                        const float* __restrict__ emission,
                        const float* __restrict__ fog,
                        const float* __restrict__ noise, int nh, int nw,
                        int nch) {
  constexpr int kHalo = kReach * S / SX;  // tile columns on each side
  constexpr int kSW = kTileW + 2 * kHalo, kSH = kTileH + 2 * kReach;
  __shared__ float4 tile[kSH * kSW];
  const int a = blockIdx.z % SX, b = blockIdx.z / SX;  // the x, y residues
  const int u0 = blockIdx.x * kTileW - kHalo;
  const int v0 = blockIdx.y * kTileH - kReach;
  for (int k = threadIdx.y * kTileW + threadIdx.x; k < kSH * kSW;
       k += kTileW * kTileH) {
    const int tv = k / kSW, tu = k - tv * kSW;
    const int x = min(max(a + SX * (u0 + tu), 0), w - 1);
    const int y = min(max(r0 + b + S * (v0 + tv), 0), h - 1);
    const int j = y * w + x;
    if (light != nullptr) {
      const float g = (float)depth[j] * 32.0f + (float)normal[j];
      tile[k] = make_float4(light[3 * j], light[3 * j + 1], light[3 * j + 2],
                            geometry_key(g));
    } else {
      tile[k] = in[j];
    }
  }
  __syncthreads();

  const int x = a + SX * (blockIdx.x * kTileW + threadIdx.x);
  const int y = r0 + b + S * (blockIdx.y * kTileH + threadIdx.y);
  if (x >= w || y >= r0 + rows) return;
  const int i = y * w + x;
  const float4* c = tile + (threadIdx.y + kReach) * kSW + threadIdx.x + kHalo;
  const float4 center = *c;
  const int32_t key = __float_as_int(center.w);
  const float dc = __int_as_float(key & ~kNormalBits);  // depth / 64
  float b0 = center.x, b1 = center.y, b2 = center.z;
  if ((key & kNormalBits) < kSky) {
    float tw = kCenterWeight;
    float a0 = b0 * kCenterWeight, a1 = b1 * kCenterWeight,
          a2 = b2 * kCenterWeight;
    taps<kSW, S / SX>(std::make_integer_sequence<int, kTaps>{}, c, key, dc, tw, a0,
                      a1, a2);
    float inv = 1.0f / tw;
    b0 = a0 * inv;
    b1 = a1 * inv;
    b2 = a2 * inv;
  }
  if (out != nullptr) {
    out[i] = make_float4(b0, b1, b2, center.w);
    return;
  }
  // Fused finalize on the raw u16 depth (exact: dc * 64).
  const float depth_f = dc * 64.0f;
  const float bc[3] = {b0, b1, b2};
  const int yw = y - r0;  // the row in the window
  const int fi = yw * w + x;
  const int t = (((dither_row0 + yw) % nh) * nw + (x % nw)) * nch;
  float* row = frame + ((size_t)(rows - 1 - yw) * w + x) * 3;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    row[ch] = finalize_channel(albedo[3 * fi + ch], emission[3 * fi + ch], fog[3 * fi + ch],
                               bc[ch], depth_f, noise[t + ch]);
}

// Kernel F1: finalize alone, one thread per channel of a pixel.
//
// Replaces JAX's jitted raytrace_tpu/ops/finalize.py `finalize_frame`
// (:21-77, XLA-fused; not a Pallas kernel): the frame's G-buffers albedo,
// emission, fog (H, W, 3) f32, the denoised lighting (H, W, 3) f32, the
// u16 depth and the blue noise in; the (H, W, 3) frame out, dithered as
// image rows row0 .., flipped vertically unless `flip` is 0.  Its plain
// PyTorch version is `finalize_planar` + `dither_planes` in
// ops/finalize.py; `finalize_channel` is K2's own finalize, so the frame is
// the plain version's bit for bit.  The lighting may be the denoise
// chain's working plane read in place: `lstride` floats a pixel (3, or 4
// for the plane's r, g, b, key).
//
// What bounds it on the H100: the bytes, 62 a pixel (four 12-byte planes
// and the 2-byte depth read, 12 bytes written) and the texture's three
// channels once; ~15 float operations a channel.  One thread per element
// of the (H, W, 3) arrays keeps every plane's loads and the frame's stores
// coalesced.
__global__ void __launch_bounds__(256)
    finalize_kernel(const float* __restrict__ albedo, const float* __restrict__ emission,
                    const float* __restrict__ fog, const float* __restrict__ light,
                    int lstride, const uint16_t* __restrict__ depth,
                    const float* __restrict__ noise, float* __restrict__ frame, int h, int w,
                    int row0, bool flip, int nh, int nw, int nch) {
  const int j = blockIdx.x * 256 + threadIdx.x;
  if (j >= h * w * 3) return;
  const int p = j / 3, c = j - 3 * p;
  const int y = p / w, x = p - y * w;
  int ty = (row0 + y) % nh;
  ty = ty < 0 ? ty + nh : ty;
  const float dither = noise[(ty * nw + x % nw) * nch + c];
  const float v = finalize_channel(albedo[j], emission[j], fog[j],
                                   light[(size_t)p * lstride + c], (float)depth[p], dither);
  frame[((size_t)(flip ? h - 1 - y : y) * w + x) * 3 + c] = v;
}

struct PassArgs {
  const float* light;
  const uint16_t* depth;
  const uint8_t* normal;
  const float4* in;
  float4* out;
  float* frame;
  int h, w, r0, rows, dither_row0;
  const float *albedo, *emission, *fog, *noise;
  int nh, nw, nch;
};

// One block per 32 x 8 tile of pixels; the finalizing pass on consecutive
// pixels of every S-th row, the others on each of the S² sub-lattices.
template <int S, int SX>
int launch(const PassArgs& p, cudaStream_t stream) {
  const int lw = (p.w + SX - 1) / SX, lh = (p.rows + S - 1) / S;
  dim3 block(kTileW, kTileH);
  dim3 grid((lw + kTileW - 1) / kTileW, (lh + kTileH - 1) / kTileH, S * SX);
  denoise_pass_kernel<S, SX><<<grid, block, 0, stream>>>(
      p.light, p.depth, p.normal, p.in, p.out, p.frame, p.h, p.w, p.r0, p.rows,
      p.dither_row0, p.albedo, p.emission, p.fog, p.noise, p.nh, p.nw, p.nch);
  return (int)cudaGetLastError();
}

template <int S>
int launch_size(const PassArgs& p, cudaStream_t stream) {
  return p.frame != nullptr ? launch<S, 1>(p, stream) : launch<S, S>(p, stream);
}

}  // namespace

extern "C" int rt_denoise_pass(const float* light, const uint16_t* depth,
                               const uint8_t* normal, const float* in,
                               float* out, float* frame, int h, int w,
                               int size, int r0, int rows, int dither_row0,
                               const float* albedo, const float* emission,
                               const float* fog, const float* noise, int nh,
                               int nw, int nch, void* stream) {
  if (h <= 0 || w <= 0 || rows <= 0) return 0;
  // The window lies in the input; a plane-to-plane pass takes every row.
  if (r0 < 0 || r0 + rows > h || dither_row0 < 0 ||
      (frame == nullptr && (r0 != 0 || rows != h)))
    return (int)cudaErrorInvalidValue;
  const PassArgs p{light, depth, normal, reinterpret_cast<const float4*>(in),
                   reinterpret_cast<float4*>(out), frame, h, w, r0, rows,
                   dither_row0, albedo, emission, fog, noise, nh, nw, nch};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (size) {
    case 1: return launch_size<1>(p, s);
    case 2: return launch_size<2>(p, s);
    case 4: return launch_size<4>(p, s);
    case 8: return launch_size<8>(p, s);
    case 16: return launch_size<16>(p, s);
    default: return (int)cudaErrorInvalidValue;  // no such dilation
  }
}

// F1.  albedo, emission, fog (H, W, 3) f32; light (H, W) pixels of
// `lstride` (3 or 4) f32; depth (H, W) u16; noise (nh, nw, nch >= 3) f32;
// frame (H, W, 3) f32 out.
extern "C" int rt_finalize(const float* albedo, const float* emission, const float* fog,
                           const float* light, int lstride, const uint16_t* depth,
                           const float* noise, float* frame, int h, int w, int row0,
                           int flip, int nh, int nw, int nch, void* stream) {
  if (h <= 0 || w <= 0) return 0;
  if ((lstride != 3 && lstride != 4) || nh <= 0 || nw <= 0 || nch < 3 ||
      (long long)h * w * 3 > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  const int blocks = (h * w * 3 + 255) / 256;
  finalize_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      albedo, emission, fog, light, lstride, depth, noise, frame, h, w, row0, flip != 0, nh,
      nw, nch);
  return (int)cudaGetLastError();
}
