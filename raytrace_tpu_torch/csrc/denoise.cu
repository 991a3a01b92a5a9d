// Kernel K2: one à-trous denoise pass, with finalize fused into the last.
//
// Replaces the Pallas TPU kernel raytrace_tpu/ops/denoise_pallas.py
// `_make_pass_kernel` (:132-246), launched from `_pallas_pass` (:249-269).
// Its plain PyTorch version is `denoise_pass_plain` in ops/denoise.py.
//
// One thread computes one output pixel: the center tap plus 36 taps at
// dilation `size`, each weighted base / (|dc - dt| / 64 + (normal equal ?
// 1 : 11)) from the packed geometry plane depth * 32 + normal.  Sky pixels
// (normal >= 16) pass through.  Edges clamp: a tap outside the frame reads
// the nearest edge pixel, which is what the JAX chain's per-pass edge
// padding gives.  With `albedo` non-null the pass also composites albedo * light *
// 16 + emission * 4, fogs terrain toward fog * 2 by depth, applies the
// filmic curve and adds the blue-noise dither / 128 (finalize.comp:33-56).
// The TPU kernel's VMEM bands, column strips and window loads have no
// counterpart: a 4K frame's planes fit the card whole.
//
// What bounds it on Hopper: memory traffic, 37 taps x 4 planes read per
// pixel per pass; neighbouring threads read neighbouring addresses, and
// the L1/L2 caches serve the taps' overlap between pixels.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The (dx, dy, weight) taps of ops/denoise.py _TAPS, in that order.
constexpr int kTaps = 36;
constexpr float kCenterWeight = 0.146634f;
__constant__ int8_t kTapDx[kTaps] = {
    0, 0, 1, -1, 1, -1, -1, 1, 2, -2, 0, 0,
    2, -2, -2, 2, 2, -2, -2, 2, 1, -1, -1, 1,
    3, -3, 0, 0, 3, -3, -3, 3, 1, -1, -1, 1,
};
__constant__ int8_t kTapDy[kTaps] = {
    1, -1, 0, 0, 1, 1, -1, -1, 0, 0, 2, -2,
    2, 2, -2, -2, 1, 1, -1, -1, 2, 2, -2, -2,
    0, 0, 3, -3, 1, 1, -1, -1, 3, 3, -3, -3,
};
__constant__ float kTapW[kTaps] = {
    0.092566f, 0.092566f, 0.092566f, 0.092566f, 0.058434f, 0.058434f,
    0.058434f, 0.058434f, 0.023205f, 0.023205f, 0.023205f, 0.023205f,
    0.003672f, 0.003672f, 0.003672f, 0.003672f, 0.014648f, 0.014648f,
    0.014648f, 0.014648f, 0.014648f, 0.014648f, 0.014648f, 0.014648f,
    0.002289f, 0.002289f, 0.002289f, 0.002289f, 0.001445f, 0.001445f,
    0.001445f, 0.001445f, 0.001445f, 0.001445f, 0.001445f, 0.001445f,
};

constexpr int kSky = 16;

__device__ __forceinline__ float filmic(float x) {
  float seg1 = x * x;
  float seg2 = x * 0.6f - 0.09f;
  float seg3 = 1.0f - 0.219512195116f * (x - 2.5f) * (x - 2.5f);
  return x < 0.3f ? seg1 : (x < 1.13333f ? seg2 : (x < 2.5f ? seg3 : 1.0f));
}

__device__ __forceinline__ void tap(const float* __restrict__ in,
                                   const float* __restrict__ geom,
                                   size_t plane, int j, float dc, float nc,
                                   float base, float& tw, float& a0, float& a1,
                                   float& a2) {
  float g = geom[j];
  float dt = floorf(g * 0.03125f);
  float nt = g - dt * 32.0f;
  float wgt = base / (fabsf(dc - dt) * 0.015625f + (nt == nc ? 1.0f : 11.0f));
  tw = tw + wgt;
  a0 = a0 + in[j] * wgt;
  a1 = a1 + in[plane + j] * wgt;
  a2 = a2 + in[2 * plane + j] * wgt;
}

__global__ void denoise_pass_kernel(const float* __restrict__ in,
                                    const float* __restrict__ geom,
                                    float* __restrict__ out, int h, int w,
                                    int size, const float* __restrict__ albedo,
                                    const float* __restrict__ emission,
                                    const float* __restrict__ fog,
                                    const float* __restrict__ noise, int nh,
                                    int nw, int nch) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  size_t plane = (size_t)h * w;
  int i = y * w + x;
  float g = geom[i];
  float dc = floorf(g * 0.03125f);
  float nc = g - dc * 32.0f;
  float b0 = in[i], b1 = in[plane + i], b2 = in[2 * plane + i];
  if (!(nc >= (float)kSky)) {
    float tw = kCenterWeight;
    float a0 = b0 * kCenterWeight, a1 = b1 * kCenterWeight,
          a2 = b2 * kCenterWeight;
    for (int k = 0; k < kTaps; ++k) {
      int ty = min(max(y + kTapDy[k] * size, 0), h - 1);
      int tx = min(max(x + kTapDx[k] * size, 0), w - 1);
      tap(in, geom, plane, ty * w + tx, dc, nc, kTapW[k], tw, a0, a1, a2);
    }
    float inv = 1.0f / tw;
    b0 = a0 * inv;
    b1 = a1 * inv;
    b2 = a2 * inv;
  }
  if (albedo == nullptr) {
    out[i] = b0;
    out[plane + i] = b1;
    out[2 * plane + i] = b2;
    return;
  }
  // Fused finalize; dc is the raw u16 depth.
  float fog_amount = fminf(dc * (1.0f / 32768.0f), 1.0f);
  bool terrain = dc < 65535.0f;
  const float b[3] = {b0, b1, b2};
  int t = ((y % nh) * nw + (x % nw)) * nch;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float f = albedo[3 * i + c] * (b[c] * 16.0f) + emission[3 * i + c] * 4.0f;
    float fogc = fog[3 * i + c] * 2.0f;
    if (terrain) f = f + (fogc - f) * fog_amount;
    out[c * plane + i] = filmic(f) + noise[t + c] * 0.0078125f;
  }
}

}  // namespace

extern "C" int rt_denoise_pass(const float* in, const float* geom, float* out,
                               int h, int w, int size, const float* albedo,
                               const float* emission, const float* fog,
                               const float* noise, int nh, int nw, int nch,
                               void* stream) {
  if (h <= 0 || w <= 0) return 0;
  dim3 block(32, 8);
  dim3 grid((w + block.x - 1) / block.x, (h + block.y - 1) / block.y);
  denoise_pass_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      in, geom, out, h, w, size, albedo, emission, fog, noise, nh, nw, nch);
  return (int)cudaGetLastError();
}
