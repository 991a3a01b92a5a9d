// The G-buffer writes the shades share: S1 and S3 (shade.cu) and S2
// (staged.cu).  Each writes the six G-buffers K2's first pass reads,
// lighting, albedo, emission and fog (N, 3) f32, depth (N,) uint16 and
// normal (N,) uint8, in the order of ops/lighting.py `GBUFFER_KEYS`, with
// the float32 operations of its plain PyTorch version (built with
// --fmad=false).
#pragma once

#include "shading.cuh"

namespace {

constexpr int kNormalSky = 16;              // constants.NORMAL_SKY
constexpr int kExhaustedDepth = 256 * 254;  // lighting.EXHAUSTED_DEPTH
constexpr int32_t kMaterialMask = (1 << 24) - 1;  // volume.MATERIAL_MASK

// The albedo of a packed material word: its three 7-bit channels over 127.
__device__ __forceinline__ Vec3 albedo_of(int32_t packed) {
  return {(float)((packed >> 14) & 0x7F) / 127.0f, (float)((packed >> 7) & 0x7F) / 127.0f,
          (float)(packed & 0x7F) / 127.0f};
}

// The packed material of the resident volume's word at linear texel `lin`.
__device__ __forceinline__ int32_t material_at(const int32_t* __restrict__ volume,
                                               int32_t lin) {
  return __ldg(volume + lin) & kMaterialMask;
}

// The linear texel of the voxel holding world position p: floor(p + 128)
// mod 256 on each axis, (z, y, x) order (ops/volume.py `lookup`).
__device__ __forceinline__ int32_t texel_of(Vec3 p) {
  const int32_t tx = (int32_t)floorf(p.x + kHalf) & 255;
  const int32_t ty = (int32_t)floorf(p.y + kHalf) & 255;
  const int32_t tz = (int32_t)floorf(p.z + kHalf) & 255;
  return (tz * 256 + ty) * 256 + tx;
}

// The G-buffer outputs.
struct Out {
  float *lighting, *albedo, *emission, *fog;
  uint16_t* depth;
  uint8_t* normal;
};

__device__ __forceinline__ void put3(float* p, int i, Vec3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}

__device__ __forceinline__ Vec3 get3(const float* __restrict__ p, int i) {
  return {p[3 * (size_t)i], p[3 * (size_t)i + 1], p[3 * (size_t)i + 2]};
}

// The depth, fog, normal and emission every shade writes alike; the sky
// pixel's depth is 0xFFFF, an exhausted one's 256 * 254 and fogged pink.
__device__ __forceinline__ void put_common(const Out& o, int i, bool sky, bool exhausted,
                                           float dist, Vec3 fog, int32_t pn) {
  // torch.clamp(max=) keeps a NaN, which .to(int32) makes 0.
  float scaled = dist * 32.0f;
  scaled = scaled > 65535.0f ? 65535.0f : scaled;
  int32_t depth = sky ? 0xFFFF : (int32_t)scaled;
  if (exhausted) depth = kExhaustedDepth;
  o.depth[i] = (uint16_t)depth;
  put3(o.fog, i, exhausted ? Vec3{1.0f, 0.0f, 1.0f}
                           : Vec3{fog.x * 0.5f, fog.y * 0.5f, fog.z * 0.5f});
  o.normal[i] = (uint8_t)(sky ? kNormalSky : pn);
  put3(o.emission, i, Vec3{0.0f, 0.0f, 0.0f});
}

}  // namespace
