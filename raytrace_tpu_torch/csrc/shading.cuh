// The sky, sun and bounce-direction math of ops/shading.py, shared by
// kernel K1 (lighting.cu), the frame rays R1 (frame_rays.cu) and the
// shades S1 and S3 (shade.cu).  Every function runs the float32 operations
// of its plain PyTorch counterpart in the same order; the kernels are built
// with --fmad=false, so each multiply and add rounds on its own, as the
// plain versions' separate PyTorch operations do.
//
// PyTorch on the card computes `torch.pow(x, 2)` as x * x and every other
// power as powf; `torch.sin`/`torch.cos` of float32 as sinf/cosf; a
// tensor-by-tensor division as a true division.  A Python float meets a
// float32 tensor as its float32 value, and `_mix(a, b, t)` of two Python
// floats takes the difference `b - a` in double before it becomes float32:
// the constants below are written so.
#pragma once

#include "heightfield.cuh"

namespace {

// ops/shading.py's colours: SUN_MAIN_COLOR, SUN_SUNSET_COLOR,
// SKY_BRIGHT_COLOR and SKY_DARK_COLOR, as doubles.
__device__ __forceinline__ double sun_main(int c) {
  return c == 0 ? 0.9647 * 2.0 : (c == 1 ? 0.7843 * 2.0 : 0.8824 * 2.0);
}
__device__ __forceinline__ double sun_sunset(int c) {
  return c == 0 ? 0.7412 * 2.0 : (c == 1 ? 0.2157 * 2.0 : 0.1686 * 2.0);
}
__device__ __forceinline__ double sky_bright(int c) {
  return c == 0 ? 0.5294 : (c == 1 ? 0.8275 : 0.9647);
}
__device__ __forceinline__ double sky_dark(int c) {
  return c == 0 ? 0.0863 : (c == 1 ? 0.1294 : 0.2196);
}

// shading.sun_direction: the normalized sun vector of the frame's angle.
__device__ __forceinline__ Vec3 sun_direction(float a) {
  float sx = cosf(a) * 0.5f + (a - 0.5f) * 0.5f;
  float sy = sinf(a);
  float sz = cosf(a);
  float norm = sqrtf(sx * sx + sy * sy + sz * sz);
  return {sx / norm, sy / norm, sz / norm};
}

// shading.sun_color: the sunlight's colour from the sun's elevation.
__device__ __forceinline__ Vec3 sun_color(Vec3 s) {
  float horizon = sqrtf(s.x * s.x + s.y * s.y);
  float amount = fminf(1.0f - horizon, 0.02f) * 50.0f;
  float out[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float sunset = (float)sun_sunset(c);
    float day = sunset + (float)(sun_main(c) - sun_sunset(c)) * amount;
    float night = sunset + (float)(0.0 - sun_sunset(c)) * (amount * 2.0f);
    out[c] = s.z >= 0.0f ? day : night;
  }
  return {out[0], out[1], out[2]};
}

// The frame's terms of shading.sample_sky: the sun and sunlight, and the
// powers and mix weight that depend on the sunlight alone.
struct Sky {
  Vec3 sun, light;
  float horizon_exp, halo_exp, amount;
};

__device__ __forceinline__ Sky sky_terms(Vec3 sun, Vec3 light) {
  float sla = fminf(fmaxf((light.x + light.y + light.z) * 0.2f - 0.02f, 0.0f), 1.0f);
  Sky k;
  k.sun = sun;
  k.light = light;
  k.horizon_exp = 40.0f + (float)(10.0 - 40.0) * sla;
  k.halo_exp = 5.0f + (float)(1.0 - 5.0) * sla;
  k.amount = fmaxf(sla, 0.1f);
  return k;
}

// shading.sample_sky of one direction, with the sun's disk (`with_sun`)
// and without it (`without`, include_sun=False: the disk term adds 0).
__device__ __forceinline__ void sample_sky(const Sky& k, float dx, float dy, float dz,
                                           Vec3* with_sun, Vec3* without) {
  float horizon = powf(sqrtf(dx * dx + dy * dy), k.horizon_exp);
  float ex = k.sun.x - dx, ey = k.sun.y - dy, ez = k.sun.z - dz;
  float dist = sqrtf(ex * ex + ey * ey + ez * ez);
  float sun_amount = 1.0f - 0.5f * dist;
  float halo_base = fmaxf(sun_amount, 0.0f);
  float halo = powf(halo_base, k.halo_exp);
  float bright = fminf(horizon + halo * 0.5f, 1.0f);
  float glow = powf(halo_base, 5.0f) * 0.5f;
  bool disk = sun_amount > 0.98f;
  const float light[3] = {k.light.x, k.light.y, k.light.z};
  float w[3], o[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float base = (float)sky_dark(c) + (float)(sky_bright(c) - sky_dark(c)) * (bright * k.amount);
    base = base + light[c] * glow;
    w[c] = base + (disk ? light[c] : 0.0f);
    o[c] = base + 0.0f;
  }
  if (with_sun != nullptr) *with_sun = {w[0], w[1], w[2]};
  if (without != nullptr) *without = {o[0], o[1], o[2]};
}

// shading.sphere_point, with sin and cos of its angle 2 pi k / 255 from
// the wrapper's table (ops/shading.py sphere_trig, computed by the plain
// version's own operations on the card: no trigonometric call here).
__device__ __forceinline__ Vec3 sphere_point(float sin_t1, float cos_t1, float ng) {
  float cos_t2 = fminf(fmaxf(1.0f - 2.0f * ng, -1.0f), 1.0f);
  float sin_t2 = sqrtf(fmaxf(1.0f - cos_t2 * cos_t2, 0.0f));
  return {sin_t1 * sin_t2, cos_t1 * sin_t2, cos_t2};
}

// shading.diffuse_from_sphere, with its degenerate guard.
__device__ __forceinline__ Vec3 diffuse_from_sphere(Vec3 sp, int32_t id) {
  Vec3 n = face_normal(id);
  float dx = sp.x + n.x, dy = sp.y + n.y, dz = sp.z + n.z;
  float norm = sqrtf(dx * dx + dy * dy + dz * dz);
  if (norm < 1e-6f) return n;
  norm = fmaxf(norm, 1e-20f);
  return {dx / norm, dy / norm, dz / norm};
}

}  // namespace
