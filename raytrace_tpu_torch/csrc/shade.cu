// Kernels S1 and S3: the planar shade of a frame's G-buffers from the path
// march's outputs, one thread per pixel, one launch each.
//
// Replace the XLA-fused final pass of the JAX frame programs, which the
// port ran as hundreds of PyTorch operations: S1 the fused program's
// (raytrace_tpu/ops/lighting_pallas.py:1007-1073 in
// `render_gbuffers_fused`, after K1), S3 the volume_fast program's
// (raytrace_tpu/ops/path_vol.py:605-714 in `render_gbuffers_path`, after
// K3).  Neither is a Pallas kernel.  Their plain PyTorch versions are
// `shade_plain` in ops/lighting.py and in ops/path_vol.py; both run the
// same float32 operations in the same order (built with --fmad=false), so
// every output is the plain version's bit for bit.
//
// Each writes the six G-buffers K2's first pass reads, in place of the
// plain version's stacks: lighting, albedo, emission and fog (N, 3) f32,
// depth (N,) uint16 (0xFFFF sky, 256 * 254 an exhausted primary) and
// normal (N,) uint8 (16 sky).  A pixel's radiance is rebuilt from its
// path bits: the sky and sun seen by its legs (shading.cuh `sample_sky`,
// with the sun's disk for the rays, without for the fog), times the
// albedo of the hit voxels.
//  - S1 reads K1's meta word and primary distance, the primary direction,
//    the packed noise word (the bounce directions' sphere points: bytes k
//    as k / 255, their sin and cos from ops/shading.py `sphere_trig`) and
//    the frame's `sun` (8,) = sun xyz, sunlight rgb; the hit materials are
//    2-bit codes of the meta word (1 grass, 2 rock, 3 snow), whose packed
//    words are launch arguments.
//  - S3 reads K3's meta word, the primary and dif1 hit voxels' linear
//    texels, the primary distance, the primary direction, R1's invariants
//    (the sphere points sp1, sp2) and `sun`, and gathers the packed
//    material of each hit voxel from the resident volume (one word each,
//    in place of JAX's row gather).  `legs` 1, 3 or 5.
//
// What bounds them on the H100: the bytes, ~75 a pixel for S1 (meta, the
// distance, the direction and the noise word in; 4 x 12 + 3 out) and ~135
// for S3 (with the invariants and two volume words); the four skies are
// ~200 float operations a pixel, three powf each.

#include "gbuffer.cuh"

namespace {

constexpr int kThreads = 256;

// lighting._mat_albedo's packed word of a 2-bit material code (0 none).
__device__ __forceinline__ int32_t code_material(int32_t code, int32_t grass, int32_t rock,
                                                 int32_t snow) {
  return code == 1 ? grass : (code == 2 ? rock : (code == 3 ? snow : 0));
}

__device__ __forceinline__ Vec3 sun_terms(const float* sun, int k) {
  return {sun[k], sun[k + 1], sun[k + 2]};
}

__global__ void __launch_bounds__(kThreads)
    shade_fused_kernel(const int32_t* __restrict__ meta, const float* __restrict__ pd,
                       const float* __restrict__ direction, const int32_t* __restrict__ nw,
                       const float* __restrict__ sun, const float* __restrict__ trig, int n,
                       int32_t grass, int32_t rock, int32_t snow, Out o) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const Sky k = sky_terms(sun_terms(sun, 0), sun_terms(sun, 3));
  const int32_t m = meta[i];
  const int32_t leg = m & 7, pn = (m >> 6) & 7, nn = (m >> 9) & 7, acc = m >> 12;
  const bool p_air = (acc & 1) != 0;
  const float a1 = (float)((acc >> 1) & 1), a2 = (float)((acc >> 2) & 1);
  const float a3 = (float)((acc >> 3) & 1), a4 = (float)((acc >> 4) & 1);
  const int32_t pcode = (acc >> 5) & 3, dcode = (acc >> 7) & 3;
  const Vec3 alb_p = albedo_of(code_material(pcode, grass, rock, snow));
  const Vec3 alb_d = albedo_of(code_material(dcode, grass, rock, snow));

  // The two bounce directions from the noise bytes.
  const uint32_t word = (uint32_t)nw[i];
  const int32_t k1 = word & 255, k2 = (word >> 16) & 255;
  const float n1g = (float)((word >> 8) & 255) / 255.0f;
  const float n2g = (float)((word >> 24) & 255) / 255.0f;
  const Vec3 d1 = diffuse_from_sphere(
      sphere_point(__ldg(trig + 2 * k1), __ldg(trig + 2 * k1 + 1), n1g), pn);
  const Vec3 d2 = diffuse_from_sphere(
      sphere_point(__ldg(trig + 2 * k2), __ldg(trig + 2 * k2 + 1), n2g), nn);

  const Vec3 rd = {direction[3 * i], direction[3 * i + 1], direction[3 * i + 2]};
  Vec3 sky0, fog0, sky1, sky2;
  sample_sky(k, rd.x, rd.y, rd.z, &sky0, &fog0);
  sample_sky(k, d1.x, d1.y, d1.z, &sky1, nullptr);
  sample_sky(k, d2.x, d2.y, d2.z, &sky2, nullptr);
  const float sl[3] = {k.light.x, k.light.y, k.light.z};
  const float s0[3] = {sky0.x, sky0.y, sky0.z}, s1[3] = {sky1.x, sky1.y, sky1.z};
  const float s2[3] = {sky2.x, sky2.y, sky2.z}, ad[3] = {alb_d.x, alb_d.y, alb_d.z};
  float light[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float lh = a1 * sl[c] + a2 * s1[c] + (a3 * sl[c] + a4 * s2[c]) * ad[c];
    light[c] = (p_air ? s0[c] + 0.0f : lh) * 0.0625f;  // / LIGHTING_SCALE
  }
  put3(o.lighting, i, Vec3{light[0], light[1], light[2]});
  put3(o.albedo, i, p_air ? Vec3{1.0f, 1.0f, 1.0f} : alb_p);
  put_common(o, i, p_air, leg == 0, pd[i], fog0, pn);
}

// path_vol.albedo_at: the albedo of the packed material at linear texel
// `lin`, 0 where not `valid`.
__device__ __forceinline__ Vec3 albedo_at(const int32_t* __restrict__ volume, int32_t lin,
                                          bool valid) {
  return albedo_of(valid ? material_at(volume, lin) : 0);
}

__device__ __forceinline__ Vec3 bounce(const float* __restrict__ inv, int i, int at,
                                       int32_t id) {
  const float* p = inv + 12 * (size_t)i + at;
  return diffuse_from_sphere(Vec3{p[0], p[1], p[2]}, id);
}

__global__ void __launch_bounds__(kThreads)
    shade_vol_kernel(const int32_t* __restrict__ meta, const int32_t* __restrict__ prim_lin,
                     const int32_t* __restrict__ dif1_lin, const float* __restrict__ prim_dist,
                     const float* __restrict__ direction, const float* __restrict__ inv,
                     const float* __restrict__ sun, const int32_t* __restrict__ volume, int n,
                     int legs, Out o) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const Sky k = sky_terms(sun_terms(sun, 0), sun_terms(sun, 3));
  const int32_t m = meta[i];
  const int32_t leg = (m >> 6) & 7, pn = (m >> 9) & 7;
  bool sky_bit[5];
#pragma unroll
  for (int b = 0; b < 5; ++b) sky_bit[b] = ((m >> (15 + b)) & 1) == 1;
  const int32_t lin1 = prim_lin[i];
  const bool hit1 = lin1 >= 0;
  const bool exhausted = leg == 0 && !sky_bit[0] && !hit1;

  Vec3 light;
  Vec3 sky_rd, fog_rd;
  sample_sky(k, direction[3 * i], direction[3 * i + 1], direction[3 * i + 2], &sky_rd,
             &fog_rd);
  if (hit1) {
    const Vec3 zero = {0.0f, 0.0f, 0.0f};
    Vec3 lh = zero;
    if (legs >= 3) {
      Vec3 a = sky_bit[1] ? k.light : zero;
      Vec3 b = zero;
      if (sky_bit[2]) {
        Vec3 d = bounce(inv, i, 3, pn);
        sample_sky(k, d.x, d.y, d.z, &b, nullptr);
      }
      lh = {a.x + b.x, a.y + b.y, a.z + b.z};
    }
    if (legs >= 5) {
      Vec3 l2 = zero;
      if (!sky_bit[2]) {
        Vec3 a = sky_bit[3] ? k.light : zero;
        Vec3 b = zero;
        if (sky_bit[4]) {
          Vec3 d = bounce(inv, i, 9, (m >> 12) & 7);
          sample_sky(k, d.x, d.y, d.z, &b, nullptr);
        }
        const int32_t lin2 = dif1_lin[i];
        const Vec3 alb = albedo_at(volume, lin2, lin2 >= 0);
        l2 = {(a.x + b.x) * alb.x, (a.y + b.y) * alb.y, (a.z + b.z) * alb.z};
      }
      lh = {lh.x + l2.x, lh.y + l2.y, lh.z + l2.z};
    }
    light = lh;
  } else {
    light = sky_rd;
  }
  put3(o.lighting, i, Vec3{light.x * 0.0625f, light.y * 0.0625f, light.z * 0.0625f});
  put3(o.albedo, i, hit1 ? albedo_at(volume, lin1, true) : Vec3{1.0f, 1.0f, 1.0f});
  put_common(o, i, sky_bit[0], exhausted, prim_dist[i], fog_rd, pn);
}

}  // namespace

// S1.  Inputs (N = n pixels): meta (N,) int32 and pd (N,) f32 from K1,
// direction (N, 3) f32, nw (N,) int32, sun (8,) f32, trig (256, 2) f32;
// grass, rock, snow: the packed material words of codes 1-3.
extern "C" int rt_shade_fused(const int32_t* meta, const float* pd, const float* direction,
                              const int32_t* nw, const float* sun, const float* trig,
                              float* lighting, float* albedo, float* emission, float* fog,
                              uint16_t* depth, uint8_t* normal, int n, int grass, int rock,
                              int snow, void* stream) {
  if (n <= 0) return 0;
  Out o{lighting, albedo, emission, fog, depth, normal};
  shade_fused_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      meta, pd, direction, nw, sun, trig, n, grass, rock, snow, o);
  return (int)cudaGetLastError();
}

// S3.  Inputs: meta, prim_lin, dif1_lin (N,) int32 and prim_dist (N,) f32
// from K3, direction (N, 3) f32, inv (N, 12) f32, sun (8,) f32 and the
// fused (256^3,) int32 volume; legs 1, 3 or 5.
extern "C" int rt_shade_vol(const int32_t* meta, const int32_t* prim_lin,
                            const int32_t* dif1_lin, const float* prim_dist,
                            const float* direction, const float* inv, const float* sun,
                            const int32_t* volume, float* lighting, float* albedo,
                            float* emission, float* fog, uint16_t* depth, uint8_t* normal,
                            int n, int legs, void* stream) {
  if (legs != 1 && legs != 3 && legs != 5) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  Out o{lighting, albedo, emission, fog, depth, normal};
  shade_vol_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      meta, prim_lin, dif1_lin, prim_dist, direction, inv, sun, volume, n, legs, o);
  return (int)cudaGetLastError();
}
