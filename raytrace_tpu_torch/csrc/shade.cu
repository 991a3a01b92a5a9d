// Kernels S1 and S3: the planar shade of a frame's G-buffers from the path
// march's outputs, one thread per pixel; S1 is two launches (the frame's
// table of bounce skies, then the shade), S3 one.
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
//    words are launch arguments.  A bounce direction is a function of the
//    noise byte k (the sphere point's angle), the byte g (its height,
//    g / 255) and the face id alone, so its sky is one of 256 x 256 x 6 a
//    frame: `sky_table_kernel` evaluates them into a 6.3 MB table (one
//    thread each, the operations of the plain version's own sky), and the
//    shade gathers a bounce's sky from it (L2) by (face, g, k).
//  - S3 reads K3's meta word, the primary and dif1 hit voxels' linear
//    texels, the primary distance, the primary direction, R1's invariants
//    (the sphere points sp1, sp2) and `sun`, and gathers the packed
//    material of each hit voxel from the resident volume (one word each,
//    in place of JAX's row gather).  `legs` 1, 3 or 5.
//
// What bounds them on the H100: the bytes, ~75 a pixel for S1 (meta, the
// distance, the direction and the noise word in; 4 x 12 + 3 out) and ~135
// for S3 (with the invariants and two volume words).  A sky is ~40 float
// operations, three powf and two sqrtf, a bounce direction three IEEE
// divisions besides: S1 that evaluated three skies and two directions for
// every pixel issued more instructions than its bytes take (2.3x its
// bound at 1024²).  So each shade evaluates only the skies a pixel uses:
// the primary's (its fog, and a sky pixel's lighting) always, and a
// bounce's where the path bits give it a weight (S1: a2, a4 of a terrain
// pixel, from the table, unless a sky may be negative; S3: the sky bits,
// evaluated).  PERF.md §6 has the designs' times.

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

// The bounce directions' skies of the frame: entry (face * 256 + g) * 256
// + k is the sky (with the sun's disk) of shading.diffuse_from_sphere of
// the sphere point of noise bytes k and g on face `face`.
constexpr int kTableFaces = 6;  // face ids 0-5: the faces a march writes
constexpr int kSkyTable = kTableFaces * 256 * 256;

__device__ __forceinline__ Vec3 bounce_sky(const Sky& k, const float* __restrict__ trig,
                                           int32_t kb, int32_t g, int32_t face) {
  const Vec3 d = diffuse_from_sphere(
      sphere_point(__ldg(trig + 2 * kb), __ldg(trig + 2 * kb + 1), (float)g / 255.0f), face);
  Vec3 sky;
  sample_sky(k, d.x, d.y, d.z, &sky, nullptr);
  return sky;
}

__global__ void __launch_bounds__(kThreads)
    sky_table_kernel(const float* __restrict__ sun, const float* __restrict__ trig,
                     float4* __restrict__ table) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= kSkyTable) return;
  const Sky k = sky_terms(sun_terms(sun, 0), sun_terms(sun, 3));
  const Vec3 s = bounce_sky(k, trig, j & 255, (j >> 8) & 255, j >> 16);
  table[j] = make_float4(s.x, s.y, s.z, 0.0f);
}

// The sky of the bounce of noise bytes k and g on face `face`: a gather from
// the table (face ids 6 and 7, which no march writes, evaluate theirs).
__device__ __forceinline__ Vec3 table_sky(const Sky& k, const float4* __restrict__ table,
                                          const float* __restrict__ trig, int32_t kb,
                                          int32_t g, int32_t face) {
  if (face >= kTableFaces) return bounce_sky(k, trig, kb, g, face);
  const float4 v = __ldg(table + (face * 256 + g) * 256 + kb);
  return {v.x, v.y, v.z};
}

__global__ void __launch_bounds__(kThreads)
    shade_fused_kernel(const int32_t* __restrict__ meta, const float* __restrict__ pd,
                       const float* __restrict__ direction, const int32_t* __restrict__ nw,
                       const float* __restrict__ sun, const float* __restrict__ trig,
                       const float4* __restrict__ table, int n, int32_t grass, int32_t rock,
                       int32_t snow, Out o) {
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

  const Vec3 rd = {direction[3 * i], direction[3 * i + 1], direction[3 * i + 2]};
  Vec3 sky0, fog0;
  sample_sky(k, rd.x, rd.y, rd.z, &sky0, &fog0);
  float light[3];
  if (p_air) {  // a sky pixel: its lighting is the primary's sky
    const float s0[3] = {sky0.x, sky0.y, sky0.z};
#pragma unroll
    for (int c = 0; c < 3; ++c) light[c] = (s0[c] + 0.0f) * 0.0625f;  // / LIGHTING_SCALE
  } else {
    // A bounce's sky only where its weight is set, or where a sky may be
    // negative: with the sunlight >= 0 every sky is > 0 (sample_sky adds
    // light * glow >= 0 and the disk's light to a positive base), so an
    // unset weight times it is +0, the weight times the +0 left here.  A
    // night sun's negative sunlight makes skies whose product with 0 is -0,
    // and a sum of -0 terms keeps that sign: then every sky is read.
    const bool lit = k.light.x >= 0.0f && k.light.y >= 0.0f && k.light.z >= 0.0f;
    const uint32_t word = (uint32_t)nw[i];
    Vec3 sky1 = {0.0f, 0.0f, 0.0f}, sky2 = {0.0f, 0.0f, 0.0f};
    if (a2 != 0.0f || !lit)
      sky1 = table_sky(k, table, trig, word & 255, (word >> 8) & 255, pn);
    if (a4 != 0.0f || !lit)
      sky2 = table_sky(k, table, trig, (word >> 16) & 255, (word >> 24) & 255, nn);
    const float sl[3] = {k.light.x, k.light.y, k.light.z};
    const float s1[3] = {sky1.x, sky1.y, sky1.z}, s2[3] = {sky2.x, sky2.y, sky2.z};
    const float ad[3] = {alb_d.x, alb_d.y, alb_d.z};
#pragma unroll
    for (int c = 0; c < 3; ++c)
      light[c] = (a1 * sl[c] + a2 * s1[c] + (a3 * sl[c] + a4 * s2[c]) * ad[c]) * 0.0625f;
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
// grass, rock, snow: the packed material words of codes 1-3.  `table`
// (6 * 65536) float4 is scratch: the first launch writes the frame's bounce
// skies into it, the second reads them.
extern "C" int rt_shade_fused(const int32_t* meta, const float* pd, const float* direction,
                              const int32_t* nw, const float* sun, const float* trig,
                              float* table, float* lighting, float* albedo, float* emission,
                              float* fog, uint16_t* depth, uint8_t* normal, int n, int grass,
                              int rock, int snow, void* stream) {
  if (n <= 0) return 0;
  if (((uintptr_t)table & 15u) != 0u) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  float4* t = reinterpret_cast<float4*>(table);
  sky_table_kernel<<<kSkyTable / kThreads, kThreads, 0, s>>>(sun, trig, t);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  Out o{lighting, albedo, emission, fog, depth, normal};
  shade_fused_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      meta, pd, direction, nw, sun, trig, t, n, grass, rock, snow, o);
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
