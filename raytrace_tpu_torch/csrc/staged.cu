// Kernels P1 and S2: the glue of the staged frame programs (tracer "hf"
// with K4, the staged volume frame with K3s, tracer "volume" with the
// exact DDA D1), one thread per pixel, one launch each.
//
// Replace the XLA-fused glue of raytrace_tpu/ops/trace_jax.py
// `integrate_gbuffers` (:268-389), which JAX jits together with its tracer
// calls (`render_gbuffers_hf`, raytrace_tpu/ops/trace_pallas.py:709-753,
// around K4; `render_gbuffers_vol`, raytrace_tpu/ops/trace_vol_pallas.py:
// 1203-1246, around K3s; `render_gbuffers`, raytrace_tpu/ops/trace_jax.py:
// 191-215, around the exact DDA) and which the port ran as hundreds of
// PyTorch operations.  Neither is a Pallas kernel.  Their plain PyTorch versions
// are `leg_batch_plain` and `shade_staged_plain` in ops/integrate.py; both
// run the same float32 operations in the same order (built with
// --fmad=false), so every output is the plain version's bit for bit.
//
// Both read a batch's raw hits as its tracer wrote them: position (before
// any nudge), entry normal id and air, and the batch's `mat`:
//  - mode 0, hf (K4): air and mat int32, mat the packed material word; the
//    0.001 nudge off the face always applies; a ray is exhausted where it
//    is not air and its packed word is 0;
//  - mode 1, volume (K3s): air and mat (done) bool; a hit is done and not
//    air, and only hits are nudged; its packed material is the resident
//    volume's word at floor(p + 128) mod 256 of the position before the
//    nudge (gbuffer.cuh `texel_of`); a ray is exhausted where not done;
//  - mode 2, dda (D1): air bool and mat int32, the hit's packed word, or
//    1 << 24 (kExhausted) where the ray is not done; every ray is nudged,
//    air and exhausted ones too (trace_jax.py:144-165), so an exhausted
//    primary, which is not air, sends its bounce rays from the nudged
//    position; the albedo is the packed word's (0 where nothing was hit).
//    The hf rule would take a solid voxel whose material bits are 0 for an
//    exhausted ray.
//
// P1 (`leg_batch_kernel`) builds one bounce's sun + diffuse pair batch of
// 2N rays from the previous leg's hits (the primary batch, or the diffuse
// half of the last pair at offset N), straight into the buffers the tracer
// reads: origin (2N, 3), the nudged hit in both halves; direction (2N, 3),
// the jittered sun direction in the first half and the diffuse direction
// about the hit's normal in the second; active (2N,), the pixel's earlier
// active flag (none for the primary batch) and not air.  The noise: hf and
// dda read R1's packed noise word (bytes k as k / 255, the sphere point's
// sin and cos from ops/shading.py `sphere_trig`) and jitter the sun
// themselves; the volume frame reads R1's invariants sd, sp of the bounce.
//
// S2 (`shade_staged_kernel`) writes the six G-buffers from the raw hits of
// the 1 + `bounces` batches: the primary's, the sky and sun its bounce rays
// reached, the first diffuse hit's albedo, and the bounce directions read
// back from P1's direction buffers.  Depth is the float64 length from the
// camera to the nudged primary hit, times 32.
//
// What bounds them on the H100: bytes.  P1 reads ~25 B a pixel (hit,
// flags, noise word) and writes 50; S2 reads ~80 (the primary's hit and
// direction, four air flags, a material word, two bounce directions) and
// writes 51.  S2's skies are ~41 float operations each, three powf.

#include "gbuffer.cuh"

namespace {

constexpr int kThreads = 256;
// The modes, as ops/integrate.py MODES orders them.
constexpr int kHf = 0, kVolume = 1, kDda = 2;
constexpr int32_t kExhausted = 1 << 24;  // ops/integrate.py EXHAUSTED

struct Batch {
  const float* pos;       // (M, 3) f32
  const int32_t* normal;  // (M,) int32
  const void* air;        // (M,) int32 (hf) or bool (volume, dda)
  const void* mat;        // (M,) int32 packed (hf, dda) or bool done (volume)
};

// The air flag of ray j: int32 in the hf mode, bool in the others.
__device__ __forceinline__ bool air_of(const void* p, int j, int mode) {
  return mode == kHf ? static_cast<const int32_t*>(p)[j] != 0
                     : static_cast<const uint8_t*>(p)[j] != 0;
}

// Position p moved 0.001 along face normal `id` where `nudge` (0 * the
// normal elsewhere: ops/integrate.py `nudged`).
__device__ __forceinline__ Vec3 nudged(Vec3 p, int32_t id, bool nudge) {
  const Vec3 n = face_normal(id);
  const float step = nudge ? 0.001f : 0.0f;
  return {p.x + step * n.x, p.y + step * n.y, p.z + step * n.z};
}

// The hit of ray j: its position nudged 0.001 off its face (in mode 1 only
// where it hit; read only where the batch has normals), and its packed
// material (in mode 1 only where `packed` is asked for).
struct Hit {
  Vec3 pos;
  bool air, exhausted;
  int32_t packed;
};

__device__ __forceinline__ Hit hit_of(const Batch& b, int j, int mode,
                                      const int32_t* __restrict__ volume, bool packed) {
  Hit h{{0.0f, 0.0f, 0.0f}, air_of(b.air, j, mode), false, 0};
  bool nudge = true;
  if (mode == kHf) {
    h.packed = static_cast<const int32_t*>(b.mat)[j];
    h.exhausted = !h.air && h.packed == 0;
  } else if (mode == kDda) {
    const int32_t mat = static_cast<const int32_t*>(b.mat)[j];
    h.packed = mat & kMaterialMask;
    h.exhausted = (mat & kExhausted) != 0;
  } else {
    const bool done = static_cast<const uint8_t*>(b.mat)[j] != 0;
    nudge = done && !h.air;
    h.exhausted = !done;
    if (packed && nudge) h.packed = material_at(volume, texel_of(get3(b.pos, j)));
  }
  if (b.normal != nullptr) h.pos = nudged(get3(b.pos, j), b.normal[j], nudge);
  return h;
}

__global__ void __launch_bounds__(kThreads)
    leg_batch_kernel(const Batch from, const uint8_t* __restrict__ prev_active,
                     const int32_t* __restrict__ nw, const float* __restrict__ inv,
                     const float* __restrict__ sun, const float* __restrict__ trig,
                     float* __restrict__ origin, float* __restrict__ direction,
                     uint8_t* __restrict__ active, int n, int off, int bounce, int mode) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int j = off + i;
  const bool air = air_of(from.air, j, mode);
  const bool nudge =
      mode != kVolume || (static_cast<const uint8_t*>(from.mat)[j] != 0 && !air);
  const int32_t id = from.normal[j];
  const Vec3 o = nudged(get3(from.pos, j), id, nudge);
  const bool act = (prev_active == nullptr || prev_active[j] != 0) && !air;
  Vec3 sd, sp;
  if (mode != kVolume) {
    const uint32_t word = (uint32_t)nw[i] >> (16 * bounce);
    const int32_t kr = word & 255;
    const float nr = (float)kr / 255.0f;
    const float ng = (float)((word >> 8) & 255) / 255.0f;
    sd = norm3(sun[0] + nr * 0.05f, sun[1] + ng * 0.05f, 0.0f + sun[2]);
    sp = sphere_point(__ldg(trig + 2 * kr), __ldg(trig + 2 * kr + 1), ng);
  } else {
    const float* v = inv + 12 * (size_t)i + 6 * bounce;
    sd = {v[0], v[1], v[2]};
    sp = {v[3], v[4], v[5]};
  }
  const Vec3 dif = diffuse_from_sphere(sp, id);
  put3(origin, i, o);
  put3(origin, n + i, o);
  put3(direction, i, sd);
  put3(direction, n + i, dif);
  active[i] = act;
  active[n + i] = act;
}

struct Staged {
  Batch prim, pair1, pair2;
  const float *dir0, *dir1, *dir2;  // the batches' directions
  const float *sun, *cam;
  const int32_t* volume;
};

__device__ __forceinline__ Vec3 add(Vec3 a, Vec3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }

// where(sun ray reached sky, sunlight, 0) + where(diffuse ray reached sky,
// sky(d, with the sun's disk), 0), the radiance one bounce's pair brings.
__device__ __forceinline__ Vec3 pair_light(const Sky& k, bool sun_air, bool dif_air,
                                           Vec3 d) {
  const Vec3 zero = {0.0f, 0.0f, 0.0f};
  Vec3 sky = zero;
  if (dif_air) sample_sky(k, d.x, d.y, d.z, &sky, nullptr);
  return add(sun_air ? k.light : zero, sky);
}

__global__ void __launch_bounds__(kThreads)
    shade_staged_kernel(const Staged s, Out o, int n, int bounces, int mode) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const Sky k = sky_terms(Vec3{s.sun[0], s.sun[1], s.sun[2]},
                          Vec3{s.sun[3], s.sun[4], s.sun[5]});
  const Hit p = hit_of(s.prim, i, mode, s.volume, true);
  const int32_t pn = s.prim.normal[i];
  const Vec3 zero = {0.0f, 0.0f, 0.0f};
  Vec3 light_hit = zero;
  if (bounces >= 1) {
    const bool dif1_air = air_of(s.pair1.air, n + i, mode);
    light_hit = pair_light(k, air_of(s.pair1.air, i, mode), dif1_air, get3(s.dir1, n + i));
    if (bounces >= 2) {
      const Vec3 alb = albedo_of(hit_of(s.pair1, n + i, mode, s.volume, true).packed);
      const Vec3 l = pair_light(k, air_of(s.pair2.air, i, mode),
                                air_of(s.pair2.air, n + i, mode), get3(s.dir2, n + i));
      const Vec3 light2 = {l.x * alb.x, l.y * alb.y, l.z * alb.z};
      light_hit = add(light_hit, dif1_air ? zero : light2);
    }
  }
  const Vec3 rd = get3(s.dir0, i);
  Vec3 sky0, fog0;
  sample_sky(k, rd.x, rd.y, rd.z, &sky0, &fog0);
  const Vec3 light = p.air ? sky0 : light_hit;
  put3(o.lighting, i, Vec3{light.x * 0.0625f, light.y * 0.0625f, light.z * 0.0625f});
  put3(o.albedo, i, p.air ? Vec3{1.0f, 1.0f, 1.0f} : albedo_of(p.packed));
  // integrate.length: |cam - p| summed in float32, its root in float64.
  const float vx = s.cam[0] - p.pos.x, vy = s.cam[1] - p.pos.y, vz = s.cam[2] - p.pos.z;
  const float dist = (float)sqrt((double)(vx * vx + vy * vy + vz * vz));
  put_common(o, i, p.air, p.exhausted, dist, fog0, pn);
}

}  // namespace

// P1.  `mode` 0 hf, 1 volume, 2 dda (see above).  The previous batch (M
// rays): pos (M, 3) f32, normal (M,) int32, air and mat (M,) (mat read in
// the volume mode alone), its active flags (M,) bool or null (the primary
// batch); the pixels are rays off .. off + n of it.  hf and dda: nw (n,)
// int32 and trig (256, 2) f32; volume: inv (n, 12) f32; sun (8,) f32.  Writes origin and direction
// (2n, 3) f32 and active (2n,) bool.  `bounce` 0 or 1: which noise texel.
extern "C" int rt_leg_batch(const float* pos, const int32_t* normal, const void* air,
                            const void* mat, const uint8_t* prev_active, const int32_t* nw,
                            const float* inv, const float* sun, const float* trig,
                            float* origin, float* direction, uint8_t* active, int n, int off,
                            int bounce, int mode, void* stream) {
  const bool volume = mode == kVolume;
  if (mode < kHf || mode > kDda || (bounce != 0 && bounce != 1) || off < 0 ||
      (!volume && (nw == nullptr || trig == nullptr)) ||
      (volume && (inv == nullptr || mat == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const Batch from{pos, normal, air, mat};
  leg_batch_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      from, prev_active, nw, inv, sun, trig, origin, direction, active, n, off, bounce, mode);
  return (int)cudaGetLastError();
}

// S2.  The primary batch (n rays: pos0, normal0, air0, mat0, its direction
// dir0) and, for `bounces` >= 1, the first pair batch (2n rays: pos1, air1,
// mat1, dir1) and, for 2, the second (air2, dir2); sun (8,) f32, the
// camera origin cam (3,) f32 and, in the volume mode, the fused (256^3,)
// int32 volume (and pos1).  Writes the six G-buffers of n pixels.
extern "C" int rt_shade_staged(const float* pos0, const int32_t* normal0, const void* air0,
                               const void* mat0, const float* dir0, const float* pos1,
                               const void* air1, const void* mat1, const float* dir1,
                               const void* air2, const float* dir2, const float* sun,
                               const float* cam, const int32_t* volume, float* lighting,
                               float* albedo, float* emission, float* fog, uint16_t* depth,
                               uint8_t* normal, int n, int bounces, int mode, void* stream) {
  const bool vol = mode == kVolume;
  if (mode < kHf || mode > kDda || bounces < 0 || bounces > 2 || (vol && volume == nullptr) ||
      (bounces >= 1 && (air1 == nullptr || dir1 == nullptr)) ||
      (bounces >= 2 && (mat1 == nullptr || (vol && pos1 == nullptr) || air2 == nullptr ||
                        dir2 == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  Staged s;
  s.prim = {pos0, normal0, air0, mat0};
  s.pair1 = {pos1, nullptr, air1, mat1};  // the diffuse hits' material (bounces 2)
  s.pair2 = {nullptr, nullptr, air2, nullptr};
  s.dir0 = dir0;
  s.dir1 = dir1;
  s.dir2 = dir2;
  s.sun = sun;
  s.cam = cam;
  s.volume = volume;
  Out o{lighting, albedo, emission, fog, depth, normal};
  shade_staged_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      s, o, n, bounces, mode);
  return (int)cudaGetLastError();
}
