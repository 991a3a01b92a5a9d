// Kernel D1: the exact DDA over the fused volume, one thread per ray.
//
// Replaces the jitted JAX program raytrace_tpu/ops/trace_jax.py
// `trace_rays` (:59-165), a `lax.while_loop` that XLA runs inside the
// frame's program (`render_gbuffers`, :191-215); it is not a Pallas kernel.
// Its plain PyTorch version is `march_rays_dda_plain` in ops/trace_dda.py;
// both run the same float32 operations in the same order (built with
// --fmad=false), so every output is the plain version's bit for bit.
//
// A ray: its direction normalized as ops/rays.py `normalize` does,
// v * (1 / sqrt(|v|^2)), 1/|d| per axis (IEEE division), the face ids and
// signs (vol_march.cuh `set_direction`); a start step (1 << s) // 2 of the
// word at its origin; then up to `max_steps` moves: to the next boundary
// of the current step grid, (1e-4 + mod((p + 128) * mul, ss)) * lp per
// axis (the floor modulo of vol_march.cuh `bdist`, exact for a power-of-two
// ss), or 1e-4 * lp where ss <= 0; along the axis of JAX's tie rule
// (use_x = lx < ly & lx < lz, use_y = !(lx < ly) & ly < lz); the fused word
// at floor(p + 128) mod 256.  The ray is air where |p - lr| >= 128 on an
// axis, a hit where the word's step is <= 0, else it takes the word's step
// size.  A ray that is done stops moving, so a thread that loops until its
// ray is done gives JAX's lock-step loop's results ray by ray.
//
// Per ray it writes the position before any nudge, the entry-face normal
// id, air (bool) and `mat` int32: the hit's packed word (fused &
// MATERIAL_MASK; 0 for air), or kExhausted (1 << 24, above every packed
// word) where the ray is not done after `max_steps` moves.  An inactive ray
// (`active` given and 0) is born done at its origin: normal 0, not air,
// mat 0, no move.  `steps` is JAX's loop counter: one past the last move
// that finished a ray, or `max_steps` while a ray is still live; each warp
// takes its lanes' maximum and one lane adds it with atomicMax to the
// device int32 that the C entry zeroes on the launching stream, so nothing
// is read on the host and the launch sits inside the frame's CUDA graph.
// An optional `census` (2,) int64 gathers the work: each warp adds its
// rays' moves to census[0] and its longest ray's to census[1] (the moves
// the warp's lanes are held for), so census[0] / (32 * census[1]) is the
// share of lane moves that do work; an optional `touched` bitmap (256^3
// bits) gets the bit of every volume word a ray reads, so its count is the
// words the batch needs.  Counting is a template instance of its own
// (kCount 1), so the frame's launches carry no test for it.
//
// What bounds it on the H100: neither bytes (a ray reads 24-25 and writes
// 21, and a move one 4-byte word) nor float32 operations (42 a move), but
// the instructions of each move (a loop of 94 in SASS around one dependent
// 4-byte gather) and its latency.  The primaries and the first pair batch
// run near the instruction rate of the 64 warps an SM that this form's 32
// registers allow; the second pair batch's time is set by its longest ray
// (161 moves at the apps' view).  So it stays one thread per ray in index
// order.  Persistent lanes that refill (lanes.cuh, as K3s) raise the pair
// batches' lane use from 0.52 and 0.12 to 0.66-0.78 and 0.33-0.39, but a
// lane's window, ray index and share of `steps` do not fit beside the ray
// in 32 registers: capped there the loop spills (lr read from local memory
// every move), uncapped it holds 6 blocks an SM, and either way a warp
// iteration costs 1.3x (whole rays) to 1.9x (one move an iteration) this
// form's.  Every form of them lost on every batch, in turns with this one
// (PERF.md section 6 gives their times and where their code is).

#include <cuda_runtime.h>
#include <stdint.h>

#include "vol_march.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int32_t kStepShift = 24;
constexpr int32_t kMaterialMask = (1 << kStepShift) - 1;
constexpr int32_t kExhausted = 1 << kStepShift;

// ops/trace_dda.py `_step_size`: (1 << s) // 2 as float32 with PyTorch's
// shift, 0 for a shift below 0 or of 32 and more; 1 << 31 is INT32_MIN,
// which the arithmetic shift floor-divides by 2.
__device__ __forceinline__ float step_size(int32_t s) {
  if (s < 0 || s >= 32) return 0.0f;
  return (float)((int32_t)(1u << s) >> 1);
}

// ops/volume.py `lookup`: the fused word at floor(p + 128) mod 256 on each
// axis, (z, y, x) order; with kCount, its bit set in `touched` where that
// is not null.
template <int kCount>
__device__ __forceinline__ int32_t word_at(const int32_t* __restrict__ volume, const Ray& r,
                                           uint32_t* __restrict__ touched) {
  const int32_t tx = (int32_t)floorf(r.px + kHalf) & (kN - 1);
  const int32_t ty = (int32_t)floorf(r.py + kHalf) & (kN - 1);
  const int32_t tz = (int32_t)floorf(r.pz + kHalf) & (kN - 1);
  const int32_t lin = (tz * kN + ty) * kN + tx;
  if (kCount && touched != nullptr) atomicOr(touched + (lin >> 5), 1u << (lin & 31));
  return __ldg(volume + lin);
}

// One move of the ray to the next boundary of the `ss` grid, with the
// entry-face normal of the axis crossed.
__device__ __forceinline__ void move(Ray& r, float ss) {
  float lx, ly, lz;
  if (ss > 0.0f) {
    const float inv = 1.0f / ss;  // exact: ss is a power of two
    lx = bdist(r.px, r.mulx, r.lpx, ss, inv);
    ly = bdist(r.py, r.muly, r.lpy, ss, inv);
    lz = bdist(r.pz, r.mulz, r.lpz, ss, inv);
  } else {
    lx = kEps * r.lpx;
    ly = kEps * r.lpy;
    lz = kEps * r.lpz;
  }
  const bool use_x = (lx < ly) && (lx < lz);
  const bool use_y = !(lx < ly) && (ly < lz);
  const float lmin = use_x ? lx : (use_y ? ly : lz);
  r.normal = (r.nids >> (use_x ? 0 : (use_y ? 3 : 6))) & 7;
  r.px = r.px + r.vx * lmin;
  r.py = r.py + r.vy * lmin;
  r.pz = r.pz + r.vz * lmin;
}

template <int kCount>
__global__ void __launch_bounds__(kThreads)
    trace_dda_kernel(const float* __restrict__ origin, const float* __restrict__ direction,
                     const uint8_t* __restrict__ active, const int32_t* __restrict__ volume,
                     const float* __restrict__ lr, float* __restrict__ pos_out,
                     int32_t* __restrict__ normal_out, uint8_t* __restrict__ air_out,
                     int32_t* __restrict__ mat_out, int n, int max_steps,
                     int32_t* __restrict__ steps, unsigned long long* __restrict__ census,
                     uint32_t* __restrict__ touched) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  int32_t last = 0;  // this ray's moves: its share of `steps`
  if (i < n) {
    Ray r;
    r.px = origin[3 * (size_t)i];
    r.py = origin[3 * (size_t)i + 1];
    r.pz = origin[3 * (size_t)i + 2];
    r.normal = 0;
    bool air = false;
    int32_t mat = 0;
    if (active == nullptr || active[i] != 0) {
      set_direction(r, direction[3 * (size_t)i], direction[3 * (size_t)i + 1],
                    direction[3 * (size_t)i + 2]);
      const float lrx = lr[0], lry = lr[1], lrz = lr[2];
      float ss = step_size(word_at<kCount>(volume, r, touched) >> kStepShift);
      mat = kExhausted;
      last = max_steps;
      for (int k = 0; k < max_steps; ++k) {
        move(r, ss);
        const int32_t word = word_at<kCount>(volume, r, touched);
        if (fabsf(r.px - lrx) >= kHalf || fabsf(r.py - lry) >= kHalf ||
            fabsf(r.pz - lrz) >= kHalf) {
          air = true;
          mat = 0;
          last = k + 1;
          break;
        }
        const int32_t s = word >> kStepShift;
        if (s <= 0) {
          mat = word & kMaterialMask;
          last = k + 1;
          break;
        }
        ss = step_size(s);
      }
    }
    pos_out[3 * (size_t)i] = r.px;
    pos_out[3 * (size_t)i + 1] = r.py;
    pos_out[3 * (size_t)i + 2] = r.pz;
    normal_out[i] = r.normal;
    air_out[i] = air;
    mat_out[i] = mat;
  }
  // Every lane of the warp gets here (the grid is whole warps).
  const bool lead = (threadIdx.x & 31) == 0;
  const int32_t most = __reduce_max_sync(0xffffffffu, last);
  if (lead && most > 0) atomicMax(steps, most);
  if (kCount && census != nullptr) {
    const int32_t moves = __reduce_add_sync(0xffffffffu, last);
    if (lead) {
      atomicAdd(census, (unsigned long long)moves);
      atomicAdd(census + 1, (unsigned long long)most);
    }
  }
}

}  // namespace

// D1 on n rays: origin and direction (n, 3) f32, active (n,) bool or null
// (every ray traced), the fused (256^3,) int32 volume and the region
// centre lr (3,) f32 on the device.  Writes pos (n, 3) f32, normal (n,)
// int32, air (n,) bool, mat (n,) int32 and steps, one int32 (zeroed here
// on `stream` first); adds to `census` (2,) int64 and `touched` (2^19,)
// int32 where they are not null.
extern "C" int rt_trace_dda(const float* origin, const float* direction, const uint8_t* active,
                            const int32_t* volume, const float* lr, float* pos,
                            int32_t* normal, uint8_t* air, int32_t* mat, int n,
                            int max_steps, int32_t* steps, long long* census,
                            int32_t* touched, void* stream) {
  if (n < 0 || max_steps < 0 || steps == nullptr || (n > 0 && (volume == nullptr ||
                                                                lr == nullptr)))
    return (int)cudaErrorInvalidValue;
  int err = (int)cudaMemsetAsync(steps, 0, sizeof(int32_t), (cudaStream_t)stream);
  if (err != 0 || n == 0) return err;
  const int blocks = (n + kThreads - 1) / kThreads;
  auto* counts = reinterpret_cast<unsigned long long*>(census);
  auto* bits = reinterpret_cast<uint32_t*>(touched);
  if (census != nullptr || touched != nullptr) {
    trace_dda_kernel<1><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        origin, direction, active, volume, lr, pos, normal, air, mat, n, max_steps, steps,
        counts, bits);
  } else {
    trace_dda_kernel<0><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        origin, direction, active, volume, lr, pos, normal, air, mat, n, max_steps, steps,
        counts, bits);
  }
  return (int)cudaGetLastError();
}
