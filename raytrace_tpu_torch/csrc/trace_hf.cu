// Kernel K4: the staged heightfield tracer, on persistent lanes.
//
// Replaces the Pallas TPU kernel raytrace_tpu/ops/trace_pallas.py
// `_make_kernel` (:208-475), launched from `trace_rays_hf` (:512-706).  Its
// plain PyTorch version is `march_rays_hf_plain` in ops/trace_hf.py; the
// two run the same float32 operations in the same order (built with
// --fmad=false, so no multiply-add is contracted), and every ray's outputs
// are the same bits whichever lane computes them.
//
// A ray walks the region's 2-D column-height pyramid and lattice heights,
// the tables K1 reads.  One iteration is the JAX unified body `body_f`
// (:362-438): classify the current voxel (the 8/16/32 pyramid word, then
// the 4-block refinement); where the step is fine, evaluate the column's
// exact height and, if the voxel lies below it, the ray hits here with the
// normal of its previous move (0 for a ray born inside a column); else move
// to the nearest boundary (the column wall or the column top for a fine
// step, the step-aligned boundary otherwise) and complete as air if that
// leaves the region.  There is no sky-escape rule: an air ray walks on to
// the region's edge.  The phased body, the `COMPACT_CAPS` sort cascade and
// the lane-shuffle table lookups of the TPU have no counterpart; the
// wrapper gives each ray the moves the JAX cascade would give it (`budget`
// iterations).
//
// Rays with active[i] == 0 are born done, as the cascade's born-done rays
// are: position = origin, normal 0, air 0, packed material 0.  A hit ray's
// packed material is that of its voxel's material band (the packed grass,
// rock and snow words come in iscal[5..7]).
//
// What bounds it on the H100 is neither memory (each ray reads 25 bytes
// and writes 24; the six 1,024-word tables, 24 KB, sit in shared memory)
// nor the float32 rate, but its per-move ALU chain (a fine step evaluates
// the column height: perlin and powf) and the latency of its longest rays.
// With one thread per ray, 32 consecutive rays to a warp, a warp ran as
// long as its longest ray: at the hf path's 1024² view, bounces=2 (NVIDIA
// H100 80GB HBM3, 700 W), that kept 0.94 of the lanes busy on the
// primaries, 0.49 on the first sun + diffuse pair and 0.11 on the second,
// whose live rays (20% of the batch) were spread over every warp.  So the
// lanes are persistent (lanes.cuh): a grid that fills the card, each warp
// refilling its idle lanes from a window of ray indices.  The inactive rays
// of a window are written born done as it is drawn, so live rays are
// packed 32 to a warp with no host-side compaction, and a ray that runs out
// its budget (a NaN ray rising vertically through a column runs 2,272
// iterations) holds one lane, not a warp.  The tables are copied into
// shared memory once per block.  There, the lanes are 0.92 / 0.76 / 0.39
// busy and the three launches take 1.25 ms a frame against 1.32 for one
// thread per ray.  The refill rule was measured with apps/march_lanes.py:
// refilling whenever a lane is idle took 1.206 ms for the three batches,
// once 16 lanes are 1.210, once all 32 are 1.238; on the primaries alone
// the last is fastest (0.180 ms against 0.239).  The floor is the longest
// rays: the 32 longest of each pair (359 and 211 moves) take 0.29 and
// 0.18 ms alone, and the pairs started longest first take 0.38 and 0.21 ms
// against 0.64 and 0.33 in index order.

#include "heightfield.cuh"
#include "lanes.cuh"

namespace {

constexpr int kThreads = 128;  // at 256 a block, ptxas spilled registers
constexpr int kHit = 1, kOut = 2, kSpent = 3;  // how a ray ends

// The refill rule: the idle lanes of a warp take new rays whenever any of
// its lanes is idle.
__device__ __forceinline__ bool refill_now(unsigned idle) {
  return idle != 0u;
}

// A ray: position, normalized direction, the terms of its moves (1/|v|, the
// sign multiplier and the entry-face normal id per axis), the normal of its
// last move and its iterations so far.
struct HfRay {
  float px, py, pz, dx, dy, dz;
  float lpx, lpy, lpz, mulx, muly, mulz;
  int32_t nx_id, ny_id, nz_id, nrm, it;
};

__device__ __forceinline__ void start_ray(int i, HfRay& r,
                                          const float* __restrict__ origin,
                                          const float* __restrict__ direction) {
  r.px = origin[3 * i];
  r.py = origin[3 * i + 1];
  r.pz = origin[3 * i + 2];
  Vec3 d = norm3(direction[3 * i], direction[3 * i + 1], direction[3 * i + 2]);
  r.dx = d.x;
  r.dy = d.y;
  r.dz = d.z;
  r.lpx = 1.0f / fabsf(d.x);
  r.lpy = 1.0f / fabsf(d.y);
  r.lpz = 1.0f / fabsf(d.z);
  r.mulx = d.x > 0.0f ? -1.0f : 1.0f;
  r.muly = d.y > 0.0f ? -1.0f : 1.0f;
  r.mulz = d.z > 0.0f ? -1.0f : 1.0f;
  r.nx_id = d.x > 0.0f ? 1 : 0;
  r.ny_id = d.y > 0.0f ? 3 : 2;
  r.nz_id = d.z > 0.0f ? 5 : 4;
  r.nrm = 0;
  r.it = 0;
}

// One iteration of body_f: test the hit, then move.  -> 0 (live), kHit,
// kOut (moved out of the region: air) or kSpent (its `budget` iterations
// are done).
__device__ __forceinline__ int hf_step(HfRay& r, const Tables& t, int32_t r0x,
                                       int32_t r0y, float lrx, float lry,
                                       float lrz, int budget, int seed) {
  int32_t xi = (int32_t)floorf(r.px);
  int32_t yi = (int32_t)floorf(r.py);
  int32_t zi = (int32_t)floorf(r.pz);
  int32_t rx, ry;
  int32_t i3 = block_index(xi, yi, r0x, r0y, rx, ry);
  int32_t stp = pyramid_step(t, i3, rx, ry, zi, r.dz >= 0.0f);
  float lx, ly, lz;
  if (stp == 0) {
    int32_t hcol = max(height_from_corners(t.ca[i3], t.cb[i3], t.cc[i3],
                                           t.cd[i3], xi, yi, seed),
                       0);
    if (zi < hcol) return kHit;
    lx = bdist(r.px, r.mulx, r.lpx, 1.0f, 1.0f);
    ly = bdist(r.py, r.muly, r.lpy, 1.0f, 1.0f);
    float ztop = (float)hcol;
    lz = (r.dz < 0.0f && r.pz >= ztop) ? (kEps + (r.pz - ztop)) * r.lpz
                                       : __int_as_float(0x7f800000);
  } else {
    float step_f = (float)stp;
    float inv_step = step_reciprocal(stp);
    lx = bdist(r.px, r.mulx, r.lpx, step_f, inv_step);
    ly = bdist(r.py, r.muly, r.lpy, step_f, inv_step);
    lz = bdist(r.pz, r.mulz, r.lpz, step_f, inv_step);
  }
  bool use_x = (lx < ly) && (lx < lz);
  bool use_y = !(lx < ly) && (ly < lz);
  float lmin = use_x ? lx : (use_y ? ly : lz);
  r.nrm = use_x ? r.nx_id : (use_y ? r.ny_id : r.nz_id);
  r.px = r.px + r.dx * lmin;
  r.py = r.py + r.dy * lmin;
  r.pz = r.pz + r.dz * lmin;
  if (fabsf(r.px - lrx) >= kHalf || fabsf(r.py - lry) >= kHalf ||
      fabsf(r.pz - lrz) >= kHalf)
    return kOut;
  return ++r.it == budget ? kSpent : 0;
}

__global__ void __launch_bounds__(kThreads)
    trace_hf_kernel(const float* __restrict__ origin,
                    const float* __restrict__ direction,
                    const uint8_t* __restrict__ active,
                    const int32_t* __restrict__ iscal,
                    const int32_t* __restrict__ hsub,
                    const int32_t* __restrict__ h3,
                    const int32_t* __restrict__ ca,
                    const int32_t* __restrict__ cb,
                    const int32_t* __restrict__ cc,
                    const int32_t* __restrict__ cd,
                    float* __restrict__ pos_out,
                    int32_t* __restrict__ normal_out,
                    int32_t* __restrict__ air_out,
                    int32_t* __restrict__ packed_out, int n, int budget,
                    int seed, int32_t* __restrict__ next,
                    long long* __restrict__ census) {
  __shared__ Tables t;
  load_tables(t, h3, hsub, ca, cb, cc, cd);
  __syncthreads();

  const int32_t r0x = iscal[0], r0y = iscal[1];
  const float lrx = (float)iscal[2], lry = (float)iscal[3],
              lrz = (float)iscal[4];
  // An inactive ray (or any ray, with no budget) is no work: it is written
  // born done when its window is drawn.
  const auto live = [=](int k) {
    return budget > 0 && (active == nullptr || active[k] != 0);
  };
  const auto born_done = [=](int k) {
    pos_out[3 * k] = origin[3 * k];
    pos_out[3 * k + 1] = origin[3 * k + 1];
    pos_out[3 * k + 2] = origin[3 * k + 2];
    normal_out[k] = 0;
    air_out[k] = 0;
    packed_out[k] = 0;
  };
  HfRay r;
  Window w;
  int i = -1;  // this lane's ray, -1 while idle
  long long iterations = 0;
  for (;;) {
    if (refill_now(__ballot_sync(kFullMask, i < 0))) {
      const int held = i;
      i = refill(i, w, next, n, live, born_done);
      if (held < 0 && i >= 0) start_ray(i, r, origin, direction);
    }
    if (!__any_sync(kFullMask, i >= 0)) break;
    ++iterations;
    if (i < 0) continue;
    int end = hf_step(r, t, r0x, r0y, lrx, lry, lrz, budget, seed);
    if (end == 0) continue;
    int32_t packed = 0;
    if (end == kHit) {
      int32_t band = material_band((int32_t)floorf(r.px), (int32_t)floorf(r.py),
                                   (int32_t)floorf(r.pz), seed);
      packed = band == 2 ? iscal[5] : (band == 5 ? iscal[6] : iscal[7]);
    }
    pos_out[3 * i] = r.px;
    pos_out[3 * i + 1] = r.py;
    pos_out[3 * i + 2] = r.pz;
    normal_out[i] = r.nrm;
    air_out[i] = end == kOut ? 1 : 0;
    packed_out[i] = packed;
    i = -1;
  }
  add_census(census, iterations);
}

int grid_cache = 0;

}  // namespace

extern "C" int rt_trace_hf(const float* origin, const float* direction,
                           const uint8_t* active, const int32_t* iscal,
                           const int32_t* hsub, const int32_t* h3,
                           const int32_t* ca, const int32_t* cb,
                           const int32_t* cc, const int32_t* cd, float* pos,
                           int32_t* normal, int32_t* air, int32_t* packed,
                           int n, int budget, int seed, int32_t* next,
                           long long* census, void* stream) {
  if (n <= 0) return 0;
  int blocks = 0;
  int err = persistent_grid(trace_hf_kernel, kThreads, n, grid_cache, blocks);
  if (err != 0) return err;
  trace_hf_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      origin, direction, active, iscal, hsub, h3, ca, cb, cc, cd, pos, normal,
      air, packed, n, budget, seed, next, census);
  return (int)cudaGetLastError();
}
