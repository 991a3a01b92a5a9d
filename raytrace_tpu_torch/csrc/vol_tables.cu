// Kernel O1: the occupancy tables of the volume_fast march, built or
// updated in place from the fused (256^3,) volume.
//
// Replaces the plain jitted JAX functions
// raytrace_tpu/ops/trace_vol_pallas.py `build_vol_tables` (:125-160) and
// `update_vol_tables` (:163-208), which JAX's `draw_frame` runs between
// frames (raytrace_tpu/render/pipeline.py:403-426).  It is not a Pallas
// kernel.  Its plain PyTorch version is ops/vol_tables.py
// `build_vol_tables_plain` / `update_vol_tables_plain`; O1 writes the same
// words: a voxel is solid iff its minefield step (bits 24-31) is 0.
//
// Two launches, one call:
//   1. vol_bricks_kernel, one warp per 4 bricks side by side in x (32
//      voxels, 128 bytes a row) over a box of bricks (the whole volume, or
//      the two brick planes a streamed slab covers): for each of a brick
//      row's 64 (lz, ly) rows one coalesced load and one __ballot_sync of
//      solidity; lane L keeps the bytes of brick L / 8 at lz = L % 8, which
//      are its two detail words (voxel v = (lz<<6)|(ly<<3)|lx, bit v & 31
//      of word v >> 5), and three shuffles give the brick's any and all.
//   2. vol_pyramid_kernel, one block: any8/all8 (a (bz, by) row of 32
//      bricks is one word, one ballot), then the 16-, 32- and 64-level any
//      bits of `any_hi`, which need every brick.  A ballot's bit 31 is the
//      int32 sign bit, as pack_bits32 wraps it.
//
// What bounds it on the H100: the volume's bytes, 67 MB for a full build
// (20 us at 3.35 TB/s), 4 MB for a slab's two brick planes (1.3 us); the
// tables (2 MB of detail words) are written once.  A slab's update is
// short of that: its two launches set its time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN = 256;          // voxels per side
constexpr int kNB = kN / 8;      // bricks per side
constexpr int kDetail = 16;      // detail words per brick
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBrickThreads = 256;
constexpr int kPyramidThreads = 1024;

__global__ void __launch_bounds__(kBrickThreads)
    vol_bricks_kernel(const int32_t* __restrict__ volume,
                      int32_t* __restrict__ detail, uint8_t* __restrict__ any8b,
                      uint8_t* __restrict__ all8b, int bz0, int nbz, int by0,
                      int nby, int bx0, int nbx) {
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int gx0 = bx0 >> 2;
  const int ngx = ((bx0 + nbx + 3) >> 2) - gx0;
  if (warp >= nbz * nby * ngx) return;  // the whole warp alike
  const int g = gx0 + warp % ngx;
  const int by = by0 + (warp / ngx) % nby;
  const int bz = bz0 + warp / (ngx * nby);
  const int j = lane >> 3;   // this lane's brick in the group
  const int mz = lane & 7;   // this lane's lz
  const int32_t* base = volume + (size_t)(bz * 8) * kN * kN + (by * 8) * kN + g * 32 + lane;
  uint32_t lo = 0, hi = 0;  // detail words 2 mz (ly 0-3) and 2 mz + 1 (ly 4-7)
#pragma unroll
  for (int lz = 0; lz < 8; ++lz) {
#pragma unroll
    for (int ly = 0; ly < 8; ++ly) {
      uint32_t v = (uint32_t)__ldg(base + lz * kN * kN + ly * kN);
      uint32_t rows = __ballot_sync(kFull, (v >> 24) == 0);
      uint32_t byte = (rows >> (8 * j)) & 0xffu;
      if (lz == mz) {
        if (ly < 4) lo |= byte << (8 * ly);
        else hi |= byte << (8 * (ly - 4));
      }
    }
  }
  uint32_t any = lo | hi, all = lo & hi;
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) {
    any |= __shfl_xor_sync(kFull, any, off);
    all &= __shfl_xor_sync(kFull, all, off);
  }
  const int bx = 4 * g + j;
  if (bx < bx0 || bx >= bx0 + nbx) return;
  const int b = (bz * kNB + by) * kNB + bx;
  reinterpret_cast<int2*>(detail + (size_t)b * kDetail)[mz] =
      make_int2((int32_t)lo, (int32_t)hi);
  if (mz == 0) {
    any8b[b] = any != 0;
    all8b[b] = all == kFull;
  }
}

__global__ void __launch_bounds__(kPyramidThreads)
    vol_pyramid_kernel(const uint8_t* __restrict__ any8b,
                       const uint8_t* __restrict__ all8b,
                       int32_t* __restrict__ any8, int32_t* __restrict__ all8,
                       int32_t* __restrict__ any_hi) {
  __shared__ uint8_t a16[16 * 16 * 16];
  __shared__ uint8_t a32[8 * 8 * 8];
  const int t = threadIdx.x, lane = t & 31;
  // any8 / all8: word (bz * 32 + by), bit bx.
  for (int row = t >> 5; row < kNB * kNB; row += kPyramidThreads / 32) {
    uint32_t a = __ballot_sync(kFull, any8b[row * kNB + lane] != 0);
    uint32_t f = __ballot_sync(kFull, all8b[row * kNB + lane] != 0);
    if (lane == 0) {
      any8[row] = (int32_t)a;
      all8[row] = (int32_t)f;
    }
  }
  // The 16-level bits, (z * 16 + y) * 16 + x: any_hi row 0.
  for (int i = t; i < 16 * 16 * 16; i += kPyramidThreads) {
    int z = i >> 8, y = (i >> 4) & 15, x = i & 15;
    bool o = false;
#pragma unroll
    for (int d = 0; d < 8; ++d)
      o |= any8b[((2 * z + (d >> 2)) * kNB + 2 * y + ((d >> 1) & 1)) * kNB +
                 2 * x + (d & 1)] != 0;
    a16[i] = o;
    uint32_t w = __ballot_sync(kFull, o);
    if (lane == 0) any_hi[i >> 5] = (int32_t)w;
  }
  __syncthreads();
  // The 32-level bits: any_hi row 1, lanes 0-15.
  if (t < 8 * 8 * 8) {
    int z = t >> 6, y = (t >> 3) & 7, x = t & 7;
    bool o = false;
#pragma unroll
    for (int d = 0; d < 8; ++d)
      o |= a16[((2 * z + (d >> 2)) * 16 + 2 * y + ((d >> 1) & 1)) * 16 + 2 * x +
               (d & 1)] != 0;
    a32[t] = o;
    uint32_t w = __ballot_sync(kFull, o);
    if (lane == 0) any_hi[128 + (t >> 5)] = (int32_t)w;
  }
  __syncthreads();
  // The 64-level bits: any_hi row 1, lanes 64-65.
  if (t < 4 * 4 * 4) {
    int z = t >> 4, y = (t >> 2) & 3, x = t & 3;
    bool o = false;
#pragma unroll
    for (int d = 0; d < 8; ++d)
      o |= a32[((2 * z + (d >> 2)) * 8 + 2 * y + ((d >> 1) & 1)) * 8 + 2 * x +
               (d & 1)] != 0;
    uint32_t w = __ballot_sync(kFull, o);
    if (lane == 0) any_hi[128 + 64 + (t >> 5)] = (int32_t)w;
  }
  // The rest of row 1 is zero.
  if (t < 128 && !(t < 16 || t == 64 || t == 65)) any_hi[128 + t] = 0;
}

}  // namespace

// The tables of the (256^3,) int32 volume: detail (32768, 16) int32,
// any8b / all8b (32, 32, 32) bool, any8 / all8 (8, 128) int32 and any_hi
// (2, 128) int32, all written in place.  The bricks of the box
// [b0, b0 + nb) (z, y, x, in bricks) are recomputed from the volume; the
// others keep their detail words and any8b / all8b; the packed pyramid is
// rebuilt from all of them.
extern "C" int rt_vol_tables(const int32_t* volume, int32_t* detail,
                             uint8_t* any8b, uint8_t* all8b, int32_t* any8,
                             int32_t* all8, int32_t* any_hi, int bz0, int nbz,
                             int by0, int nby, int bx0, int nbx,
                             void* stream) {
  if (bz0 < 0 || by0 < 0 || bx0 < 0 || nbz < 1 || nby < 1 || nbx < 1 ||
      bz0 + nbz > kNB || by0 + nby > kNB || bx0 + nbx > kNB)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int ngx = ((bx0 + nbx + 3) >> 2) - (bx0 >> 2);
  const int warps = nbz * nby * ngx;
  const int blocks = (warps * 32 + kBrickThreads - 1) / kBrickThreads;
  vol_bricks_kernel<<<blocks, kBrickThreads, 0, s>>>(
      volume, detail, any8b, all8b, bz0, nbz, by0, nby, bx0, nbx);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  vol_pyramid_kernel<<<1, kPyramidThreads, 0, s>>>(any8b, all8b, any8, all8,
                                                   any_hi);
  return (int)cudaGetLastError();
}
