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
// One launch a call, `vol_tables_kernel`.  The box of bricks to recompute
// (the whole volume, or the two brick planes a streamed slab covers) is cut
// into units of 4 bricks, one warp-wide load of 32 voxels each: 4 bricks
// side by side in x of one brick row (bz, by), or, in a box 2 bricks wide in
// x (a slab along array axis 2), 2 x 2 bricks of rows by and by + 1, so that
// no load reads voxels outside the box.  A block of 256 threads takes U
// consecutive units (U = 2 on a slab, 4 on a build):
//   1. Warp w takes plane lz = w of each of its units: 8 rows, one
//      coalesced load and one __ballot_sync of solidity each, all 8U loads
//      in flight at once.  Bits 8j-8j+7 of a ballot are brick j's lx, so
//      lane j packs brick j's detail words 2 lz (ly 0-3) and 2 lz + 1 (ly
//      4-7) (voxel v = (lz<<6)|(ly<<3)|lx, bit v & 31 of word v >> 5) into
//      shared memory, and the OR and AND of the 8 ballots are the plane's
//      any and all bytes.
//   2. The units' detail rows go out as coalesced 16-byte stores.  Warp 0
//      takes a brick a lane: its any and all over the 8 planes, its any8b /
//      all8b bytes; three ballots gather the block's bits, and the lane
//      that starts each brick row of the block sets the bits of the row's
//      packed any8 / all8 word (word bz * 32 + by, bit bx) that the block
//      owns, with an atomicAnd that clears them and an atomicOr that sets
//      the new ones: the blocks of a row own disjoint bits, and a box that
//      covers part of a row keeps the others.  A ballot's bit 31 is the
//      int32 sign bit, as pack_bits32 wraps it.  Lane 0 stores the block's
//      any bits in its slot, tagged with the launch's epoch.
//   3. Each block takes a ticket as it starts (its round trip overlaps the
//      volume's loads).  The block that takes the last one, and so starts
//      after every other block has started, builds `any_hi` from the any8
//      words once its own bricks are done: the old words without the box's
//      bits (no block of the launch writes the others), ORed with the box's
//      bits from the slots, gathered a row a thread.  A slot that does not
//      yet show this launch's tag is read again until it does; its block is
//      running and will store it.  So no fence orders a block's bits before
//      a ticket, and the atomics on any8 / all8 need only be done when the
//      launch ends.
//      A 16-level row of 16 bits is the OR of the four any8 words under it,
//      folded by adjacent bit pairs; the 32- and 64-level rows fold the 16-
//      and 32-level ones the same way in shared memory.  The block zeroes
//      the rest of any_hi row 1, moves the epoch on and resets the ticket
//      for the next launch.  Launches on one device run one at a time (they
//      share the ticket, the epoch and the slots): the pipeline's table
//      updates are in stream order.
//
// What bounds it on the H100: the volume's bytes, 67 MB for a full build
// (20 us at 3.35 TB/s), 4 MB for a slab's two brick planes (1.3 us); the
// tables (2 MB of detail words) are written once.  A slab is 256 blocks, so
// every SM has a block and every load of the slab is in flight in one
// round; what is left is the launch, that round, and the last block's one
// round of loads and its folds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN = 256;          // voxels per side
constexpr int kNB = kN / 8;      // bricks per side
constexpr int kDetail = 16;      // detail words per brick
constexpr int kUnit = 4;         // bricks a unit (a warp's 32 lanes) takes
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;    // 8 warps, one per lz plane
constexpr int kLevel16 = 16;     // 16-level cells per side
constexpr int kMaxBlocks = 2048; // slots: the most blocks a launch has
static_assert(kThreads == kLevel16 * kLevel16, "the tail takes a 16-level row a thread");

// The blocks of the running launch that have started (taken a ticket); the
// launch's epoch (tags start at 1, so the zeroed slots match none); and
// each block's any bits, tag << 32 | bit 4u + j for brick j of unit u.
__device__ unsigned int tickets = 0;
__device__ unsigned int epoch = 0;
__device__ unsigned long long slots[kMaxBlocks];

// Bit k of the result is bit 2k | bit 2k + 1 of r (k < 16): a row of cells
// from the row of cells of half their size.
__device__ __forceinline__ uint32_t fold_pairs(uint32_t r) {
  r = (r | (r >> 1)) & 0x55555555u;
  r = (r | (r >> 1)) & 0x33333333u;
  r = (r | (r >> 2)) & 0x0f0f0f0fu;
  r = (r | (r >> 4)) & 0x00ff00ffu;
  return (r | (r >> 8)) & 0x0000ffffu;
}

__device__ __forceinline__ unsigned long long load_slot(int b) {
  return *reinterpret_cast<volatile unsigned long long*>(&slots[b]);
}

// The box of bricks [b0, b0 + nb) (z, y, x) and its units, in the order
// x (cols), then y (rows), then z.  A wide unit reads x = 32 g + L in lane
// L; a narrow one row by + (L >> 4) at x = 8 bx0 + (L & 15).  Either way
// brick j of the unit is lanes 8j-8j+7.
struct Box {
  int bz0, nbz, by0, nby, bx0, nbx;
  bool narrow;
  int cols, rows;

  __device__ int units() const { return nbz * rows * cols; }
  // Unit i as (c, row, z) counters.
  __device__ void split(int i, int& c, int& r, int& z) const {
    c = i % cols;
    r = (i / cols) % rows;
    z = i / (cols * rows);
  }
  __device__ void next(int& c, int& r, int& z) const {
    if (++c == cols) {
      c = 0;
      if (++r == rows) {
        r = 0;
        ++z;
      }
    }
  }
  __device__ int bz(int z) const { return bz0 + z; }
  __device__ int by(int r) const { return by0 + (narrow ? 2 * r : r); }
  __device__ int x0(int c) const { return narrow ? 8 * bx0 : 32 * ((bx0 >> 2) + c); }
  // Brick j of a unit: its row offset and its bx.
  __device__ int brick_dy(int j) const { return narrow ? j >> 1 : 0; }
  __device__ int brick_x(int j, int c) const { return narrow ? bx0 + (j & 1) : (x0(c) >> 3) + j; }
  __device__ bool has_x(int bx) const { return bx >= bx0 && bx < bx0 + nbx; }
};

__device__ __forceinline__ Box make_box(int bz0, int nbz, int by0, int nby, int bx0,
                                        int nbx) {
  Box b{bz0, nbz, by0, nby, bx0, nbx, nbx == 2 && nby % 2 == 0, 1, nby};
  if (b.narrow) b.rows = nby / 2;
  else b.cols = ((bx0 + nbx + 3) >> 2) - (bx0 >> 2);
  return b;
}

template <int U>
__global__ void __launch_bounds__(kThreads)
    vol_tables_kernel(const int32_t* __restrict__ volume,
                      int32_t* __restrict__ detail, uint8_t* __restrict__ any8b,
                      uint8_t* __restrict__ all8b, int32_t* any8, int32_t* all8,
                      int32_t* __restrict__ any_hi, int bz0, int nbz, int by0,
                      int nby, int bx0, int nbx) {
  static_assert(U * kUnit <= 32, "warp 0 takes a brick a lane");
  __shared__ __align__(16) uint32_t words[U][kUnit * kDetail];
  __shared__ uint32_t plane_any[U][8], plane_all[U][8];
  __shared__ uint32_t w8[kNB * kNB];             // the tail's any8 words
  __shared__ uint32_t block_bits[kMaxBlocks];    // the tail's slots, untagged
  __shared__ uint32_t l16[kLevel16 * kLevel16];  // 16-level rows (z * 16 + y), bit x
  __shared__ uint32_t l32[8 * 8];                // 32-level rows (z * 8 + y), bit x
  __shared__ unsigned tag;
  __shared__ bool last;
  const Box box = make_box(bz0, nbz, by0, nby, bx0, nbx);
  const int units = box.units();
  const int t = threadIdx.x, lane = t & 31, lz = t >> 5;
  // Thread 0 reads the epoch and takes the block's ticket at once: the
  // atomic's round trip overlaps the volume's loads.
  unsigned e = 0;
  bool final_block = false;
  if (t == 0) {
    e = *reinterpret_cast<volatile unsigned*>(&epoch) + 1;
    final_block = atomicAdd(&tickets, 1u) == gridDim.x - 1;
  }

  // 1. The warp's plane of each unit: 8 rows of 32 voxels.
  int32_t v[U][8];
  {
    int c, r, z;
    box.split(min((int)blockIdx.x * U, units - 1), c, r, z);
    const int dy = box.narrow ? lane >> 4 : 0, dx = box.narrow ? lane & 15 : lane;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int32_t* row = volume +
                           ((size_t)(box.bz(z) * 8 + lz) * kN + (box.by(r) + dy) * 8) * kN +
                           box.x0(c) + dx;
#pragma unroll
      for (int ly = 0; ly < 8; ++ly) v[u][ly] = __ldg(row + ly * kN);
      if ((int)blockIdx.x * U + u + 1 < units) box.next(c, r, z);  // a ragged end reads twice
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    uint32_t rows[8], any = 0, all = kFull;
#pragma unroll
    for (int ly = 0; ly < 8; ++ly) {
      rows[ly] = __ballot_sync(kFull, ((uint32_t)v[u][ly] >> 24) == 0);
      any |= rows[ly];
      all &= rows[ly];
    }
    if (lane < kUnit) {
      uint32_t lo = 0, hi = 0;
#pragma unroll
      for (int ly = 0; ly < 4; ++ly) {
        lo |= ((rows[ly] >> (8 * lane)) & 0xffu) << (8 * ly);
        hi |= ((rows[ly + 4] >> (8 * lane)) & 0xffu) << (8 * ly);
      }
      words[u][lane * kDetail + 2 * lz] = lo;
      words[u][lane * kDetail + 2 * lz + 1] = hi;
    }
    if (lane == 0) {
      plane_any[u][lz] = any;
      plane_all[u][lz] = all;
    }
  }
  __syncthreads();

  // 2. The units' detail rows (4 16-byte stores a brick), then warp 0: a
  // brick a lane.
  if (t < U * kUnit * 4) {
    const int u = t >> 4, j = (t >> 2) & 3, i = (int)blockIdx.x * U + u;
    int c, r, z;
    box.split(i, c, r, z);
    const int bx = box.brick_x(j, c);
    if (i < units && box.has_x(bx))
      reinterpret_cast<uint4*>(
          detail + (size_t)((box.bz(z) * kNB + box.by(r) + box.brick_dy(j)) * kNB + bx) *
                       kDetail)[t & 3] = reinterpret_cast<const uint4*>(words[u])[t & 15];
  }
  if (t < 32) {
    const int u = min(lane >> 2, U - 1), j = lane & 3, i = (int)blockIdx.x * U + u;
    int c, r, z;
    box.split(i, c, r, z);
    const int bx = box.brick_x(j, c), row = box.bz(z) * kNB + box.by(r) + box.brick_dy(j);
    const bool mine = lane < U * kUnit && i < units && box.has_x(bx);
    uint32_t a = 0, f = kFull;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      a |= plane_any[u][k];
      f &= plane_all[u][k];
    }
    const bool ba = ((a >> (8 * j)) & 0xffu) != 0, bf = ((f >> (8 * j)) & 0xffu) == 0xffu;
    if (mine) {
      any8b[row * kNB + bx] = ba;
      all8b[row * kNB + bx] = bf;
    }
    const uint32_t m = __ballot_sync(kFull, mine), ab = __ballot_sync(kFull, mine && ba),
                   fb = __ballot_sync(kFull, mine && bf);
    // A lane that starts a brick row of the block sets the bits of all the
    // block's bricks in that row: lanes and bx upward from its own.
    int run = 0;
    if (lane < U * kUnit && i < units) {
      if (box.narrow) run = (j & 1) == 0 ? 2 : 0;
      else if (j == 0 && (u == 0 || c == 0)) run = kUnit * min(U - u, min(box.cols - c, units - i));
    }
    if (run) {
      const uint32_t sel = (1u << run) - 1, mask = ((m >> lane) & sel) << bx;
      unsigned* wa = reinterpret_cast<unsigned*>(any8 + row);
      unsigned* wf = reinterpret_cast<unsigned*>(all8 + row);
      if (mask) {
        atomicAnd(wa, ~mask);
        atomicOr(wa, ((ab >> lane) & sel) << bx);
        atomicAnd(wf, ~mask);
        atomicOr(wf, ((fb >> lane) & sel) << bx);
      }
    }
    if (lane == 0) {
      *reinterpret_cast<volatile unsigned long long*>(&slots[blockIdx.x]) =
          (unsigned long long)e << 32 | ab;
      tag = e;
      last = final_block;
    }
  }
  __syncthreads();
  if (!last) return;

  // 3. The last block: the any8 words, then any_hi from them.  Every
  // thread first issues its loads: its slots and its 4 rows' old words.
  constexpr int kSlotsPerThread = kMaxBlocks / kThreads, kRowsPerThread = kNB * kNB / kThreads;
  const unsigned want = tag;
  unsigned long long sv[kSlotsPerThread];
#pragma unroll
  for (int k = 0; k < kSlotsPerThread; ++k) {
    const int b = t + k * kThreads;
    sv[k] = b < (int)gridDim.x ? load_slot(b) : 0;
  }
  uint32_t old[kRowsPerThread];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k)
    old[k] = __ldcg(reinterpret_cast<const unsigned*>(any8) + t + k * kThreads);
#pragma unroll
  for (int k = 0; k < kSlotsPerThread; ++k) {
    const int b = t + k * kThreads;
    if (b >= (int)gridDim.x) continue;
    while ((unsigned)(sv[k] >> 32) != want) sv[k] = load_slot(b);
    block_bits[b] = (uint32_t)sv[k];
  }
  if (t >= 128) {  // any_hi row 1 outside the 32- and 64-level words is zero
    const int k = t - 128;
    if (k >= 16 && k != 64 && k != 65) any_hi[128 + k] = 0;
  }
  __syncthreads();
  // A row of the box: its old word without the box's bits, and the bits of
  // its units (a unit's bits are 4u-4u+3 of its block's).
  const uint32_t box_bits = nbx == kNB ? kFull : ((1u << nbx) - 1) << bx0;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int r = t + k * kThreads, z = (r >> 5) - bz0, y = (r & 31) - by0;
    uint32_t w = old[k];
    if (z >= 0 && z < nbz && y >= 0 && y < nby) {
      w &= ~box_bits;
      if (box.narrow) {
        const int i = z * box.rows + (y >> 1);
        w |= ((block_bits[i / U] >> (4 * (i % U) + 2 * (y & 1))) & 3u) << bx0;
      } else {
        const int i0 = (z * box.rows + y) * box.cols;
        for (int c = 0; c < box.cols; ++c) {
          const int i = i0 + c;
          w |= ((block_bits[i / U] >> (4 * (i % U))) & 0xfu) << (4 * ((bx0 >> 2) + c));
        }
      }
    }
    w8[r] = w;
  }
  __syncthreads();
  {  // The 16-level bits, (z * 16 + y) * 16 + x: any_hi row 0.
    const int z = t >> 4, y = t & 15, r = 2 * z * kNB + 2 * y;
    const uint32_t h = fold_pairs(w8[r] | w8[r + 1] | w8[r + kNB] | w8[r + kNB + 1]);
    l16[t] = h;
    const uint32_t odd = __shfl_down_sync(kFull, h, 1);
    if ((t & 1) == 0) any_hi[t >> 1] = (int32_t)(h | (odd << 16));
  }
  __syncthreads();
  if (t < 64) {  // The 32-level bits: any_hi row 1, lanes 0-15.
    const int z = t >> 3, y = t & 7, r = 2 * z * kLevel16 + 2 * y;
    const uint32_t h =
        fold_pairs(l16[r] | l16[r + 1] | l16[r + kLevel16] | l16[r + kLevel16 + 1]);
    l32[t] = h;
    uint32_t w = h << (8 * (t & 3));
    w |= __shfl_xor_sync(kFull, w, 1);
    w |= __shfl_xor_sync(kFull, w, 2);
    if ((t & 3) == 0) any_hi[128 + (t >> 2)] = (int32_t)w;
  }
  __syncthreads();
  if (t < 32) {  // The 64-level bits: any_hi row 1, lanes 64-65.
    uint32_t w = 0;
    if (t < 16) {
      const int z = t >> 2, y = t & 3, r = 2 * z * 8 + 2 * y;
      w = fold_pairs(l32[r] | l32[r + 1] | l32[r + 8] | l32[r + 9]) << (4 * (t & 7));
    }
    w |= __shfl_xor_sync(kFull, w, 1);
    w |= __shfl_xor_sync(kFull, w, 2);
    w |= __shfl_xor_sync(kFull, w, 4);
    if (t == 0 || t == 8) any_hi[128 + 64 + (t >> 3)] = (int32_t)w;
    if (t == 0) {
      *reinterpret_cast<volatile unsigned*>(&epoch) = want;
      atomicExch(&tickets, 0u);
    }
  }
}

}  // namespace

// The tables of the (256^3,) int32 volume: detail (32768, 16) int32,
// any8b / all8b (32, 32, 32) bool, any8 / all8 (8, 128) int32 and any_hi
// (2, 128) int32, all written in place; detail 16-byte aligned.  The bricks
// of the box [b0, b0 + nb) (z, y, x, in bricks) are recomputed from the
// volume; the others keep their detail words, any8b / all8b bytes and bits
// of any8 / all8; any_hi is rebuilt from all of them.  A block takes two
// units on a slab (256 blocks), four on a build (2,048 blocks).
extern "C" int rt_vol_tables(const int32_t* volume, int32_t* detail,
                             uint8_t* any8b, uint8_t* all8b, int32_t* any8,
                             int32_t* all8, int32_t* any_hi, int bz0, int nbz,
                             int by0, int nby, int bx0, int nbx,
                             void* stream) {
  if (bz0 < 0 || by0 < 0 || bx0 < 0 || nbz < 1 || nby < 1 || nbx < 1 ||
      bz0 + nbz > kNB || by0 + nby > kNB || bx0 + nbx > kNB ||
      (uintptr_t)detail % 16)
    return (int)cudaErrorInvalidValue;
  const bool narrow = nbx == 2 && nby % 2 == 0;
  const int units = nbz * (narrow ? nby / 2 : nby * (((bx0 + nbx + 3) >> 2) - (bx0 >> 2)));
  cudaStream_t s = (cudaStream_t)stream;
  if (units > 2 * kMaxBlocks)
    vol_tables_kernel<4><<<(units + 3) / 4, kThreads, 0, s>>>(
        volume, detail, any8b, all8b, any8, all8, any_hi, bz0, nbz, by0, nby, bx0, nbx);
  else
    vol_tables_kernel<2><<<(units + 1) / 2, kThreads, 0, s>>>(
        volume, detail, any8b, all8b, any8, all8, any_hi, bz0, nbz, by0, nby, bx0, nbx);
  return (int)cudaGetLastError();
}
