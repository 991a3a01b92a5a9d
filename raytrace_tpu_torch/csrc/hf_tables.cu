// Kernel T1: the heightfield region tables, built on the card from the
// region offset `lr` that lies in device memory.
//
// Replaces the plain jitted JAX function raytrace_tpu/ops/trace_pallas.py
// `build_hf_tables` (:60-133), which the JAX frame program `_rffp_impl`
// (raytrace_tpu/render/pipeline.py:198-238) runs inside its one dispatch,
// so that a slice crossing costs the frame no extra dispatch.  It is not a
// Pallas kernel.  Its plain PyTorch version is `build_hf_tables_plain`
// followed by `column_heights` in ops/hf_tables.py: T1 writes the same
// words, `h3`, `hsub`, `cA`..`cD`, `r0` and the column table `hcol` K1
// reads, built with --fmad=false from the same float32 operations in the
// same order.
//
// 256 blocks of 256 threads: one cluster of four blocks per 32 x 32-column
// tile of the 256 x 256-column region (the tiles of the 32-block pyramid
// level), one block per strip of 8 rows, one thread per column:
//   1. The tile stage that T1 shares with G1 (heightfield.cuh
//      `strip_column`): the strip's lattice words, one perlin octave a
//      thread; each column's height (`height_from_corners`) and the maxima
//      of max(h, 0) over its 2- to 32-column blocks (warp shuffles along x,
//      the strip's rows in shared memory, the 16- and 32-row blocks from
//      the cluster's neighbours).
//   2. Each thread writes its column's `hcol` (when it is asked for); the
//      first column's thread of each 8-block reads its four 4-block maxima
//      from the strip's shared rows and packs its `h3` and `hsub` words
//      (the maxima + 1) and writes its four corner words.  No two blocks
//      write the same word.
// `heightmap_grid`, from which the plain version takes the pyramid,
// evaluates the same lattice points and the same per-column arithmetic as
// `height_from_corners` when r0 is a multiple of 8 (the streamer moves `lr`
// on the 16-voxel slice grid), so one evaluation serves both.
//
// `lr` comes either from the packed (16,) frame uniforms, as `_rffp_impl`
// takes it (`lr.x = int(packed[14])`, `lr.y = 0`), or from an int32 (3,)
// vector; r0 = (lr.x - 128, lr.y - 128).  No host value enters the launch,
// so the kernel can sit inside a captured CUDA graph and rebuild the tables
// of each replay's uniforms.  With a `key`, an int32 (4,) vector
// (lr.x, lr.y, seed, valid) that says what the output buffers hold, every
// block returns at entry when the key holds this launch's lr and seed with
// valid 1; otherwise the blocks build, and the last block to finish (an
// atomic ticket after a fence) writes the key and resets the ticket.  The
// key changes only after every block has read it, so no block skips its
// part of a build.  Keyed launches on one device run one at a time (they
// share the ticket): a frame program's replays are in stream order.
//
// What bounds it on the H100: its latency.  It moves 156 KB (6 x 4 KB of
// words, 128 KB of column heights) and does ~6.4M float32 operations
// (1,089 lattice points of 13 perlin octaves, 65,536 columns of one
// octave and a powf): well under a microsecond at the card's rates.  Its
// time is the launch, one perlin octave, the lattice fold, one column
// height and the cluster's barrier; a launch whose key matches is
// the launch alone.

#include "heightfield.cuh"

namespace {

constexpr int kTilesPerSide = kRegion / kTile;                    // 8
constexpr int kBlocks = kTilesPerSide * kTilesPerSide * kStrips;  // 256

// The blocks of the running keyed launch that have built their strip.
__device__ unsigned int built_blocks = 0;

__global__ void __cluster_dims__(kStrips, 1, 1) __launch_bounds__(kStripThreads)
    hf_tables_kernel(const float* __restrict__ packed,
                     const int32_t* __restrict__ lr, int32_t seed,
                     int32_t* key, int32_t* __restrict__ h3,
                     int32_t* __restrict__ hsub, int32_t* __restrict__ ca,
                     int32_t* __restrict__ cb, int32_t* __restrict__ cc,
                     int32_t* __restrict__ cd, int32_t* __restrict__ r0,
                     int16_t* __restrict__ hcol) {
  __shared__ StripStage stage;
  __shared__ int32_t entry[3];  // lr.x, lr.y, and whether the key holds them

  // 0. One thread of the block reads lr and the key (every block reading
  // them from every thread queues thousands of loads on one line of L2).
  // When the buffers already hold this region's tables there is nothing to
  // do.  A key changes only between launches, so every block, and so every
  // block of a cluster, takes the same branch.
  const int t = threadIdx.x;
  if (t == 0) {
    const int32_t x = packed != nullptr ? (int32_t)packed[14] : lr[0];
    const int32_t y = packed != nullptr ? 0 : lr[1];
    bool held = false;
    if (key != nullptr) {
      const int32_t k0 = __ldcg(key), k1 = __ldcg(key + 1),
                    k2 = __ldcg(key + 2), k3 = __ldcg(key + 3);
      held = (k3 == 1) & (k0 == x) & (k1 == y) & (k2 == seed);
    }
    entry[0] = x;
    entry[1] = y;
    entry[2] = held;
  }
  __syncthreads();
  if (entry[2]) return;
  const int32_t lrx = entry[0], lry = entry[1];
  const int32_t r0x = lrx - 128, r0y = lry - 128;
  if (blockIdx.x == 0 && t == 0) {
    r0[0] = r0x;
    r0[1] = r0y;
  }

  // 1. The tile stage.
  const int tile = blockIdx.x / kStrips, rank = blockIdx.x % kStrips;
  const int tile_x = tile % kTilesPerSide, tile_y = tile / kTilesPerSide;
  const Column c = strip_column(stage, r0x + kTile * tile_x,
                                r0y + kTile * tile_y, seed);

  // 2. The thread's column, then its 8-block's words.
  const int cx = t % kTile, cy = t / kTile;
  const int rx = kTile * tile_x + cx;
  const int ry = kTile * tile_y + kStripRows * rank + cy;
  if (hcol != nullptr) hcol[ry * kRegion + rx] = (int16_t)c.h;
  if (cy == 0 && (cx & 7) == 0) {
    const int bx = cx >> 3;
    const int32_t h8 = c.h3 + 1;
    uint32_t sub = 0;
    for (int k = 0; k < 4; ++k) {  // bytes (y, x) = (0,0), (0,1), (1,0), (1,1)
      int32_t q = 0;               // the 4-block's maximum of max(h, 0)
      for (int r = 0; r < 4; ++r)
        q = max(q, stage.xmax[1][4 * (k >> 1) + r][cx + 4 * (k & 1)]);
      int32_t d = h8 - (q + 1);
      sub |= (uint32_t)min(max(d, 0), 255) << (8 * k);
    }
    const int w = (ry >> 3) * (kRegion / 8) + (rx >> 3);
    h3[w] = h8 | ((c.h4 + 1) << 9) | ((c.h5 + 1) << 18);
    hsub[w] = (int32_t)sub;
    ca[w] = stage.lat[0][bx];
    cb[w] = stage.lat[0][bx + 1];
    cc[w] = stage.lat[1][bx];
    cd[w] = stage.lat[1][bx + 1];
  }

  // 3. The last block to finish a keyed build records what it built.
  if (key != nullptr && t == 0) {
    __threadfence();
    if (atomicAdd(&built_blocks, 1u) == gridDim.x - 1) {
      key[0] = lrx;
      key[1] = lry;
      key[2] = seed;
      key[3] = 1;
      atomicExch(&built_blocks, 0u);
    }
  }
}

}  // namespace

// Exactly one of `packed` and `lr` is non-null; `key` may be null (always
// build).  Outputs: six (1024,) int32 tables, r0 (2,) int32 and, unless it
// is null, hcol (65536,) int16.
extern "C" int rt_hf_tables(const float* packed, const int32_t* lr, int seed,
                            int32_t* key, int32_t* h3, int32_t* hsub,
                            int32_t* ca, int32_t* cb, int32_t* cc, int32_t* cd,
                            int32_t* r0, int16_t* hcol, void* stream) {
  if ((packed == nullptr) == (lr == nullptr)) return (int)cudaErrorInvalidValue;
  hf_tables_kernel<<<kBlocks, kStripThreads, 0, (cudaStream_t)stream>>>(
      packed, lr, seed, key, h3, hsub, ca, cb, cc, cd, r0, hcol);
  return (int)cudaGetLastError();
}
