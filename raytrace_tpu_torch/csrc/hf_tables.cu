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
// One block per 32 x 32-column tile of the 256 x 256-column region (64
// blocks, the tiles of the 32-block pyramid level), one thread per column:
//   1. The tile stage that T1 shares with G1 (heightfield.cuh
//      `tile_column_height`): the tile's 5 x 5 lattice words, five noise
//      samples of a point side by side.
//   2. Each thread blends its column's height from its block's four
//      corner words (`height_from_corners`) and writes `hcol` (when it is
//      asked for); max(h, 0) + 1 goes to shared memory.
//   3. Maxima over 4-, 8-, 16- and 32-column blocks in shared memory; one
//      thread per 8-block packs its `h3` and `hsub` words and writes its
//      four corner words.  No two blocks write the same word.
// `heightmap_grid`, from which the plain version takes the pyramid,
// evaluates the same lattice points and the same per-column arithmetic as
// `height_from_corners` when r0 is a multiple of 8 (the streamer moves `lr`
// on the 16-voxel slice grid), so one evaluation serves both.
//
// `lr` comes either from the packed (16,) frame uniforms, as `_rffp_impl`
// takes it (`lr.x = int(packed[14])`, `lr.y = 0`), or from an int32 (3,)
// vector; r0 = (lr.x - 128, lr.y - 128).  No host value enters the launch,
// so the kernel can sit inside a captured CUDA graph and rebuild the tables
// of each replay's uniforms.
//
// What bounds it on the H100: its latency.  It moves 156 KB (6 x 4 KB of
// words, 128 KB of column heights) and does ~6.4M float32 operations
// (1,089 lattice points of 13 perlin octaves, 65,536 columns of one
// octave and a powf): well under a microsecond at the card's rates.  Its
// time is the launch, the lattice stage's chain of five perlin octaves and
// the reductions' barriers.

#include "heightfield.cuh"

namespace {

constexpr int kTilesPerSide = kRegion / kTile;  // 8
constexpr int kThreads = kTileThreads;          // one per column

__global__ void __launch_bounds__(kThreads)
    hf_tables_kernel(const float* __restrict__ packed,
                     const int32_t* __restrict__ lr, int32_t seed,
                     int32_t* __restrict__ h3, int32_t* __restrict__ hsub,
                     int32_t* __restrict__ ca, int32_t* __restrict__ cb,
                     int32_t* __restrict__ cc, int32_t* __restrict__ cd,
                     int32_t* __restrict__ r0, int16_t* __restrict__ hcol) {
  __shared__ TileStage stage;
  __shared__ int32_t hs[kTile][kTile];
  __shared__ int32_t h2s[kTile / 4][kTile / 4];
  __shared__ int32_t h3s[kTile / 8][kTile / 8];

  const int t = threadIdx.x;
  const int tile_x = blockIdx.x % kTilesPerSide;
  const int tile_y = blockIdx.x / kTilesPerSide;
  const int32_t lrx = packed != nullptr ? (int32_t)packed[14] : lr[0];
  const int32_t lry = packed != nullptr ? 0 : lr[1];
  const int32_t r0x = lrx - 128, r0y = lry - 128;
  if (blockIdx.x == 0 && t == 0) {
    r0[0] = r0x;
    r0[1] = r0y;
  }

  // 1-2. The tile's lattice words, then the thread's column.
  const int cx = t % kTile, cy = t / kTile;
  const int rx = tile_x * kTile + cx, ry = tile_y * kTile + cy;
  int32_t h = tile_column_height(stage, r0x + tile_x * kTile,
                                 r0y + tile_y * kTile, seed);
  h = max(h, 0);
  if (hcol != nullptr) hcol[ry * kRegion + rx] = (int16_t)h;
  hs[cy][cx] = h + 1;
  __syncthreads();

  // 3. The pyramid: 4-blocks, then 8-blocks, then each 8-block's words.
  if (t < (kTile / 4) * (kTile / 4)) {
    int qy = t / (kTile / 4), qx = t % (kTile / 4);
    int32_t m = 0;
    for (int y = 0; y < 4; ++y)
      for (int x = 0; x < 4; ++x) m = max(m, hs[qy * 4 + y][qx * 4 + x]);
    h2s[qy][qx] = m;
  }
  __syncthreads();
  const int nb = kTile / 8;  // 8-blocks per tile side
  if (t < nb * nb) {
    int by = t / nb, bx = t % nb;
    h3s[by][bx] = max(max(h2s[2 * by][2 * bx], h2s[2 * by][2 * bx + 1]),
                      max(h2s[2 * by + 1][2 * bx], h2s[2 * by + 1][2 * bx + 1]));
  }
  __syncthreads();
  if (t < nb * nb) {
    int by = t / nb, bx = t % nb;
    int32_t h8 = h3s[by][bx];
    int y16 = by & ~1, x16 = bx & ~1;
    int32_t h16 = max(max(h3s[y16][x16], h3s[y16][x16 + 1]),
                      max(h3s[y16 + 1][x16], h3s[y16 + 1][x16 + 1]));
    int32_t h32 = 0;
    for (int k = 0; k < nb * nb; ++k) h32 = max(h32, h3s[k / nb][k % nb]);
    uint32_t sub = 0;
    for (int k = 0; k < 4; ++k) {  // bytes (y, x) = (0,0), (0,1), (1,0), (1,1)
      int32_t d = h8 - h2s[2 * by + (k >> 1)][2 * bx + (k & 1)];
      sub |= (uint32_t)min(max(d, 0), 255) << (8 * k);
    }
    int w = (tile_y * nb + by) * (kRegion / 8) + tile_x * nb + bx;
    h3[w] = h8 | (h16 << 9) | (h32 << 18);
    hsub[w] = (int32_t)sub;
    ca[w] = stage.lat[by][bx];
    cb[w] = stage.lat[by][bx + 1];
    cc[w] = stage.lat[by + 1][bx];
    cd[w] = stage.lat[by + 1][bx + 1];
  }
}

}  // namespace

// Exactly one of `packed` and `lr` is non-null.  Outputs: six (1024,)
// int32 tables, r0 (2,) int32 and, unless it is null, hcol (65536,) int16.
extern "C" int rt_hf_tables(const float* packed, const int32_t* lr, int seed,
                            int32_t* h3, int32_t* hsub, int32_t* ca,
                            int32_t* cb, int32_t* cc, int32_t* cd,
                            int32_t* r0, int16_t* hcol, void* stream) {
  if ((packed == nullptr) == (lr == nullptr)) return (int)cudaErrorInvalidValue;
  hf_tables_kernel<<<kTilesPerSide * kTilesPerSide, kThreads, 0,
                     (cudaStream_t)stream>>>(packed, lr, seed, h3, hsub, ca,
                                             cb, cc, cd, r0, hcol);
  return (int)cudaGetLastError();
}
