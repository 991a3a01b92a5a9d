// Kernel G1: the fused words of a generated world box, written in place
// into the resident (256^3,) volume.
//
// Replaces the plain jitted JAX data plane raytrace_tpu/render/streaming.py
// `_generate_and_apply` (:79-107, a streamed slab) and `_generate_region`
// (:110-134, a teleport's region), with what they call:
// raytrace_tpu/world/generate.py `generate_box` (:66-105) and
// raytrace_tpu/world/chunk.py `minefield_from_solid` (:58-73).  It is not a
// Pallas kernel.  JAX generates the 64-aligned enclosure of the box
// (320 x 320 x 64 for a 256 x 256 x 16 slab, 320^3 for a region), slices
// the box out, rolls it into texel space and stores it.  G1 writes each
// voxel of the box straight to its texel ((w + 128) & 255 on each axis,
// where `_store_slab`'s roll and narrow put it), computed from its column:
//   - a voxel is solid iff z < H = max(h(x, y), 0) (below the terrain or
//     below z = 0);
//   - a globally aligned 2^l block (l <= 5) is occupied iff its lowest z
//     lies below the maximum of H over the block's columns, so the
//     minefield step of an air voxel is the smallest l in 1..5 with
//     (z & ~(2^l - 1)) < Hmax_l of its column's 2^l block, else 6: five
//     column maxima, no 3-D reduction;
//   - a solid voxel's word is the packed material of its height band
//     (`material_band`, the uint32 modulo), step 0; an air voxel's is
//     step << 24.
// Its plain PyTorch version, ops/worldgen.py `box_words_plain`, computes
// the same formulation (heightmap_grid over the 32-aligned column tiles,
// the column-maximum pyramid, the per-voxel step and material);
// tests/test_torch_worldgen.py holds it word for word against JAX's
// enclosure, chip_smoke.py holds G1 against it.  Built with --fmad=false,
// the heights follow the float32 chain of heightmap_grid exactly (the tile
// stage T1 shares, heightfield.cuh).
//
// One block per 32 x 32-column tile of the box's 32-aligned column cover
// and per kZChunk planes of z, one thread per column: the tile stage gives
// every column's height, shared-memory maxima give the 2-, 4-, 8-, 16- and
// 32-column maxima, then each thread whose column lies in the box walks
// its z planes.  A warp's 32 columns are consecutive in x, so each plane's
// stores are 128 consecutive bytes.
//
// What bounds it on the H100: the bytes it writes, 4 MB for a 256 x 256 x
// 16 slab and 67 MB for a 256^3 region (1.3 us and 20 us at 3.35 TB/s).
// A slab's launch is short of that: its tile stages (a chain of five
// perlin octaves and the barriers) and the launch set its time.

#include "heightfield.cuh"

namespace {

constexpr int kZChunk = 32;  // z planes per block

__global__ void __launch_bounds__(kTileThreads)
    worldgen_kernel(int32_t* __restrict__ volume, int32_t x0, int32_t y0,
                    int32_t z0, int32_t sx, int32_t sy, int32_t sz,
                    int32_t ax0, int32_t ay0, int32_t tiles_x, int32_t seed,
                    int32_t grass, int32_t rock, int32_t snow) {
  __shared__ TileStage stage;
  __shared__ int32_t m0[kTile][kTile];
  __shared__ int32_t m1[kTile / 2][kTile / 2];
  __shared__ int32_t m2[kTile / 4][kTile / 4];
  __shared__ int32_t m3[kTile / 8][kTile / 8];
  __shared__ int32_t m4[kTile / 16][kTile / 16];

  const int t = threadIdx.x;
  const int cx = t % kTile, cy = t / kTile;
  const int32_t tx0 = ax0 + kTile * (int32_t)(blockIdx.x % tiles_x);
  const int32_t ty0 = ay0 + kTile * (int32_t)(blockIdx.x / tiles_x);
  const int32_t h = max(tile_column_height(stage, tx0, ty0, seed), 0);
  m0[cy][cx] = h;
  __syncthreads();
  if (t < (kTile / 2) * (kTile / 2)) {
    int y = t / (kTile / 2), x = t % (kTile / 2);
    m1[y][x] = max(max(m0[2 * y][2 * x], m0[2 * y][2 * x + 1]),
                   max(m0[2 * y + 1][2 * x], m0[2 * y + 1][2 * x + 1]));
  }
  __syncthreads();
  if (t < (kTile / 4) * (kTile / 4)) {
    int y = t / (kTile / 4), x = t % (kTile / 4);
    m2[y][x] = max(max(m1[2 * y][2 * x], m1[2 * y][2 * x + 1]),
                   max(m1[2 * y + 1][2 * x], m1[2 * y + 1][2 * x + 1]));
  }
  __syncthreads();
  if (t < (kTile / 8) * (kTile / 8)) {
    int y = t / (kTile / 8), x = t % (kTile / 8);
    m3[y][x] = max(max(m2[2 * y][2 * x], m2[2 * y][2 * x + 1]),
                   max(m2[2 * y + 1][2 * x], m2[2 * y + 1][2 * x + 1]));
  }
  __syncthreads();
  if (t < (kTile / 16) * (kTile / 16)) {
    int y = t / (kTile / 16), x = t % (kTile / 16);
    m4[y][x] = max(max(m3[2 * y][2 * x], m3[2 * y][2 * x + 1]),
                   max(m3[2 * y + 1][2 * x], m3[2 * y + 1][2 * x + 1]));
  }
  __syncthreads();

  const int32_t wx = tx0 + cx, wy = ty0 + cy;
  if (wx < x0 || wx >= x0 + sx || wy < y0 || wy >= y0 + sy) return;
  const int32_t h1 = m1[cy >> 1][cx >> 1], h2 = m2[cy >> 2][cx >> 2];
  const int32_t h3 = m3[cy >> 3][cx >> 3], h4 = m4[cy >> 4][cx >> 4];
  const int32_t h5 = max(max(m4[0][0], m4[0][1]), max(m4[1][0], m4[1][1]));
  int32_t* col =
      volume + ((wy + kRegion / 2) & (kRegion - 1)) * kRegion +
      ((wx + kRegion / 2) & (kRegion - 1));
  const int32_t zs = z0 + kZChunk * (int32_t)blockIdx.y;
  const int32_t ze = min(zs + kZChunk, z0 + sz);
  for (int32_t z = zs; z < ze; ++z) {
    int32_t word;
    if (z < h) {
      int32_t band = material_band(wx, wy, z, seed);
      word = band == 2 ? grass : (band == 5 ? rock : snow);
    } else {
      int32_t step = (z & ~1) < h1    ? 1
                     : (z & ~3) < h2  ? 2
                     : (z & ~7) < h3  ? 3
                     : (z & ~15) < h4 ? 4
                     : (z & ~31) < h5 ? 5
                                      : 6;
      word = step << 24;
    }
    col[(size_t)((z + kRegion / 2) & (kRegion - 1)) * kRegion * kRegion] = word;
  }
}

}  // namespace

// The world box at (x0, y0, z0) with extents (sx, sy, sz), each 1..256,
// into the (256^3,) int32 volume at texel (w + 128) & 255 per axis; seed
// and the packed grass, rock and snow words.  Nothing is read from the
// device: every argument is a launch argument.
extern "C" int rt_worldgen(int32_t* volume, int x0, int y0, int z0, int sx,
                           int sy, int sz, int seed, int grass, int rock,
                           int snow, void* stream) {
  if (sx < 1 || sy < 1 || sz < 1 || sx > kRegion || sy > kRegion ||
      sz > kRegion)
    return (int)cudaErrorInvalidValue;
  // The 32-aligned column cover (floor division of negative origins).
  const int32_t ax0 = x0 & ~(kTile - 1), ay0 = y0 & ~(kTile - 1);
  const int32_t tiles_x = (((x0 + sx + kTile - 1) & ~(kTile - 1)) - ax0) / kTile;
  const int32_t tiles_y = (((y0 + sy + kTile - 1) & ~(kTile - 1)) - ay0) / kTile;
  dim3 grid(tiles_x * tiles_y, (sz + kZChunk - 1) / kZChunk);
  worldgen_kernel<<<grid, kTileThreads, 0, (cudaStream_t)stream>>>(
      volume, x0, y0, z0, sx, sy, sz, ax0, ay0, tiles_x, seed, grass, rock,
      snow);
  return (int)cudaGetLastError();
}
