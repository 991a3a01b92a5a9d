// Kernel G1: the words of a generated world box, in two modes.
//
// Slab mode (`rt_worldgen`): the fused words written in place into the
// resident (256^3,) volume.  Replaces the plain jitted JAX data plane
// raytrace_tpu/render/streaming.py `_generate_and_apply` (:79-107, a
// streamed slab) and `_generate_region` (:110-134, a teleport's region),
// with what they call: raytrace_tpu/world/generate.py `generate_box`
// (:66-105) and raytrace_tpu/world/chunk.py `minefield_from_solid`
// (:58-73).  JAX generates the 64-aligned enclosure of the box (320 x 320
// x 64 for a 256 x 256 x 16 slab, 320^3 for a region), slices the box out,
// rolls it into texel space and stores it.  G1 writes each voxel of the box
// straight to its texel ((w + 128) & 255 on each axis, where
// `_store_slab`'s roll and narrow put it).
//
// Box mode (`rt_worldgen_box`): the jitted `generate_box` itself
// (world/generate.py:66-105 with `minefield_from_solid`), for a 64-aligned
// box with 64-multiple extents, as the chunk cache's misses, generate_world
// (one x-row of chunks) and the benchmark's worlds call it.  Three dense
// (Z, Y, X) outputs: `materials` (int32, the packed word where solid, else
// 0), `minefield` (uint8, 0 where solid, else the step) and `solid` (bool).
//
// Both modes compute one formulation, each voxel from its column:
//   - a voxel is solid iff z < H = max(h(x, y), 0) (below the terrain or
//     below z = 0);
//   - a globally aligned 2^l block (l <= 5) is occupied iff its lowest z
//     lies below the maximum of H over the block's columns, so the
//     minefield step of an air voxel is the smallest l in 1..5 with
//     (z & ~(2^l - 1)) < Hmax_l of its column's 2^l block, else 6: five
//     column maxima, no 3-D reduction;
//   - a solid voxel's word is the packed material of its height band
//     (`material_band`, the uint32 modulo), step 0; an air voxel's is
//     step << 24.  The packed materials lie below 2^24, so the word's low
//     24 bits are the material and its high byte the step.
// Its plain PyTorch version, ops/worldgen.py `box_words_plain` (split into
// the three outputs by `box_plain`), computes the same formulation
// (heightmap_grid over the 32-aligned column tiles, the column-maximum
// pyramid, the per-voxel step and material); tests/test_torch_worldgen.py
// holds it word for word against JAX's `generate_box`, chip_smoke.py holds
// G1 against it (slab mode) and against world/generate.py
// `generate_box_plain` (box mode).  Built with --fmad=false, the heights
// follow the float32 chain of heightmap_grid exactly (the tile stage T1
// shares, heightfield.cuh).
//
// One block per 32 x 32-column tile of the box's 32-aligned column cover
// and per kZChunk planes of z, one thread per column: the tile stage gives
// every column's height, shared-memory maxima give the 2-, 4-, 8-, 16- and
// 32-column maxima (`tile_column`), then each thread whose column lies in
// the box walks its z planes (`voxel_word`).  The two modes differ only in
// the store.  A warp's 32 columns are consecutive in x, so each plane's
// int32 stores are 128 consecutive bytes (and the box mode's uint8 and bool
// stores 32).
//
// What bounds it on the H100: the bytes it writes, 4 B a voxel in slab
// mode (4 MB for a 256 x 256 x 16 slab, 67 MB for a 256^3 region: 1.3 us
// and 20 us at 3.35 TB/s) and 6 B a voxel in box mode (a 64^3 chunk 1.57
// MB, 0.47 us; a 512 x 64 x 64 row 3.8 us; a 256^3 box 30 us).  A small
// box's launch is short of that: its tile stages (a chain of five perlin
// octaves and the barriers) and the launch set its time.

#include "heightfield.cuh"

namespace {

constexpr int kZChunk = 32;  // z planes per block
constexpr int kChunk = 64;   // the box mode's alignment
constexpr int32_t kMaterialMask = (1 << 24) - 1;

// A tile's stage and its column-maximum pyramid, in shared memory.
struct WorldTile {
  TileStage stage;
  int32_t m0[kTile][kTile];
  int32_t m1[kTile / 2][kTile / 2];
  int32_t m2[kTile / 4][kTile / 4];
  int32_t m3[kTile / 8][kTile / 8];
  int32_t m4[kTile / 16][kTile / 16];
};

// A thread's column: its world (x, y), H = max(h, 0), and the maxima of H
// over its 2-, 4-, 8-, 16- and 32-column blocks.
struct Column {
  int32_t wx, wy, h, h1, h2, h3, h4, h5;
};

// The column of thread t in the tile whose first column is (tx0, ty0).
// Every thread of the block must call it.
__device__ Column tile_column(WorldTile& s, int32_t tx0, int32_t ty0,
                              int32_t seed) {
  const int t = threadIdx.x;
  const int cx = t % kTile, cy = t / kTile;
  const int32_t h = max(tile_column_height(s.stage, tx0, ty0, seed), 0);
  s.m0[cy][cx] = h;
  __syncthreads();
  if (t < (kTile / 2) * (kTile / 2)) {
    int y = t / (kTile / 2), x = t % (kTile / 2);
    s.m1[y][x] = max(max(s.m0[2 * y][2 * x], s.m0[2 * y][2 * x + 1]),
                     max(s.m0[2 * y + 1][2 * x], s.m0[2 * y + 1][2 * x + 1]));
  }
  __syncthreads();
  if (t < (kTile / 4) * (kTile / 4)) {
    int y = t / (kTile / 4), x = t % (kTile / 4);
    s.m2[y][x] = max(max(s.m1[2 * y][2 * x], s.m1[2 * y][2 * x + 1]),
                     max(s.m1[2 * y + 1][2 * x], s.m1[2 * y + 1][2 * x + 1]));
  }
  __syncthreads();
  if (t < (kTile / 8) * (kTile / 8)) {
    int y = t / (kTile / 8), x = t % (kTile / 8);
    s.m3[y][x] = max(max(s.m2[2 * y][2 * x], s.m2[2 * y][2 * x + 1]),
                     max(s.m2[2 * y + 1][2 * x], s.m2[2 * y + 1][2 * x + 1]));
  }
  __syncthreads();
  if (t < (kTile / 16) * (kTile / 16)) {
    int y = t / (kTile / 16), x = t % (kTile / 16);
    s.m4[y][x] = max(max(s.m3[2 * y][2 * x], s.m3[2 * y][2 * x + 1]),
                     max(s.m3[2 * y + 1][2 * x], s.m3[2 * y + 1][2 * x + 1]));
  }
  __syncthreads();
  Column c;
  c.wx = tx0 + cx;
  c.wy = ty0 + cy;
  c.h = h;
  c.h1 = s.m1[cy >> 1][cx >> 1];
  c.h2 = s.m2[cy >> 2][cx >> 2];
  c.h3 = s.m3[cy >> 3][cx >> 3];
  c.h4 = s.m4[cy >> 4][cx >> 4];
  c.h5 = max(max(s.m4[0][0], s.m4[0][1]), max(s.m4[1][0], s.m4[1][1]));
  return c;
}

// The fused word of the voxel at height z of column c.
__device__ __forceinline__ int32_t voxel_word(const Column& c, int32_t z,
                                              int32_t seed, int32_t grass,
                                              int32_t rock, int32_t snow) {
  if (z < c.h) {
    int32_t band = material_band(c.wx, c.wy, z, seed);
    return band == 2 ? grass : (band == 5 ? rock : snow);
  }
  int32_t step = (z & ~1) < c.h1    ? 1
                 : (z & ~3) < c.h2  ? 2
                 : (z & ~7) < c.h3  ? 3
                 : (z & ~15) < c.h4 ? 4
                 : (z & ~31) < c.h5 ? 5
                                    : 6;
  return step << 24;
}

__global__ void __launch_bounds__(kTileThreads)
    worldgen_kernel(int32_t* __restrict__ volume, int32_t x0, int32_t y0,
                    int32_t z0, int32_t sx, int32_t sy, int32_t sz,
                    int32_t ax0, int32_t ay0, int32_t tiles_x, int32_t seed,
                    int32_t grass, int32_t rock, int32_t snow) {
  __shared__ WorldTile tile;
  const Column c =
      tile_column(tile, ax0 + kTile * (int32_t)(blockIdx.x % tiles_x),
                  ay0 + kTile * (int32_t)(blockIdx.x / tiles_x), seed);
  if (c.wx < x0 || c.wx >= x0 + sx || c.wy < y0 || c.wy >= y0 + sy) return;
  int32_t* col =
      volume + ((c.wy + kRegion / 2) & (kRegion - 1)) * kRegion +
      ((c.wx + kRegion / 2) & (kRegion - 1));
  const int32_t zs = z0 + kZChunk * (int32_t)blockIdx.y;
  const int32_t ze = min(zs + kZChunk, z0 + sz);
  for (int32_t z = zs; z < ze; ++z)
    col[(size_t)((z + kRegion / 2) & (kRegion - 1)) * kRegion * kRegion] =
        voxel_word(c, z, seed, grass, rock, snow);
}

// The box is 64-aligned with 64-multiple extents, so its column cover is
// the box itself and every block's kZChunk planes lie in it.
__global__ void __launch_bounds__(kTileThreads)
    worldgen_box_kernel(int32_t* __restrict__ materials,
                        uint8_t* __restrict__ minefield,
                        bool* __restrict__ solid, int32_t x0, int32_t y0,
                        int32_t z0, int32_t sx, int32_t sy, int32_t tiles_x,
                        int32_t seed, int32_t grass, int32_t rock,
                        int32_t snow) {
  __shared__ WorldTile tile;
  const Column c =
      tile_column(tile, x0 + kTile * (int32_t)(blockIdx.x % tiles_x),
                  y0 + kTile * (int32_t)(blockIdx.x / tiles_x), seed);
  const size_t plane = (size_t)sx * sy;
  size_t i = (size_t)kZChunk * blockIdx.y * plane +
             (size_t)(c.wy - y0) * sx + (c.wx - x0);
  const int32_t zs = z0 + kZChunk * (int32_t)blockIdx.y;
  for (int32_t z = zs; z < zs + kZChunk; ++z, i += plane) {
    const int32_t word = voxel_word(c, z, seed, grass, rock, snow);
    const uint32_t step = (uint32_t)word >> 24;
    materials[i] = word & kMaterialMask;
    minefield[i] = (uint8_t)step;
    solid[i] = step == 0;
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

// The box mode: the 64-aligned world box at (x0, y0, z0) with 64-multiple
// extents (sx, sy, sz) into dense (sz, sy, sx) materials (int32),
// minefield (uint8) and solid (bool); seed and the packed grass, rock and
// snow words.  One launch, every value a launch argument.  A box that is
// not 64-aligned, or whose grid exceeds the launch limits (2^31 - 1 tiles,
// 65535 z chunks), is refused.
extern "C" int rt_worldgen_box(int32_t* materials, uint8_t* minefield,
                               bool* solid, int x0, int y0, int z0, int sx,
                               int sy, int sz, int seed, int grass, int rock,
                               int snow, void* stream) {
  if (sx < 1 || sy < 1 || sz < 1 ||
      ((x0 | y0 | z0 | sx | sy | sz) & (kChunk - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const int32_t tiles_x = sx / kTile;
  const long long tiles = (long long)tiles_x * (sy / kTile);
  if (tiles > 0x7fffffffLL || sz / kZChunk > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)tiles, sz / kZChunk);
  worldgen_box_kernel<<<grid, kTileThreads, 0, (cudaStream_t)stream>>>(
      materials, minefield, solid, x0, y0, z0, sx, sy, tiles_x, seed, grass,
      rock, snow);
  return (int)cudaGetLastError();
}
