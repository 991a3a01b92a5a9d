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
// Without a minefield buffer it is `generate_box(..., with_minefield=False)`,
// which takes any box (extents >= 1 at any integer origin) and writes
// `materials` and `solid` only (`worldgen_box_kernel<false>`): its column
// cover is 32-aligned, as the slab mode's, so the tile stage sees aligned
// strips whatever the box, and the columns and planes of the cover that lie
// outside the box (its partial strips and its last z chunk) store nothing.
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
// A cluster of four blocks per 32 x 32-column tile of the box's 32-aligned
// column cover, one block per strip of 8 rows (256 threads, one per
// column), times a chunk of z planes: the tile stage (heightfield.cuh
// `strip_column`: the strip's lattice words one perlin octave a thread,
// each column's height, its 2- to 32-column maxima by warp shuffles, the
// strip's rows and the cluster's neighbours) gives each thread its column,
// then each thread whose column lies in the box walks its z planes
// (`voxel_word`).  The two modes differ only in the store.  A warp's 32
// columns are consecutive in x, so each plane's int32 stores are 128
// consecutive bytes (and the box mode's uint8 and bool stores 32), four
// planes to an unrolled step.  A block takes kZChunk = 64 planes, or fewer
// where the strips that meet the box would give fewer blocks than the card
// has SMs (`z_chunk`: a 64^3 chunk is 256 blocks of 4 planes, a slab 16
// rows deep 32-plane blocks, a 256^3 region 64-plane ones); each block
// computes its own tile stage.
//
// What bounds it on the H100: the bytes it writes, 4 B a voxel in slab
// mode (4 MB for a 256 x 256 x 16 slab, 67 MB for a 256^3 region: 1.3 us
// and 20 us at 3.35 TB/s) and 6 B a voxel in box mode (a 64^3 chunk 1.57
// MB, 0.47 us; a 512 x 64 x 64 row 3.8 us; a 256^3 box 30 us), 5 B a voxel
// without the minefield (a 256^3 box 25 us).  A small
// box's launch is short of that: the launch, the tile stage's latency (one
// perlin octave, the lattice fold, one column height, the cluster's
// barrier) and a few planes a thread set its time.

#include "heightfield.cuh"

namespace {

constexpr int kZChunk = 64;  // z planes per block, at most
constexpr int kChunk = 64;   // the box mode's alignment
constexpr int32_t kMaterialMask = (1 << 24) - 1;

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

__global__ void __cluster_dims__(kStrips, 1, 1) __launch_bounds__(kStripThreads)
    worldgen_kernel(int32_t* __restrict__ volume, int32_t x0, int32_t y0,
                    int32_t z0, int32_t sx, int32_t sy, int32_t sz,
                    int32_t ax0, int32_t ay0, int32_t tiles_x, int32_t zc,
                    int32_t seed, int32_t grass, int32_t rock, int32_t snow) {
  __shared__ StripStage stage;
  const int32_t tile = (int32_t)(blockIdx.x / kStrips);
  const Column c = strip_column(stage, ax0 + kTile * (tile % tiles_x),
                                ay0 + kTile * (tile / tiles_x), seed);
  if (c.wx >= x0 && c.wx < x0 + sx && c.wy >= y0 && c.wy < y0 + sy) {
    int32_t* col = volume +
                   ((c.wy + kRegion / 2) & (kRegion - 1)) * kRegion +
                   ((c.wx + kRegion / 2) & (kRegion - 1));
    const int32_t zs = z0 + zc * (int32_t)blockIdx.y;
    const int32_t ze = min(zs + zc, z0 + sz);
#pragma unroll 4
    for (int32_t z = zs; z < ze; ++z)
      col[(size_t)((z + kRegion / 2) & (kRegion - 1)) * kRegion * kRegion] =
          voxel_word(c, z, seed, grass, rock, snow);
  }
}

// The box mode, in two instances.  With the minefield (kMinefield) the box
// is 64-aligned with 64-multiple extents, so its column cover is the box
// itself and every block's zc planes lie in it: no guard, and three stores
// a voxel.  Without it, any box: the cover is 32-aligned, a column of it
// outside the box and the planes of a block past the box's end store
// nothing, and a voxel stores materials and solid.
template <bool kMinefield>
__global__ void __cluster_dims__(kStrips, 1, 1) __launch_bounds__(kStripThreads)
    worldgen_box_kernel(int32_t* __restrict__ materials,
                        uint8_t* __restrict__ minefield,
                        bool* __restrict__ solid, int32_t x0, int32_t y0,
                        int32_t z0, int32_t sx, int32_t sy, int32_t sz,
                        int32_t ax0, int32_t ay0, int32_t tiles_x, int32_t zc,
                        int32_t seed, int32_t grass, int32_t rock,
                        int32_t snow) {
  __shared__ StripStage stage;
  const long long tile = blockIdx.x / kStrips;
  const Column c = strip_column(
      stage, (kMinefield ? x0 : ax0) + kTile * (int32_t)(tile % tiles_x),
      (kMinefield ? y0 : ay0) + kTile * (int32_t)(tile / tiles_x), seed);
  if (!kMinefield &&
      (c.wx < x0 || c.wx - x0 >= sx || c.wy < y0 || c.wy - y0 >= sy))
    return;
  const size_t plane = (size_t)sx * sy;
  size_t i = (size_t)zc * blockIdx.y * plane + (size_t)(c.wy - y0) * sx +
             (c.wx - x0);
  const int32_t zs = z0 + zc * (int32_t)blockIdx.y;
  const int32_t ze = kMinefield ? zs + zc : min(zs + zc, z0 + sz);
#pragma unroll 4
  for (int32_t z = zs; z < ze; ++z, i += plane) {
    const int32_t word = voxel_word(c, z, seed, grass, rock, snow);
    const uint32_t step = (uint32_t)word >> 24;
    materials[i] = word & kMaterialMask;
    if (kMinefield) minefield[i] = (uint8_t)step;
    solid[i] = step == 0;
  }
}

// The z planes a block takes, for `active` strips of columns in the box
// and `sz` planes: kZChunk, halved while the blocks of those strips are
// fewer than the card's SMs (down to one plane).  A block's tile stage
// costs about what a few dozen of its planes do, so large boxes take long
// chunks; a small box takes short ones to spread over the card.
cudaError_t z_chunk(long long active, int sz, int* zc) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  *zc = kZChunk;
  while (*zc > 1 && active * ((sz + *zc - 1) / *zc) < sms) *zc >>= 1;
  return err;
}

// floor(v / 8) for any sign.
__host__ __forceinline__ long long floor8(long long v) {
  return v >= 0 ? v / 8 : -((7 - v) / 8);
}

// The grid of a box: (blocks in x, z chunks), its tile origin and tiles
// along x, and the planes a block takes.  A box whose grid exceeds the
// launch limits (2^31 - 1 blocks in x, 65535 z chunks) is refused.
struct Grid {
  dim3 blocks;
  int32_t ax0, ay0, tiles_x, zc;
};

cudaError_t grid_of(int x0, int y0, int sx, int sy, int sz, Grid* g) {
  // The 32-aligned column cover (floor division of negative origins).
  g->ax0 = x0 & ~(kTile - 1);
  g->ay0 = y0 & ~(kTile - 1);
  g->tiles_x = (int32_t)(((x0 + (long long)sx + kTile - 1) & ~(kTile - 1)) - g->ax0) / kTile;
  const long long tiles_y =
      (((y0 + (long long)sy + kTile - 1) & ~(kTile - 1)) - g->ay0) / kTile;
  const long long strips = (long long)g->tiles_x * tiles_y * kStrips;
  // The strips whose 8 rows meet the box: a slab 16 rows deep meets two of
  // its tiles' four.
  const long long active =
      (long long)g->tiles_x * (floor8(y0 + (long long)sy + 7) - floor8(y0));
  cudaError_t err = z_chunk(active, sz, &g->zc);
  const long long chunks = (sz + g->zc - 1) / g->zc;
  if (err == cudaSuccess && (strips > 0x7fffffffLL || chunks > 65535))
    err = cudaErrorInvalidValue;
  g->blocks = dim3((unsigned)strips, (unsigned)chunks);
  return err;
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
  Grid g;
  cudaError_t err = grid_of(x0, y0, sx, sy, sz, &g);
  if (err != cudaSuccess) return (int)err;
  worldgen_kernel<<<g.blocks, kStripThreads, 0, (cudaStream_t)stream>>>(
      volume, x0, y0, z0, sx, sy, sz, g.ax0, g.ay0, g.tiles_x, g.zc, seed,
      grass, rock, snow);
  return (int)cudaGetLastError();
}

// The box mode: the 64-aligned world box at (x0, y0, z0) with 64-multiple
// extents (sx, sy, sz) into dense (sz, sy, sx) materials (int32),
// minefield (uint8) and solid (bool); seed and the packed grass, rock and
// snow words.  One launch, every value a launch argument.  A box that is
// not 64-aligned, or whose grid exceeds the launch limits, is refused.
// With `minefield` null, any box of extents >= 1 into materials and solid
// alone (`worldgen_box_kernel<false>`), one launch as well.
extern "C" int rt_worldgen_box(int32_t* materials, uint8_t* minefield,
                               bool* solid, int x0, int y0, int z0, int sx,
                               int sy, int sz, int seed, int grass, int rock,
                               int snow, void* stream) {
  if (sx < 1 || sy < 1 || sz < 1 ||
      (minefield != nullptr &&
       ((x0 | y0 | z0 | sx | sy | sz) & (kChunk - 1)) != 0))
    return (int)cudaErrorInvalidValue;
  Grid g;
  cudaError_t err = grid_of(x0, y0, sx, sy, sz, &g);
  if (err != cudaSuccess) return (int)err;
  if (minefield == nullptr)
    worldgen_box_kernel<false><<<g.blocks, kStripThreads, 0,
                                 (cudaStream_t)stream>>>(
        materials, nullptr, solid, x0, y0, z0, sx, sy, sz, g.ax0, g.ay0,
        g.tiles_x, g.zc, seed, grass, rock, snow);
  else
    worldgen_box_kernel<true><<<g.blocks, kStripThreads, 0,
                                (cudaStream_t)stream>>>(
        materials, minefield, solid, x0, y0, z0, sx, sy, sz, g.ax0, g.ay0,
        g.tiles_x, g.zc, seed, grass, rock, snow);
  return (int)cudaGetLastError();
}

// The grid every form launches for a box (the box mode's with the
// minefield is 64-aligned):
// blocks in x and z chunks into grid[0..1], and the planes a block takes
// into grid[2].  For the measurement scripts: an empty kernel on the same
// grid is the launch's floor.
extern "C" int rt_worldgen_grid(int x0, int y0, int sx, int sy, int sz,
                                int32_t* grid) {
  Grid g;
  cudaError_t err = grid_of(x0, y0, sx, sy, sz, &g);
  grid[0] = (int32_t)g.blocks.x;
  grid[1] = (int32_t)g.blocks.y;
  grid[2] = g.zc;
  return (int)err;
}
