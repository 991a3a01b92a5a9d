// Heightfield device code shared by kernel K1 (lighting.cu), kernel K4
// (trace_hf.cu), the region-table build T1 (hf_tables.cu) and the world
// generator G1 (worldgen.cu): the world math that gives a lattice point's
// quantized fields and a column's exact height (T1 and G1 through the tile
// stage `strip_column`; K4 per step; K1 reads the region's column table)
// and a voxel's material band, the region-table classification of a
// position, and the distance to the next step-aligned boundary.  The plain
// PyTorch counterparts are ops/hf_tables.py (height_from_corners), world/noise.py,
// world/heightmap.py (lattice_fields_q), world/generate.py (material_band)
// and the marches of ops/lighting.py and ops/trace_hf.py; all are built
// with --fmad=false, so every multiply and add rounds separately, as
// PyTorch computes them.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRegion = 256;
constexpr float kHalf = 128.0f;
constexpr int kWords = 1024;
constexpr float kEps = 1e-4f;

constexpr int32_t kHA = 374761393;
constexpr int32_t kHB = 668265263;
constexpr int32_t kHZ = -1262997521;
constexpr uint32_t kHSeed = 1440662683u;
constexpr int32_t kHMix = 1274126177;

// float32 values of the JAX package's constants (lacunarity^5 * 2,
// persistence^5, sqrt 2, 2 pi), written exactly.
constexpr float kTopFreq = 0x1.42642p+6f;
constexpr float kTopAmp = 0.03125f;
constexpr float kSqrt2 = 0x1.6a09e6p+0f;
constexpr float kTwoPi = 0x1.921fb6p+2f;

// int32 arithmetic that wraps, through uint32: signed overflow is
// undefined in C++.
__device__ __forceinline__ int32_t wmul(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a * (uint32_t)b);
}
__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int32_t seed_term(int32_t seed) {
  return (int32_t)((uint32_t)seed * kHSeed);
}
__device__ __forceinline__ int32_t mix(int32_t h) {
  h = wmul(h ^ (h >> 13), kHMix);  // >> on int32 is arithmetic
  return h ^ (h >> 16);
}

__device__ __forceinline__ float grad_dot(int32_t hv, float dx, float dy) {
  int h = hv & 7;
  float u = h < 6 ? ((h & 1) == 0 ? dx : -dx) : 0.0f;
  float v = h < 4 ? ((h & 2) == 0 ? dy : -dy)
                  : (h >= 6 ? ((h & 1) == 0 ? dy : -dy) : 0.0f);
  return u + v;
}

// world/noise.py perlin2
__device__ float perlin2(float x, float y, int32_t seed) {
  float x0 = floorf(x), y0 = floorf(y);
  int32_t xi = (int32_t)x0, yi = (int32_t)y0;
  float xf = x - x0, yf = y - y0;
  float u = xf * xf * xf * (xf * (xf * 6.0f - 15.0f) + 10.0f);
  float v = yf * yf * yf * (yf * (yf * 6.0f - 15.0f) + 10.0f);
  int32_t hb = wadd(wadd(wmul(xi, kHA), wmul(yi, kHB)), seed_term(seed));
  float n00 = grad_dot(mix(hb), xf, yf);
  float n10 = grad_dot(mix(wadd(hb, kHA)), xf - 1.0f, yf);
  float n01 = grad_dot(mix(wadd(hb, kHB)), xf, yf - 1.0f);
  float n11 = grad_dot(mix(wadd(hb, kHA + kHB)), xf - 1.0f, yf - 1.0f);
  float nx0 = n00 + u * (n10 - n00);
  float nx1 = n01 + u * (n11 - n01);
  float n = nx0 + v * (nx1 - nx0);
  return n * kSqrt2;
}

// float32 values of world/noise.py's lacunarity (2 pi / 3) and of
// world/heightmap.py's slope offset d = 0.2 and its 0.2 * 2.
constexpr float kLacunarity = 0x1.0c1524p+1f;
constexpr float kSlopeD = 0x1.99999ap-3f;
constexpr float kSlopeTwoD = 0x1.99999ap-2f;

// The five noise samples world/heightmap.py lattice_fields_q takes at a
// lattice point (fx, fy) are world/noise.py basic_multi sums (frequency 2,
// persistence 0.5): k = 0 the five-octave field r at (fx, fy), k = 1..4
// the two-octave field at fx + d, fx - d, fy + d, fy - d mapped to [0, 1].
// Their 13 octaves are independent perlin2 calls; octave j of a point is
// octave j of sample 0 for j < 5, else octave (j - 5) % 2 of sample
// 1 + (j - 5) / 2.
constexpr int kFieldOctaves = 5;
constexpr int kSlopeOctaves = 2;
constexpr int kLatticeSamples = 5;
constexpr int kPointOctaves =
    kFieldOctaves + (kLatticeSamples - 1) * kSlopeOctaves;  // 13

// Octave j of the lattice point (fx, fy), at the coordinates basic_multi
// reaches it by (x * 2, then one multiply by the lacunarity per octave),
// so that it is bit for bit the octave basic_multi evaluates.
__device__ float lattice_octave(int j, float fx, float fy, int32_t seed) {
  const int k = j < kFieldOctaves ? 0 : 1 + (j - kFieldOctaves) / kSlopeOctaves;
  const int o = j < kFieldOctaves ? j : (j - kFieldOctaves) % kSlopeOctaves;
  float a = fx, b = fy;
  if (k == 1) a = fx + kSlopeD;
  if (k == 2) a = fx - kSlopeD;
  if (k == 3) b = fy + kSlopeD;
  if (k == 4) b = fy - kSlopeD;
  float px = a * 2.0f, py = b * 2.0f;
  for (int i = 0; i < o; ++i) {
    px = px * kLacunarity;
    py = py * kLacunarity;
  }
  return perlin2(px, py, seed + o);
}

// basic_multi's sum of its n octaves v[0 .. n), in its order.
__device__ __forceinline__ float fold_octaves(const float* v, int n) {
  float result = v[0];
  float amp = 1.0f;
  for (int o = 1; o < n; ++o) {
    amp *= 0.5f;
    float signal = v[o] * amp;
    result = result + signal * result;
  }
  return result;
}

// lattice_fields_q's word r16 | e16 << 16 from its five samples.
// torch.round rounds half to even, as rintf does; the clamp comes before
// the conversion.
__device__ int32_t lattice_word(const float s[5]) {
  float dx = (s[1] - s[2]) / kSlopeTwoD;
  float dy = (s[3] - s[4]) / kSlopeTwoD;
  float slope = sqrtf(dx * dx + dy * dy);
  float e = (1.0f - slope) * 0.7f;
  float r16 = fminf(fmaxf(rintf((s[0] - -4.0f) * 8192.0f), 0.0f), 65535.0f);
  float e16 = fminf(fmaxf(rintf((e - -2.0f) * 16384.0f), 0.0f), 65535.0f);
  return (int32_t)((uint32_t)(int32_t)r16 | ((uint32_t)(int32_t)e16 << 16));
}

// A lattice point's word from its 13 octaves, in lattice_octave's order.
__device__ int32_t lattice_point_word(const float* v) {
  float s[kLatticeSamples];
  s[0] = fold_octaves(v, kFieldOctaves);
#pragma unroll
  for (int k = 1; k < kLatticeSamples; ++k)
    s[k] = fold_octaves(v + kFieldOctaves + (k - 1) * kSlopeOctaves,
                        kSlopeOctaves) * 0.5f + 0.5f;
  return lattice_word(s);
}

// The factor q = 1 + perlin * amp of world/heightmap.py height_from_lattice
// at column (xi, yi): its top-frequency octave, which needs no lattice
// word.
__device__ __forceinline__ float column_q(int32_t xi, int32_t yi,
                                          int32_t seed) {
  float fx = (float)xi / 600.0f;
  float fy = (float)yi / 600.0f;
  return 1.0f + perlin2(fx * kTopFreq, fy * kTopFreq, seed + 5) * kTopAmp;
}

// ops/hf_tables.py height_from_corners (world/heightmap.py
// dequant_lattice + height_from_lattice), with the column's q given.
__device__ int32_t height_from_corners_q(int32_t ca, int32_t cb, int32_t cc,
                                         int32_t cd, int32_t xi, int32_t yi,
                                         float q) {
  float tx = (float)(xi & 7) * 0.125f;
  float ty = (float)(yi & 7) * 0.125f;
  const int32_t w[4] = {ca, cb, cc, cd};
  float r[4], e[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    r[k] = -4.0f + (float)(w[k] & 0xFFFF) * 0x1p-13f;
    e[k] = -2.0f + (float)((w[k] >> 16) & 0xFFFF) * 0x1p-14f;
  }
  float rt = r[0] + tx * (r[1] - r[0]);
  float rb = r[2] + tx * (r[3] - r[2]);
  float rr = rt + ty * (rb - rt);
  float et = e[0] + tx * (e[1] - e[0]);
  float eb = e[2] + tx * (e[3] - e[2]);
  float ee = et + ty * (eb - et);
  float base = rr * q * 0.5f + 0.5f;
  float eroded = base + ee;
  float n = eroded >= 0.0f ? powf(fabsf(eroded) / 1.5f, 2.6f) : 0.0f;
  float h = n * 120.0f + 10.0f;
  return (int32_t)floorf(h);
}

__device__ __forceinline__ int32_t height_from_corners(
    int32_t ca, int32_t cb, int32_t cc, int32_t cd, int32_t xi, int32_t yi,
    int32_t seed) {
  return height_from_corners_q(ca, cb, cc, cd, xi, yi, column_q(xi, yi, seed));
}

// The tile stage of T1 and G1.  A tile is 32 x 32 columns whose first
// column (x0, y0) is a multiple of 32 from the grid's origin, computed by
// a cluster of kStrips blocks: block rank r takes the strip of rows
// y0 + 8r .. y0 + 8r + 7, one thread per column, column
// (x0 + t % 32, y0 + 8r + t / 32) for thread t, so that a warp is one row
// of 32 consecutive columns.
//   1. The strip's 5 x 2 lattice points (every 8 columns, its edges
//      included) times their 13 octaves, one perlin2 a thread, beside each
//      thread's column_q (which needs no lattice word); then a thread per
//      point folds its octaves into the five samples and quantizes them
//      into its word r16 | e16 << 16 (`lat`).
//   2. Each thread blends its column's height from its 8-block's four
//      corner words (`height_from_corners_q`), which is what
//      world/heightmap.py heightmap_grid computes for that column, and
//      takes H = max(h, 0).
//   3. The maxima of H over the column's 2-, 4-, 8-, 16- and 32-column
//      blocks, aligned to the tile: along x by warp shuffles, along y over
//      the strip's rows in shared memory; a 16- or 32-row block spans
//      strips, so each block writes its strip's 16- and 32-column maxima
//      into the shared memory of every block of its cluster, and one
//      cluster barrier later reads all four strips' from its own.  No
//      block touches another's shared memory after that barrier, so a
//      block may return as soon as it is done.
// Every thread of every block of the cluster calls `strip_column`.
constexpr int kTile = 32;                          // columns per tile side
constexpr int kStripRows = 8;                      // rows per strip
constexpr int kStrips = kTile / kStripRows;        // blocks per tile
constexpr int kStripThreads = kTile * kStripRows;  // one per column
constexpr int kStripLatX = kTile / 8 + 1;          // lattice points along x
constexpr int kStripPoints = 2 * kStripLatX;       // two rows of them
constexpr int kLevels = 5;                         // blocks of 2^1 .. 2^5
static_assert(kStripPoints * kPointOctaves <= kStripThreads,
              "one lattice octave per thread");

struct StripStage {
  float octaves[kStripPoints][kPointOctaves];
  int32_t lat[2][kStripLatX];
  // H's maxima along x over 2^(l+1) columns, per row of the strip.
  int32_t xmax[kLevels][kStripRows][kTile];
  // Each strip of the tile's maxima over its two 16-column halves, then
  // over all 32, written by that strip's block.
  int32_t parts[kStrips][3];
};

// A thread's column: its world (x, y), H = max(h, 0), and the maxima of H
// over its 2-, 4-, 8-, 16- and 32-column blocks.
struct Column {
  int32_t wx, wy, h, h1, h2, h3, h4, h5;
};

// The maximum of xmax[l] over n rows from row r0, in the thread's lane.
__device__ __forceinline__ int32_t strip_rows_max(const StripStage& s, int l,
                                                  int r0, int n, int cx) {
  int32_t m = s.xmax[l][r0][cx];
  for (int r = 1; r < n; ++r) m = max(m, s.xmax[l][r0 + r][cx]);
  return m;
}

__device__ Column strip_column(StripStage& s, int32_t x0, int32_t y0,
                               int32_t seed) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int t = threadIdx.x;
  const int cx = t % kTile, cy = t / kTile;
  const int32_t sy0 = y0 + kStripRows * rank;
  Column c;
  c.wx = x0 + cx;
  c.wy = sy0 + cy;
  if (t < kStripPoints * kPointOctaves) {
    const int p = t / kPointOctaves;
    const int32_t wx = x0 + 8 * (p % kStripLatX);
    const int32_t wy = sy0 + 8 * (p / kStripLatX);
    s.octaves[p][t % kPointOctaves] = lattice_octave(
        t % kPointOctaves, (float)wx / 600.0f, (float)wy / 600.0f, seed);
  }
  const float q = column_q(c.wx, c.wy, seed);
  __syncthreads();
  if (t < kStripPoints)
    s.lat[t / kStripLatX][t % kStripLatX] = lattice_point_word(s.octaves[t]);
  __syncthreads();
  const int lx = cx >> 3;
  c.h = max(height_from_corners_q(s.lat[0][lx], s.lat[0][lx + 1],
                                  s.lat[1][lx], s.lat[1][lx + 1], c.wx, c.wy,
                                  q),
            0);
  int32_t m = c.h;
#pragma unroll
  for (int l = 0; l < kLevels; ++l) {
    m = max(m, __shfl_xor_sync(0xffffffffu, m, 1 << l));
    s.xmax[l][cy][cx] = m;
  }
  __syncthreads();
  c.h1 = strip_rows_max(s, 0, cy & ~1, 2, cx);
  c.h2 = strip_rows_max(s, 1, cy & ~3, 4, cx);
  c.h3 = strip_rows_max(s, 2, 0, kStripRows, cx);
  if (cy == 0) {  // warp 0: the strip's parts, into every block's `parts`
    const int32_t m16 = strip_rows_max(s, 3, 0, kStripRows, cx);
    const int32_t m32 = strip_rows_max(s, 4, 0, kStripRows, cx);
    const int32_t half0 = __shfl_sync(0xffffffffu, m16, 0);
    const int32_t half1 = __shfl_sync(0xffffffffu, m16, kTile / 2);
    if (cx < kStrips * 3) {
      const int v = cx % 3;
      cluster.map_shared_rank(&s.parts[rank][0], cx / 3)[v] =
          v == 0 ? half0 : (v == 1 ? half1 : m32);
    }
  }
  cluster.sync();  // every strip's parts are in every block
  c.h4 = max(s.parts[rank][cx >> 4], s.parts[rank ^ 1][cx >> 4]);
  c.h5 = max(max(s.parts[0][2], s.parts[1][2]), max(s.parts[2][2], s.parts[3][2]));
  return c;
}

// world/generate.py material_band of the voxel's hash: material id 2
// (grass), 5 (rock) or 6 (snow).  The modulo is unsigned, as in JAX.
__device__ int32_t material_band(int32_t xi, int32_t yi, int32_t zi,
                                 int32_t seed) {
  int32_t h = wadd(wadd(wmul(xi, kHA), wmul(yi, kHB)), wmul(zi, kHZ));
  h = wadd(h, seed_term(seed + 1));
  h = mix(h);
  uint32_t bits = (uint32_t)h;
  int32_t r60 = (int32_t)(bits % 60u);
  int32_t r80 = (int32_t)(bits % 80u);
  int32_t mid = r60 < zi - 20 ? 5 : 2;
  int32_t high = r80 < zi - 80 ? 6 : 5;
  return zi < 20 ? 2 : (zi < 80 ? mid : (zi < 160 ? high : 6));
}

struct Vec3 {
  float x, y, z;
};

__device__ __forceinline__ Vec3 face_normal(int32_t id) {
  float sign = (id % 2 == 0) ? 1.0f : -1.0f;
  int32_t axis = id / 2;
  return {axis == 0 ? sign : 0.0f, axis == 1 ? sign : 0.0f,
          axis == 2 ? sign : 0.0f};
}

// ops/rays.py normalize: v / sqrt(max(|v|^2, 1e-20)), a true division.
__device__ __forceinline__ Vec3 norm3(float x, float y, float z) {
  float inv = 1.0f / sqrtf(fmaxf(x * x + y * y + z * z, 1e-20f));
  return {x * inv, y * inv, z * inv};
}

// Distance along the ray to the next boundary of the `step_f` grid:
// (eps + mod((p + 128) * mul, step_f)) * lp, with the floor modulo written
// as shifted - floor(shifted / step) * step.  For a power-of-two step
// (inv_step its exact reciprocal) that difference is rounded once from the
// exact value, as jnp.mod's is.
__device__ __forceinline__ float bdist(float p, float mul, float lp,
                                      float step_f, float inv_step) {
  float shifted = (p + kHalf) * mul;
  float m = shifted - floorf(shifted * inv_step) * step_f;
  return (kEps + m) * lp;
}

// The exact reciprocal of a pyramid step size (1 for the fine step 0).
__device__ __forceinline__ float step_reciprocal(int32_t stp) {
  return stp == 32 ? 0.03125f
         : stp == 16 ? 0.0625f
         : stp == 8  ? 0.125f
         : stp == 4  ? 0.25f
                     : 1.0f;
}

// The six region tables of ops/hf_tables.py, one word per 8x8-column block.
struct Tables {
  int32_t h3[kWords], hsub[kWords], ca[kWords], cb[kWords], cc[kWords],
      cd[kWords];
};

// Copy the tables into the block's shared memory (all threads take part;
// the caller synchronizes).
__device__ __forceinline__ void load_tables(Tables& t, const int32_t* h3,
                                            const int32_t* hsub,
                                            const int32_t* ca,
                                            const int32_t* cb,
                                            const int32_t* cc,
                                            const int32_t* cd) {
  for (int k = threadIdx.x; k < kWords; k += blockDim.x) {
    t.h3[k] = h3[k];
    t.hsub[k] = hsub[k];
    t.ca[k] = ca[k];
    t.cb[k] = cb[k];
    t.cc[k] = cc[k];
    t.cd[k] = cd[k];
  }
}

// The block word index of column (xi, yi), clamped into the region, and
// the column's region coordinates.
__device__ __forceinline__ int32_t block_index(int32_t xi, int32_t yi,
                                               int32_t r0x, int32_t r0y,
                                               int32_t& rx, int32_t& ry) {
  rx = min(max(xi - r0x, 0), kRegion - 1);
  ry = min(max(yi - r0y, 0), kRegion - 1);
  return (ry >> 3) * 32 + (rx >> 3);
}

// The safe step size at voxel height zi of block i3: 32, 16 or 8 from the
// packed pyramid word, else 4 from the 4-block refinement, else 0 (march
// the column).  Rising rays (up) compare the voxel itself, not the aligned
// slab floor.
__device__ __forceinline__ int32_t pyramid_step(const int32_t* h3,
                                                const int32_t* hsub,
                                                int32_t i3, int32_t rx,
                                                int32_t ry, int32_t zi,
                                                bool up) {
  int32_t w = h3[i3];
  int32_t h8 = w & 511;
  int32_t z32 = up ? zi : (zi & ~31);
  int32_t z16 = up ? zi : (zi & ~15);
  int32_t z8 = up ? zi : (zi & ~7);
  int32_t z4 = up ? zi : (zi & ~3);
  int32_t stp = z32 >= ((w >> 18) & 511)   ? 32
                : z16 >= ((w >> 9) & 511) ? 16
                : z8 >= h8                ? 8
                                          : 0;
  if (stp == 0) {
    int32_t quad = (((ry >> 2) & 1) << 1) | ((rx >> 2) & 1);
    int32_t delta = (hsub[i3] >> (quad << 3)) & 255;
    if (z4 >= h8 - delta) stp = 4;
  }
  return stp;
}

__device__ __forceinline__ int32_t pyramid_step(const Tables& t, int32_t i3,
                                                int32_t rx, int32_t ry,
                                                int32_t zi, bool up) {
  return pyramid_step(t.h3, t.hsub, i3, rx, ry, zi, up);
}

}  // namespace
