// Kernel K4: the staged heightfield tracer, one thread per ray.
//
// Replaces the Pallas TPU kernel raytrace_tpu/ops/trace_pallas.py
// `_make_kernel` (:208-475), launched from `trace_rays_hf` (:512-706).  Its
// plain PyTorch version is `march_rays_hf_plain` in ops/trace_hf.py; the
// two run the same float32 operations in the same order (built with
// --fmad=false, so no multiply-add is contracted).
//
// Each thread walks one ray over the region's 2-D column-height pyramid
// and lattice heights, the tables K1 reads.  One iteration is the JAX
// unified body `body_f` (:362-438): classify the current voxel (the
// 8/16/32 pyramid word, then the 4-block refinement); where the step is
// fine, evaluate the column's exact height and, if the voxel lies below
// it, the ray hits here with the normal of its previous move (0 for a ray
// born inside a column); else move to the nearest boundary (the column
// wall or the column top for a fine step, the step-aligned boundary
// otherwise) and complete as air if that leaves the region.  There is no
// sky-escape rule: an air ray walks on to the region's edge.  The phased
// body, the `COMPACT_CAPS` sort cascade and the lane-shuffle table lookups
// of the TPU have no counterpart; the wrapper gives each ray the moves the
// JAX cascade would give it (`budget` iterations).
//
// Rays with active[i] == 0 are born done, as the cascade's born-done rays
// are: position = origin, normal 0, air 0, packed material 0.  A hit ray's
// packed material is that of its voxel's material band (the packed grass,
// rock and snow words come in iscal[5..7]).
//
// What bounds it on Hopper: the step loop's float and integer ALU work and
// the divergence between neighbouring rays of very different length, not
// memory.  The six 1,024-word tables (24 KB) sit in shared memory, loaded
// once per block (heightfield.cuh); each ray reads 25 bytes and writes 24.

#include "heightfield.cuh"

namespace {

constexpr int kThreads = 128;

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
                    int seed) {
  __shared__ Tables t;
  load_tables(t, h3, hsub, ca, cb, cc, cd);
  __syncthreads();
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  const int32_t r0x = iscal[0], r0y = iscal[1];
  const float lrx = (float)iscal[2], lry = (float)iscal[3],
              lrz = (float)iscal[4];
  float px = origin[3 * i], py = origin[3 * i + 1], pz = origin[3 * i + 2];
  int32_t nrm = 0;
  bool traced = active == nullptr || active[i] != 0;
  bool hit = false, air = false;

  if (traced) {
    Vec3 d = norm3(direction[3 * i], direction[3 * i + 1],
                   direction[3 * i + 2]);
    float lpx = 1.0f / fabsf(d.x);
    float lpy = 1.0f / fabsf(d.y);
    float lpz = 1.0f / fabsf(d.z);
    float mulx = d.x > 0.0f ? -1.0f : 1.0f;
    float muly = d.y > 0.0f ? -1.0f : 1.0f;
    float mulz = d.z > 0.0f ? -1.0f : 1.0f;
    int32_t nx_id = d.x > 0.0f ? 1 : 0;
    int32_t ny_id = d.y > 0.0f ? 3 : 2;
    int32_t nz_id = d.z > 0.0f ? 5 : 4;
    bool up = d.z >= 0.0f;

    for (int it = 0; it < budget; ++it) {
      int32_t xi = (int32_t)floorf(px);
      int32_t yi = (int32_t)floorf(py);
      int32_t zi = (int32_t)floorf(pz);
      int32_t rx, ry;
      int32_t i3 = block_index(xi, yi, r0x, r0y, rx, ry);
      int32_t stp = pyramid_step(t, i3, rx, ry, zi, up);
      float lx, ly, lz;
      if (stp == 0) {
        int32_t hcol = max(height_from_corners(t.ca[i3], t.cb[i3], t.cc[i3],
                                               t.cd[i3], xi, yi, seed),
                           0);
        if (zi < hcol) {
          hit = true;
          break;
        }
        lx = bdist(px, mulx, lpx, 1.0f, 1.0f);
        ly = bdist(py, muly, lpy, 1.0f, 1.0f);
        float ztop = (float)hcol;
        lz = (d.z < 0.0f && pz >= ztop) ? (kEps + (pz - ztop)) * lpz
                                        : __int_as_float(0x7f800000);
      } else {
        float step_f = (float)stp;
        float inv_step = step_reciprocal(stp);
        lx = bdist(px, mulx, lpx, step_f, inv_step);
        ly = bdist(py, muly, lpy, step_f, inv_step);
        lz = bdist(pz, mulz, lpz, step_f, inv_step);
      }
      bool use_x = (lx < ly) && (lx < lz);
      bool use_y = !(lx < ly) && (ly < lz);
      float lmin = use_x ? lx : (use_y ? ly : lz);
      nrm = use_x ? nx_id : (use_y ? ny_id : nz_id);
      px = px + d.x * lmin;
      py = py + d.y * lmin;
      pz = pz + d.z * lmin;
      if (fabsf(px - lrx) >= kHalf || fabsf(py - lry) >= kHalf ||
          fabsf(pz - lrz) >= kHalf) {
        air = true;
        break;
      }
    }
  }

  int32_t packed = 0;
  if (hit) {
    int32_t band = material_band((int32_t)floorf(px), (int32_t)floorf(py),
                                 (int32_t)floorf(pz), seed);
    packed = band == 2 ? iscal[5] : (band == 5 ? iscal[6] : iscal[7]);
  }
  pos_out[3 * i] = px;
  pos_out[3 * i + 1] = py;
  pos_out[3 * i + 2] = pz;
  normal_out[i] = nrm;
  air_out[i] = air ? 1 : 0;
  packed_out[i] = packed;
}

}  // namespace

extern "C" int rt_trace_hf(const float* origin, const float* direction,
                           const uint8_t* active, const int32_t* iscal,
                           const int32_t* hsub, const int32_t* h3,
                           const int32_t* ca, const int32_t* cb,
                           const int32_t* cc, const int32_t* cd, float* pos,
                           int32_t* normal, int32_t* air, int32_t* packed,
                           int n, int budget, int seed, void* stream) {
  if (n <= 0) return 0;
  int blocks = (n + kThreads - 1) / kThreads;
  trace_hf_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      origin, direction, active, iscal, hsub, h3, ca, cb, cc, cd, pos, normal,
      air, packed, n, budget, seed);
  return (int)cudaGetLastError();
}
