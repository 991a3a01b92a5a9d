// Persistent lanes that refill, shared by kernels K3 (trace_vol.cu), K3s
// (trace_rays_vol.cu) and K4 (trace_hf.cu); K1 (lighting.cu), one thread per
// pixel, takes only the census.
//
// A march kernel launches one grid that fills the card and lets each lane
// walk item after item (a path, a ray).  Each warp holds a window of 32
// consecutive indices, drawn from a counter in device memory with one
// atomicAdd by lane 0 and a shuffle of the base; a ballot marks the
// window's live indices.  When the warp refills, its idle lanes take the
// window's live indices in order, and a new window is drawn when it is used
// up.  Every lane of a warp stays in the kernel's loop until the warp exits
// together, so the full-mask ballots and shuffles always see all 32 lanes.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

// The warp's window: indices [base, base + 32), the mask of its live
// indices not taken yet, and whether the counter has run past the end.
// The same in every lane.
struct Window {
  int base = 0;
  unsigned left = 0u;
  bool drained = false;
};

// The position of the r-th (from 0) set bit of m, which has more than r.
__device__ __forceinline__ int nth_bit(unsigned m, int r) {
  int pos = 0;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    const unsigned low = m & ((1u << w) - 1u);
    const int c = __popc(low);
    if (r >= c) {
      r -= c;
      m >>= w;
      pos += w;
    } else {
      m = low;
    }
  }
  return pos;
}

// Give every idle lane (item < 0) the next live index of the warp's window,
// drawing new windows of `n` items from `next` as needed, until no lane is
// idle or the items run out.  `live(k)` says whether item k is work; the
// lane at position p of a new window calls `skip(base + p)` for an item that
// is not (each writes its own).  -> this lane's item, or -1.  Every lane of
// the warp calls it together.
template <typename Live, typename Skip>
__device__ __forceinline__ int refill(int item, Window& w, int32_t* next, int n,
                                     Live live, Skip skip) {
  const int lane = threadIdx.x & 31;
  for (;;) {
    const unsigned idle = __ballot_sync(kFullMask, item < 0);
    if (idle == 0u) return item;
    if (w.left == 0u) {
      if (w.drained) return item;
      int base = 0;
      if (lane == 0) base = atomicAdd(next, 32);
      w.base = __shfl_sync(kFullMask, base, 0);
      w.drained = w.base + 32 >= n;
      const int k = w.base + lane;
      const bool is_live = k < n && live(k);
      if (k < n && !is_live) skip(k);
      w.left = __ballot_sync(kFullMask, is_live);
      continue;
    }
    const int have = __popc(w.left);
    const int take = min(__popc(idle), have);
    const int rank = __popc(idle & ((1u << lane) - 1u));
    if (item < 0 && rank < take) item = w.base + nth_bit(w.left, rank);
    w.left = take == have ? 0u : w.left & ~((1u << nth_bit(w.left, take)) - 1u);
  }
}

// Add the warp's loop iterations to the census counter (if any), once per
// warp, at its exit.
__device__ __forceinline__ void add_census(long long* census,
                                           long long iterations) {
  if (census != nullptr && (threadIdx.x & 31) == 0)
    atomicAdd(reinterpret_cast<unsigned long long*>(census),
              static_cast<unsigned long long>(iterations));
}

// The census of K1 and K3, (2,) int64, if any: the warp's loop iterations
// to census[0] and the moves of its lanes, each counted in the lane's own
// register, to census[1]; once per warp, at its exit, where every lane of
// the warp calls it together.  A warp's moves fit 32 bits: K3's 1024²
// frame makes 73M moves over its ~4,000 persistent warps.
__device__ __forceinline__ void add_census(long long* census,
                                           long long iterations,
                                           unsigned moves) {
  if (census == nullptr) return;
  const unsigned warp_moves = __reduce_add_sync(kFullMask, moves);
  if ((threadIdx.x & 31) == 0) {
    auto* words = reinterpret_cast<unsigned long long*>(census);
    atomicAdd(words, static_cast<unsigned long long>(iterations));
    atomicAdd(words + 1, static_cast<unsigned long long>(warp_moves));
  }
}

// The persistent grid of `kernel` at `threads` per block: SMs x resident
// blocks per SM, computed at the first launch; no more blocks than `n`
// items need.  -> 0 on success, else the CUDA error.
template <typename Kernel>
int persistent_grid(Kernel kernel, int threads, int n, int& cached,
                    int& blocks) {
  if (cached == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          threads, 0);
    if (err != cudaSuccess) return (int)err;
    cached = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int needed = (n + threads - 1) / threads;
  blocks = needed < cached ? needed : cached;
  return 0;
}

}  // namespace
