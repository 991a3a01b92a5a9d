// Empty kernels for the measurement scripts (testing/measure.py
// `launch_floor_ms`): the time of a launch that does nothing on a given
// grid, the floor under a short kernel's time on that grid.  They replace
// no TPU kernel and run on no path of the renderer.  `floor_cluster_kernel`
// is launched in clusters of four blocks, as T1 and G1 are.

#include <cuda_runtime.h>

namespace {

__global__ void floor_kernel() {}

__global__ void __cluster_dims__(4, 1, 1) floor_cluster_kernel() {}

}  // namespace

// An empty launch of (blocks_x, blocks_y) blocks of `threads` threads, in
// clusters of four blocks along x when `cluster` is non-zero.
extern "C" int rt_launch_floor(int blocks_x, int blocks_y, int threads,
                               int cluster, void* stream) {
  const dim3 grid(blocks_x, blocks_y);
  if (cluster)
    floor_cluster_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>();
  else
    floor_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
