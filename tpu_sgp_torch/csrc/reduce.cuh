// Reductions shared by the port's kernels: a warp's butterfly of shuffles,
// after which every lane of the warp holds the result, and a block's sum.
#pragma once

#include <cuda_runtime.h>

namespace tpu_sgp {

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_min(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T o = __shfl_xor_sync(0xffffffffu, v, off);
    v = o < v ? o : v;
  }
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T o = __shfl_xor_sync(0xffffffffu, v, off);
    v = o > v ? o : v;
  }
  return v;
}

// The sum of v over a block of a multiple of 32 threads: each warp's
// butterfly, then warp 0's over the warps' sums, which pass through part
// (32 values of shared memory, free on entry and again on return). Every
// lane of warp 0 ends with the result.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* part) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) part[warp] = v;
  __syncthreads();
  v = T(0);
  if (warp == 0) v = warp_sum(lane < (blockDim.x >> 5) ? part[lane] : T(0));
  __syncthreads();
  return v;
}

}  // namespace tpu_sgp
