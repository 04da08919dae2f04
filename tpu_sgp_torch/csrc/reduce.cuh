// Warp-level reductions shared by the port's kernels: a butterfly of
// shuffles, after which every lane of the warp holds the result.
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

}  // namespace tpu_sgp
