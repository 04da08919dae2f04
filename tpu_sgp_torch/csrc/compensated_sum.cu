// Compensated (float-float) row sums for Hopper (sm_90a), one launch a call.
//
// Replaces no Pallas kernel. It is the JAX package's XLA tree,
// tpu_sgp/ops/reduce.py:39-75 (gsum_ff; the port's plain version is
// tpu_sgp_torch/ops/reduce.py tree_sum_ff), made one launch, bit for bit.
// For each row of a (B, N) batch: the row is zero-padded (+0) to
// p = 2^ceil(log2 N) and halved level by level; level by level slot i is
// paired with slot i + p/2 (p the current width), a node being the exact
// two-sum
//
//     s = a + b,  bb = s - a,  err = (a - (s - bb)) + (b - bb),
//     hi = s,     lo = (lo_a + lo_b) + err,
//
// with every leaf's lo = +0; the result is hi + lo of slot 0.
//
// Why one launch: the plain tree issues about 8 elementwise launches a
// level, 18 levels on a 410x410 frame (p = 2^18), about 148 launches a
// call, and the float32 facade's KL objective calls it twice an
// evaluation. What bounds the kernel is bytes: 4 N read once, so (1,
// 168100) in float32 is 0.67 MB, about 0.0002 ms at 3.35 TB/s; the
// operations (8 a pixel) are less. What a caller waits for is the host's
// work a call, tens of microseconds, and the launch, so the design is one
// launch of one block a row, with no second pass, no partials and nothing
// to allocate but the result. The price: one SM does a row's 8 operations
// a slot alone, about 0.033 ms for a frame's row in float32 on an H100,
// where 32 blocks took 0.005 ms; the frame's solve, bound by the host,
// ran faster with the single block all the same.
//
// What the design does about it. After k levels slot j holds the tree over
// the strided column {j + m p / 2^k : m < 2^k}, the same operations in the
// same order. So a row is cut into cols = p / 4 columns (at most
// kThreads), one a thread of the row's block, of 2^levels values each,
// which a thread reads in bit-reversed order, kChunk levels at a time, and
// folds as it reads; the block's cols column results then run the last
// log2(cols) levels in shared memory, and in shuffles below 32. The fold
// (ff_row_sum) is in ff_tree.cuh, shared with the beta objective
// (beta_divergence.cu), which folds the values it computes into the same
// tree. A frame's row (p = 2^18) is one block of 1024 threads, columns of
// 256; a stamp's (p = 1024) one of 256 threads, columns of 4. The plan
// (cols, levels) comes from N alone (tpu_sgp_ff_sum_plan). Every add and
// subtract is __fadd_rn / __fsub_rn (or the double forms), so no compiler
// rewrite (contraction, reassociation) changes an operation.

#include <cuda_runtime.h>

#include <climits>
#include <cstdio>

#include "ff_tree.cuh"

namespace {

using tpu_sgp::ff_plan;
using tpu_sgp::ff_row_sum;

// threads a block, at most: the plan (ff_plan) gives a stamp's row (p =
// 1024) 256 threads of 4 values, a frame's (p = 2^18) 1024 threads of 256
constexpr int kThreadBits = 10;
constexpr int kThreads = 1 << kThreadBits;
// levels of a column a thread reduces in registers at once: 16 float32 or
// 8 float64 values, 64 KB of a block's loads in flight
template <typename T>
constexpr int kChunk = sizeof(T) == 4 ? 4 : 3;

// Row blockIdx.x, thread t its column t < cols (threads at and above cols,
// in a block of 32 for a row of fewer slots, hold +0); a column of
// 2^levels values, row r at x + r * ld.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ff_sum_kernel(const T* __restrict__ x, T* __restrict__ out, long long ld,
              int n, int cols, int levels) {
  __shared__ T sh[kThreads];
  __shared__ T sl[kThreads];
  const T* xr = x + blockIdx.x * ld;
  const T sum = ff_row_sum<kThreadBits, kChunk<T>>(
      [xr](long long i) { return xr[i]; }, n, cols, levels, sh, sl);
  if (threadIdx.x == 0) out[blockIdx.x] = sum;
}

template <typename T>
int launch(const void* x, void* out, int rows, int n, long long ld,
           int device, void* stream) {
  int cols = 0, levels = 0;
  if (rows <= 0 || !ff_plan(n, kThreadBits, &cols, &levels))
    return static_cast<int>(cudaErrorInvalidValue);
  int previous = 0;
  cudaError_t err = cudaGetDevice(&previous);
  if (err == cudaSuccess && previous != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = cols < 32 ? 32 : cols;
  ff_sum_kernel<T><<<rows, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(out), ld, n, cols, levels);
  err = cudaGetLastError();
  if (previous != device) cudaSetDevice(previous);
  return static_cast<int>(err);
}

}  // namespace

// Plain C entry points, loaded with ctypes. x is a device pointer to rows
// rows of n values, row r at x + r * ld, unit stride within a row; out
// (rows,); stream a cudaStream_t. Returns the launch's cudaError_t (0 on
// success; cudaErrorInvalidValue, 1, for rows or n below 1).
extern "C" int tpu_sgp_ff_sum_f32(const void* x, void* out, int rows, int n,
                                  long long ld, int device, void* stream) {
  return launch<float>(x, out, rows, n, ld, device, stream);
}

extern "C" int tpu_sgp_ff_sum_f64(const void* x, void* out, int rows, int n,
                                  long long ld, int device, void* stream) {
  return launch<double>(x, out, rows, n, ld, device, stream);
}

// The plan of a row of n values: its columns (threads of the row's block
// that hold values), levels a column, and values a chunk (2^chunk) in
// float32 (f64 = 0) or float64. Returns cudaErrorInvalidValue for n < 1.
extern "C" int tpu_sgp_ff_sum_plan(int n, int f64, int* cols, int* levels,
                                   int* chunk) {
  if (!ff_plan(n, kThreadBits, cols, levels))
    return static_cast<int>(cudaErrorInvalidValue);
  *chunk = f64 ? kChunk<double> : kChunk<float>;
  return 0;
}

// Instantiation i (0: float32, 1: float64): its name, n = 0 (any), and
// its resident blocks an SM at kThreads threads. Returns -1 past the last,
// else the cudaError_t.
extern "C" int tpu_sgp_compensated_sum_occupancy(int i, int device,
                                                 char* name, int len, int* n,
                                                 int* blocks) {
  if (i < 0 || i > 1) return -1;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  *n = 0;
  snprintf(name, len, "ff_sum_kernel<%c>", i == 0 ? 'f' : 'd');
  return static_cast<int>(
      i == 0 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   blocks, ff_sum_kernel<float>, kThreads, 0)
             : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   blocks, ff_sum_kernel<double>, kThreads, 0));
}
