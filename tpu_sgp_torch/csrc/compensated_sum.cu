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
// kThreads), one a thread of the row's block, of 2^levels values each:
// - a column's tree pairs m with m + 2^(levels-1) first; read in
//   bit-reversed order of m that is a tree of neighbours, which a thread
//   folds as it reads: chunk g of the column is its 2^kChunk values
//   {rev(g) + s 2^(levels-kChunk)}, loaded at once (neighbouring threads,
//   neighbouring addresses) and reduced in registers; the chunks' results
//   are folded in order on a stack of at most levels - kChunk entries (a
//   binary counter: chunk g merges as many times as g ends in ones);
// - the block's cols column results then run the last log2(cols) levels
//   in shared memory, and in shuffles below 32.
// A frame's row (p = 2^18) is one block of 1024 threads, columns of 256;
// a stamp's (p = 1024) one of 256 threads, columns of 4. The plan (cols,
// levels) comes from N alone (tpu_sgp_ff_sum_plan). Every add and subtract
// is __fadd_rn / __fsub_rn (or the double forms), so no compiler rewrite
// (contraction, reassociation) changes an operation.

#include <cuda_runtime.h>

#include <climits>
#include <cstdio>

namespace {

constexpr int kThreadBits = 10;
constexpr int kThreads = 1 << kThreadBits;  // threads a block, at most
// levels of a column a thread reduces in registers at once: 16 float32 or
// 8 float64 values, 64 KB of a block's loads in flight
template <typename T>
constexpr int kChunk = sizeof(T) == 4 ? 4 : 3;
// entries of a column's stack: a row of up to 2^31 slots has columns of
// 2^(31 - kThreadBits) values, 2^(31 - kThreadBits - kChunk) chunks
constexpr int kStack = 31 - kThreadBits;

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}

// One node of the tree: (ah, al) becomes the node of a = (ah, al) and
// b = (bh, bl), as reduce.py writes it.
template <typename T>
__device__ __forceinline__ void node(T& ah, T& al, T bh, T bl) {
  const T s = add(ah, bh);
  const T bb = sub(s, ah);
  const T err = add(sub(ah, sub(s, bb)), sub(bh, bb));
  al = add(add(al, bl), err);
  ah = s;
}

// The last `levels` levels of the tree over slots [0, 2^levels) of (h, l),
// level LV pairing slot m with slot m + 2^LV; the result lands in slot 0.
// The level is a template argument so that every index is static and the
// arrays stay in registers.
template <int LV, int N, typename T>
__device__ __forceinline__ void chunk_levels(T (&h)[N], T (&l)[N],
                                             int levels) {
  if constexpr (LV >= 0) {
    if (LV < levels) {
#pragma unroll
      for (int m = 0; m < (1 << LV); ++m)
        node(h[m], l[m], h[m + (1 << LV)], l[m + (1 << LV)]);
    }
    chunk_levels<LV - 1>(h, l, levels);
  }
}

// The tree over `width` (a power of two, <= blockDim.x) slots held one a
// thread, thread t slot t: halvings in shared memory down to 32 slots, then
// shuffles. Thread 0 ends with the result.
template <typename T>
__device__ __forceinline__ void block_levels(T& h, T& l, int width, T* sh,
                                             T* sl) {
  const int t = threadIdx.x;
  if (width > 32) {
    if (t < width) {
      sh[t] = h;
      sl[t] = l;
    }
    __syncthreads();
    // a level reads slots [half, 2 half) and writes [0, half)
    for (int half = width / 2; half >= 32; half /= 2) {
      if (t < half) {
        node(h, l, sh[t + half], sl[t + half]);
        sh[t] = h;
        sl[t] = l;
      }
      __syncthreads();
    }
    width = 32;
  }
  if (t < 32) {
    // lane t pairs with lane t + off; the lanes at and above off compute
    // what no later level reads
    for (int off = width / 2; off >= 1; off /= 2) {
      const T bh = __shfl_down_sync(0xffffffffu, h, off);
      const T bl = __shfl_down_sync(0xffffffffu, l, off);
      node(h, l, bh, bl);
    }
  }
}

// Row blockIdx.x, thread t its column t < cols (threads at and above cols,
// in a block of 32 for a row of fewer slots, hold +0); a column of
// 2^levels values, row r at x + r * ld.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ff_sum_kernel(const T* __restrict__ x, T* __restrict__ out, long long ld,
              int n, int cols, int levels) {
  constexpr int kC = kChunk<T>;
  __shared__ T sh[kThreads];
  __shared__ T sl[kThreads];
  const int t = threadIdx.x;
  const T* xr = x + blockIdx.x * ld;
  const int cl = levels < kC ? levels : kC;  // levels a chunk
  const int sl_bits = levels - cl;           // log2 of the chunks
  const long long stride = static_cast<long long>(cols) << sl_bits;

  T vh = T(0), vl = T(0);
  T st_h[kStack], st_l[kStack];
  for (unsigned int g = 0; g < (1u << sl_bits); ++g) {
    // chunk g: column values rev(g) + s 2^sl_bits, s < 2^cl
    const unsigned int m0 = sl_bits ? __brev(g) >> (32 - sl_bits) : 0u;
    const long long i0 = t + static_cast<long long>(m0) * cols;
    T h[1 << kC], l[1 << kC];
#pragma unroll
    for (int s = 0; s < (1 << kC); ++s) {
      const long long i = i0 + s * stride;
      h[s] = (s < (1 << cl) && t < cols && i < n) ? xr[i] : T(0);
      l[s] = T(0);
    }
    chunk_levels<kC - 1>(h, l, cl);
    vh = h[0];
    vl = l[0];
    // the stack holds the pending left operands, level lv's at st[lv]
    int lv = 0;
    for (; (g >> lv) & 1u; ++lv) {
      T ah = st_h[lv], al = st_l[lv];
      node(ah, al, vh, vl);
      vh = ah;
      vl = al;
    }
    st_h[lv] = vh;
    st_l[lv] = vl;
  }
  block_levels(vh, vl, cols, sh, sl);
  if (t == 0) out[blockIdx.x] = add(vh, vl);
}

// The plan of a row of n values: cols columns of 2^levels, cols << levels
// = p the power of two that the tree pads n to, cols = p / 4 within [1,
// kThreads]: a stamp's row (p = 1024) takes 256 threads of 4 values, a
// frame's (p = 2^18) 1024 threads of 256.
bool plan(int n, int* cols, int* levels) {
  if (n <= 0) return false;
  int bits = 0;
  while ((1LL << bits) < n) ++bits;
  const int cb = bits < 2 ? 0 : bits - 2 < kThreadBits ? bits - 2
                                                        : kThreadBits;
  *cols = 1 << cb;
  *levels = bits - cb;
  return true;
}

template <typename T>
int launch(const void* x, void* out, int rows, int n, long long ld,
           int device, void* stream) {
  int cols = 0, levels = 0;
  if (rows <= 0 || !plan(n, &cols, &levels))
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
  if (!plan(n, cols, levels)) return static_cast<int>(cudaErrorInvalidValue);
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
