// Batched flux-conserving projection for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` / `project_df_pallas` in
// tpu_sgp/experimental/pallas_projection.py:40-122. For every row of a
// (B, N) batch it computes
//
//     x = min(max((c + lam) * inv, 0), cap),   inv = 1 / dia
//
// (cap only when has_sat), where lam is the root of sum(x) = b: the bracket
// lo = min(-c), hi = max(max(b * dia - c), lo + 1) is narrowed by 7-point
// sectioning, 3 bits a step, for n_steps steps, and x is evaluated at the
// bracket's midpoint. The arithmetic is the Pallas kernel's, operation for
// operation; only the order of the sums differs.
//
// What bounds it on this card: at N = 961 (31x31 stamps) a row is 7.7 KB
// in float32, read once and written once (42 us at 12288 rows), and the 7
// section points of 10 steps cost about 35 operations a pixel a step (63
// us at the float32 peak). Neither set the first design's pace: it ran one
// 256-thread block a row, and each row's 2 + n_steps dependent block
// reductions (a shuffle tree, a barrier, a read of 8 warp partials) left
// the SMs waiting, with at most 8 rows in flight an SM (0.45 ms at 12288
// rows, 82 us at the main path's 2048-row tail; PERF.md).
//
// What the design does about it:
// - Rows up to 1024 pixels in float32 (512 in float64) take one warp a row
//   (4 rows a block). A lane holds c and 1/dia of its PER <= 32 pixels in
//   registers for all steps (31 pixels at N = 961), so device memory is
//   read once. A step's 7
//   section sums are 7 interleaved butterfly shuffles, after which every
//   lane holds every sum: no shared memory, no barrier, and 7 independent
//   shuffle chains in flight. Rows are independent warps, so an SM keeps
//   about 20 rows in flight, and the main path's 2048-row tail fits in one
//   wave.
// - Longer rows take one 256-thread block a row, reducing the 7 sums
//   together through double-buffered warp partials (one barrier a step);
//   rows up to 2048 pixels sit in registers, longer ones are streamed from
//   memory on each pass. The launcher picks the path by N; neither is a
//   fallback for the other.
// The TPU version's (rows, 128) padding and sentinel pixels become a bounds
// check on the ragged edge.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdio>

#include "reduce.cuh"

namespace {

using tpu_sgp::warp_max;
using tpu_sgp::warp_min;
using tpu_sgp::warp_sum;

constexpr int kThreads = 256;        // block path: threads a row
constexpr int kWarps = kThreads / 32;
constexpr int kRowWarps = 4;         // warp path: rows (warps) a block
// longest row the warp path holds in registers: 32 pixels a lane in
// float32, 16 in float64 (32 would spill)
template <typename T>
constexpr int kWarpRowMax = sizeof(T) == 4 ? 32 * 32 : 32 * 16;
constexpr int kK = 7;  // interior section points per step

__device__ __forceinline__ float dev_max(float a, float b) {
  return fmaxf(a, b);
}
__device__ __forceinline__ double dev_max(double a, double b) {
  return fmax(a, b);
}
__device__ __forceinline__ float dev_min(float a, float b) {
  return fminf(a, b);
}
__device__ __forceinline__ double dev_min(double a, double b) {
  return fmin(a, b);
}

// The projected pixel, jnp.minimum(jnp.maximum((c + lam) * inv, 0), cap)
// as pallas_projection.py:48-51 writes it: one max and one min
// instruction. Without saturation the caller passes cap = +inf, for which
// the min returns x unchanged, so the evaluation never branches.
template <typename T>
__device__ __forceinline__ T xval(T ci, T ii, T lam, T cap) {
  return dev_min(dev_max((ci + lam) * ii, T(0)), cap);
}

// Warp path: row blockIdx.x * kRowWarps + warp, pixels i = lane + 32 * j
// for j < PER.
template <typename T, int PER>
__global__ void __launch_bounds__(32 * kRowWarps)
project_rows_warp_kernel(const T* __restrict__ b, const T* __restrict__ c,
                         const T* __restrict__ dia,
                         const T* __restrict__ cap, T* __restrict__ out,
                         int rows, int n, int n_steps, int has_sat) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // a whole warp: no barrier follows
  const size_t off = static_cast<size_t>(row) * n;
  const T brow = b[row];
  const T caprow = has_sat ? cap[row] : T(CUDART_INF);

  // Pixels and bracket (pallas_projection.py:104-108): lo = min(-c),
  // hi = max(max(b * dia - c), lo + 1).
  T cv[PER], inv[PER];
  T lo = T(CUDART_INF), hi = -T(CUDART_INF);
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = lane + 32 * j;
    cv[j] = T(0);
    inv[j] = T(0);
    if (i < n) {
      const T ci = c[off + i], di = dia[off + i];
      cv[j] = ci;
      inv[j] = T(1) / di;
      const T neg = -ci;
      const T top = brow * di - ci;
      lo = neg < lo ? neg : lo;
      hi = top > hi ? top : hi;
    }
  }
  lo = warp_min(lo);
  hi = warp_max(hi);
  const T lo1 = lo + T(1);
  hi = hi > lo1 ? hi : lo1;

  for (int s = 0; s < n_steps; ++s) {
    const T seg = (hi - lo) / T(kK + 1);
    T lam[kK], part[kK];
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      lam[k] = lo + seg * T(k + 1);
      part[k] = T(0);
    }
    // pad pixels hold c = 0 and 1/dia = 0, so they add x = 0: no check
#pragma unroll
    for (int j = 0; j < PER; ++j) {
#pragma unroll
      for (int k = 0; k < kK; ++k)
        part[k] += xval(cv[j], inv[j], lam[k], caprow);
    }
    // 7 butterflies side by side; every lane ends with every sum
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int k = 0; k < kK; ++k)
        part[k] += __shfl_xor_sync(0xffffffffu, part[k], o);
    }
    // Sign census of the residual r - b at the 7 points: the root lies
    // nbelow segments above lo (pallas_projection.py:53-61).
    T nbelow = T(0);
#pragma unroll
    for (int k = 0; k < kK; ++k)
      if (part[k] - brow < T(0)) nbelow += T(1);
    lo = lo + nbelow * seg;
    hi = lo + seg;
  }

  const T mid = T(0.5) * (lo + hi);
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = lane + 32 * j;
    if (i < n) out[off + i] = xval(cv[j], inv[j], mid, caprow);
  }
}

// Block path: a thread's pixels of one row, i = tid + j * kThreads for
// j < PER, with c and 1/dia held in registers.
template <typename T, int PER>
struct Pixels {
  T c[PER], inv[PER];
  int n, tid;

  __device__ Pixels(const T* cr, const T* dr, int n_, int tid_)
      : n(n_), tid(tid_) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = tid + j * kThreads;
      c[j] = i < n ? cr[i] : T(0);
      inv[j] = i < n ? T(1) / dr[i] : T(0);
    }
  }

  template <class F>
  __device__ __forceinline__ void each(F&& f) const {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = tid + j * kThreads;
      if (i < n) f(c[j], inv[j], i);
    }
  }
};

// Rows too long for registers: the same walk, reading memory on each pass.
template <typename T>
struct Pixels<T, 0> {
  const T* cr;
  const T* dr;
  int n, tid;

  __device__ Pixels(const T* cr_, const T* dr_, int n_, int tid_)
      : cr(cr_), dr(dr_), n(n_), tid(tid_) {}

  template <class F>
  __device__ __forceinline__ void each(F&& f) const {
    for (int i = tid; i < n; i += kThreads) f(cr[i], T(1) / dr[i], i);
  }
};

template <typename T, int PER>
__global__ void __launch_bounds__(kThreads)
project_rows_kernel(const T* __restrict__ b, const T* __restrict__ c,
                    const T* __restrict__ dia, const T* __restrict__ cap,
                    T* __restrict__ out, int /*rows*/, int n, int n_steps,
                    int has_sat) {
  // Two buffers: phase p (the bracket is phase 0, step s is phase s + 1)
  // writes buffer p & 1. A thread writes phase p + 2 only after the barrier
  // of phase p + 1, which every thread reaches after its reads of phase p.
  __shared__ T red[2][kK][kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t off = static_cast<size_t>(blockIdx.x) * n;
  const T* cr = c + off;
  const T* dr = dia + off;
  const T brow = b[blockIdx.x];
  const T caprow = has_sat ? cap[blockIdx.x] : T(CUDART_INF);

  // Bracket (pallas_projection.py:104-108): lo = min(-c),
  // hi = max(max(b * dia - c), lo + 1).
  T lo = T(CUDART_INF), hi = -T(CUDART_INF);
  for (int i = tid; i < n; i += kThreads) {
    const T ci = cr[i];
    const T neg = -ci;
    const T top = brow * dr[i] - ci;
    lo = neg < lo ? neg : lo;
    hi = top > hi ? top : hi;
  }
  lo = warp_min(lo);
  hi = warp_max(hi);
  if (lane == 0) {
    red[0][0][warp] = lo;
    red[0][1][warp] = hi;
  }
  __syncthreads();
  lo = red[0][0][0];
  hi = red[0][1][0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    lo = red[0][0][w] < lo ? red[0][0][w] : lo;
    hi = red[0][1][w] > hi ? red[0][1][w] : hi;
  }
  const T lo1 = lo + T(1);
  hi = hi > lo1 ? hi : lo1;

  const Pixels<T, PER> px(cr, dr, n, tid);

  for (int s = 0; s < n_steps; ++s) {
    const int buf = (s + 1) & 1;
    const T seg = (hi - lo) / T(kK + 1);
    T lam[kK], part[kK];
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      lam[k] = lo + seg * T(k + 1);
      part[k] = T(0);
    }
    px.each([&](T ci, T ii, int) {
#pragma unroll
      for (int k = 0; k < kK; ++k)
        part[k] += xval(ci, ii, lam[k], caprow);
    });
#pragma unroll
    for (int k = 0; k < kK; ++k) part[k] = warp_sum(part[k]);
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < kK; ++k) red[buf][k][warp] = part[k];
    }
    __syncthreads();
    // Sign census of the residual r - b at the 7 points: the root lies
    // nbelow segments above lo (pallas_projection.py:53-61).
    T nbelow = T(0);
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      T r = red[buf][k][0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) r += red[buf][k][w];
      if (r - brow < T(0)) nbelow += T(1);
    }
    lo = lo + nbelow * seg;
    hi = lo + seg;
  }

  const T mid = T(0.5) * (lo + hi);
  px.each([&](T ci, T ii, int i) {
    out[off + i] = xval(ci, ii, mid, caprow);
  });
}

// The kernel for rows of n pixels and its grid: the warp path for
// n <= kWarpRowMax<T>, else the block path.
template <typename T>
using RowsKernel = void (*)(const T*, const T*, const T*, const T*, T*, int,
                            int, int, int);

template <typename T>
struct Plan {
  RowsKernel<T> kernel;
  int blocks, threads;
  const char* name;  // as chip_smoke.py prints ptxas's report
  int per;           // pixels a thread; 0: streamed
};

template <typename T>
Plan<T> plan(int n, int rows) {
  const int wb = (rows + kRowWarps - 1) / kRowWarps, wt = 32 * kRowWarps;
  const char* warp = "project_rows_warp_kernel";
  const char* block = "project_rows_kernel";
  if (n <= 32) return {project_rows_warp_kernel<T, 1>, wb, wt, warp, 1};
  if (n <= 64) return {project_rows_warp_kernel<T, 2>, wb, wt, warp, 2};
  if (n <= 128) return {project_rows_warp_kernel<T, 4>, wb, wt, warp, 4};
  if (n <= 256) return {project_rows_warp_kernel<T, 8>, wb, wt, warp, 8};
  if (n <= 512) return {project_rows_warp_kernel<T, 16>, wb, wt, warp, 16};
  if constexpr (kWarpRowMax<T> == 32 * 32)
    if (n <= 32 * 32)
      return {project_rows_warp_kernel<T, 32>, wb, wt, warp, 32};
  if (n <= 8 * kThreads)
    return {project_rows_kernel<T, 8>, rows, kThreads, block, 8};
  return {project_rows_kernel<T, 0>, rows, kThreads, block, 0};
}

template <typename T>
int launch(const void* b, const void* c, const void* dia, const void* cap,
           void* out, int rows, int n, int n_steps, int has_sat, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Plan<T> p = plan<T>(n, rows);
  const auto s = static_cast<cudaStream_t>(stream);
  p.kernel<<<p.blocks, p.threads, 0, s>>>(
      static_cast<const T*>(b), static_cast<const T*>(c),
      static_cast<const T*>(dia), static_cast<const T*>(cap),
      static_cast<T*>(out), rows, n, n_steps, has_sat);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int occupancy(int n, char* name, int len, int* blocks) {
  const Plan<T> p = plan<T>(n, 1);
  snprintf(name, len, "%s<%c,%d>", p.name, sizeof(T) == 4 ? 'f' : 'd',
           p.per);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, p.kernel, p.threads, 0));
}

}  // namespace

// Plain C entry points, loaded with ctypes. Pointers are device pointers of
// contiguous (rows,) b and cap and (rows, n) c, dia and out; stream is a
// cudaStream_t. Returns the launch's cudaError_t (0 on success).
extern "C" int tpu_sgp_project_rows_f32(const void* b, const void* c,
                                        const void* dia, const void* cap,
                                        void* out, int rows, int n,
                                        int n_steps, int has_sat, int device,
                                        void* stream) {
  return launch<float>(b, c, dia, cap, out, rows, n, n_steps, has_sat,
                       device, stream);
}

extern "C" int tpu_sgp_project_rows_f64(const void* b, const void* c,
                                        const void* dia, const void* cap,
                                        void* out, int rows, int n,
                                        int n_steps, int has_sat, int device,
                                        void* stream) {
  return launch<double>(b, c, dia, cap, out, rows, n, n_steps, has_sat,
                        device, stream);
}

// Instantiation i of the kernels (float32 then float64, each at the
// largest n it takes: 32 .. 1024 the warp path in float32, up to 512 in
// float64, the block path above): its name, that n (0: any), and its
// resident blocks an SM. Returns -1 past the last, else the cudaError_t.
extern "C" int tpu_sgp_flux_projection_occupancy(int i, int device,
                                                 char* name, int len, int* n,
                                                 int* blocks) {
  static const int kSizes[] = {32, 64, 128, 256, 512, 1024, 2048, 0};
  constexpr int kCount = sizeof(kSizes) / sizeof(kSizes[0]);
  if (i < 0 || i >= 2 * kCount) return -1;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  *n = kSizes[i % kCount];
  const int size = *n ? *n : 1 << 30;
  return i < kCount ? occupancy<float>(size, name, len, blocks)
                    : occupancy<double>(size, name, len, blocks);
}
