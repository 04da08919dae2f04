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
// in float32, read once and written once. The time goes to the 2 + n_steps
// dependent block reductions of each row (12 in float32, 20 in float64),
// each a warp-shuffle tree and a barrier: the kernel is latency-bound, not
// bandwidth-bound.
//
// What the design does about it: one 256-thread block per row, so a batch
// of 12288 rows keeps every SM busy with several rows whose reductions
// overlap. Each thread holds its pixels (about 4 at N = 961) in registers
// for all steps, so device memory is read once. A step evaluates all 7
// section points in one pass over those registers and reduces the 7 partial
// sums together: one barrier per step, through a double-buffered shared
// array, and every thread derives the new bracket from the same warp
// partials in the same order, so no second barrier is needed to broadcast
// it. Rows longer than 8 * 256 pixels are streamed from memory on each
// pass instead of held in registers. The TPU version's (rows, 128) padding
// and sentinel pixels become a bounds check on the ragged edge.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "reduce.cuh"

namespace {

using tpu_sgp::warp_max;
using tpu_sgp::warp_min;
using tpu_sgp::warp_sum;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kK = 7;  // interior section points per step

// A thread's pixels of one row: i = tid + j * kThreads for j < PER, with c
// and 1/dia held in registers.
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
                    T* __restrict__ out, int n, int n_steps, int has_sat) {
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
  const T caprow = cap[blockIdx.x];

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
  auto xval = [&](T ci, T ii, T lam) {
    T x = (ci + lam) * ii;
    x = x > T(0) ? x : T(0);
    if (has_sat) x = x < caprow ? x : caprow;
    return x;
  };

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
      for (int k = 0; k < kK; ++k) part[k] += xval(ci, ii, lam[k]);
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
  px.each([&](T ci, T ii, int i) { out[off + i] = xval(ci, ii, mid); });
}

template <typename T, int PER>
void launch_rows(const void* b, const void* c, const void* dia,
                 const void* cap, void* out, int rows, int n, int n_steps,
                 int has_sat, cudaStream_t stream) {
  project_rows_kernel<T, PER><<<rows, kThreads, 0, stream>>>(
      static_cast<const T*>(b), static_cast<const T*>(c),
      static_cast<const T*>(dia), static_cast<const T*>(cap),
      static_cast<T*>(out), n, n_steps, has_sat);
}

template <typename T>
int launch(const void* b, const void* c, const void* dia, const void* cap,
           void* out, int rows, int n, int n_steps, int has_sat, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  if (n <= kThreads)
    launch_rows<T, 1>(b, c, dia, cap, out, rows, n, n_steps, has_sat, s);
  else if (n <= 2 * kThreads)
    launch_rows<T, 2>(b, c, dia, cap, out, rows, n, n_steps, has_sat, s);
  else if (n <= 4 * kThreads)
    launch_rows<T, 4>(b, c, dia, cap, out, rows, n, n_steps, has_sat, s);
  else if (n <= 8 * kThreads)
    launch_rows<T, 8>(b, c, dia, cap, out, rows, n, n_steps, has_sat, s);
  else
    launch_rows<T, 0>(b, c, dia, cap, out, rows, n, n_steps, has_sat, s);
  return static_cast<int>(cudaGetLastError());
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
