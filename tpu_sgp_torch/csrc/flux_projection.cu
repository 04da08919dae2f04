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
//   memory on each pass.
// - A few rows too long for that (a whole 410x410 frame is one row of
//   168100 pixels, and one block a row would leave 131 of 132 SMs idle) are
//   split over the grid: a block keeps kGridPer pixels a thread of c and
//   1/dia in registers for every step, so device memory is still read once,
//   and each step's 7 sums are reduced over the row's blocks through a small
//   scratch buffer between two grid-wide barriers (a cooperative launch and
//   grid.sync()). Every block then adds the row's partials in the same
//   order, so all of them narrow the bracket identically. Each step's
//   bracket depends on the previous step's sums over the whole row, so all
//   blocks of a row must wait for each other whatever the scheme; a
//   cooperative launch is the one way the CUDA runtime guarantees that they are
//   all resident, and it refuses a grid that is not, where a hand-made
//   barrier would hang. What bounds this path is the 1 + n_steps barriers,
//   a few microseconds each, not bytes or operations.
// The launcher picks the path from N and the number of rows; none is a
// fallback for another.
// The TPU version's (rows, 128) padding and sentinel pixels become a bounds
// check on the ragged edge.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdio>

#include "reduce.cuh"

namespace {

namespace cg = cooperative_groups;

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
constexpr int kGridPer = 4;  // grid path: pixels a thread
constexpr int kGridChunk = kThreads * kGridPer;  // grid path: pixels a block
constexpr int kSlots = kK + 1;  // grid path: scratch values a block a phase
static_assert(kWarps >= kK, "one warp adds the partials of one section point");

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

// Grid path: block blockIdx.x serves pixels [part * PER * kThreads, ...) of
// row blockIdx.x / bpr, i = base + tid + j * kThreads for j < PER. Phase p
// (the bracket is phase 0, step s is phase s + 1) writes plane p & 1 of
// ``scratch``, laid out [plane][row][slot][part]; a block writes phase p + 2
// only after the grid barrier of phase p + 1, which every block reaches
// after its reads of phase p. The partials are read with __ldcg: they were
// written by other SMs, whose stores an L1 line filled two phases ago
// would hide.
template <typename T, int PER>
__global__ void __launch_bounds__(kThreads)
project_rows_grid_kernel(const T* __restrict__ b, const T* __restrict__ c,
                         const T* __restrict__ dia,
                         const T* __restrict__ cap, T* __restrict__ out,
                         T* scratch, int rows, int n, int n_steps,
                         int has_sat, int bpr) {
  cg::grid_group grid = cg::this_grid();
  __shared__ T red[kSlots][kWarps];
  __shared__ T tot[kSlots];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row = blockIdx.x / bpr;
  const int part = blockIdx.x - row * bpr;
  const size_t off = static_cast<size_t>(row) * n;
  const int base = part * (PER * kThreads);
  const T brow = b[row];
  const T caprow = has_sat ? cap[row] : T(CUDART_INF);
  const size_t plane = static_cast<size_t>(rows) * kSlots * bpr;
  T* const mine = scratch + static_cast<size_t>(row) * kSlots * bpr;

  // Pixels and this block's share of the bracket
  // (pallas_projection.py:104-108).
  T cv[PER], inv[PER];
  T lo = T(CUDART_INF), hi = -T(CUDART_INF);
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = base + tid + j * kThreads;
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
  if (lane == 0) {
    red[0][warp] = lo;
    red[1][warp] = hi;
  }
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      lo = red[0][w] < lo ? red[0][w] : lo;
      hi = red[1][w] > hi ? red[1][w] : hi;
    }
    mine[part] = lo;
    mine[bpr + part] = hi;
  }
  grid.sync();
  if (warp < 2) {
    T v = warp == 0 ? T(CUDART_INF) : -T(CUDART_INF);
    for (int j = lane; j < bpr; j += 32) {
      const T o = __ldcg(mine + warp * bpr + j);
      v = warp == 0 ? (o < v ? o : v) : (o > v ? o : v);
    }
    v = warp == 0 ? warp_min(v) : warp_max(v);
    if (lane == 0) tot[warp] = v;
  }
  __syncthreads();
  lo = tot[0];
  hi = tot[1];
  const T lo1 = lo + T(1);
  hi = hi > lo1 ? hi : lo1;

  for (int s = 0; s < n_steps; ++s) {
    T* const buf = mine + ((s + 1) & 1) * plane;
    const T seg = (hi - lo) / T(kK + 1);
    T lam[kK], sum[kK];
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      lam[k] = lo + seg * T(k + 1);
      sum[k] = T(0);
    }
    // pad pixels hold c = 0 and 1/dia = 0, so they add x = 0: no check
#pragma unroll
    for (int j = 0; j < PER; ++j) {
#pragma unroll
      for (int k = 0; k < kK; ++k)
        sum[k] += xval(cv[j], inv[j], lam[k], caprow);
    }
#pragma unroll
    for (int k = 0; k < kK; ++k) sum[k] = warp_sum(sum[k]);
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < kK; ++k) red[k][warp] = sum[k];
    }
    __syncthreads();
    if (tid < kK) {
      T r = red[tid][0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) r += red[tid][w];
      buf[tid * bpr + part] = r;
    }
    grid.sync();
    // warp k adds the row's partials of section point k, in the same order
    // in every block of the row
    if (warp < kK) {
      T v = T(0);
      for (int j = lane; j < bpr; j += 32) v += __ldcg(buf + warp * bpr + j);
      v = warp_sum(v);
      if (lane == 0) tot[warp] = v;
    }
    __syncthreads();
    // Sign census of the residual r - b at the 7 points: the root lies
    // nbelow segments above lo (pallas_projection.py:53-61).
    T nbelow = T(0);
#pragma unroll
    for (int k = 0; k < kK; ++k)
      if (tot[k] - brow < T(0)) nbelow += T(1);
    lo = lo + nbelow * seg;
    hi = lo + seg;
  }

  const T mid = T(0.5) * (lo + hi);
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = base + tid + j * kThreads;
    if (i < n) out[off + i] = xval(cv[j], inv[j], mid, caprow);
  }
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

// Which path serves (rows, n). kPathAuto is the launcher's own rule; the
// other two are for measurements that hold one path against another.
enum Path { kPathAuto = 0, kPathRows = 1, kPathGrid = 2 };

// Blocks of the grid kernel that the device holds at once.
template <typename T>
cudaError_t grid_capacity(int device, int* blocks) {
  int per_sm = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, project_rows_grid_kernel<T, kGridPer>, kThreads, 0);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  *blocks = per_sm * sms;
  return err;
}

// The grid path takes rows that the block path would stream from memory,
// when all their blocks are resident at once: few long rows. Many long
// rows fill the card with one block a row as it is.
template <typename T>
cudaError_t choose(int rows, int n, int device, int* path) {
  if (*path != kPathAuto) return cudaSuccess;
  *path = kPathRows;
  if (n <= 8 * kThreads) return cudaSuccess;
  int capacity = 0;
  const cudaError_t err = grid_capacity<T>(device, &capacity);
  const long long need =
      static_cast<long long>(rows) * ((n + kGridChunk - 1) / kGridChunk);
  if (err == cudaSuccess && need <= capacity) *path = kPathGrid;
  return err;
}

template <typename T>
int launch(const void* b, const void* c, const void* dia, const void* cap,
           void* out, void* scratch, int rows, int n, int n_steps,
           int has_sat, int path, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = choose<T>(rows, n, device, &path);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  const T* bp = static_cast<const T*>(b);
  const T* cp = static_cast<const T*>(c);
  const T* dp = static_cast<const T*>(dia);
  const T* capp = static_cast<const T*>(cap);
  T* op = static_cast<T*>(out);
  if (path == kPathGrid) {
    // A cooperative launch: the runtime starts it only if every block is
    // resident at once, and returns cudaErrorCooperativeLaunchTooLarge
    // otherwise, so grid.sync() cannot hang.
    T* sp = static_cast<T*>(scratch);
    int bpr = (n + kGridChunk - 1) / kGridChunk;
    void* args[] = {&bp, &cp, &dp, &capp, &op, &sp, &rows, &n,
                    &n_steps, &has_sat, &bpr};
    err = cudaLaunchCooperativeKernel(
        reinterpret_cast<void*>(project_rows_grid_kernel<T, kGridPer>),
        dim3(rows * bpr), dim3(kThreads), args, 0, s);
    return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
  }
  const Plan<T> p = plan<T>(n, rows);
  p.kernel<<<p.blocks, p.threads, 0, s>>>(bp, cp, dp, capp, op, rows, n,
                                          n_steps, has_sat);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int occupancy(int n, char* name, int len, int* blocks) {
  const char type = sizeof(T) == 4 ? 'f' : 'd';
  if (n < 0) {
    snprintf(name, len, "project_rows_grid_kernel<%c,%d>", type, kGridPer);
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, project_rows_grid_kernel<T, kGridPer>, kThreads, 0));
  }
  const Plan<T> p = plan<T>(n, 1);
  snprintf(name, len, "%s<%c,%d>", p.name, type, p.per);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, p.kernel, p.threads, 0));
}

}  // namespace

// Plain C entry points, loaded with ctypes. Pointers are device pointers of
// contiguous (rows,) b and cap and (rows, n) c, dia and out; scratch holds
// what tpu_sgp_project_rows_plan asks for; path is 0 (the launcher's rule),
// 1 (one warp or one block a row) or 2 (the grid path); stream is a
// cudaStream_t. Returns the launch's cudaError_t (0 on success).
extern "C" int tpu_sgp_project_rows_f32(const void* b, const void* c,
                                        const void* dia, const void* cap,
                                        void* out, void* scratch, int rows,
                                        int n, int n_steps, int has_sat,
                                        int path, int device, void* stream) {
  return launch<float>(b, c, dia, cap, out, scratch, rows, n, n_steps,
                       has_sat, path, device, stream);
}

extern "C" int tpu_sgp_project_rows_f64(const void* b, const void* c,
                                        const void* dia, const void* cap,
                                        void* out, void* scratch, int rows,
                                        int n, int n_steps, int has_sat,
                                        int path, int device, void* stream) {
  return launch<double>(b, c, dia, cap, out, scratch, rows, n, n_steps,
                        has_sat, path, device, stream);
}

// What a launch of (rows, n) with ``path`` will do: ``chosen`` is 1 (one
// warp or one block a row) or 2 (the grid path), ``scratch`` the elements
// of scratch it needs (0 for path 1) and ``blocks`` its grid. Returns the
// cudaError_t of the device queries.
extern "C" int tpu_sgp_project_rows_plan(int rows, int n, int is_f64,
                                         int path, int device, int* chosen,
                                         long long* scratch, int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = is_f64 ? choose<double>(rows, n, device, &path)
               : choose<float>(rows, n, device, &path);
  *chosen = path;
  const int bpr = (n + kGridChunk - 1) / kGridChunk;
  if (path == kPathGrid) {
    *scratch = 2LL * rows * kSlots * bpr;
    *blocks = rows * bpr;
  } else {
    *scratch = 0;
    *blocks = is_f64 ? plan<double>(n, rows).blocks
                     : plan<float>(n, rows).blocks;
  }
  return static_cast<int>(err);
}

// Instantiation i of the kernels (float32 then float64, each at the
// largest n it takes: 32 .. 1024 the warp path in float32, up to 512 in
// float64, the block path above, and last the grid path): its name, that n
// (0: any), and its resident blocks an SM. Returns -1 past the last, else
// the cudaError_t.
extern "C" int tpu_sgp_flux_projection_occupancy(int i, int device,
                                                 char* name, int len, int* n,
                                                 int* blocks) {
  static const int kSizes[] = {32, 64, 128, 256, 512, 1024, 2048, 0, -1};
  constexpr int kCount = sizeof(kSizes) / sizeof(kSizes[0]);
  if (i < 0 || i >= 2 * kCount) return -1;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int size = kSizes[i % kCount];
  *n = size > 0 ? size : 0;
  const int arg = size == 0 ? 1 << 30 : size;
  return i < kCount ? occupancy<float>(arg, name, len, blocks)
                    : occupancy<double>(arg, name, len, blocks);
}
