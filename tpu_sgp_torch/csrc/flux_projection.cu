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
// Beside K1, the same grid design runs the 'bisect' method's cold guided
// secant on rows of any length (project_rows_guided_grid_kernel, below).
// The TPU version's (rows, 128) padding and sentinel pixels become a bounds
// check on the ragged edge.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cfloat>
#include <cstdio>
#include <type_traits>

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

// The dtype's machine epsilon, torch.finfo(dtype).eps.
template <typename T>
__device__ __forceinline__ T machine_eps() {
  return sizeof(T) == 4 ? T(FLT_EPSILON) : T(DBL_EPSILON);
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

// ---- The guided secant ('bisect') on long rows -----------------------------
//
// project_df_bisect's cold ladder, _guided_root in
// tpu_sgp_torch/projection/flux_projection.py (tpu_sgp/projection/
// flux_projection.py:538-623), on rows split over the grid as the grid path
// above splits them: a stamp is one block, a 410x410 frame 165 blocks that
// hold its pixels in registers, and a row longer than the card's resident
// blocks can hold (a 2048x2048 frame) is shared among all of them, each
// block streaming its part from memory in every phase (guided_choose,
// below). Where the plain version issues about 25 small PyTorch operations
// a step, about 600 launches a call, this is one launch (one a group of
// rows, where more rows come than the card holds at once). Its phases are the plain version's, each ending in one grid-wide
// reduction of its partials and one grid.sync():
// - phase 0: the bracket lo = min(-c), hi = max(max(b * dia - c), lo + 1),
//   and the anchors' max(-c), sum(1/dia), sum(max(c, 0)/dia);
// - the probe: the residual at 4 points (r(lo) = -b is known);
// - n_passes main passes and the finish pass: the residual at the 3 sorted
//   candidates of _candidates, and _ladder_update over the 5-point ladder;
// then the closing secant, and the last phase writes x.
// Every block of a row adds the row's partials in one fixed order and then
// computes the same scalar state, so all of them take the same branches
// without the host. The residual at lam is sum(min(max(c + lam, 0),
// cap * dia) * (1/dia)) - b, the plain version's evalr, and x is
// min(max((c + lam) / dia, 0), cap), its xval. What bounds it is the
// 3 + n_passes barriers, as it bounds the grid path.

// scratch values a block a phase: phase 0's five reductions
constexpr int kGuidedSlots = 5;
// How a slot is reduced, two bits a slot in a phase's ``ops``: slot k is
// reduced by (ops >> 2k) & 3.
enum Reduce { kSum = 0, kMin = 1, kMax = 2 };

template <typename T>
__device__ __forceinline__ T combine(T a, T b, int op) {
  return op == kSum ? a + b : op == kMin ? (b < a ? b : a) : (b > a ? b : a);
}

template <typename T>
__device__ __forceinline__ T warp_reduce(T v, int op) {
  return op == kSum ? warp_sum(v) : op == kMin ? warp_min(v) : warp_max(v);
}

template <typename T>
__device__ __forceinline__ T identity(int op) {
  return op == kSum ? T(0) : op == kMin ? T(CUDART_INF) : -T(CUDART_INF);
}

// The K totals of the row's blocks: each thread's v[k] is reduced over its
// block, written to ``buf`` (laid out [slot][part]), and after the grid
// barrier warp k reduces slot k over the row's parts in the same order in
// every block. A row of one block (bpr == 1, a launch that need not be
// cooperative) takes its block's totals as they are, with no grid barrier:
// the same values, since the row's other parts would add only identities.
// Returns with the totals in tot[0..K).
template <typename T, int K, int OPS>
__device__ __forceinline__ void row_reduce(T (&v)[K], T (*red)[kWarps],
                                           T* tot, T* buf, int part, int bpr,
                                           cg::grid_group& grid) {
  static_assert(K <= kWarps, "one warp adds the partials of one slot");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = warp_reduce(v[k], (OPS >> 2 * k) & 3);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) red[k][warp] = v[k];
  }
  __syncthreads();
  if (tid < K) {
    const int op = (OPS >> 2 * tid) & 3;
    T r = red[tid][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) r = combine(r, red[tid][w], op);
    if (bpr == 1)
      tot[tid] = r;
    else
      buf[tid * bpr + part] = r;
  }
  if (bpr == 1) {
    __syncthreads();
    return;
  }
  grid.sync();
  if (warp < K) {
    const int op = (OPS >> 2 * warp) & 3;
    T r = identity<T>(op);
    for (int j = lane; j < bpr; j += 32)
      r = combine(r, __ldcg(buf + warp * bpr + j), op);
    r = warp_reduce(r, op);
    if (lane == 0) tot[warp] = r;
  }
  __syncthreads();
}

// The ladder's bracket and slope surrogates, _ladder_update's result.
template <typename T>
struct Ladder {
  T lo, hi, r_lo, r_hi, sl_lo, sl_hi;
};

// _ladder_update over L ascending points q with nondecreasing residuals v:
// the new lo is the last inner point (1..L-2) with v < 0, else point 0, the
// new hi the first inner point with v >= 0, else point L-1; the chord
// slopes of the segments next to them become the slope surrogates, and a
// side that kept its end point keeps its previous slope.
template <typename T, int L>
__device__ __forceinline__ Ladder<T> ladder_update(const T (&q)[L],
                                                   const T (&v)[L],
                                                   T sl_lo_prev,
                                                   T sl_hi_prev) {
  T slope[L - 1];
#pragma unroll
  for (int i = 0; i < L - 1; ++i) {
    const T dl = q[i + 1] - q[i];
    slope[i] = dl > T(0) ? (v[i + 1] - v[i]) / dl : T(0);
  }
  Ladder<T> s{q[0], q[L - 1], v[0], v[L - 1], sl_lo_prev, sl_hi_prev};
#pragma unroll
  for (int i = 1; i <= L - 2; ++i)
    if (v[i] < T(0)) {
      s.lo = q[i];
      s.r_lo = v[i];
      s.sl_lo = slope[i - 1];
    }
#pragma unroll
  for (int i = L - 2; i >= 1; --i)
    if (v[i] >= T(0)) {
      s.hi = q[i];
      s.r_hi = v[i];
      s.sl_hi = slope[i];
    }
  return s;
}

// _candidates: the endpoint chord, Newton from hi (or lo + w/16 where it
// leaves the bracket), and the midpoint in a main pass or Newton from lo in
// the finish pass; sorted, and clipped into [lo + eps w, hi - eps w].
template <typename T>
__device__ __forceinline__ void candidates(const Ladder<T>& s, bool with_mid,
                                           T (&p)[3]) {
  const T eps = machine_eps<T>();
  const T w = s.hi - s.lo;
  const T mid = s.lo + T(0.5) * w;
  const T den = s.r_hi - s.r_lo;
  const T chord = den > T(0) ? s.lo - s.r_lo * w / den : mid;
  const T nh_raw = s.sl_hi > T(0) ? s.hi - s.r_hi / s.sl_hi : mid;
  const T nh = nh_raw > s.lo && nh_raw < s.hi ? nh_raw : s.lo + w / T(16);
  const T third = with_mid || !(s.sl_lo > T(0)) ? mid
                                                 : s.lo - s.r_lo / s.sl_lo;
  const T a = dev_min(chord, nh), b2 = dev_max(chord, nh);
  const T srt[3] = {dev_min(a, third), dev_min(b2, dev_max(a, third)),
                    dev_max(b2, third)};
  const T eps_w = eps * w;
  const T lo_c = s.lo + eps_w, hi_c = s.hi - eps_w;
#pragma unroll
  for (int k = 0; k < 3; ++k) p[k] = dev_min(dev_max(srt[k], lo_c), hi_c);
}

// Block blockIdx.x serves part blockIdx.x % bpr of row blockIdx.x / bpr.
// With PER > 0 that part is pixels i = base + tid + j * kThreads, j < PER,
// base = part * PER * kThreads, whose c, 1/dia and cap * dia stay in
// registers for every phase. With PER == 0 (streamed: a row longer than
// the blocks the card holds at once can cover, a whole 2048x2048 frame)
// the part is every pixel i = (part + j * bpr) * kThreads + tid, and each
// phase reads c and dia again. Phase p writes plane p & 1 of ``scratch``,
// laid out [plane][row][slot][part]; as in the grid path, a block writes
// phase p + 2 only after the barrier of phase p + 1. The first block of a
// row writes the row's root to lam.
// At least 3 blocks an SM: unbounded, float64 takes 93 registers, 2 blocks
// an SM, and two whole frames (330 blocks) would not fit on the card at
// once; bounded, 80 registers and a few spilled bytes. Float32 then takes
// 72 registers, 3 blocks an SM (48 and 5 unbounded).
template <typename T, int PER>
__global__ void __launch_bounds__(kThreads, 3)
project_rows_guided_grid_kernel(const T* __restrict__ b,
                                const T* __restrict__ c,
                                const T* __restrict__ dia,
                                const T* __restrict__ cap, T* __restrict__ out,
                                T* __restrict__ lam_out, T* scratch, int rows,
                                int n, int n_passes, int has_sat, int bpr) {
  cg::grid_group grid = cg::this_grid();
  __shared__ T red[kGuidedSlots][kWarps];
  __shared__ T tot[kGuidedSlots];

  const int tid = threadIdx.x;
  const int row = blockIdx.x / bpr;
  const int part = blockIdx.x - row * bpr;
  const size_t off = static_cast<size_t>(row) * n;
  const T brow = b[row];
  const T caprow = has_sat ? cap[row] : T(CUDART_INF);
  const size_t plane = static_cast<size_t>(rows) * kGuidedSlots * bpr;
  T* const mine = scratch + static_cast<size_t>(row) * kGuidedSlots * bpr;
  int phase = 0;
  auto buf = [&]() { return mine + (phase++ & 1) * plane; };

  // Each pixel of this block's part as f(c, 1/dia, cap * dia, i): from
  // registers, or (streamed) read from memory. Pad pixels (PER > 0) hold
  // c = 0, 1/dia = 0 and cap * dia = 0, so they add 0 to every residual.
  constexpr int kPer = PER > 0 ? PER : 1;
  T cv[kPer], inv[kPer], top[kPer];
  const int base = part * (kPer * kThreads);
  auto pixels = [&](auto&& f) {
    if constexpr (PER > 0) {
#pragma unroll
      for (int j = 0; j < PER; ++j)
        f(cv[j], inv[j], top[j], base + tid + j * kThreads);
    } else {
      const size_t stride = static_cast<size_t>(bpr) * kThreads;
      for (size_t i = static_cast<size_t>(part) * kThreads + tid;
           i < static_cast<size_t>(n); i += stride) {
        const T ci = c[off + i], di = dia[off + i];
        f(ci, T(1) / di, has_sat ? caprow * di : T(CUDART_INF),
          static_cast<int>(i));
      }
    }
  };

  // Phase 0: the pixels, the bracket and the anchors.
  T v0[kGuidedSlots] = {T(CUDART_INF), -T(CUDART_INF), -T(CUDART_INF), T(0),
                        T(0)};
  constexpr int kOps0 = kMin | kMax << 2 | kMax << 4 | kSum << 6 | kSum << 8;
  auto anchor = [&](T ci, T di, T ii) {
    const T neg = -ci;
    const T up = brow * di - ci;
    v0[0] = neg < v0[0] ? neg : v0[0];
    v0[1] = up > v0[1] ? up : v0[1];
    v0[2] = neg > v0[2] ? neg : v0[2];
    v0[3] += ii;
    v0[4] += dev_max(ci, T(0)) * ii;
  };
  if constexpr (PER > 0) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = base + tid + j * kThreads;
      cv[j] = T(0);
      inv[j] = T(0);
      top[j] = T(0);
      if (i < n) {
        const T ci = c[off + i], di = dia[off + i];
        cv[j] = ci;
        inv[j] = T(1) / di;
        top[j] = has_sat ? caprow * di : T(CUDART_INF);
        anchor(ci, di, inv[j]);
      }
    }
  } else {
    pixels([&](T ci, T ii, T, int i) { anchor(ci, dia[off + i], ii); });
  }
  row_reduce<T, kGuidedSlots, kOps0>(v0, red, tot, buf(), part, bpr, grid);
  const T lo = tot[0];
  const T hi = dev_max(tot[1], lo + T(1));
  const T anl_hi = tot[2] + brow / tot[3];
  const T anl_lo = (brow - tot[4]) / tot[3];

  // The residual sum(x) - b at K points, over the whole row.
  auto residuals = [&](const auto& lam, auto& r) {
    constexpr int K = std::extent_v<std::remove_reference_t<decltype(r)>>;
    T sum[K];
#pragma unroll
    for (int k = 0; k < K; ++k) sum[k] = T(0);
    pixels([&](T ci, T ii, T ti, int) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        sum[k] += dev_min(dev_max(ci + lam[k], T(0)), ti) * ii;
    });
    row_reduce<T, K, kSum>(sum, red, tot, buf(), part, bpr, grid);
#pragma unroll
    for (int k = 0; k < K; ++k) r[k] = tot[k] - brow;
  };

  // The probe: the anchors, the midpoint and hi.
  const T eps = machine_eps<T>();
  Ladder<T> s;
  {
    const T w = hi - lo;
    const T eps_w = eps * w;
    const T ql = dev_min(dev_max(anl_lo, lo + eps_w), hi - eps_w);
    const T qh = dev_min(dev_max(anl_hi, ql), hi - eps_w);
    const T mid = lo + T(0.5) * w;
    T pts[4] = {dev_min(ql, mid), dev_min(qh, dev_max(ql, mid)),
                dev_max(qh, mid), hi};
    T r[4];
    residuals(pts, r);
    const T q[5] = {lo, pts[0], pts[1], pts[2], pts[3]};
    const T v[5] = {-brow, r[0], r[1], r[2], r[3]};
    s = ladder_update<T, 5>(q, v, T(0), T(0));
  }

  // The main passes, then the finish pass.
  for (int pass = 0; pass <= n_passes; ++pass) {
    const bool finish = pass == n_passes;
    T pts[3], r[3];
    candidates(s, !finish, pts);
    residuals(pts, r);
    const T q[5] = {s.lo, pts[0], pts[1], pts[2], s.hi};
    const T v[5] = {s.r_lo, r[0], r[1], r[2], s.r_hi};
    s = finish ? ladder_update<T, 5>(q, v, T(0), T(0))
               : ladder_update<T, 5>(q, v, s.sl_lo, s.sl_hi);
  }

  // The secant inside the tightest sign-changing segment.
  const T den = s.r_hi - s.r_lo;
  const T lam = den > T(0) ? dev_min(dev_max(s.lo - s.r_lo * (s.hi - s.lo)
                                                            / den,
                                             s.lo),
                                     s.hi)
                           : s.hi;
  if (part == 0 && tid == 0) lam_out[row] = lam;
  pixels([&](T ci, T, T, int i) {
    if (PER > 0 && i >= n) return;
    const T x = dev_max((ci + lam) / dia[off + i], T(0));
    out[off + i] = has_sat ? dev_min(caprow, x) : x;
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
    // a refused launch also sets the runtime's last error: read it here, or
    // the next launch's check would report it as its own
    if (err != cudaSuccess) cudaGetLastError();
    return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
  }
  const Plan<T> p = plan<T>(n, rows);
  p.kernel<<<p.blocks, p.threads, 0, s>>>(bp, cp, dp, capp, op, rows, n,
                                          n_steps, has_sat);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the guided kernel with PER pixels a thread (0: streamed) that
// the device holds at once.
template <typename T, int PER>
cudaError_t guided_capacity(int device, int* blocks) {
  int per_sm = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, project_rows_guided_grid_kernel<T, PER>, kThreads, 0);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  *blocks = per_sm * sms;
  return err;
}

// How the guided kernel takes (rows, n): ``bpr`` blocks a row, ``group``
// rows a launch (the last launch may take fewer), ``streamed`` whether a
// block streams its part from memory, and ``capacity`` the blocks of that
// kernel the card holds at once.
// - A row of at most kGridChunk pixels is one block: no grid barrier, so
//   any number of rows in one plain launch.
// - A longer row is ceil(n / kGridChunk) blocks that hold their pixels in
//   registers, if that many fit on the card; rows go in groups of as many
//   as fit at once, one cooperative launch a group.
// - A row longer than that (a whole 2048x2048 frame needs 4096 blocks)
//   streams: groups of up to ``capacity`` rows, each row taking an equal
//   share of the card's blocks.
struct GuidedPlan {
  int bpr, group, streamed, capacity;
};

template <typename T>
cudaError_t guided_choose(int rows, int n, int device, GuidedPlan* p) {
  const int full = (n + kGridChunk - 1) / kGridChunk;
  *p = {1, rows > 0 ? rows : 1, 0, 0};
  cudaError_t err = guided_capacity<T, kGridPer>(device, &p->capacity);
  if (err != cudaSuccess || full == 1) return err;
  if (full <= p->capacity) {
    p->bpr = full;
    p->group = p->capacity / full < rows ? p->capacity / full : rows;
    return cudaSuccess;
  }
  err = guided_capacity<T, 0>(device, &p->capacity);
  if (err != cudaSuccess) return err;
  if (p->capacity < 1) return cudaErrorInvalidConfiguration;
  p->streamed = 1;
  p->group = p->capacity < rows ? p->capacity : rows;
  p->bpr = p->capacity / p->group;
  return cudaSuccess;
}

// The launches of guided_choose's plan ``p`` (its capacity unread), which
// the caller asked for once and passes in, so that a launch makes no
// device query.
template <typename T>
int launch_guided(const void* b, const void* c, const void* dia,
                  const void* cap, void* out, void* lam, void* scratch,
                  int rows, int n, int n_passes, int has_sat, GuidedPlan p,
                  int device, void* stream) {
  const int full = (n + kGridChunk - 1) / kGridChunk;
  if (p.bpr < 1 || p.group < 1 || (!p.streamed && p.bpr != full))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  void* kernel =
      p.streamed
          ? reinterpret_cast<void*>(project_rows_guided_grid_kernel<T, 0>)
          : reinterpret_cast<void*>(
                project_rows_guided_grid_kernel<T, kGridPer>);
  T* sp = static_cast<T*>(scratch);
  int bpr = p.bpr;
  for (int start = 0; start < rows; start += p.group) {
    int g = rows - start < p.group ? rows - start : p.group;
    const size_t at = static_cast<size_t>(start) * n;
    const T* bp = static_cast<const T*>(b) + start;
    const T* cp = static_cast<const T*>(c) + at;
    const T* dp = static_cast<const T*>(dia) + at;
    const T* capp = has_sat ? static_cast<const T*>(cap) + start : nullptr;
    T* op = static_cast<T*>(out) + at;
    T* lp = static_cast<T*>(lam) + start;
    void* args[] = {&bp, &cp,   &dp, &capp,     &op,      &lp, &sp,
                    &g,  &n, &n_passes, &has_sat, &bpr};
    // one block a row needs no grid barrier; otherwise cooperative, as the
    // grid path: a grid that is not all resident at once is refused
    // (cudaErrorCooperativeLaunchTooLarge), never hung
    const cudaError_t launched =
        bpr == 1 ? cudaLaunchKernel(kernel, dim3(g), dim3(kThreads), args, 0,
                                    s)
                 : cudaLaunchCooperativeKernel(kernel, dim3(g * bpr),
                                               dim3(kThreads), args, 0, s);
    if (launched != cudaSuccess) {
      cudaGetLastError();  // as the grid path
      return static_cast<int>(launched);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

template <typename T>
int occupancy(int n, char* name, int len, int* blocks) {
  const char type = sizeof(T) == 4 ? 'f' : 'd';
  if (n == -2) {
    snprintf(name, len, "project_rows_guided_grid_kernel<%c,%d>", type,
             kGridPer);
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, project_rows_guided_grid_kernel<T, kGridPer>, kThreads, 0));
  }
  if (n == -3) {
    snprintf(name, len, "project_rows_guided_grid_kernel<%c,0>", type);
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, project_rows_guided_grid_kernel<T, 0>, kThreads, 0));
  }
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

// The guided secant (project_rows_guided_grid_kernel) on rows of any
// length: the same pointers as above, lam a (rows,) output of the roots,
// cap read only when has_sat (it may be null otherwise), scratch of the
// elements that tpu_sgp_project_guided_plan asks for, n_passes main passes,
// and that plan's bpr, group and streamed. Returns the first failing
// launch's cudaError_t (0 on success).
extern "C" int tpu_sgp_project_guided_rows_f32(
    const void* b, const void* c, const void* dia, const void* cap, void* out,
    void* lam, void* scratch, int rows, int n, int n_passes, int has_sat,
    int bpr, int group, int streamed, int device, void* stream) {
  return launch_guided<float>(b, c, dia, cap, out, lam, scratch, rows, n,
                              n_passes, has_sat, {bpr, group, streamed, 0},
                              device, stream);
}

extern "C" int tpu_sgp_project_guided_rows_f64(
    const void* b, const void* c, const void* dia, const void* cap, void* out,
    void* lam, void* scratch, int rows, int n, int n_passes, int has_sat,
    int bpr, int group, int streamed, int device, void* stream) {
  return launch_guided<double>(b, c, dia, cap, out, lam, scratch, rows, n,
                               n_passes, has_sat, {bpr, group, streamed, 0},
                               device, stream);
}

// What the guided launches of (rows, n) are (guided_choose): ``blocks``
// each launch's grid at most, ``scratch`` the elements of scratch they
// share, ``launches`` their number, ``bpr`` the blocks a row, ``group``
// the rows a launch and ``streamed`` 1 where a block streams its part.
// Returns the cudaError_t of the device queries.
extern "C" int tpu_sgp_project_guided_plan(int rows, int n, int is_f64,
                                           int device, int* blocks,
                                           long long* scratch, int* launches,
                                           int* bpr, int* group,
                                           int* streamed) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  GuidedPlan p;
  err = is_f64 ? guided_choose<double>(rows, n, device, &p)
               : guided_choose<float>(rows, n, device, &p);
  *blocks = p.group * p.bpr;
  *scratch = 2LL * p.group * kGuidedSlots * p.bpr;
  *launches = rows > 0 ? (rows + p.group - 1) / p.group : 0;
  *bpr = p.bpr;
  *group = p.group;
  *streamed = p.streamed;
  return static_cast<int>(err);
}

// Instantiation i of the kernels (float32 then float64, each at the
// largest n it takes: 32 .. 1024 the warp path in float32, up to 512 in
// float64, the block path above, then the grid path and last the guided
// secant's grid kernel, in registers and streamed): its name, that n (0:
// any), and its resident blocks an SM. Returns -1 past the last, else the
// cudaError_t.
extern "C" int tpu_sgp_flux_projection_occupancy(int i, int device,
                                                 char* name, int len, int* n,
                                                 int* blocks) {
  static const int kSizes[] = {32, 64, 128, 256, 512, 1024,
                               2048, 0, -1, -2, -3};
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
