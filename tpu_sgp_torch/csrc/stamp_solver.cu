// Whole KL-SGP solve of a batch of stamps that share one PSF, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` / `solve_stamps_pallas` in
// tpu_sgp/experimental/pallas_batch.py:57-399. Each row of a (B, N) batch
// (a raveled H x W stamp, N = H * W <= 4096) is solved to completion:
// data scaling and the null-pixel floor, init from the data and a
// projection, the scaling-matrix bounds, and per iteration the scaled step
// with its flux-conserving projection (bisection of the dual, 28 1-bit
// steps in float32, 54 in float64), Armijo backtracking with the cap-exit
// fix, the Barzilai-Borwein steplengths with their 3-deep memory and tau
// alternation, stop rule 1 or 3, and revert-on-exit. The arithmetic is the
// Pallas kernel's step for step (the plain twin is
// kernels/stamp_solver.py:solve_rows_plain); selects are selects, not the
// TPU version's arithmetic blends.
//
// The operator is the dense circulant C[(i,j),(p,q)] = k[(i-p) mod H,
// (j-q) mod W] of the taps k = fftshift(psf):
//   AT(x)[i][j] = sum_{a,b} k[a][b] * x[(i+a) mod H][(j+b) mod W],
//   A(x)[i][j]  = sum_{a,b} kf[a][b] * x[(i+1+a) mod H][(j+1+b) mod W],
// with kf[a][b] = k[H-1-a][W-1-b] the taps flipped. Both are one
// correlation over the input doubled (every index taken mod H, W) in
// shared memory, so no index needs a `mod`; full-precision FMAs (no TF32,
// no tensor cores: the reference pins Precision.HIGHEST).
//
// What bounds it on this card: the operator. A lane makes 3 + 2 * iters
// applications of N^2 multiply-adds (about 0.92 M at 31 x 31), so the
// batch is compute-bound on the FP32 pipes by its FLOP count; its bytes
// (the stamps in, x out) are negligible. The first design read a tap from
// shared memory for every FMA (about 1.25 shared loads an FMA); measured on
// the card its operator took 95 % of the kernel's time (PERF.md).
//
// What the design does about it:
// - Register tiling. A thread owns a 2 x 4 patch of outputs (rows 2p and
//   2p + 1, columns 4g .. 4g + 3), and the solver's per-pixel state lives
//   in the same registers, so the operator's outputs land where they are
//   used. For each input row the thread slides a window of 7 inputs along
//   the row and takes the two tap rows that meet it (zero rows pad the
//   table above and below, zero columns pad it to a multiple of 4): per 4
//   taps, one aligned vector load of 4 inputs and 2 warp-uniform vector
//   tap loads (broadcasts) feed 32 FMAs: 3 shared load instructions for
//   32 FMAs, fully unrolled along a tap row for the main path's width. A
//   quarter warp's input loads (8 column groups of one row pair) cover
//   128 contiguous bytes, so they take one shared-memory wavefront.
// - Block shape from the stamp. ceil(H / 2) * ceil(W / 4) threads, 128 at
//   31 x 31 (4 warps); the template's MAXT (128, 256, 512, 1024) is the
//   launch bound the compiler allocates registers for.
// - Fewer barriers. One block per stamp, the whole batch in one launch, no
//   host round trip: a block leaves its loop when its own stop rule fires,
//   which equals the reference's masked commits. Block reductions go
//   through double-buffered warp partials that every thread reads in the
//   same order, so all threads hold the same scalars without a broadcast.
//   The bisection can evaluate kDepth levels of its tree at once (the
//   2^kDepth - 1 midpoints, each by the same 0.5 * (lo + hi) as in
//   sequence), reduce their sums in one barrier and walk the tree: the
//   same (lo, hi) as kDepth 1-bit steps on the same sums. Measured at the
//   main path's shape, depth 2 and 3 cost more in xval's true divisions
//   than they save in barriers, so kDepth is 1 (kernel_variants.py). gd is
//   reduced with the first trial objective, the four BB sums together,
//   and the operator stages its input behind one barrier (a second only
//   where no reduction separates two applications). The projection's
//   bracket keeps its own barrier: its maxima depend on alpha, which the
//   BB sums' reduction yields just before.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdio>
#include <type_traits>

#include "reduce.cuh"

// Solver parameters, field for field kernels/stamp_solver.py:_Params.
struct SolveParams {
  int n, h, w;
  int max_iter, stop_rule, max_backtracks, proj_steps;
  double tol, gamma, bt_factor, alpha_init, alpha_min, alpha_max, tau_init;
};

namespace {

using tpu_sgp::warp_max;
using tpu_sgp::warp_sum;

constexpr int kCols = 4;                // adjacent outputs of a patch row
constexpr int kPix = 2 * kCols;         // pixels a thread: a 2 x 4 patch
constexpr int kDepth = 1;               // bisection levels a barrier
constexpr int kNodes = (1 << kDepth) - 1;
constexpr int kMaxVals = 8;             // values one reduction carries
constexpr int kMaxWarps = 32;

__device__ __forceinline__ float dev_log(float v) { return logf(v); }
__device__ __forceinline__ double dev_log(double v) { return log(v); }
__device__ __forceinline__ float dev_fma(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double dev_fma(double a, double b, double c) {
  return fma(a, b, c);
}
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

// Four consecutive values from 16-byte-aligned shared memory.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
  const double2 q0 = *reinterpret_cast<const double2*>(p);
  const double2 q1 = *reinterpret_cast<const double2*>(p + 2);
  v[0] = q0.x;
  v[1] = q0.y;
  v[2] = q1.x;
  v[3] = q1.y;
}

// The block's shape and shared-memory layout for an h x w stamp.
struct Layout {
  int h, w;
  int groups;  // column groups of kCols: ceil(w / 4)
  int pairs;   // row pairs: ceil(h / 2)
  int pitch;   // tap table row length, 4 * groups (zero columns past w)
  int xrows;   // rows of the doubled input: 2 * pairs + h
  int xcols;   // its columns: 4 * groups + pitch
  int stride;  // its row stride: xcols + 1 (A's shift) rounded up to 4

  __host__ __device__ explicit Layout(int h_, int w_)
      : h(h_), w(w_), groups((w_ + kCols - 1) / kCols), pairs((h_ + 1) / 2),
        pitch(kCols * groups), xrows(2 * pairs + h_),
        xcols(kCols * groups + pitch), stride((xcols + 1 + 3) / 4 * 4) {}

  __host__ __device__ int threads() const {
    return (pairs * groups + 31) / 32 * 32;
  }
  // two tap tables of h + 2 rows, then the doubled input
  __host__ __device__ size_t elems() const {
    return static_cast<size_t>(2) * (h + 2) * pitch +
           static_cast<size_t>(xrows) * stride;
  }
};

// Block-wide sums and maxima of M values at once. Two buffers: reduction
// j writes buffer j & 1, and a thread writes it again (reduction j + 2)
// only after the barrier of reduction j + 1, which every thread reaches
// after its reads of reduction j.
template <typename T, int MAXT>
struct BlockReduce {
  T (*red)[kMaxVals][kMaxWarps];
  int lane, warp, warps, phase;

  template <bool MAX, int M>
  __device__ __forceinline__ void run(T (&v)[M]) {
    static_assert(M <= kMaxVals, "too many values a reduction");
    T(*buf)[kMaxWarps] = red[phase];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      if constexpr (MAX) v[m] = warp_max(v[m]);
      else v[m] = warp_sum(v[m]);
      if (lane == 0) buf[m][warp] = v[m];
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < M; ++m) {
      T r = buf[m][0];
#pragma unroll
      for (int w = 1; w < MAXT / 32; ++w) {
        if (w >= warps) break;
        if constexpr (MAX) r = buf[m][w] > r ? buf[m][w] : r;
        else r += buf[m][w];
      }
      v[m] = r;
    }
    phase ^= 1;
  }
};

// jnp.clip(v, lo, hi): one max and one min instruction
template <typename T>
__device__ __forceinline__ T clip(T v, T lo, T hi) {
  return dev_min(dev_max(v, lo), hi);
}

// One thread's 2 x 4 patch of a stamp and the operator on it. Pixel
// k = 4 * ri + r is (2 * pair + ri, 4 * group + r); ok[k] marks those
// inside the stamp (threads past pairs * groups own none). PITCH is the
// tap row length when known at compile time (32: stamps 29 to 32 wide,
// the main path's 31 among them), which unrolls a tap row's loop; 0 reads
// it from the layout.
template <typename T, int PITCH>
struct Patch {
  Layout L;
  T* tap_a;  // (h + 2, pitch) flipped taps, zero first and last rows
  T* tap_t;  // (h + 2, pitch) taps, the same padding
  T* xs;     // (xrows, stride) doubled input
  int pair, group, base;
  bool ok[kPix];

  __device__ Patch(unsigned char* smem, const T* taps, const Layout& lay,
                   int tid)
      : L(lay) {
    tap_a = reinterpret_cast<T*>(smem);
    tap_t = tap_a + (L.h + 2) * L.pitch;
    xs = tap_t + (L.h + 2) * L.pitch;
    for (int t = tid; t < (L.h + 2) * L.pitch; t += blockDim.x) {
      const int k = t / L.pitch, b = t - k * L.pitch;
      const bool in = k >= 1 && k <= L.h && b < L.w;
      tap_t[t] = in ? taps[(k - 1) * L.w + b] : T(0);
      tap_a[t] = in ? taps[(L.h - k) * L.w + (L.w - 1 - b)] : T(0);
    }
    const bool live = tid < L.pairs * L.groups;
    pair = live ? tid / L.groups : 0;
    group = live ? tid - pair * L.groups : 0;
    base = 2 * pair * L.w + kCols * group;
#pragma unroll
    for (int k = 0; k < kPix; ++k)
      ok[k] = live && 2 * pair + k / kCols < L.h &&
              kCols * group + k % kCols < L.w;
  }

  // offset of pixel k in the row-major stamp
  __device__ __forceinline__ int index(int k) const {
    return base + (k / kCols) * L.w + k % kCols;
  }

  // out = A(v) (transpose false) or AT(v) (transpose true) at this
  // thread's pixels. The input is staged in xs behind one barrier;
  // sync_first adds one before, where no barrier separates this call from
  // the last call's reads of xs.
  __device__ void apply(bool transpose, const T (&v)[kPix], T (&out)[kPix],
                        bool sync_first) {
    // A reads the input one column right of where AT does (s); staging
    // it o = 1 - s columns right puts both reads at stored column
    // 4 * group + 1 + b, so a chunk's four new inputs are one aligned
    // vector load.
    const int s = transpose ? 0 : 1, o = 1 - s;
    const T* tab = transpose ? tap_t : tap_a;
    if (sync_first) __syncthreads();
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      if (!ok[k]) continue;
      const int i = 2 * pair + k / kCols, j = kCols * group + k % kCols;
      for (int u = i; u < L.xrows; u += L.h) {
        T* row = xs + u * L.stride + o;
        for (int c = j; c < L.xcols; c += L.w) row[c] = v[k];
      }
    }
    __syncthreads();
    T acc[kPix];
#pragma unroll
    for (int k = 0; k < kPix; ++k) acc[k] = T(0);
    for (int a = 0; a <= L.h; ++a) {
      // input row u meets tap row a for output row 2p and a - 1 for 2p + 1
      const int u = 2 * pair + s + a;
      const T* row = xs + u * L.stride + kCols * group + 1;
      const int pitch = PITCH ? PITCH : L.pitch;
      const T* t0 = tab + (a + 1) * pitch;
      const T* t1 = tab + a * pitch;
      T win[kCols + 3], v4[4];
      load4(row - 1, v4);
#pragma unroll
      for (int q = 0; q < 3; ++q) win[q] = v4[1 + q];
#pragma unroll
      for (int b0 = 0; b0 < pitch; b0 += 4) {
        load4(row + b0 + 3, v4);
#pragma unroll
        for (int q = 0; q < 4; ++q) win[3 + q] = v4[q];
        T k0[4], k1[4];
        load4(t0 + b0, k0);
        load4(t1 + b0, k1);
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
#pragma unroll
          for (int r = 0; r < kCols; ++r) {
            acc[r] = dev_fma(k0[bb], win[bb + r], acc[r]);
            acc[kCols + r] = dev_fma(k1[bb], win[bb + r], acc[kCols + r]);
          }
        }
#pragma unroll
        for (int q = 0; q < 3; ++q) win[q] = win[4 + q];
      }
    }
#pragma unroll
    for (int k = 0; k < kPix; ++k) out[k] = acc[k];
  }
};

// At the main path's 128 threads a float32 block is held to 128 registers,
// so 4 blocks share an SM: 46.3 ms against 49.9 ms for 3 blocks at 166
// registers, at the main path's shape on an H100 (kernel_variants.py).
template <typename T, int MAXT, int PITCH>
__global__ void __launch_bounds__(MAXT,
                                  sizeof(T) == 4 && MAXT == 128 ? 4 : 1)
solve_stamps_kernel(const T* __restrict__ gn_in, const T* __restrict__ bkg_in,
                    const T* __restrict__ flux_in,
                    const T* __restrict__ sat_in,
                    const T* __restrict__ taps, T* __restrict__ x_out,
                    int* __restrict__ it_out, const SolveParams prm) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T red[2][kMaxVals][kMaxWarps];

  const int tid = threadIdx.x;
  BlockReduce<T, MAXT> blk{red, tid & 31, tid >> 5,
                           static_cast<int>(blockDim.x) >> 5, 0};
  const size_t off = static_cast<size_t>(blockIdx.x) * prm.n;
  const T eps = sizeof(T) == 4 ? T(1.1920928955078125e-07)
                               : T(2.220446049250313e-16);
  const T inf = T(CUDART_INF);

  Patch<T, PITCH> op(smem, taps, Layout(prm.h, prm.w), tid);
  const bool(&ok)[kPix] = op.ok;
  T gn[kPix], bkg[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    gn[k] = ok[k] ? gn_in[off + op.index(k)] : T(0);
    bkg[k] = ok[k] ? bkg_in[off + op.index(k)] : T(0);
  }
#define FOR_PIX(k) _Pragma("unroll") for (int k = 0; k < kPix; ++k) if (ok[k])

  // ---- preamble (pallas_batch.py:111-118) --------------------------------
  T m1[1] = {-inf};
  FOR_PIX(k) m1[0] = gn[k] > m1[0] ? gn[k] : m1[0];
  blk.template run<true>(m1);
  const T scaling = m1[0];
  T mp[1] = {-inf};  // min over positive pixels = -max(-gn)
  FOR_PIX(k) {
    gn[k] = gn[k] / scaling;
    bkg[k] = bkg[k] / scaling;
    if (gn[k] > T(0) && -gn[k] > mp[0]) mp[0] = -gn[k];
  }
  blk.template run<true>(mp);
  const T vmin = -mp[0];
  FOR_PIX(k) if (gn[k] <= T(0)) gn[k] = vmin * eps * eps;
  const T flux = flux_in[blockIdx.x] / scaling;
  const T cap = sat_in[blockIdx.x] / scaling - eps;

  // jnp.minimum(cap, jnp.maximum((c + lam) / dia, 0)) (pallas_batch.py:125)
  auto xval = [&](T c, T dia, T lam) {
    return dev_min(cap, dev_max((c + lam) / dia, T(0)));
  };

  // Flux-conserving projection by bisection (pallas_batch.py:120-149),
  // kDepth levels of the tree a barrier. Node q of the heap has children
  // 2q + 1 (hi := mid) and 2q + 2 (lo := mid).
  auto project = [&](const T(&c)[kPix], const T(&dia)[kPix], T(&out)[kPix]) {
    T mb[2] = {-inf, -inf};  // max(c) = -lo, max(flux * dia - c)
    FOR_PIX(k) {
      mb[0] = c[k] > mb[0] ? c[k] : mb[0];
      const T top = flux * dia[k] - c[k];
      mb[1] = top > mb[1] ? top : mb[1];
    }
    blk.template run<true>(mb);
    T lo = -mb[0];
    T hi = mb[1] > lo + T(1) ? mb[1] : lo + T(1);
    for (int left = prm.proj_steps; left > 0; left -= kDepth) {
      T nlo[kNodes], nhi[kNodes], mid[kNodes], part[kNodes];
      nlo[0] = lo;
      nhi[0] = hi;
#pragma unroll
      for (int q = 0; q < kNodes; ++q) {
        mid[q] = T(0.5) * (nlo[q] + nhi[q]);
        if (2 * q + 2 < kNodes) {
          nlo[2 * q + 1] = nlo[q];
          nhi[2 * q + 1] = mid[q];
          nlo[2 * q + 2] = mid[q];
          nhi[2 * q + 2] = nhi[q];
        }
        part[q] = T(0);
      }
      FOR_PIX(k) {
#pragma unroll
        for (int q = 0; q < kNodes; ++q) part[q] += xval(c[k], dia[k], mid[q]);
      }
      blk.template run<false>(part);
      const int depth = left < kDepth ? left : kDepth;
      int node = 0;
      for (int l = 0; l < depth; ++l) {
        T pq = T(0), mq = T(0);
#pragma unroll
        for (int q = 0; q < kNodes; ++q) {
          if (q == node) {
            pq = part[q];
            mq = mid[q];
          }
        }
        if (pq - flux < T(0)) {
          lo = mq;
          node = 2 * node + 2;
        } else {
          hi = mq;
          node = 2 * node + 1;
        }
      }
    }
    const T mid = T(0.5) * (lo + hi);
#pragma unroll
    for (int k = 0; k < kPix; ++k)
      out[k] = ok[k] ? xval(c[k], dia[k], mid) : T(0);
  };

  // KL objective (pallas_batch.py:151-154): both sums in one reduction,
  // with a third sum `extra` (the caller's partial, returned reduced)
  auto objective = [&](const T(&xt)[kPix], T& extra) {
    T s[3] = {T(0), T(0), extra};
    FOR_PIX(k) {
      s[0] += gn[k] * dev_log(gn[k] / (xt[k] + bkg[k]));
      s[1] += xt[k];
    }
    blk.template run<false>(s);
    extra = s[2];
    return s[0] + s[1] - flux;
  };

  // ---- init 2, projection, gradient, bounds (pallas_batch.py:156-167) ----
  T x[kPix], xtf[kPix], g[kPix], tmp[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) tmp[k] = T(1);
  project(gn, tmp, x);
  op.apply(false, x, xtf, false);
  FOR_PIX(k) tmp[k] = gn[k] / (xtf[k] + bkg[k]);
  op.apply(true, tmp, g, true);
#pragma unroll
  for (int k = 0; k < kPix; ++k) g[k] = T(1) - g[k];
  T none = T(0);
  T fv = objective(xtf, none);

  op.apply(true, gn, tmp, false);  // AT(gn)
  T mlb[2] = {-inf, -inf};  // -min over positive y_b, max y_b
  FOR_PIX(k) {
    const T yb = flux / (flux + bkg[k]) * tmp[k];
    if (yb > T(0) && -yb > mlb[0]) mlb[0] = -yb;
    mlb[1] = yb > mlb[1] ? yb : mlb[1];
  }
  blk.template run<true>(mlb);
  T x_lb = -mlb[0], x_ub = mlb[1];
  if (x_ub / x_lb < T(50)) {
    x_lb = x_lb / T(10);
    x_ub = x_ub * T(10);
  }

  T xp[kPix], xm[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    xp[k] = x[k];
    xm[k] = ok[k] ? clip(x[k], x_lb, x_ub) : T(1);
  }

  const T gamma = T(prm.gamma), bt = T(prm.bt_factor);
  const T alpha_min = T(prm.alpha_min), alpha_max = T(prm.alpha_max);
  const T tol = T(prm.tol);
  T alpha = T(prm.alpha_init), tau = T(prm.tau_init);
  T v1 = alpha_max, v2 = alpha_max;  // the last two alpha2 memories
  int it = 1;
  bool keep = true;

  // ---- iterations (pallas_batch.py:199-299) ------------------------------
  while (keep) {
    T c[kPix], dia[kPix], d[kPix], dtf[kPix];
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      dia[k] = T(1) / xm[k];
      c[k] = (x[k] - alpha * xm[k] * g[k]) * dia[k];
    }
    project(c, dia, d);
    T gd = T(0);  // reduced with the first trial objective
    FOR_PIX(k) {
      d[k] = d[k] - x[k];
      gd += d[k] * g[k];
    }
    op.apply(false, d, dtf, false);

    // Armijo backtracking; fr = fv since m_mem == 1 (:210-241)
    T lam = T(1), fv_new;
    if (prm.max_backtracks == 0) {
      FOR_PIX(k) tmp[k] = xtf[k] + dtf[k];
      fv_new = objective(tmp, gd);
    } else {
      bool acc = false;
      fv_new = fv;
      for (int t = 0; t < prm.max_backtracks && !acc; ++t) {
        FOR_PIX(k) tmp[k] = xtf[k] + lam * dtf[k];
        none = T(0);
        fv_new = objective(tmp, t == 0 ? gd : none);
        if (fv_new <= fv + gamma * lam * gd || lam < T(1e-12)) acc = true;
        else lam = lam * bt;
      }
      if (!acc) {  // cap exit: back to the last evaluated lam, at most 1
        lam = lam / bt;
        lam = lam < T(1) ? lam : T(1);
      }
    }

    // step, new gradient, BB sums (:243-256); x_prev trails x by one
    FOR_PIX(k) {
      xtf[k] = xtf[k] + lam * dtf[k];
      tmp[k] = gn[k] / (xtf[k] + bkg[k]);
    }
    op.apply(true, tmp, c, false);  // c := AT(gn / den_new)
    T bb[4] = {T(0), T(0), T(0), T(0)};
    FOR_PIX(k) {
      const T sk = lam * d[k];
      const T x_new = x[k] + sk;
      const T g_new = T(1) - c[k];
      const T yk = g_new - g[k];
      const T xm_new = clip(x_new, x_lb, x_ub);
      const T sk2 = sk * (T(1) / xm_new);
      const T yk2 = yk * xm_new;
      bb[0] += sk2 * yk;
      bb[1] += yk2 * sk;
      bb[2] += sk2 * sk2;
      bb[3] += yk2 * yk2;
      xp[k] = x[k];
      x[k] = x_new;
      xm[k] = xm_new;
      g[k] = g_new;
    }
    blk.template run<false>(bb);

    // BB steplengths, memory and tau alternation (:257-272)
    const T grow = T(10) * alpha < alpha_max ? T(10) * alpha : alpha_max;
    const T alpha1 = bb[0] <= T(0) ? grow
                                   : clip(bb[2] / bb[0], alpha_min, alpha_max);
    const T alpha2 = bb[1] <= T(0) ? grow
                                   : clip(bb[1] / bb[3], alpha_min, alpha_max);
    const bool early = it <= 20;
    const bool ratio_lt = alpha2 / alpha1 < tau;
    T vmin_a = v1 < v2 ? v1 : v2;
    vmin_a = vmin_a < alpha2 ? vmin_a : alpha2;
    const T alpha_new = (early || ratio_lt) ? vmin_a : alpha1;
    const T tau_new = early ? tau : (ratio_lt ? tau * T(0.9) : tau * T(1.1));

    // stop rule 1 or 3 (:274-280)
    bool rule = it + 1 <= prm.max_iter;
    if (prm.stop_rule == 3) {
      const T reld = (fv - fv_new) / fv_new;
      rule = rule && reld > tol && reld >= T(0);
    }
    fv = fv_new;
    alpha = alpha_new;
    tau = tau_new;
    v1 = v2;
    v2 = alpha2;
    it += 1;
    keep = rule;
  }

  // revert-on-exit (:313-314)
  FOR_PIX(k) x_out[off + op.index(k)] = xp[k] * scaling;
  if (tid == 0) it_out[blockIdx.x] = it - 1;
#undef FOR_PIX
}

// Operator alone (chip_smoke.py measures K2's operator share with it):
// each row x of a (rows, n) batch becomes (AT A)^reps x, through the same
// Patch as the solver.
template <typename T, int MAXT, int PITCH>
__global__ void __launch_bounds__(MAXT)
apply_operator_kernel(const T* __restrict__ x_in, const T* __restrict__ taps,
                      T* __restrict__ out, int h, int w, int reps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t off = static_cast<size_t>(blockIdx.x) * h * w;
  Patch<T, PITCH> op(smem, taps, Layout(h, w), threadIdx.x);
  T v[kPix], t[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k)
    v[k] = op.ok[k] ? x_in[off + op.index(k)] : T(0);
  for (int k = 0; k < reps; ++k) {
    op.apply(false, v, t, true);
    op.apply(true, t, v, true);
  }
#pragma unroll
  for (int k = 0; k < kPix; ++k)
    if (op.ok[k]) out[off + op.index(k)] = v[k];
}

// Call f(MAXT, PITCH) with the instantiation for an h x w stamp's block:
// its launch bound, and the tap row length where the block of 128 threads
// has it fixed at 32; an error if the block would exceed 1024 threads.
template <class F>
int by_shape(const Layout& lay, F&& f) {
  using std::integral_constant;
  const int threads = lay.threads();
  if (threads <= 128 && lay.pitch == 32)
    return f(integral_constant<int, 128>{}, integral_constant<int, 32>{});
  if (threads <= 128)
    return f(integral_constant<int, 128>{}, integral_constant<int, 0>{});
  if (threads <= 256)
    return f(integral_constant<int, 256>{}, integral_constant<int, 0>{});
  if (threads <= 512)
    return f(integral_constant<int, 512>{}, integral_constant<int, 0>{});
  if (threads <= 1024)
    return f(integral_constant<int, 1024>{}, integral_constant<int, 0>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

// Lift a kernel's dynamic shared memory limit where smem needs it.
template <class K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T>
int launch(const void* gn, const void* bkg, const void* flux, const void* sat,
           const void* taps, void* x, void* iters, int rows,
           const SolveParams* prm, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = prm->n;
  if (n <= 0 || n > 4096 || prm->h * prm->w != n)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout lay(prm->h, prm->w);
  return by_shape(lay, [&](auto maxt, auto pitch) {
    const auto kernel = solve_stamps_kernel<T, decltype(maxt)::value,
                                            decltype(pitch)::value>;
    const size_t smem = lay.elems() * sizeof(T);
    const cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const auto st = static_cast<cudaStream_t>(stream);
    kernel<<<rows, lay.threads(), smem, st>>>(
        static_cast<const T*>(gn), static_cast<const T*>(bkg),
        static_cast<const T*>(flux), static_cast<const T*>(sat),
        static_cast<const T*>(taps), static_cast<T*>(x),
        static_cast<int*>(iters), *prm);
    return static_cast<int>(cudaGetLastError());
  });
}

// The operator alone, held to the solver's residency: its dynamic shared
// memory is padded so that no more of its blocks share an SM than of the
// solver's for the same stamp (the solver holds more registers), and
// *resident reports that count.
template <typename T>
int launch_operator(const void* x, const void* taps, void* out, int rows,
                    int h, int w, int reps, int* resident, int device,
                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (h <= 0 || w <= 0 || h * w > 4096 || reps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout lay(h, w);
  return by_shape(lay, [&](auto maxt, auto pitch) {
    constexpr int kMaxt = decltype(maxt)::value;
    constexpr int kPitch = decltype(pitch)::value;
    const auto solver = solve_stamps_kernel<T, kMaxt, kPitch>;
    const auto kernel = apply_operator_kernel<T, kMaxt, kPitch>;
    size_t smem = lay.elems() * sizeof(T);
    int blocks = 0;
    cudaError_t e = allow_smem(solver, smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, solver,
                                                        lay.threads(), smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    // an SM's 228 KB, 1 KB of it reserved a block: blocks + 1 must not fit
    const size_t share = 228 * 1024 / (blocks + 1) - 1024 + 1;
    smem = share > smem ? share : smem;
    e = allow_smem(kernel, smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident, kernel,
                                                        lay.threads(), smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const auto st = static_cast<cudaStream_t>(stream);
    kernel<<<rows, lay.threads(), smem, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(taps),
        static_cast<T*>(out), h, w, reps);
    return static_cast<int>(cudaGetLastError());
  });
}

// Resident blocks an SM of the solver's instantiation for an h x w stamp,
// and its name as chip_smoke.py prints ptxas's report.
template <typename T>
int occupancy(int h, int w, int* blocks, char* name, int len) {
  const Layout lay(h, w);
  return by_shape(lay, [&](auto maxt, auto pitch) {
    constexpr int kMaxt = decltype(maxt)::value;
    constexpr int kPitch = decltype(pitch)::value;
    const auto kernel = solve_stamps_kernel<T, kMaxt, kPitch>;
    const size_t smem = lay.elems() * sizeof(T);
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    snprintf(name, len, "solve_stamps_kernel<%c,%d,%d>",
             sizeof(T) == 4 ? 'f' : 'd', kMaxt, kPitch);
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kernel, lay.threads(), smem));
  });
}

}  // namespace

// Plain C entry points, loaded with ctypes. Pointers are device pointers of
// contiguous (rows, n) gn, bkg and x, (rows,) flux, sat and int32 iters,
// and the (h, w) taps; prm is a host pointer; stream is a cudaStream_t.
// Returns the launch's cudaError_t (0 on success).
extern "C" int tpu_sgp_solve_stamps_f32(const void* gn, const void* bkg,
                                        const void* flux, const void* sat,
                                        const void* taps, void* x,
                                        void* iters, int rows,
                                        const SolveParams* prm, int device,
                                        void* stream) {
  return launch<float>(gn, bkg, flux, sat, taps, x, iters, rows, prm, device,
                       stream);
}

extern "C" int tpu_sgp_solve_stamps_f64(const void* gn, const void* bkg,
                                        const void* flux, const void* sat,
                                        const void* taps, void* x,
                                        void* iters, int rows,
                                        const SolveParams* prm, int device,
                                        void* stream) {
  return launch<double>(gn, bkg, flux, sat, taps, x, iters, rows, prm, device,
                        stream);
}

// The operator alone: out = (AT A)^reps x for each row of a contiguous
// (rows, h * w) x, with the (h, w) taps, at the solver's residency (its
// blocks an SM written to *resident, a host pointer). Returns the launch's
// cudaError_t.
extern "C" int tpu_sgp_apply_operator_f32(const void* x, const void* taps,
                                          void* out, int rows, int h, int w,
                                          int reps, int* resident, int device,
                                          void* stream) {
  return launch_operator<float>(x, taps, out, rows, h, w, reps, resident,
                                device, stream);
}

extern "C" int tpu_sgp_apply_operator_f64(const void* x, const void* taps,
                                          void* out, int rows, int h, int w,
                                          int reps, int* resident, int device,
                                          void* stream) {
  return launch_operator<double>(x, taps, out, rows, h, w, reps, resident,
                                 device, stream);
}

// Instantiation i of the solver (float32 then float64, each at a stamp that
// takes it: 31x31, 16x16, 40x40, 64x64, 63x65): its name, the n, and its
// resident blocks an SM. Returns -1 past the last instantiation, else the
// cudaError_t.
extern "C" int tpu_sgp_stamp_solver_occupancy(int i, int device, char* name,
                                              int len, int* n, int* blocks) {
  static const int kShapes[][2] = {
      {31, 31}, {16, 16}, {40, 40}, {64, 64}, {63, 65}};
  constexpr int kCount = sizeof(kShapes) / sizeof(kShapes[0]);
  if (i < 0 || i >= 2 * kCount) return -1;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int h = kShapes[i % kCount][0], w = kShapes[i % kCount][1];
  *n = h * w;
  return i < kCount ? occupancy<float>(h, w, blocks, name, len)
                    : occupancy<double>(h, w, blocks, name, len);
}
