// Whole KL-SGP solve of a batch of stamps that share one PSF, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` / `solve_stamps_pallas` in
// tpu_sgp/experimental/pallas_batch.py:57-399. Each row of a (B, N) batch
// (a raveled H x W stamp, N = H * W <= 4096) is solved to completion:
// data scaling and the null-pixel floor, init from the data and a
// projection, the scaling-matrix bounds, and per iteration the scaled step
// with its flux-conserving projection (1-bit bisection of the dual, 28
// steps in float32, 54 in float64), Armijo backtracking with the cap-exit
// fix, the Barzilai-Borwein steplengths with their 3-deep memory and tau
// alternation, stop rule 1 or 3, and revert-on-exit. The arithmetic is the
// Pallas kernel's step for step (the plain twin is
// kernels/stamp_solver.py:solve_rows_plain); selects are selects, not the
// TPU version's arithmetic blends.
//
// The operator is the dense circulant C[(i,j),(p,q)] = k[(i-p) mod H,
// (j-q) mod W] of the taps k = fftshift(psf): A(x) = C x is a circular
// convolution and AT(x) = C^T x a circular correlation. The kernel keeps
// the taps doubled to (2H, 2W) in shared memory, so an index needs no
// `mod`, and applies both directly in full-precision FMAs (no TF32, no
// tensor cores: the reference pins Precision.HIGHEST).
//
// What bounds it on this card: the operator. A lane makes 3 + 2 * iters
// applications of N^2 multiply-adds (about 0.92 M at 31 x 31), so the
// batch is compute-bound on the FP32 pipes by its FLOP count; its bytes
// (the stamps in, x out) are negligible. In this first, simple design each
// multiply-add reads its tap from shared memory, and each input value is
// one broadcast read for PER outputs, so shared-memory bandwidth (one
// 32-wide load a cycle per SM) holds the operator to about a fifth of the
// FMA peak. Second come the ~35 dependent block reductions an iteration
// (28 bisection sums, the trial objectives, gd, the BB sums): each is a
// warp-shuffle tree and a barrier.
//
// What the design does about it: one block per stamp, the whole batch in
// one launch, and no host round trip: a block leaves its loop when its own
// stop rule fires, which equals the reference's masked commits (a frozen
// lane never changes again). Every per-pixel vector lives in registers
// (PER pixels a thread), so device memory is read once and written once;
// blocks are small enough that several share an SM and overlap their
// reductions' latency. Several sums that fall due together (the
// objective's two, the BB four) are reduced in one barrier. All threads
// read the warp partials in the same order, so every thread holds the same
// scalars and takes the same branches without a broadcast.

#include <cuda_runtime.h>
#include <math_constants.h>

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

__device__ __forceinline__ float dev_log(float v) { return logf(v); }
__device__ __forceinline__ double dev_log(double v) { return log(v); }
__device__ __forceinline__ float dev_fma(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double dev_fma(double a, double b, double c) {
  return fma(a, b, c);
}

// Block-wide sums and maxima of M values at once. Two buffers: reduction
// j writes buffer j & 1, and a thread writes it again (reduction j + 2)
// only after the barrier of reduction j + 1, which every thread reaches
// after its reads of reduction j.
template <typename T, int THREADS>
struct BlockReduce {
  static constexpr int kWarps = THREADS / 32;
  T (*red)[4][kWarps];
  int lane, warp, phase;

  template <bool MAX, int M>
  __device__ __forceinline__ void run(T (&v)[M]) {
    static_assert(M <= 4, "at most 4 values a reduction");
    T(*buf)[kWarps] = red[phase];
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
      for (int w = 1; w < kWarps; ++w) {
        if constexpr (MAX) r = buf[m][w] > r ? buf[m][w] : r;
        else r += buf[m][w];
      }
      v[m] = r;
    }
    phase ^= 1;
  }
};

template <typename T>
__device__ __forceinline__ T clip(T v, T lo, T hi) {
  v = v > lo ? v : lo;
  return v < hi ? v : hi;
}

template <typename T, int THREADS, int PER>
__global__ void __launch_bounds__(THREADS)
solve_stamps_kernel(const T* __restrict__ gn_in, const T* __restrict__ bkg_in,
                    const T* __restrict__ flux_in,
                    const T* __restrict__ sat_in,
                    const T* __restrict__ taps, T* __restrict__ x_out,
                    int* __restrict__ it_out, const SolveParams prm) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T red[2][4][THREADS / 32];
  const int n = prm.n, h = prm.h, w = prm.w;
  T* k2 = reinterpret_cast<T*>(smem);  // (2h, 2w) doubled taps
  T* vs = k2 + 4 * n;                  // operator input, n values

  const int tid = threadIdx.x;
  BlockReduce<T, THREADS> blk{red, tid & 31, tid >> 5, 0};
  const size_t off = static_cast<size_t>(blockIdx.x) * n;
  const T eps = sizeof(T) == 4 ? T(1.1920928955078125e-07)
                               : T(2.220446049250313e-16);
  const T inf = T(CUDART_INF);

  for (int t = tid; t < 4 * n; t += THREADS) {
    const int a = t / (2 * w), b = t - a * (2 * w);
    k2[t] = taps[(a % h) * w + b % w];
  }

  // This thread's pixels i = tid + r * THREADS; ok[r] marks those < n.
  // base_a / base_t are the tap offsets of pixel (i, j) for A and AT.
  bool ok[PER];
  int base_a[PER], base_t[PER];
  T gn[PER], bkg[PER];
#pragma unroll
  for (int r = 0; r < PER; ++r) {
    const int i = tid + r * THREADS;
    ok[r] = i < n;
    const int pi = ok[r] ? i / w : 0, pj = ok[r] ? i - (i / w) * w : 0;
    base_a[r] = (pi + h) * 2 * w + pj + w;
    base_t[r] = (h - pi) * 2 * w + (w - pj);
    gn[r] = ok[r] ? gn_in[off + i] : T(0);
    bkg[r] = ok[r] ? bkg_in[off + i] : T(0);
  }
#define FOR_PIX(r) _Pragma("unroll") for (int r = 0; r < PER; ++r) if (ok[r])

  // out = A(v) (transpose false) or AT(v) (transpose true) at this
  // thread's pixels, through the shared copy of v.
  auto apply = [&](bool transpose, const T(&v)[PER], T(&out)[PER]) {
    __syncthreads();  // the last operator's readers are done with vs
    FOR_PIX(r) vs[tid + r * THREADS] = v[r];
    __syncthreads();
    T acc[PER];
#pragma unroll
    for (int r = 0; r < PER; ++r) acc[r] = T(0);
    const int sign = transpose ? 1 : -1;
    int bse[PER];
#pragma unroll
    for (int r = 0; r < PER; ++r) bse[r] = transpose ? base_t[r] : base_a[r];
    for (int p = 0; p < h; ++p) {
      const T* vrow = vs + p * w;
      const int roff = sign * p * 2 * w;
      for (int q = 0; q < w; ++q) {
        const T xv = vrow[q];
        const int o = roff + sign * q;
#pragma unroll
        for (int r = 0; r < PER; ++r)
          acc[r] = dev_fma(k2[bse[r] + o], xv, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < PER; ++r) out[r] = acc[r];
  };

  // ---- preamble (pallas_batch.py:111-118) --------------------------------
  T m1[1] = {-inf};
  FOR_PIX(r) m1[0] = gn[r] > m1[0] ? gn[r] : m1[0];
  blk.template run<true>(m1);
  const T scaling = m1[0];
  T mp[1] = {-inf};  // min over positive pixels = -max(-gn)
  FOR_PIX(r) {
    gn[r] = gn[r] / scaling;
    bkg[r] = bkg[r] / scaling;
    if (gn[r] > T(0) && -gn[r] > mp[0]) mp[0] = -gn[r];
  }
  blk.template run<true>(mp);
  const T vmin = -mp[0];
  FOR_PIX(r) if (gn[r] <= T(0)) gn[r] = vmin * eps * eps;
  const T flux = flux_in[blockIdx.x] / scaling;
  const T cap = sat_in[blockIdx.x] / scaling - eps;

  auto xval = [&](T c, T dia, T lam) {
    T v = (c + lam) / dia;
    v = v > T(0) ? v : T(0);
    return cap < v ? cap : v;
  };

  // Flux-conserving projection by 1-bit bisection (pallas_batch.py:120-149)
  auto project = [&](const T(&c)[PER], const T(&dia)[PER], T(&out)[PER]) {
    T mb[2] = {-inf, -inf};  // max(c) = -lo, max(flux * dia - c)
    FOR_PIX(r) {
      mb[0] = c[r] > mb[0] ? c[r] : mb[0];
      const T top = flux * dia[r] - c[r];
      mb[1] = top > mb[1] ? top : mb[1];
    }
    blk.template run<true>(mb);
    T lo = -mb[0];
    T hi = mb[1] > lo + T(1) ? mb[1] : lo + T(1);
    for (int s = 0; s < prm.proj_steps; ++s) {
      const T mid = T(0.5) * (lo + hi);
      T part[1] = {T(0)};
      FOR_PIX(r) part[0] += xval(c[r], dia[r], mid);
      blk.template run<false>(part);
      if (part[0] - flux < T(0)) lo = mid;
      else hi = mid;
    }
    const T mid = T(0.5) * (lo + hi);
#pragma unroll
    for (int r = 0; r < PER; ++r) out[r] = ok[r] ? xval(c[r], dia[r], mid) : T(0);
  };

  // KL objective (pallas_batch.py:151-154): both sums in one reduction
  auto objective = [&](const T(&xt)[PER]) {
    T s[2] = {T(0), T(0)};
    FOR_PIX(r) {
      s[0] += gn[r] * dev_log(gn[r] / (xt[r] + bkg[r]));
      s[1] += xt[r];
    }
    blk.template run<false>(s);
    return s[0] + s[1] - flux;
  };

  // ---- init 2, projection, gradient, bounds (pallas_batch.py:156-167) ----
  T x[PER], xtf[PER], g[PER], tmp[PER];
#pragma unroll
  for (int r = 0; r < PER; ++r) tmp[r] = T(1);
  project(gn, tmp, x);
  apply(false, x, xtf);
  FOR_PIX(r) tmp[r] = gn[r] / (xtf[r] + bkg[r]);
  apply(true, tmp, g);
#pragma unroll
  for (int r = 0; r < PER; ++r) g[r] = T(1) - g[r];
  T fv = objective(xtf);

  apply(true, gn, tmp);  // AT(gn)
  T mlb[2] = {-inf, -inf};  // -min over positive y_b, max y_b
  FOR_PIX(r) {
    const T yb = flux / (flux + bkg[r]) * tmp[r];
    if (yb > T(0) && -yb > mlb[0]) mlb[0] = -yb;
    mlb[1] = yb > mlb[1] ? yb : mlb[1];
  }
  blk.template run<true>(mlb);
  T x_lb = -mlb[0], x_ub = mlb[1];
  if (x_ub / x_lb < T(50)) {
    x_lb = x_lb / T(10);
    x_ub = x_ub * T(10);
  }

  T xp[PER], xm[PER];
#pragma unroll
  for (int r = 0; r < PER; ++r) {
    xp[r] = x[r];
    xm[r] = ok[r] ? clip(x[r], x_lb, x_ub) : T(1);
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
    T c[PER], dia[PER], d[PER], dtf[PER];
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      dia[r] = T(1) / xm[r];
      c[r] = (x[r] - alpha * xm[r] * g[r]) * dia[r];
    }
    project(c, dia, d);
    T gd[1] = {T(0)};
    FOR_PIX(r) {
      d[r] = d[r] - x[r];
      gd[0] += d[r] * g[r];
    }
    blk.template run<false>(gd);
    apply(false, d, dtf);

    // Armijo backtracking; fr = fv since m_mem == 1 (:210-241)
    T lam = T(1), fv_new;
    if (prm.max_backtracks == 0) {
      FOR_PIX(r) tmp[r] = xtf[r] + dtf[r];
      fv_new = objective(tmp);
    } else {
      bool acc = false;
      fv_new = fv;
      for (int k = 0; k < prm.max_backtracks && !acc; ++k) {
        FOR_PIX(r) tmp[r] = xtf[r] + lam * dtf[r];
        fv_new = objective(tmp);
        if (fv_new <= fv + gamma * lam * gd[0] || lam < T(1e-12)) acc = true;
        else lam = lam * bt;
      }
      if (!acc) {  // cap exit: back to the last evaluated lam, at most 1
        lam = lam / bt;
        lam = lam < T(1) ? lam : T(1);
      }
    }

    // step, new gradient, BB sums (:243-256); x_prev trails x by one
    FOR_PIX(r) {
      xtf[r] = xtf[r] + lam * dtf[r];
      tmp[r] = gn[r] / (xtf[r] + bkg[r]);
    }
    apply(true, tmp, c);  // c := AT(gn / den_new)
    T bb[4] = {T(0), T(0), T(0), T(0)};
    FOR_PIX(r) {
      const T sk = lam * d[r];
      const T x_new = x[r] + sk;
      const T g_new = T(1) - c[r];
      const T yk = g_new - g[r];
      const T xm_new = clip(x_new, x_lb, x_ub);
      const T sk2 = sk * (T(1) / xm_new);
      const T yk2 = yk * xm_new;
      bb[0] += sk2 * yk;
      bb[1] += yk2 * sk;
      bb[2] += sk2 * sk2;
      bb[3] += yk2 * yk2;
      xp[r] = x[r];
      x[r] = x_new;
      xm[r] = xm_new;
      g[r] = g_new;
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
  FOR_PIX(r) x_out[off + tid + r * THREADS] = xp[r] * scaling;
  if (tid == 0) it_out[blockIdx.x] = it - 1;
#undef FOR_PIX
}

template <typename T, int THREADS, int PER>
int launch_rows(const void* gn, const void* bkg, const void* flux,
                const void* sat, const void* taps, void* x, void* iters,
                int rows, const SolveParams& prm, cudaStream_t stream) {
  const auto kernel = solve_stamps_kernel<T, THREADS, PER>;
  const size_t smem = static_cast<size_t>(5) * prm.n * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  solve_stamps_kernel<T, THREADS, PER><<<rows, THREADS, smem, stream>>>(
      static_cast<const T*>(gn), static_cast<const T*>(bkg),
      static_cast<const T*>(flux), static_cast<const T*>(sat),
      static_cast<const T*>(taps), static_cast<T*>(x),
      static_cast<int*>(iters), prm);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* gn, const void* bkg, const void* flux, const void* sat,
           const void* taps, void* x, void* iters, int rows,
           const SolveParams* prm, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  const int n = prm->n;
  if (n <= 0 || n > 4096 || prm->h * prm->w != n)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 256)
    return launch_rows<T, 256, 1>(gn, bkg, flux, sat, taps, x, iters, rows,
                                  *prm, s);
  if (n <= 512)
    return launch_rows<T, 256, 2>(gn, bkg, flux, sat, taps, x, iters, rows,
                                  *prm, s);
  if (n <= 1024)
    return launch_rows<T, 256, 4>(gn, bkg, flux, sat, taps, x, iters, rows,
                                  *prm, s);
  if (n <= 2048)
    return launch_rows<T, 512, 4>(gn, bkg, flux, sat, taps, x, iters, rows,
                                  *prm, s);
  return launch_rows<T, 1024, 4>(gn, bkg, flux, sat, taps, x, iters, rows,
                                 *prm, s);
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
