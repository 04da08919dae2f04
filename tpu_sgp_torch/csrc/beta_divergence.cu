// The beta-divergence of each row and the row sums of its d/dbeta for
// Hopper (sm_90a), one launch a call.
//
// Replaces no Pallas kernel. It is the JAX package's XLA function
// tpu_sgp/ops/divergence.py:113-161 (beta_div_with_dbeta), which XLA fuses
// into one pass on the TPU; the port's plain version is
// tpu_sgp_torch/ops/divergence.py beta_div_with_dbeta_plain. For row r of
// a (B, N) batch, with b = beta[r] and e = b - 1, and for each pixel
//
//     d = log(den / gn),  gn_b = exp(b log_gn),
//     r1 = expm1(e d) / e  (d where |e| < eps/512),
//     r2 = expm1(b d) / b  (d where |b| < eps/512),
//     fv[r]   = sum gn_b (r2 - r1),
//     dsum[r] = sum gn_b (log_gn (r2 - r1) + d^2 (E2(b d) - E2(e d))),
//
// E2(s) = (s e^s - expm1(s)) / s^2 from expm1(s), by its Taylor series of
// 11 terms where |s| < 0.25. The beta-SGP line search with beta adaptation
// evaluates it at every trial, on every row of the batch.
//
// Why one launch: the plain version is about 98 ATen operations, 84 of
// them writing a full (B, N) tensor, so at a stamp batch's (12288, 961) in
// float32 a call moves about 10 GB and takes 4.31 ms on an H100, and each
// of its launches costs the host's time besides. What the pass needs is
// den, gn and log_gn read once (141.7 MB there) and two (B,) vectors
// written, 0.042 ms at 3.35 TB/s. A pixel's arithmetic is long, though:
// the precise log, exp and two expm1, four IEEE divisions and two Horner
// series of 11 terms are sequences of instructions, so the kernel may be
// bound by its instruction rate rather than by the bytes.
//
// What the design does about it. One block a row: a row's two sums need no
// second pass and nothing in memory but the results. Each pixel is
// computed in registers as the plain version's operations in its order,
// each rounded on its own (__fmul_rn, __fdiv_rn, ..., and -fmad=false)
// with the CUDA math functions that ATen calls (logf / log, expf / exp,
// expm1f / expm1), so a pixel's terms are the plain version's where those
// functions give the same bits. With `stable` the terms of fv fold into
// the compensated row sum's tree (ff_tree.cuh) as they are computed, so fv
// is then gsum_ff(gn_b * (r2 - r1)) bit for bit; fv without `stable`, and
// dsum always, are plain block sums (the plain version's sum(-1) adds in
// another order). A block has at most 256 threads, so that a thread holds
// a pixel's temporaries in registers (up to 255) and not in local memory:
// a stamp's row (p = 1024) is the compensated sum's own plan, 256 columns
// of 4 values read in one chunk; a longer row keeps 256 columns of longer
// ones, read 4 values a chunk, which is the same tree, so the same bits.

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdio>

#include "ff_tree.cuh"
#include "reduce.cuh"

namespace {

using tpu_sgp::add;
using tpu_sgp::block_sum;
using tpu_sgp::ff_plan;
using tpu_sgp::ff_row_sum;
using tpu_sgp::sub;

constexpr int kThreadBits = 8;
constexpr int kThreads = 1 << kThreadBits;  // threads a block, at most
constexpr int kChunk = 2;                   // 4 values a chunk

// The operations that round, one by one, and the math functions ATen's
// log, exp and expm1 call for each type.
template <typename T>
struct Ops;

template <>
struct Ops<float> {
  static __device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
  static __device__ __forceinline__ float div(float a, float b) {
    return __fdiv_rn(a, b);
  }
  static __device__ __forceinline__ float log(float a) { return logf(a); }
  static __device__ __forceinline__ float exp(float a) { return expf(a); }
  static __device__ __forceinline__ float expm1(float a) {
    return expm1f(a);
  }
  static constexpr float kSmall = FLT_EPSILON / 512.0f;  // eps / 512
};

template <>
struct Ops<double> {
  static __device__ __forceinline__ double mul(double a, double b) {
    return __dmul_rn(a, b);
  }
  static __device__ __forceinline__ double div(double a, double b) {
    return __ddiv_rn(a, b);
  }
  static __device__ __forceinline__ double log(double a) { return ::log(a); }
  static __device__ __forceinline__ double exp(double a) { return ::exp(a); }
  static __device__ __forceinline__ double expm1(double a) {
    return ::expm1(a);
  }
  static constexpr double kSmall = DBL_EPSILON / 512.0;
};

// (m + 1) / (m + 2)!, the Taylor coefficient of s^m in E2(s), in double as
// divergence.py computes _E2_COEFFS; a coefficient enters the series in
// the compute type, as a Python float does an ATen operation.
__host__ __device__ constexpr double e2_coeff(int m) {
  double f = 1.0;
  for (int k = 2; k <= m + 2; ++k) f *= k;
  return (m + 1) / f;
}

// Horner's steps acc = acc * s + c_M, M down to 0.
template <int M, typename T>
__device__ __forceinline__ T e2_horner(T acc, T s) {
  if constexpr (M < 0) {
    return acc;
  } else {
    constexpr T c = static_cast<T>(e2_coeff(M));
    return e2_horner<M - 1>(add(Ops<T>::mul(acc, s), c), s);
  }
}

// E2(s) given em = expm1(s) (divergence.py _e2_from_expm1): the series
// where |s| < 0.25, else (s (em + 1) - em) / s^2.
template <typename T>
__device__ __forceinline__ T e2_from_expm1(T s, T em) {
  using O = Ops<T>;
  if (fabs(s) < T(0.25)) {
    constexpr T c10 = static_cast<T>(e2_coeff(10));
    return e2_horner<9>(c10, s);
  }
  return O::div(sub(O::mul(s, add(em, T(1))), em), O::mul(s, s));
}

// A row's beta and what follows from it alone: e = b - 1, and the
// singular switches |e|, |b| < eps/512 with the divisors they leave.
template <typename T>
struct Row {
  T b, e, safe_b, safe_e;
  bool b_sing, e_sing;

  __device__ __forceinline__ explicit Row(T beta) : b(beta) {
    e = sub(b, T(1));
    e_sing = fabs(e) < Ops<T>::kSmall;
    b_sing = fabs(b) < Ops<T>::kSmall;
    safe_e = e_sing ? T(1) : e;
    safe_b = b_sing ? T(1) : b;
  }
};

// One pixel: returns its term of fv, gn_b (r2 - r1), and sets dphi to its
// term of dsum.
template <typename T>
__device__ __forceinline__ T pixel(const Row<T>& r, T den, T gn, T lg,
                                   T& dphi) {
  using O = Ops<T>;
  const T d = O::log(O::div(den, gn));
  const T gn_b = O::exp(O::mul(r.b, lg));
  const T se = O::mul(r.e, d);
  const T em_e = O::expm1(se);
  const T r1 = r.e_sing ? d : O::div(em_e, r.safe_e);
  const T sb = O::mul(r.b, d);
  const T em_b = O::expm1(sb);
  const T r2 = r.b_sing ? d : O::div(em_b, r.safe_b);
  const T diff = sub(r2, r1);
  const T e2 = sub(e2_from_expm1(sb, em_b), e2_from_expm1(se, em_e));
  dphi = O::mul(gn_b, add(O::mul(lg, diff), O::mul(O::mul(d, d), e2)));
  return O::mul(gn_b, diff);
}

// Row blockIdx.x of den, gn and lg (= log gn), row r at den + r * ld_den
// and so on, with beta[r]: fv[r] (kStable: the compensated tree over the
// plan's cols columns of 2^levels, else a plain block sum) and dsum[r].
template <typename T, int kStable>
__global__ void __launch_bounds__(kThreads)
beta_div_kernel(const T* __restrict__ den, const T* __restrict__ gn,
                const T* __restrict__ lg, const T* __restrict__ beta,
                T* __restrict__ fv, T* __restrict__ dsum, long long ld_den,
                long long ld_gn, long long ld_lg, int n, int cols,
                int levels) {
  __shared__ T sh[kStable ? kThreads : 1];
  __shared__ T sl[kStable ? kThreads : 1];
  __shared__ T part[32];
  const Row<T> row(beta[blockIdx.x]);
  const T* dr = den + blockIdx.x * ld_den;
  const T* gr = gn + blockIdx.x * ld_gn;
  const T* lr = lg + blockIdx.x * ld_lg;
  T dacc = T(0);
  const auto term = [&](long long i) {
    T dphi;
    const T f = pixel(row, dr[i], gr[i], lr[i], dphi);
    dacc = add(dacc, dphi);
    return f;
  };
  T f;
  if constexpr (kStable) {
    f = ff_row_sum<kThreadBits, kChunk>(term, n, cols, levels, sh, sl);
  } else {
    T facc = T(0);
    for (long long i = threadIdx.x; i < n; i += blockDim.x)
      facc = add(facc, term(i));
    f = block_sum(facc, part);
  }
  const T ds = block_sum(dacc, part);
  if (threadIdx.x == 0) {
    fv[blockIdx.x] = f;
    dsum[blockIdx.x] = ds;
  }
}

template <typename T>
int launch(const void* den, const void* gn, const void* lg,
           const void* beta, void* fv, void* dsum, int rows, int n,
           long long ld_den, long long ld_gn, long long ld_lg, int stable,
           int device, void* stream) {
  int cols = 0, levels = 0;
  if (rows <= 0 || !ff_plan(n, kThreadBits, &cols, &levels))
    return static_cast<int>(cudaErrorInvalidValue);
  int previous = 0;
  cudaError_t err = cudaGetDevice(&previous);
  if (err == cudaSuccess && previous != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = cols < 32 ? 32 : cols;
  auto kernel = stable ? beta_div_kernel<T, 1> : beta_div_kernel<T, 0>;
  kernel<<<rows, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(den), static_cast<const T*>(gn),
      static_cast<const T*>(lg), static_cast<const T*>(beta),
      static_cast<T*>(fv), static_cast<T*>(dsum), ld_den, ld_gn, ld_lg, n,
      cols, levels);
  err = cudaGetLastError();
  if (previous != device) cudaSetDevice(previous);
  return static_cast<int>(err);
}

}  // namespace

// Plain C entry points, loaded with ctypes. den, gn and lg are device
// pointers to rows rows of n values, row r at den + r * ld_den (and so
// on), unit stride within a row; beta, fv and dsum (rows,); stable
// nonzero for fv's compensated tree; stream a cudaStream_t. Returns the
// launch's cudaError_t (0 on success; cudaErrorInvalidValue, 1, for rows
// or n below 1).
extern "C" int tpu_sgp_beta_div_f32(const void* den, const void* gn,
                                    const void* lg, const void* beta,
                                    void* fv, void* dsum, int rows, int n,
                                    long long ld_den, long long ld_gn,
                                    long long ld_lg, int stable, int device,
                                    void* stream) {
  return launch<float>(den, gn, lg, beta, fv, dsum, rows, n, ld_den, ld_gn,
                       ld_lg, stable, device, stream);
}

extern "C" int tpu_sgp_beta_div_f64(const void* den, const void* gn,
                                    const void* lg, const void* beta,
                                    void* fv, void* dsum, int rows, int n,
                                    long long ld_den, long long ld_gn,
                                    long long ld_lg, int stable, int device,
                                    void* stream) {
  return launch<double>(den, gn, lg, beta, fv, dsum, rows, n, ld_den, ld_gn,
                        ld_lg, stable, device, stream);
}

// The plan of a row of n values, in either type: its columns (threads of
// the row's block that hold values), levels a column, and values a chunk
// (2^chunk). Returns cudaErrorInvalidValue for n < 1.
extern "C" int tpu_sgp_beta_div_plan(int n, int* cols, int* levels,
                                     int* chunk) {
  if (!ff_plan(n, kThreadBits, cols, levels))
    return static_cast<int>(cudaErrorInvalidValue);
  *chunk = kChunk;
  return 0;
}

// Instantiation i (0: float32 stable, 1: float32, 2: float64 stable, 3:
// float64): its name, n = 0 (any), and its resident blocks an SM at
// kThreads threads. Returns -1 past the last, else the cudaError_t.
extern "C" int tpu_sgp_beta_divergence_occupancy(int i, int device,
                                                 char* name, int len, int* n,
                                                 int* blocks) {
  if (i < 0 || i > 3) return -1;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  *n = 0;
  const int stable = i % 2 == 0;
  snprintf(name, len, "beta_div_kernel<%c,%d>", i < 2 ? 'f' : 'd', stable);
  const void* kernel =
      i == 0   ? reinterpret_cast<const void*>(beta_div_kernel<float, 1>)
      : i == 1 ? reinterpret_cast<const void*>(beta_div_kernel<float, 0>)
      : i == 2 ? reinterpret_cast<const void*>(beta_div_kernel<double, 1>)
               : reinterpret_cast<const void*>(beta_div_kernel<double, 0>);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, kThreads, 0));
}
