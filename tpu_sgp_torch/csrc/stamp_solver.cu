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
// with kf[a][b] = k[H-1-a][W-1-b] the taps flipped. The reference pins
// Precision.HIGHEST, so every design keeps float32 (float64) accuracy.
//
// What bounds it on this card: the operator. A lane makes 3 + 2 * iters
// applications of N^2 multiply-adds (about 0.92 M at 31 x 31), so the
// batch is compute-bound by its FLOP count; its bytes (the stamps in, x
// out) are negligible. On the FP32 pipes the operator took 72 % of the
// kernel's time at 55 % of their peak (PERF.md), so float32 runs it on the
// tensor cores (TcPatch) and float64 on the FP64 pipes (Patch).
//
// float32, on the tensor cores (TcPatch). For tap row a, AT is one matrix
// product Y_a = (S_a X) T_a: S_a X is the stamp with its rows shifted
// cyclically by a, T_a[c][j] = k[a][(c - j) mod W] the circulant of the
// tap row; A is the same with the flipped taps, one more row of shift and
// T_a[c][j] = kf[a][(c - j - 1) mod W]. Summed over a, an application is
// one GEMM of M = H, N = W, K = H * W, padded to M = 16 * ceil(H / 16)
// output rows and P = 16 * ceil(W / 16) output and reduction columns (32 x
// 32 x 992 at 31 x 31: 1.016 M multiply-adds against the dense operator's
// 0.924 M). Each warp owns a 16 x 16 output tile, two m16n8k8 TF32
// fragments, and the solver's per-pixel state lives in their accumulator
// layout (8 pixels a thread). The A operand is the input staged in shared
// memory with its rows doubled (row u holds X[u mod H], columns W..P-1
// zero), so a shift is an offset. T_a depends on c - j only, so a tap
// row's B fragments come from one widened row of 2P taps, e = c - j in
// [-P+1, P-1], and consecutive k-steps share one: a tap row takes P / 8 +
// 1 B fragments for 2 P / 8 fragment products. Accuracy: HIGHEST is a multi-pass
// split product on the TPU's matrix unit, and here it is the three-pass
// TF32 split, v = hi + lo with hi = tf32(v), lo = tf32(v - hi), rounded to
// nearest, and hi*hi + hi*lo + lo*hi: each TF32 product is exact in
// float32 and only lo*lo (2^-22 of the product) is dropped. The taps are
// split once, the input as it is staged, into hi and lo arrays: fewer
// instructions a product than splitting each fragment as it is loaded.
// A's widened taps are AT's read backwards (kf[a][(e-1) mod W] = k[H-1-
// a][-e mod W]), so one table serves both. Every shared load is 4 bytes:
// pairing a lane's two values of a row into one 8-byte load measured
// slower (kernel_variants.py). Each k-step's three products start from
// zero and are added to the float32 accumulator with a rounded add, so no
// long run of sums stays inside the tensor core's own adder.
//
// float64, on the FP64 pipes (Patch): one correlation over the input
// doubled in rows and columns (every index taken mod H, W) in shared
// memory, so no index needs a `mod`; full-precision FMAs.
//
// Routes. The design is a template argument of both kernels, and the
// float32 library carries both: the wrapper's plan (kernels/
// stamp_solver.py:stamp_solver_plan) picks one from the stamp's shape
// before the launch, TcPatch, else Patch<float> on the FP32 pipes, each on
// the stamp or else on its transpose (a circular convolution commutes with
// transposing the image and the taps, and every sum of the solve runs over
// all pixels), whichever block fits 1024 threads and the card's shared
// memory first; float64 has Patch alone, in either orientation. The
// entries check the block again and return an error rather than launch one
// that cannot run.
//
// What Patch does about the FLOP count:
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
//
// Both designs:
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

// Round a float32 to TF32 (10 explicit mantissa bits), to nearest with
// ties away from zero: cvt.rna.tf32.f32 for every finite value, in two
// integer instructions.
__device__ __forceinline__ unsigned tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// d += a * b on the tensor cores: one m16n8k8 TF32 product, float32 sums.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The float32 block's shape and shared-memory layout for an h x w stamp:
// one warp a 16 x 16 output tile of the padded m x p stamp.
struct TcLayout {
  int h, w;
  int m;       // output rows padded to 16
  int pitch;   // output and reduction columns padded to 16 (p)
  int tiles;   // 16 x 16 tiles a row of tiles: p / 16
  int stride;  // row stride of the staged input: p + 4, so that the 8 rows
               // of a fragment start 4 banks apart
  int taplen;  // a widened tap row: 2 * p (index e + p - 1, e = c - j)

  __host__ __device__ explicit TcLayout(int h_, int w_)
      : h(h_), w(w_), m((h_ + 15) / 16 * 16), pitch((w_ + 15) / 16 * 16),
        tiles(pitch / 16), stride(pitch + 4), taplen(2 * pitch) {}

  __host__ __device__ int threads() const { return 32 * (m / 16) * tiles; }
  // the widened tap table (h rows), then the input doubled in rows (2h
  // rows), each as a hi and a lo array
  __host__ __device__ size_t elems() const {
    return static_cast<size_t>(2) * h * taplen +
           static_cast<size_t>(4) * h * stride;
  }
};

// A thread's 8 pixels of a stamp on the tensor cores and the float32
// operator on them. Lane (g, t) = (lane / 4, lane % 4) of the warp of tile
// (mi, ni) holds the m16n8k8 accumulators of the tile's two 16 x 8
// fragments: pixel k = 4 * f + r is (16 mi + g + 8 (r / 2), 16 ni + 8 f +
// 2 t + r % 2); ok[k] marks those inside the stamp. PITCH is p when known
// at compile time (32: stamps 17 to 32 wide, the main path's 31 among
// them), which unrolls a tap row's k-steps; 0 reads it from the layout.
template <int PITCH>
struct TcPatch {
  TcLayout L;
  // AT's widened taps, T[a][e + p - 1] = k[a][e mod w], hi then lo; A's
  // are the same read backwards: kf[a][(e - 1) mod w] = T[h-1-a][-e + p-1]
  const float* tap;
  float* xs;          // (2h, stride): row u holds X[u mod h], zero past w;
                      // hi, then lo at lo_x
  int lo_t, lo_x;     // offsets of the lo arrays
  int base, sbase;    // offset of pixel 0 in the stamp and in xs
  int arow0, arow1;   // xs offsets of this lane's fragment rows g and g + 8
  int boff;           // widened tap index of this lane's B element, k-step 0
  bool ok[kPix];

  __device__ TcPatch(unsigned char* smem, const float* taps,
                     const TcLayout& lay, int tid)
      : L(lay) {
    float* tab = reinterpret_cast<float*>(smem);
    const int p = L.pitch;
    lo_t = L.h * L.taplen;
    lo_x = 2 * L.h * L.stride;
    tap = tab;
    xs = tab + 2 * lo_t;
    for (int i = tid; i < lo_t; i += blockDim.x) {
      const int a = i / L.taplen, e = i - a * L.taplen - (p - 1);  // c - j
      const float v = taps[a * L.w + ((e % L.w) + L.w) % L.w];
      const float hi = __uint_as_float(tf32_rna(v));
      tab[i] = hi;
      tab[lo_t + i] = __uint_as_float(tf32_rna(v - hi));
    }
    // the reduction's columns past the stamp read zeros (staging never
    // writes them, so no barrier is needed before the first apply)
    const int pad = p - L.w;
    for (int i = tid; i < 2 * L.h * pad; i += blockDim.x) {
      const int u = i / pad, o = u * L.stride + L.w + (i - u * pad);
      xs[o] = 0.f;
      xs[lo_x + o] = 0.f;
    }
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int mi = warp / L.tiles, ni = warp - mi * L.tiles;
    const int row = 16 * mi + g, col = 16 * ni + 2 * t;
    base = row * L.w + col;
    sbase = row * L.stride + col;
    // padded output rows read a real row (their outputs are dropped)
    arow0 = (row % L.h) * L.stride + t;
    arow1 = ((row + 8) % L.h) * L.stride + t;
    boff = p - 1 + t - g - 16 * ni;
#pragma unroll
    for (int k = 0; k < kPix; ++k)
      ok[k] = row + 8 * ((k >> 1) & 1) < L.h &&
              col + 8 * (k >> 2) + (k & 1) < L.w;
  }

  // offset of pixel k in the row-major stamp
  __device__ __forceinline__ int index(int k) const {
    return base + 8 * ((k >> 1) & 1) * L.w + 8 * (k >> 2) + (k & 1);
  }

  // acc[f .. f + 3] += one k-step of a fragment, a * b with b = (b hi,
  // b hi, b lo, b lo) for its two rows: lo*hi, hi*lo, then hi*hi from
  // zero, added to the accumulators with float32 adds
  __device__ __forceinline__ static void step(float (&acc)[kPix], int f,
                                              const unsigned (&ah)[4],
                                              const unsigned (&al)[4],
                                              const unsigned (&b)[4]) {
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    mma_tf32(d, al, b[0], b[1]);
    mma_tf32(d, ah, b[2], b[3]);
    mma_tf32(d, ah, b[0], b[1]);
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[f + r] += d[r];
  }

  // the B fragment whose first row's taps lie at t[0] and its second's at
  // t[four] (4 along the table for AT, -4 for A), as (hi, hi, lo, lo)
  __device__ __forceinline__ void b_frag(const float* t, int four,
                                         unsigned (&b)[4]) const {
    b[0] = __float_as_uint(t[0]);
    b[1] = __float_as_uint(t[four]);
    b[2] = __float_as_uint(t[lo_t]);
    b[3] = __float_as_uint(t[lo_t + four]);
  }

  // out = A(v) (transpose false) or AT(v) (transpose true) at this
  // thread's pixels. The input is split and staged in xs behind one
  // barrier; sync_first adds one before, where no barrier separates this
  // call from the last call's reads of xs.
  __device__ void apply(bool transpose, const float (&v)[kPix],
                        float (&out)[kPix], bool sync_first) {
    const int p = PITCH ? PITCH : L.pitch;
    if (sync_first) __syncthreads();
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      if (!ok[k]) continue;
      const int o = sbase + 8 * ((k >> 1) & 1) * L.stride + 8 * (k >> 2) +
                    (k & 1);
      const float hi = __uint_as_float(tf32_rna(v[k]));
      const float lo = __uint_as_float(tf32_rna(v[k] - hi));
      xs[o] = hi;
      xs[o + L.h * L.stride] = hi;
      xs[lo_x + o] = lo;
      xs[lo_x + o + L.h * L.stride] = lo;
    }
    __syncthreads();
    float acc[kPix];
#pragma unroll
    for (int k = 0; k < kPix; ++k) acc[k] = 0.f;
    // A reads its rows one further down than AT, and its taps backwards
    const int shift = transpose ? 0 : L.stride;
    const int dir = transpose ? 1 : -1;
    for (int a = 0; a < L.h; ++a) {
      const float* r0 = xs + arow0 + shift + a * L.stride;
      const float* r1 = xs + arow1 + shift + a * L.stride;
      const float* tb = transpose ? tap + a * L.taplen + boff
                                  : tap + (L.h - 1 - a) * L.taplen +
                                        (2 * p - 2 - boff);
      // B of the k-step before the first, for the second fragment
      unsigned prev[4];
      b_frag(tb - 8 * dir, 4 * dir, prev);
#pragma unroll
      for (int c0 = 0; c0 < p; c0 += 8) {
        const unsigned ah[4] = {
            __float_as_uint(r0[c0]), __float_as_uint(r1[c0]),
            __float_as_uint(r0[c0 + 4]), __float_as_uint(r1[c0 + 4])};
        const unsigned al[4] = {__float_as_uint(r0[lo_x + c0]),
                                __float_as_uint(r1[lo_x + c0]),
                                __float_as_uint(r0[lo_x + c0 + 4]),
                                __float_as_uint(r1[lo_x + c0 + 4])};
        unsigned cur[4];
        b_frag(tb + dir * c0, 4 * dir, cur);
        // fragment f of the tile takes B at c - j = c0 - 8 f: cur, prev
        step(acc, 0, ah, al, cur);
        step(acc, 4, ah, al, prev);
#pragma unroll
        for (int q = 0; q < 4; ++q) prev[q] = cur[q];
      }
    }
#pragma unroll
    for (int k = 0; k < kPix; ++k) out[k] = acc[k];
  }
};

// The operator designs, the last template argument of both kernels (and of
// their names in ptxas's report): float32 takes either, float64 Patch.
constexpr int kPipes = 0;        // Patch, on the FP32 or FP64 pipes
constexpr int kTensorCores = 1;  // TcPatch, float32 on the tensor cores

template <typename T, int DESIGN>
struct Design {
  static_assert(DESIGN == kPipes, "float64 has the FP64-pipe design only");
  using Shape = Layout;
  template <int PITCH>
  using Op = Patch<T, PITCH>;
};
template <>
struct Design<float, kTensorCores> {
  using Shape = TcLayout;
  template <int PITCH>
  using Op = TcPatch<PITCH>;
};

// the solver's static shared memory: BlockReduce's red[2][kMaxVals][kMaxWarps]
template <typename T>
constexpr size_t kStaticSmem = sizeof(T) * 2 * kMaxVals * kMaxWarps;

// At the main path's 128 threads a float32 block is held to 128 registers,
// so 4 blocks share an SM: 37.0 ms against 48.6 ms for 2 blocks at 193
// registers, at the main path's shape on an H100 (kernel_variants.py).
template <typename T, int MAXT, int PITCH, int DESIGN>
__global__ void __launch_bounds__(MAXT,
                                  sizeof(T) == 4 && MAXT == 128 ? 4 : 1)
solve_stamps_kernel(const T* __restrict__ gn_in, const T* __restrict__ bkg_in,
                    const T* __restrict__ flux_in,
                    const T* __restrict__ sat_in,
                    const T* __restrict__ taps, T* __restrict__ x_out,
                    int* __restrict__ it_out, const SolveParams prm) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T red[2][kMaxVals][kMaxWarps];
  static_assert(sizeof(red) == kStaticSmem<T>, "kStaticSmem");

  const int tid = threadIdx.x;
  BlockReduce<T, MAXT> blk{red, tid & 31, tid >> 5,
                           static_cast<int>(blockDim.x) >> 5, 0};
  const size_t off = static_cast<size_t>(blockIdx.x) * prm.n;
  const T eps = sizeof(T) == 4 ? T(1.1920928955078125e-07)
                               : T(2.220446049250313e-16);
  const T inf = T(CUDART_INF);

  using D = Design<T, DESIGN>;
  typename D::template Op<PITCH> op(smem, taps,
                                    typename D::Shape(prm.h, prm.w), tid);
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
template <typename T, int MAXT, int PITCH, int DESIGN>
__global__ void __launch_bounds__(MAXT)
apply_operator_kernel(const T* __restrict__ x_in, const T* __restrict__ taps,
                      T* __restrict__ out, int h, int w, int reps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t off = static_cast<size_t>(blockIdx.x) * h * w;
  using D = Design<T, DESIGN>;
  typename D::template Op<PITCH> op(smem, taps, typename D::Shape(h, w),
                                    threadIdx.x);
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

// Call f(lay, MAXT, PITCH, DESIGN) with the solver's instantiation for an
// h x w stamp under DESIGN: its layout, its launch bound, and the layout's
// pitch where a block of 128 threads has it fixed at 32. An error, and no
// call, where the block cannot run: more than 1024 threads, or more
// dynamic shared memory than the card gives a block beside the solver's
// static buffer. The wrapper's plan makes the same checks before it calls
// an entry; by_design also refuses a design the element type lacks.
template <typename T, int DESIGN, class F>
int by_shape(int h, int w, int device, F&& f) {
  using std::integral_constant;
  const typename Design<T, DESIGN>::Shape lay(h, w);
  int limit = 0;
  const cudaError_t e = cudaDeviceGetAttribute(
      &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (lay.elems() * sizeof(T) + kStaticSmem<T> > static_cast<size_t>(limit))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr integral_constant<int, DESIGN> design{};
  const int threads = lay.threads();
  if (threads <= 128 && lay.pitch == 32)
    return f(lay, integral_constant<int, 128>{}, integral_constant<int, 32>{},
             design);
  if (threads <= 128)
    return f(lay, integral_constant<int, 128>{}, integral_constant<int, 0>{},
             design);
  if (threads <= 256)
    return f(lay, integral_constant<int, 256>{}, integral_constant<int, 0>{},
             design);
  if (threads <= 512)
    return f(lay, integral_constant<int, 512>{}, integral_constant<int, 0>{},
             design);
  if (threads <= 1024)
    return f(lay, integral_constant<int, 1024>{},
             integral_constant<int, 0>{}, design);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, class F>
int by_design(int design, int h, int w, int device, F&& f) {
  if (design == kPipes) return by_shape<T, kPipes>(h, w, device, f);
  if constexpr (std::is_same_v<T, float>) {
    if (design == kTensorCores)
      return by_shape<T, kTensorCores>(h, w, device, f);
  }
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
           const SolveParams* prm, int design, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = prm->n;
  if (n <= 0 || n > 4096 || prm->h * prm->w != n)
    return static_cast<int>(cudaErrorInvalidValue);
  return by_design<T>(design, prm->h, prm->w, device,
                      [&](const auto& lay, auto maxt, auto pitch, auto dsg) {
    const auto kernel =
        solve_stamps_kernel<T, decltype(maxt)::value, decltype(pitch)::value,
                            decltype(dsg)::value>;
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
                    int h, int w, int reps, int design, int* resident,
                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (h <= 0 || w <= 0 || h * w > 4096 || reps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return by_design<T>(design, h, w, device,
                      [&](const auto& lay, auto maxt, auto pitch, auto dsg) {
    constexpr int kMaxt = decltype(maxt)::value;
    constexpr int kPitch = decltype(pitch)::value;
    constexpr int kDesign = decltype(dsg)::value;
    const auto solver = solve_stamps_kernel<T, kMaxt, kPitch, kDesign>;
    const auto kernel = apply_operator_kernel<T, kMaxt, kPitch, kDesign>;
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

// The solver's block for an h x w stamp under `design`: its threads, its
// dynamic shared bytes, its resident blocks an SM, and its instantiation's
// name as chip_smoke.py prints ptxas's report.
template <typename T>
int route(int design, int h, int w, int device, int* threads, int* smem,
          int* blocks, char* name, int len) {
  return by_design<T>(design, h, w, device,
                      [&](const auto& lay, auto maxt, auto pitch, auto dsg) {
    constexpr int kMaxt = decltype(maxt)::value;
    constexpr int kPitch = decltype(pitch)::value;
    constexpr int kDesign = decltype(dsg)::value;
    const auto kernel = solve_stamps_kernel<T, kMaxt, kPitch, kDesign>;
    const size_t bytes = lay.elems() * sizeof(T);
    const cudaError_t err = allow_smem(kernel, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    *threads = lay.threads();
    *smem = static_cast<int>(bytes);
    snprintf(name, len, "solve_stamps_kernel<%c,%d,%d,%d>",
             sizeof(T) == 4 ? 'f' : 'd', kMaxt, kPitch, kDesign);
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kernel, lay.threads(), bytes));
  });
}

}  // namespace

// Plain C entry points, loaded with ctypes. Pointers are device pointers of
// contiguous (rows, n) gn, bkg and x, (rows,) flux, sat and int32 iters,
// and the (h, w) taps; prm is a host pointer; design is kPipes or
// kTensorCores (float32 only), as the wrapper's plan picked it; stream is
// a cudaStream_t. Returns the launch's cudaError_t (0 on success), or
// cudaErrorInvalidValue, with nothing launched, for a block that cannot run.
extern "C" int tpu_sgp_solve_stamps_f32(const void* gn, const void* bkg,
                                        const void* flux, const void* sat,
                                        const void* taps, void* x,
                                        void* iters, int rows,
                                        const SolveParams* prm, int design,
                                        int device, void* stream) {
  return launch<float>(gn, bkg, flux, sat, taps, x, iters, rows, prm, design,
                       device, stream);
}

extern "C" int tpu_sgp_solve_stamps_f64(const void* gn, const void* bkg,
                                        const void* flux, const void* sat,
                                        const void* taps, void* x,
                                        void* iters, int rows,
                                        const SolveParams* prm, int design,
                                        int device, void* stream) {
  return launch<double>(gn, bkg, flux, sat, taps, x, iters, rows, prm,
                        design, device, stream);
}

// The operator alone: out = (AT A)^reps x for each row of a contiguous
// (rows, h * w) x, with the (h, w) taps, under `design`, at the solver's
// residency (its blocks an SM written to *resident, a host pointer).
// Returns the launch's cudaError_t.
extern "C" int tpu_sgp_apply_operator_f32(const void* x, const void* taps,
                                          void* out, int rows, int h, int w,
                                          int reps, int design, int* resident,
                                          int device, void* stream) {
  return launch_operator<float>(x, taps, out, rows, h, w, reps, design,
                                resident, device, stream);
}

extern "C" int tpu_sgp_apply_operator_f64(const void* x, const void* taps,
                                          void* out, int rows, int h, int w,
                                          int reps, int design, int* resident,
                                          int device, void* stream) {
  return launch_operator<double>(x, taps, out, rows, h, w, reps, design,
                                 resident, device, stream);
}

// The solver's block for an h x w stamp (f64: float64, else float32) under
// `design`: threads, dynamic shared bytes and resident blocks an SM (host
// pointers) and the instantiation's name. Returns the cudaError_t, or
// cudaErrorInvalidValue where the block cannot run.
extern "C" int tpu_sgp_stamp_solver_route(int f64, int design, int h, int w,
                                          int device, int* threads, int* smem,
                                          int* blocks, char* name, int len) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return f64 ? route<double>(design, h, w, device, threads, smem, blocks,
                             name, len)
             : route<float>(design, h, w, device, threads, smem, blocks,
                            name, len);
}

// Instantiation i of the solver (float32 TcPatch, float32 Patch, float64
// Patch, each at a stamp that takes it: 31x31, 16x16, 40x40, 64x64,
// 63x65): its name, the n, and its resident blocks an SM. Returns -1 past
// the last instantiation, else the cudaError_t.
extern "C" int tpu_sgp_stamp_solver_occupancy(int i, int device, char* name,
                                              int len, int* n, int* blocks) {
  static const int kShapes[][2] = {
      {31, 31}, {16, 16}, {40, 40}, {64, 64}, {63, 65}};
  static const int kKinds[][2] = {  // {f64, design}
      {0, kTensorCores}, {0, kPipes}, {1, kPipes}};
  constexpr int kCount = sizeof(kShapes) / sizeof(kShapes[0]);
  if (i < 0 || i >= 3 * kCount) return -1;
  const int h = kShapes[i % kCount][0], w = kShapes[i % kCount][1];
  const int* kind = kKinds[i / kCount];
  int threads = 0, smem = 0;
  *n = h * w;
  return tpu_sgp_stamp_solver_route(kind[0], kind[1], h, w, device, &threads,
                                    &smem, blocks, name, len);
}
