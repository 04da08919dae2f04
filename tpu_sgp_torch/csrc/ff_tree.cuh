// The compensated (float-float) pairwise tree of a row, as one block's
// fold: shared by the compensated row sum (compensated_sum.cu) and the
// beta objective (beta_divergence.cu), which folds the values it computes
// into the same tree. The tree and why a block folds it this way are set
// out at the head of compensated_sum.cu.
//
// After k levels slot j holds the tree over the strided column
// {j + m p / 2^k : m < 2^k}, so any power-of-two count of columns, and any
// count of values a thread reads at once, gives the same operations on
// the same operands: the tree's bits (tests/test_torch_compensated_sum.py
// checks every such plan on the CPU).
#pragma once

#include <cuda_runtime.h>

namespace tpu_sgp {

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

// The compensated tree sum of a row of n values, value i being value(i),
// in a block of at most 2^kBits threads whose threads t < cols each hold a
// column of 2^levels values (threads at and above cols, in a block of 32
// for a row of fewer slots, hold +0). A column's tree pairs m with
// m + 2^(levels-1) first; read in bit-reversed order of m that is a tree
// of neighbours, which a thread folds as it reads: chunk g of the column
// is its 2^kC values {rev(g) + s 2^(levels-kC)}, asked for at once
// (neighbouring threads, neighbouring indices) and reduced in registers;
// the chunks' results are folded in order on a stack (a binary counter:
// chunk g merges as many times as g ends in ones). The block's columns
// then run the last log2(cols) levels in sh and sl (blockDim.x values
// each). value is asked once for each index below n, by the thread of its
// column; thread 0 returns hi + lo of slot 0, the others what no caller
// reads.
template <int kBits, int kC, typename T, typename Value>
__device__ __forceinline__ T ff_row_sum(Value&& value, int n, int cols,
                                        int levels, T* sh, T* sl) {
  const int t = threadIdx.x;
  const int cl = levels < kC ? levels : kC;  // levels a chunk
  const int sl_bits = levels - cl;           // log2 of the chunks
  const long long stride = static_cast<long long>(cols) << sl_bits;

  T vh = T(0), vl = T(0);
  // a row of up to 2^31 slots has columns of at most 2^(31 - kBits)
  // values, so at most 2^(31 - kBits - kC) chunks
  T st_h[31 - kBits], st_l[31 - kBits];
  for (unsigned int g = 0; g < (1u << sl_bits); ++g) {
    // chunk g: column values rev(g) + s 2^sl_bits, s < 2^cl
    const unsigned int m0 = sl_bits ? __brev(g) >> (32 - sl_bits) : 0u;
    const long long i0 = t + static_cast<long long>(m0) * cols;
    T h[1 << kC], l[1 << kC];
#pragma unroll
    for (int s = 0; s < (1 << kC); ++s) {
      const long long i = i0 + s * stride;
      h[s] = (s < (1 << cl) && t < cols && i < n) ? value(i) : T(0);
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
  return add(vh, vl);
}

// The plan of a row of n values in a block of at most 2^thread_bits
// threads: cols columns of 2^levels, cols << levels = p the power of two
// that the tree pads n to, cols = p / 4 within [1, 2^thread_bits].
inline bool ff_plan(int n, int thread_bits, int* cols, int* levels) {
  if (n <= 0) return false;
  int bits = 0;
  while ((1LL << bits) < n) ++bits;
  const int cb = bits < 2 ? 0 : bits - 2 < thread_bits ? bits - 2
                                                        : thread_bits;
  *cols = 1 << cb;
  *levels = bits - cb;
  return true;
}

}  // namespace tpu_sgp
