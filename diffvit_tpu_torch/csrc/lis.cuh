// Log-Int-Softmax over score rows, shared by the attention kernels so
// that they cannot drift apart: lis_row_quad over two rows held by the
// four lanes of a quad in the mma accumulator layout (attention_mma.cuh:
// K1, K5, K6, K7a, K8, K4/K4b and probe P1's consumer), built from two
// steps, lis_exp (the integer exponential of one score) and lis_shift (the
// log2 code of one weight), which attention_mma.cuh's exponential table
// also calls.
// The device form of _lis_body (diffvit_tpu/ops/pallas/attention.py:51)
// and of its plain PyTorch specification, lis_body_plain
// (ops/kernels/attention.py).
//
// Exactness against the plain version:
//  * 2^(32-q) is ldexpf (exact); floor(log2 y) is y's exponent field
//    (exact: y is a normal float of at least 4/3 wherever it is below
//    2^16, since exp_sum >= e);
//  * the row sum of the integer exponentials is exact, rounded once to
//    float, so it does not depend on the summation order, nor does the row
//    max: any split of a row over lanes agrees bit for bit.  It is an int64
//    sum where lis_sum_fits bounds the total below 2^63, and elsewhere
//    (LisConsts::wide) the 128-bit sum of wide_add / wide_to_float: each
//    exponential (an integer float below 2^68 for s_a >= 2^-17) split at
//    2^32 into two exact int64 limbs, each limb summed, the total rounded
//    once to float (lis_body_plain's wide_row_sum, step for step);
//  * the weight 2^-code is kept as the integer 2^(15-code), or as its
//    shift 15-code.
// Float constants are written as (float)(double expression), the rounding
// the JAX reference applies to its weakly typed Python constants.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace dvt {

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The `lis` argument of the C entries: 0 the float softmax, 1 the LIS, and
// kLisWide the LIS with the 128-bit row sum.
constexpr int kLisWide = 2;

// The integer-exponential constants of one softmax scale s_a; `wide`: the
// row sum takes the 128-bit form (the int64 one could overflow).
struct LisConsts {
  float x0_int, b_int, c_int, x_lo, nudge;
  bool wide;
};

__device__ __forceinline__ LisConsts lis_consts(float s_a, bool wide = false) {
  LisConsts k;
  k.wide = wide;
  k.x0_int = floorf((float)(-0.6931) / s_a);
  k.b_int = floorf((float)(0.96963238 / 0.35815147) / s_a);
  k.c_int = floorf((float)(1.0 / 0.35815147) / (s_a * s_a));
  k.x_lo = 32.f * k.x0_int;
  k.nudge = (float)(4.0 / 3.0 * (1.0 + 0x1p-17));
  return k;
}

// The integer exponential (n = 32) of the score a in a row whose maximum
// is row_max.  `fast` drops the floor/max that is a no-op for s_a in
// [2^-10, ln 2] (lis_fast_ok).
__device__ __forceinline__ float lis_exp(float a, float row_max, const LisConsts& k,
                                         bool fast) {
  const float x = fmaxf(a - row_max, k.x_lo);
  const float q = floorf(x / k.x0_int);
  const float r = x - k.x0_int * q;
  const float poly = r * (r + k.b_int) + k.c_int;
  float ev = poly * ldexpf(1.f, 32 - static_cast<int>(q));
  if (!fast) ev = fmaxf(floorf(ev), 0.f);
  return ev;
}

// The 128-bit row sum: adds the exponential e (a non-negative integer float)
// as two exact int64 limbs, hi = floor(e / 2^32) and lo = e - hi * 2^32 (both
// representable: lo is a multiple of e's ulp below 2^32).
__device__ __forceinline__ void wide_add(long long& hi, long long& lo, float e) {
  const float h = floorf(e * 0x1p-32f);
  hi += static_cast<long long>(h);
  lo += static_cast<long long>(e - h * 0x1p32f);
}

// The limb sums hi * 2^32 + lo rounded once to float (round to nearest
// even): the carry of lo moves into hi; below 2^63 the total is an int64;
// above, its bits below 2^16 fold into one sticky bit, which lies under the
// rounding position of a total of at least 2^63 and so rounds as they do.
__device__ __forceinline__ float wide_to_float(long long hi, long long lo) {
  hi += lo >> 32;
  lo &= 0xffffffffll;
  if (hi < (1ll << 31)) return __ll2float_rn((hi << 32) | lo);
  const long long v = (hi << 16) | (lo >> 16) | ((lo & 0xffff) != 0);
  return ldexpf(__ll2float_rn(v), 16);
}

// The shift 15 - code of the weight 2^-code of the exponential e in a row
// whose exponentials sum to exp_sum, or kLisZero where the log2 code
// saturates (the weight is 0).
constexpr int kLisZero = 16;

__device__ __forceinline__ int lis_shift(float exp_sum, float e, const LisConsts& k) {
  const float y = rintf(exp_sum / e) * k.nudge;
  return (y < 65536.f) ? 15 - ((__float_as_int(y) >> 23) - 127) : kLisZero;
}

// The quad form: the four lanes of a quad (lanes 4g .. 4g+3, t = lane % 4)
// hold two rows r = 0, 1 of a score tile in the mma accumulator layout,
// N scores a row each.  scores.get(r, u) is the score of slot u of row r,
// scores.key(u, t) its key; keys at or past n_keys are masked.  exp.e(a,
// row_max) and exp.ei(a, row_max) are lis_exp's value of a score and its
// int64 (attention_mma.cuh's ExpTable reads both from a table that
// lis_exp filled).  Calls put(r, u, shift) with lis_shift's value
// (kLisZero for a masked key).  The row max and the row sum (int64, or
// k.wide's two limbs, split from exp.e) reduce over shfl_xor 1 and 2;
// every lane of the warp must call it.  The two
// rows go through each step together, two independent chains;
// Scores::kUnroll words of four slots a loop step.  The
// exponentials are looked up twice (for the sum, then for the weights)
// rather than held: N floats a row would double the registers of a
// 256-key row.
template <int N, class Scores, class Exp, class Put>
__device__ __forceinline__ void lis_row_quad(const Scores& scores, int n_keys,
                                             const LisConsts& k, const Exp& exp, int t,
                                             const Put& put) {
  // slots in words of four: Scores::kUnroll words a step (all of them for
  // scores in registers, which need constant indices)
  float row_max[2] = {-INFINITY, -INFINITY};
#pragma unroll(Scores::kUnroll)
  for (int p = 0; p < N / 4; ++p)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (scores.key(4 * p + i, t) < n_keys)
#pragma unroll
        for (int r = 0; r < 2; ++r) row_max[r] = fmaxf(row_max[r], scores.get(r, 4 * p + i));
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row_max[r] = fmaxf(row_max[r], __shfl_xor_sync(0xffffffffu, row_max[r], 1));
    row_max[r] = fmaxf(row_max[r], __shfl_xor_sync(0xffffffffu, row_max[r], 2));
  }
  float exp_sum[2];
  if (k.wide) {
    long long hi[2] = {0, 0}, lo[2] = {0, 0};
#pragma unroll(Scores::kUnroll)
    for (int p = 0; p < N / 4; ++p)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (scores.key(4 * p + i, t) < n_keys)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            wide_add(hi[r], lo[r], exp.e(scores.get(r, 4 * p + i), row_max[r]));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        hi[r] += __shfl_xor_sync(0xffffffffu, hi[r], o);
        lo[r] += __shfl_xor_sync(0xffffffffu, lo[r], o);
      }
      exp_sum[r] = wide_to_float(hi[r], lo[r]);
    }
  } else {
    long long part[2] = {0, 0};
#pragma unroll(Scores::kUnroll)
    for (int p = 0; p < N / 4; ++p)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (scores.key(4 * p + i, t) < n_keys)
#pragma unroll
          for (int r = 0; r < 2; ++r) part[r] += exp.ei(scores.get(r, 4 * p + i), row_max[r]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      part[r] += __shfl_xor_sync(0xffffffffu, part[r], 1);
      part[r] += __shfl_xor_sync(0xffffffffu, part[r], 2);
      exp_sum[r] = static_cast<float>(part[r]);
    }
  }
#pragma unroll(Scores::kUnroll)
  for (int p = 0; p < N / 4; ++p)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int u = 4 * p + i;
      const bool ok = scores.key(u, t) < n_keys;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        put(r, u, ok ? lis_shift(exp_sum[r], exp.e(scores.get(r, u), row_max[r]), k) : kLisZero);
    }
}

}  // namespace dvt
