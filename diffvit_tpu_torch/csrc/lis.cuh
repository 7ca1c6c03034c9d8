// Log-Int-Softmax over one score row held by one warp, shared by the
// attention kernels (qkv_attention.cu, swin_attention.cu) so that they
// cannot drift apart.  The device form of _lis_body
// (diffvit_tpu/ops/pallas/attention.py:51) and of its plain PyTorch
// specification, lis_body_plain (ops/kernels/attention.py).
//
// Exactness against the plain version:
//  * 2^(32-q) is ldexpf (exact), floor(log2 y) is ilogbf (exact);
//  * the row sum of the integer exponentials is an exact int64 sum (every
//    term is an integer; lis_sum_fits bounds the total below 2^63), rounded
//    once to float, so it does not depend on the summation order;
//  * the weight 2^-code is kept as the integer 2^(15-code).
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

// The integer-exponential constants of one softmax scale s_a.
struct LisConsts {
  float x0_int, b_int, c_int, x_lo, nudge;
};

__device__ __forceinline__ LisConsts lis_consts(float s_a) {
  LisConsts k;
  k.x0_int = floorf((float)(-0.6931) / s_a);
  k.b_int = floorf((float)(0.96963238 / 0.35815147) / s_a);
  k.c_int = floorf((float)(1.0 / 0.35815147) / (s_a * s_a));
  k.x_lo = 32.f * k.x0_int;
  k.nudge = (float)(4.0 / 3.0 * (1.0 + 0x1p-17));
  return k;
}

// Lane `lane` of a warp holds a[u], the integer score of key lane + 32u,
// for keys below n_keys.  Writes weights[j] = 2^(15 - code) (0 where the
// log2 code saturates) for every key j < n_keys.  `fast` drops the
// floor/max that is a no-op for s_a in [2^-10, ln 2] (lis_fast_ok).
template <int KeysPerLane>
__device__ __forceinline__ void lis_row(const float (&a)[KeysPerLane],
                                        int n_keys, const LisConsts& k,
                                        bool fast, int* weights, int lane) {
  float row_max = -INFINITY;
#pragma unroll
  for (int u = 0; u < KeysPerLane; ++u)
    if (lane + 32 * u < n_keys) row_max = fmaxf(row_max, a[u]);
  row_max = warp_max(row_max);

  // integer exponential (n = 32) and its exact row sum
  float e[KeysPerLane];
  long long part = 0;
#pragma unroll
  for (int u = 0; u < KeysPerLane; ++u) {
    e[u] = 0.f;
    if (lane + 32 * u < n_keys) {
      const float x = fmaxf(a[u] - row_max, k.x_lo);
      const float q = floorf(x / k.x0_int);
      const float r = x - k.x0_int * q;
      const float poly = r * (r + k.b_int) + k.c_int;
      float ev = poly * ldexpf(1.f, 32 - static_cast<int>(q));
      if (!fast) ev = fmaxf(floorf(ev), 0.f);
      e[u] = ev;
      part += static_cast<long long>(ev);
    }
  }
  const float exp_sum = static_cast<float>(warp_sum(part));

  // log2 quantization: weight 2^-code, kept as the integer 2^(15-code)
#pragma unroll
  for (int u = 0; u < KeysPerLane; ++u) {
    const int j = lane + 32 * u;
    if (j < n_keys) {
      const float y = rintf(exp_sum / e[u]) * k.nudge;
      weights[j] = (y < 65536.f) ? (1 << (15 - ilogbf(y))) : 0;
    }
  }
}

}  // namespace dvt
