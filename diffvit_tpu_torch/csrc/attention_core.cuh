// What the attention kernels share besides attention_mma.cuh's core: the
// qkv GEMM's requant (qkv_code, in K1's and K8's orders; probe P1's
// per-head epilogue calls it too) and its wgmma_gemm.cuh epilogue QkvOut
// (K1, K6, K7a, K8, P5), the core's strides and scalars, and the float softmax
// of one row (softmax_row_bf16, the lis=False branch of every core), so
// that the kernels cannot drift apart.
//
// Exactness against the plain PyTorch versions (ops/kernels/attention.py):
//  * built with -fmad=false: every a*b+c rounds twice, as torch does;
//  * rintf rounds half to even, like torch.round;
//  * the float softmax is taken in double and rounded once to float, then
//    to bfloat16.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "codes.cuh"
#include "lis.cuh"

namespace dvt {

// The qkv GEMM's requant, in one of two orders: K1's
// rint(acc * mult/s1 + bias/s1) (mb folded by the wrapper, s1_inv null),
// or K8's (the Pallas v1, v3-v5) rint((acc * mult + bias) * (1/s1)),
// clipped to int8.  mb: (2, n) [mult/s1, bias/s1], or [mult, bias].
__device__ __forceinline__ int8_t qkv_code(const float* mb, int n, const float* s1_inv,
                                           int c, int acc) {
  float y = static_cast<float>(acc) * mb[c] + mb[n + c];
  if (s1_inv != nullptr) y = y * *s1_inv;
  return clip_i8(rintf(y));
}

// The requant as wgmma_gemm.cuh's epilogue (K1, K6, K7a, K8, P5): returns the code.
struct QkvOut {
  using Out = int8_t;
  const float* mb;      // (2, 3C)
  int8_t* out;          // (rows, 3C)
  int ld;               // 3C
  const float* s1_inv;  // device scalar 1/s1 for K8's order, or null
  __device__ int8_t operator()(int, int c, int acc) const {
    return qkv_code(mb, ld, s1_inv, c, acc);
  }
};

struct Strides {
  long long q_image, q_slot, q_head, q_row;  // qkv, in elements
  long long o_image, o_head, o_row;          // out, in elements
};

// Device pointers to the core's three scalars.
struct CoreScalars {
  const float* c1;          // s1^2 * attn_scale / s_a
  const float* s1_over_s2;  // qact1 -> qact2 grid
  const float* s_a;         // softmax scale (qact_attn1)
};

__device__ __forceinline__ double warp_sum_d(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Float softmax of the float32 logits a[u] * s_a over the keys below n_keys
// (lane `lane` holds key lane + 32u), taken in double, rounded to float and
// then to bfloat16: weights[j] for j < n_keys.
template <int KeysPerLane>
__device__ __forceinline__ void softmax_row_bf16(const float (&a)[KeysPerLane],
                                                 int n_keys, float s_a,
                                                 float* weights, int lane) {
  float x[KeysPerLane];
  float row_max = -INFINITY;
#pragma unroll
  for (int u = 0; u < KeysPerLane; ++u) {
    x[u] = a[u] * s_a;
    if (lane + 32 * u < n_keys) row_max = fmaxf(row_max, x[u]);
  }
  row_max = warp_max(row_max);
  double e[KeysPerLane];
  double part = 0.0;
#pragma unroll
  for (int u = 0; u < KeysPerLane; ++u) {
    e[u] = (lane + 32 * u < n_keys) ? exp((double)x[u] - (double)row_max) : 0.0;
    part += e[u];
  }
  const double sum = warp_sum_d(part);
#pragma unroll
  for (int u = 0; u < KeysPerLane; ++u) {
    const int j = lane + 32 * u;
    if (j < n_keys)
      weights[j] = __bfloat162float(__float2bfloat16_rn(__double2float_rn(e[u] / sum)));
  }
}

}  // namespace dvt
