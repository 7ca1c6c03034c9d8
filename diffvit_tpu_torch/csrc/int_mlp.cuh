// The polynomial GELU and the fc1 epilogue of the integer MLP, shared by K2
// (int_mlp.cu), K7b (int_mlp_block.cu), the resident encoder K6
// (resident.cu) and the probe P3 (probes/overlap_mlp.cu).  The GELU constants
// are the float32 roundings of mlp.py's GELU_P (the same double -> float
// rounding as the Python side); with -fmad=false every multiply and add
// rounds on its own, as torch's separate elementwise ops do.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "codes.cuh"

namespace dvt {

// GELU_P of diffvit_tpu/ops/pallas/mlp.py:40-46 (degree-12 Chebyshev fit)
static __constant__ float kGeluP[13] = {
    (float)1.472124915e-01,  (float)-7.297722655e-02, (float)5.292239887e-02,
    (float)-4.063959391e-02, (float)3.055344378e-02,  (float)-2.162323356e-02,
    (float)1.431964120e-02,  (float)-9.132027657e-03, (float)5.130726935e-03,
    (float)-2.055695227e-03, (float)1.023744687e-03,  (float)-9.600747865e-04,
    (float)3.919371191e-04,
};

__device__ __forceinline__ float gelu_poly(float x) {
  const float b2 = (float)(4.8 * 4.8);
  const float u = fminf(x * x, b2);
  const float s = u * (float)(2.0 / (4.8 * 4.8)) - 1.f;
  float p = kGeluP[12];
#pragma unroll
  for (int i = 11; i >= 0; --i) p = p * s + kGeluP[i];
  const float phi = fminf(fmaxf(0.5f + x * p, 0.f), 1.f);
  return x * phi;
}

// fc1's hidden code of one accumulator: rint(gelu_poly(acc * mult1 +
// bias1) * (1/s_q1)) clipped to int8.
__device__ __forceinline__ int8_t fc1_code(int acc, float mult1, float bias1,
                                          float s_q1_inv) {
  const float mid = static_cast<float>(acc) * mult1 + bias1;
  return clip_i8(rintf(gelu_poly(mid) * s_q1_inv));
}

// fc1's hidden codes as wgmma_gemm.cuh's epilogue functor (K2, K6, K7b).
// In an unnamed namespace: each kernel source that launches
// wgmma_gemm_kernel<..., Fc1Hidden> instantiates its own copy.
namespace {
struct Fc1Hidden {
  using Out = int8_t;
  const float* mult1;
  const float* bias1;
  const float* s_q1_inv;  // (1,) on the device
  int8_t* out;            // (R, ld) hidden
  int ld;
  __device__ int8_t operator()(int, int c, int acc) const {
    return fc1_code(acc, mult1[c], bias1[c], s_q1_inv[0]);
  }
};
}  // namespace

}  // namespace dvt
