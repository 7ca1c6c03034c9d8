// The fixed-point step of the integer LayerNorm, shared by the resident
// encoder's LN (resident.cu) and K7b's LN (int_mlp_block.cu): the device
// form of ops/int_layernorm.get_mn.
#pragma once

#include <cuda_runtime.h>

namespace dvt {

// |a| ~ m * 2^-n with a 7-bit mantissa: n = clip(7 - floor(log2 |a|), 0,
// 31), m = clip(floor(|a| * 2^n), 0, 255); log2 0 = -inf gives n = 31, log2
// inf gives n = 0.  floor(log2) is ilogbf and 2^n is ldexpf (both exact).
struct Mn {
  float m, p2n;
};

__device__ __forceinline__ Mn get_mn(float aa) {
  float n;
  if (aa > 0.f && aa < INFINITY)
    n = fminf(fmaxf(7.f - static_cast<float>(ilogbf(aa)), 0.f), 31.f);
  else
    n = aa == 0.f ? 31.f : 0.f;
  const float p2n = ldexpf(1.f, static_cast<int>(n));
  return {fminf(fmaxf(floorf(aa * p2n), 0.f), 255.f), p2n};
}

}  // namespace dvt
