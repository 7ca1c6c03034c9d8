// The int8 code clip shared by the GEMM epilogues of both mainloops
// (int8_gemm.cuh's mma.sync tile and wgmma_gemm.cuh).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace dvt {

// clip(v, -128, 127) of an integer-valued float, as int8
__device__ __forceinline__ int8_t clip_i8(float v) {
  return static_cast<int8_t>(fminf(fmaxf(v, -128.f), 127.f));
}

}  // namespace dvt
