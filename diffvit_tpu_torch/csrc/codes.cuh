// The int8 code clip shared by the int8-out epilogues (attention_core.cuh's
// QkvOut, int_mlp.cuh's Fc1Hidden) and the attention cores.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace dvt {

// clip(v, -128, 127) of an integer-valued float, as int8
__device__ __forceinline__ int8_t clip_i8(float v) {
  return static_cast<int8_t>(fminf(fmaxf(v, -128.f), 127.f));
}

}  // namespace dvt
