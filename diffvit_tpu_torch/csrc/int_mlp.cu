// Integer MLP (fc1 -> polynomial GELU -> qact1 -> fc2 -> PTF qact2) for
// Hopper.
//
// Replaces the Pallas kernel diffvit_tpu/ops/pallas/mlp.py::fused_int_mlp
// (body _mlp_kernel, GELU _gelu_poly).
//
// What bounds it on the H100: two int8 GEMMs, (R, C) @ (C, 4C) and
// (R, 4C) @ (4C, C) — at DeiT-S width the largest tensor-core work of a
// block — plus an elementwise epilogue per output (the 12-term Horner GELU
// on the fc1 side).  The epilogues run on the accumulator registers, so
// no int32 or f32 intermediate reaches device memory; what does is the
// int8 hidden stream (R x 4C bytes) between the two launches.
//
// Design: two launches of the shared int8 GEMM core (int8_gemm.cuh):
//  1. fc1 with the epilogue gelu_poly(acc * mult1 + bias1) * (1/s_q1),
//     rounded and clipped into an int8 (R, 4C) hidden tensor;
//  2. fc2 with the epilogue rint((acc * mult2 + bias2) * (1/out_scale))
//     clipped, stored as int8 codes (emit_codes) or as codes * out_scale
//     in f32.
// Fusing the hidden stream into one launch is left until a measurement
// shows its round trip through device memory matters.
//
// Exactness against the plain PyTorch version (ops/kernels/mlp.py): built
// with -fmad=false, so every multiply and add rounds on its own as torch's
// separate elementwise ops do; rintf rounds half to even; the GELU and the
// fc1 epilogue (int_mlp.cuh, shared with resident.cu) use the float32
// roundings of mlp.py's GELU_P.
#include <cstdint>
#include <cuda_runtime.h>

#include "int8_gemm.cuh"
#include "int_mlp.cuh"

namespace {

struct Fc2Epilogue {
  const float* mult2;
  const float* bias2;
  const float* inv_out;    // 1/out_scale per channel
  const float* out_scale;
  void* out;               // (R, Cout) int8 codes or f32 values
  int n;
  int emit_codes;
  __device__ void operator()(int r, int c, int acc) const {
    const float y = static_cast<float>(acc) * mult2[c] + bias2[c];
    const float code = fminf(fmaxf(rintf(y * inv_out[c]), -128.f), 127.f);
    const size_t at = (size_t)r * n + c;
    if (emit_codes)
      static_cast<int8_t*>(out)[at] = static_cast<int8_t>(code);
    else
      static_cast<float*>(out)[at] = code * out_scale[c];
  }
};

}  // namespace

// x: (R, Cin) int8; w1: (Cin, Hid) int8; w2: (Hid, Cout) int8; mult1/bias1:
// (Hid,) f32; mult2/bias2/inv_out/out_scale: (Cout,) f32; s_q1_inv: (1,) f32;
// hidden: (R, Hid) int8 scratch; out: (R, Cout) int8 or f32.
// Requires Cin % 32 == 0, Hid % 32 == 0, Hid % 16 == 0, Cout % 16 == 0
// (checked by the Python wrapper).
extern "C" int dvt_int_mlp(const void* x, const void* w1, const void* w2,
                           const void* mult1, const void* bias1,
                           const void* mult2, const void* bias2,
                           const void* inv_out, const void* out_scale,
                           const void* s_q1_inv, void* hidden, void* out,
                           int rows, int cin, int hid, int cout, int emit_codes,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dvt::Fc1Epilogue e1{static_cast<const float*>(mult1), static_cast<const float*>(bias1),
                 static_cast<const float*>(s_q1_inv), static_cast<int8_t*>(hidden), hid};
  dvt::launch_int8_gemm(static_cast<const int8_t*>(x), static_cast<const int8_t*>(w1),
                        rows, hid, cin, e1, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  Fc2Epilogue e2{static_cast<const float*>(mult2), static_cast<const float*>(bias2),
                 static_cast<const float*>(inv_out), static_cast<const float*>(out_scale),
                 out, cout, emit_codes};
  dvt::launch_int8_gemm(static_cast<const int8_t*>(hidden), static_cast<const int8_t*>(w2),
                        rows, cout, hid, e2, s);
  return cudaGetLastError();
}
