// Integer linear with a fused epilogue (K3) for Hopper.
//
// Replaces the Pallas kernel diffvit_tpu/ops/pallas/linear.py::
// fused_int_linear (body _linear_kernel): (R, K) int8 @ (K, N) int8 ->
// y = acc * mult + bias, stored as float32 (raw), or quantized onto the
// out_scale grid as clip(rint(y * (1/out_scale))) and stored as int8 codes
// (codes) or codes * out_scale in float32 (fq).
//
// What bounds it on the H100: one int8 GEMM plus an elementwise epilogue.
// At the sites it is shaped for (the ViT patch embed, qkv, proj, fc1 and
// head; Swin's patch embed with K = 48 and its 96/288-wide outputs) the
// float32 output of the raw and fq modes is the largest stream: at DeiT-S
// fc1 b=64 raw writes 77 MB (23 us at 3.35 TB/s) against 14.9 G int8
// operations (7.5 us of tensor-core peak), so the raw and fq modes are
// bound by bytes and the codes mode (19 MB out) about evenly.
//
// Design: the shared int8 GEMM tile (int8_gemm.cuh, ViewOperands) with the
// epilogue on the accumulator registers, so the int32 product never
// reaches device memory.  It takes any K and N: the real sites include K =
// 48 (Swin's 4x4x3 patch) and N = 1000 (the ViT head), so the ragged K and
// N edges are zero-filled in the tile loads.
//
// Exactness against the plain PyTorch version (ops/kernels/linear.py):
// built with -fmad=false, so acc * mult + bias rounds twice as torch's
// separate multiply and add do (and as the forward's int_matmul(x, w) *
// mult + b); rintf rounds half to even.
#include <cstdint>
#include <cuda_runtime.h>

#include "int8_gemm.cuh"

namespace {

constexpr int kRaw = 0, kCodes = 2;  // the modes; 1 is fq

struct LinearEpilogue {
  const float* v;  // (4, N): [mult, bias, out_scale, 1/out_scale]
  void* out;       // (R, N) f32 (raw, fq) or int8 (codes)
  int n;
  int mode;
  __device__ void operator()(int r, int c, int acc) const {
    const float y = static_cast<float>(acc) * v[c] + v[n + c];
    const size_t at = (size_t)r * n + c;
    if (mode == kRaw) {
      static_cast<float*>(out)[at] = y;
      return;
    }
    const float code = fminf(fmaxf(rintf(y * v[3 * n + c]), -128.f), 127.f);
    if (mode == kCodes)
      static_cast<int8_t*>(out)[at] = static_cast<int8_t>(code);
    else
      static_cast<float*>(out)[at] = code * v[2 * n + c];
  }
};

}  // namespace

// x: (R, K) int8 row-major; w: (K, N) int8 row-major; v: (4, N) f32
// [mult, bias, out_scale, 1/out_scale]; out: (R, N) f32 (mode 0 raw, 1 fq)
// or int8 (mode 2 codes).  Any R, K, N.
extern "C" int dvt_int_linear(const void* x, const void* w, const void* v, void* out,
                              int rows, int k, int n, int mode, void* stream) {
  const int8_t* wp = static_cast<const int8_t*>(w);
  const dvt::BView wv{{wp, wp, wp}, 0, n, 1, n, n};
  LinearEpilogue epi{static_cast<const float*>(v), out, n, mode};
  dvt::launch_int8_gemm_ops(dvt::ViewOperands{static_cast<const int8_t*>(x), k, rows, n, k, wv},
                            epi, static_cast<cudaStream_t>(stream));
  return cudaGetLastError();
}
