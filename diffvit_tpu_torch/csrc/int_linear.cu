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
// Design: the Hopper GEMM mainloop (wgmma_gemm.cuh: TMA into an mbarrier
// ring, wgmma, persistent blocks) with LinearOut on the accumulator
// registers, so the int32 product never reaches device memory.  The
// weight is read K-major, as the Python wrapper's cached (N, Kp) copy
// (gemm.kmajor); where K % 16 != 0 the wrapper pads x's K with zeros,
// which add nothing to the integer sum.  The ragged N edge (N = 1000 at
// the ViT head) is TMA's zero fill and the epilogue's mask, so no byte is
// gathered one at a time.  The output is staged in shared memory and
// stored in whole rows of 16-byte vectors (wgmma_gemm.cuh's epilogue).
//
// Exactness against the plain PyTorch version (ops/kernels/linear.py):
// built with -fmad=false, so acc * mult + bias rounds twice as torch's
// separate multiply and add do (and as the forward's int_matmul(x, w) *
// mult + b); rintf rounds half to even.
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "wgmma_gemm.cuh"

namespace {

constexpr int kRaw = 0;  // the modes; 1 is fq, 2 codes

// The output element of one accumulator (wgmma_gemm.cuh's contract): Out
// float for the raw and fq modes, int8_t for codes.
template <class OutT>
struct LinearOut {
  using Out = OutT;
  const float* v;  // (4, N): [mult, bias, out_scale, 1/out_scale]
  Out* out;        // (R, N)
  int ld;          // N
  int mode;
  __device__ Out operator()(int, int c, int acc) const {
    const int n = ld;
    const float y = static_cast<float>(acc) * v[c] + v[n + c];
    if constexpr (std::is_same<Out, float>::value) {
      if (mode == kRaw) return y;
    }
    const float code = fminf(fmaxf(rintf(y * v[3 * n + c]), -128.f), 127.f);
    if constexpr (std::is_same<Out, float>::value)
      return code * v[2 * n + c];
    else
      return static_cast<int8_t>(code);
  }
};

}  // namespace

// x: (R, Kp) int8 row-major; wk: (N, Kp) int8, the weight K-major; v:
// (4, N) f32 [mult, bias, out_scale, 1/out_scale]; out: (R, N) f32 (mode 0
// raw, 1 fq) or int8 (mode 2 codes).  Kp % 16 == 0, 16-byte aligned x and
// wk; bm, bn, blocks, stages, smem and grid are gemm_plan's
// (ops/kernels/gemm.py).
extern "C" int dvt_int_linear(const void* x, const void* wk, const void* v, void* out,
                              int rows, int kp, int n, int mode, int bm, int bn, int blocks,
                              int stages, int smem, int grid, void* stream) {
  const dvt::wg::GemmArgs g{x, wk, rows, n, kp, bm, bn, blocks, stages, smem, grid};
  const float* vf = static_cast<const float*>(v);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 2)
    return dvt::wg::gemm(g, LinearOut<int8_t>{vf, static_cast<int8_t*>(out), n, mode}, s);
  return dvt::wg::gemm(g, LinearOut<float>{vf, static_cast<float*>(out), n, mode}, s);
}

// The footprint of the kernel of `mode` (2: codes, int8 out; else float
// out) for tile (bm, bn) at `blocks` blocks an SM and `smem` bytes of
// dynamic shared memory: registers a thread, shared memory a block,
// blocks an SM.
extern "C" int dvt_int_linear_footprint(int mode, int bm, int bn, int blocks, int smem,
                                        int* registers, int* smem_bytes, int* blocks_per_sm) {
  if (mode == 2)
    return dvt::wg::footprint<LinearOut<int8_t>>(bm, bn, blocks, smem, registers, smem_bytes,
                                                 blocks_per_sm);
  return dvt::wg::footprint<LinearOut<float>>(bm, bn, blocks, smem, registers, smem_bytes,
                                              blocks_per_sm);
}
