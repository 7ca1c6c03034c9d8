// Integer MLP (fc1 -> polynomial GELU -> qact1 -> fc2 -> PTF qact2) for
// Hopper.
//
// Replaces the Pallas kernel diffvit_tpu/ops/pallas/mlp.py::fused_int_mlp
// (body _mlp_kernel, GELU _gelu_poly).
//
// What bounds it on the H100: two int8 GEMMs, (R, C) @ (C, 4C) and
// (R, 4C) @ (4C, C) — at DeiT-S width the largest tensor-core work of a
// block — plus an elementwise epilogue per output (the 12-term Horner GELU
// on the fc1 side).  The epilogues run on the accumulator registers and
// stage their outputs in shared memory, so no int32 or f32 intermediate
// reaches device memory; what does is the int8 hidden stream (R x 4C
// bytes) between the two launches.
//
// Design: two launches of the Hopper GEMM mainloop (wgmma_gemm.cuh: TMA
// into an mbarrier ring, wgmma, persistent blocks), on the K-major weight
// copies that the Python wrapper keeps (gemm.kmajor):
//  1. fc1 with the epilogue gelu_poly(acc * mult1 + bias1) * (1/s_q1),
//     rounded and clipped into an int8 (R, Hid) hidden tensor (row stride
//     Hid rounded up to 16 bytes for TMA; the pad columns meet zero
//     weight columns in fc2);
//  2. fc2 with the epilogue rint((acc * mult2 + bias2) * (1/out_scale))
//     clipped, stored as int8 codes (emit_codes) or as codes * out_scale
//     in f32.
// Fusing the hidden stream into one launch is left until a measurement
// shows its round trip through device memory matters.
//
// Exactness against the plain PyTorch version (ops/kernels/mlp.py): built
// with -fmad=false, so every multiply and add rounds on its own as torch's
// separate elementwise ops do; rintf rounds half to even; the GELU and the
// fc1 epilogue (int_mlp.cuh's Fc1Hidden, shared with K6 and K7b) use the
// float32 roundings of mlp.py's GELU_P.
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "wgmma_gemm.cuh"
#include "int_mlp.cuh"

namespace {

using dvt::Fc1Hidden;

// fc2's output: the mlp.qact2 codes (Out int8_t) or their values (float).
template <class OutT>
struct Fc2Out {
  using Out = OutT;
  const float* mult2;
  const float* bias2;
  const float* inv_out;    // 1/out_scale per channel
  const float* out_scale;
  Out* out;                // (R, Cout)
  int ld;
  __device__ Out operator()(int, int c, int acc) const {
    const float y = static_cast<float>(acc) * mult2[c] + bias2[c];
    const float code = fminf(fmaxf(rintf(y * inv_out[c]), -128.f), 127.f);
    if constexpr (std::is_same<Out, int8_t>::value)
      return static_cast<int8_t>(code);
    else
      return code * out_scale[c];
  }
};

}  // namespace

// x: (R, Cin_p) int8; w1k: (Hid, Cin_p) int8 and w2k: (Cout, Hid_p) int8,
// the weights K-major with K zero-padded to a multiple of 16;
// mult1/bias1: (Hid,) f32; mult2/bias2/inv_out/out_scale: (Cout,) f32;
// s_q1_inv: (1,) f32; hidden: (R, Hid_p) int8 scratch; out: (R, Cout)
// int8 or f32.  plan1 and plan2 are gemm_plan's (bm, bn, blocks, stages,
// smem, grid) of fc1 and fc2 (ops/kernels/gemm.py).
extern "C" int dvt_int_mlp(const void* x, const void* w1k, const void* w2k,
                           const void* mult1, const void* bias1,
                           const void* mult2, const void* bias2,
                           const void* inv_out, const void* out_scale,
                           const void* s_q1_inv, void* hidden, void* out,
                           int rows, int cin_p, int hid, int hid_p, int cout, int emit_codes,
                           int bm1, int bn1, int blocks1, int stages1, int smem1, int grid1,
                           int bm2, int bn2, int blocks2, int stages2, int smem2, int grid2,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Fc1Hidden e1{static_cast<const float*>(mult1), static_cast<const float*>(bias1),
                     static_cast<const float*>(s_q1_inv), static_cast<int8_t*>(hidden), hid_p};
  const dvt::wg::GemmArgs g1{x,     w1k,     rows,    hid,   cin_p, bm1,
                             bn1,   blocks1, stages1, smem1, grid1};
  cudaError_t err = dvt::wg::gemm(g1, e1, s);
  if (err != cudaSuccess) return err;
  const dvt::wg::GemmArgs g2{hidden, w2k,     rows,    cout,  hid_p, bm2,
                             bn2,    blocks2, stages2, smem2, grid2};
  const float *m2 = static_cast<const float*>(mult2), *b2 = static_cast<const float*>(bias2),
              *io = static_cast<const float*>(inv_out), *os = static_cast<const float*>(out_scale);
  if (emit_codes)
    return dvt::wg::gemm(g2, Fc2Out<int8_t>{m2, b2, io, os, static_cast<int8_t*>(out), cout}, s);
  return dvt::wg::gemm(g2, Fc2Out<float>{m2, b2, io, os, static_cast<float*>(out), cout}, s);
}

// The footprint of fc1's kernel (layer 1) or fc2's (layer 2: codes out; 3:
// float out) for tile (bm, bn) at `blocks` blocks an SM and `smem` bytes
// of dynamic shared memory: registers a thread, shared memory a block,
// blocks an SM.
extern "C" int dvt_int_mlp_footprint(int layer, int bm, int bn, int blocks, int smem,
                                     int* registers, int* smem_bytes, int* blocks_per_sm) {
  if (layer == 1)
    return dvt::wg::footprint<Fc1Hidden>(bm, bn, blocks, smem, registers, smem_bytes,
                                         blocks_per_sm);
  if (layer == 2)
    return dvt::wg::footprint<Fc2Out<int8_t>>(bm, bn, blocks, smem, registers, smem_bytes,
                                              blocks_per_sm);
  return dvt::wg::footprint<Fc2Out<float>>(bm, bn, blocks, smem, registers, smem_bytes,
                                           blocks_per_sm);
}
