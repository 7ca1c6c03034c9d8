// Fused int8 qkv projection + attention, and the attention core alone, for
// Hopper.
//
// Replaces two Pallas kernels of diffvit_tpu/ops/pallas/attention.py:
//  * fused_qkv_attention_v2 (K1; body _qkv_attn_kernel_v2, LIS in
//    _lis_body): the qkv GEMM, then the attention core, with the LIS or, for
//    lis=False, a float softmax rounded to bfloat16;
//  * fused_int_attention (K5; body _attn_kernel): the attention core alone,
//    on qkv that the caller has projected and requantized (SmoothQuant off),
//    with the slow LIS or the float softmax.
// One kernel body, attention_core_kernel, serves both: the entries pass
// the element strides of qkv's (image, slot, head, row) axes and of the
// output's (image, head, row) axes, and pointers to the three scalars, whose
// order differs between the two Pallas contracts.  K1 reads its
// (B, Npad, 3C) scratch; K5 reads a strided (B, 3, H, N, D) view of the
// caller's (B, N, 3C) qkv codes with no copy.  The core itself
// (attention_core.cuh) is shared with the resident encoder (resident.cu).
//
// What bounds it on the H100: the qkv GEMM, (B*N, C) @ (C, 3C) in int8, is
// ~75% of K1's operations and is tensor-core work.  The attention core is
// small integer/float work per (query, key) pair (scores over D=64, the LIS
// integer exponent, one IEEE division, attn@v over the keys) whose
// operands fit in shared memory.  Device memory sees only int8 codes in and
// out: the (N, N) scores and weights never leave the SM.  At DeiT-S b=64
// K5 moves 19.4 MB (5.8 us at 3.35 TB/s) for 3.8 G operations (1.9 us of
// int8 tensor-core peak): by bytes it is memory-bound, in practice it is
// bound by the per-score SIMT chain.
//
// Design, K1 in two launches:
//  1. The int8 GEMM core (int8_gemm.cuh) with the epilogue
//     rint(acc * mb0 + mb1) clipped to int8, into a (B, Npad, 3C) int8
//     scratch — mb = [mult/s1, bias/s1] as the wrapper folds it.
//  2. The attention core: one block per (query tile of 32 rows, head,
//     image), as attention_core.cuh describes.
// K5 is launch 2 alone.  Exactness: see attention_core.cuh; the float
// softmax's codes agree with the plain version in practice (the order of
// the sums and an ulp of exp in double do not reach the float result; the
// tolerance is 1 code).  The reference takes both in float32.
#include <cstdint>
#include <cuda_runtime.h>

#include "attention_core.cuh"
#include "int8_gemm.cuh"

namespace {

using dvt::CoreScalars;
using dvt::Strides;

__global__ void __launch_bounds__(dvt::kAttnWarps * 32)
    attention_core_kernel(const int8_t* __restrict__ qkv, CoreScalars sc,
                          int8_t* __restrict__ out, int npad, int d,
                          int n_real, int lis, int lis_fast, Strides st) {
  __shared__ dvt::AttnSmem sm;
  dvt::attention_item(qkv, sc, out, npad, d, n_real, lis, lis_fast, st, blockIdx.z,
                      blockIdx.y, blockIdx.x * dvt::kQueryTile, sm);
}

cudaError_t launch_core(const int8_t* qkv, CoreScalars sc, int8_t* out,
                        int batch, int heads, int npad, int d, int n_real,
                        int lis, int lis_fast, const Strides& st,
                        cudaStream_t s) {
  dim3 grid((npad + dvt::kQueryTile - 1) / dvt::kQueryTile, heads, batch);
  attention_core_kernel<<<grid, dvt::kAttnWarps * 32, 0, s>>>(
      qkv, sc, out, npad, d, n_real, lis, lis_fast, st);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* dvt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K1.  x: (B, Npad, Cin) int8 LN codes; w: (Cin, 3C) int8; mb: (2, 3C) f32;
// scalars: (4,) f32 [s_a, c1, 1/s1, s1/s2] on the device; qkv: (B, Npad,
// 3C) int8 scratch; out: (B, H, Npad, D) int8.  lis: 1 for the LIS, 0 for
// the bfloat16 float softmax.  Requires n_real <= 256,
// D <= 64, D % 4 == 0, Cin % 32 == 0, 3C % 16 == 0 (checked by the Python
// wrapper).
extern "C" int dvt_qkv_attention(const void* x, const void* w, const void* mb,
                                 const void* scalars, void* qkv, void* out,
                                 int batch, int npad, int cin, int heads, int d,
                                 int n_real, int lis, int lis_fast, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int c = heads * d;
  dvt::QkvEpilogue epi{static_cast<const float*>(mb), static_cast<int8_t*>(qkv), 3 * c};
  dvt::launch_int8_gemm(static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
                        batch * npad, 3 * c, cin, epi, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float* sp = static_cast<const float*>(scalars);
  const Strides st{(long long)npad * 3 * c, c, d, 3 * c,
                   (long long)heads * npad * d, (long long)npad * d, d};
  return launch_core(static_cast<const int8_t*>(qkv), CoreScalars{sp + 1, sp + 3, sp},
                     static_cast<int8_t*>(out), batch, heads, npad, d, n_real,
                     lis, lis_fast, st, s);
}

// K5.  qkv: int8, element (image, slot, head, row, d) at
// image*sq_i + slot*sq_s + head*sq_h + row*sq_r + d; scalars: (3,) f32
// [c1, s1/s2, s_a] on the device; out: int8, element (image, head, row, d)
// at image*so_i + head*so_h + row*so_r + d.  lis: 1 for the slow LIS, 0 for
// the bfloat16 float softmax.  Requires n_real <= min(npad, 256), D <= 64,
// D % 4 == 0, every qkv stride a multiple of 4 (checked by the wrapper).
extern "C" int dvt_int_attention(const void* qkv, const void* scalars, void* out,
                                 int batch, int heads, int npad, int d,
                                 int n_real, int lis, long long sq_i,
                                 long long sq_s, long long sq_h, long long sq_r,
                                 long long so_i, long long so_h, long long so_r,
                                 void* stream) {
  const float* sp = static_cast<const float*>(scalars);
  const Strides st{sq_i, sq_s, sq_h, sq_r, so_i, so_h, so_r};
  return launch_core(static_cast<const int8_t*>(qkv), CoreScalars{sp, sp + 1, sp + 2},
                     static_cast<int8_t*>(out), batch, heads, npad, d, n_real,
                     lis, 0, st, static_cast<cudaStream_t>(stream));
}
