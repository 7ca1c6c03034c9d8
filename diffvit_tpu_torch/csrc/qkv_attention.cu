// Fused int8 qkv projection + attention, the attention core alone, and the
// whole attention half-block, for Hopper.
//
// Replaces these Pallas kernels of diffvit_tpu/ops/pallas/attention.py:
//  * fused_qkv_attention_v2 (K1; body _qkv_attn_kernel_v2, LIS in
//    _lis_body): the qkv GEMM, then the attention core, with the LIS or, for
//    lis=False, a float softmax rounded to bfloat16;
//  * fused_qkv_attention (K8 v1; body _qkv_attn_kernel) and its scheduling
//    variants _v3, _v4 and _v5: K1's function with the requant order
//    rint((acc * mult + bias) * (1/s1)) and the slow LIS; v1 reads three
//    per-head (H, Cin, D) weights, v3-v5 K1's (Cin, 3C) weight;
//  * fused_int_attention (K5; body _attn_kernel): the attention core alone,
//    on qkv that the caller has projected and requantized (SmoothQuant off),
//    with the slow LIS or the float softmax;
//  * fused_attention_block (K7a; body _attn_block_kernel): K8 v1, then the
//    proj accumulated over the heads in int32, and the qact3 / residual /
//    qact2 fences on the float32 residual stream.
// One GEMM launch with one epilogue serves the qkv projection of K1, K7a
// and K8: the weight is read in place through pointers and element strides
// (int8_gemm.cuh's BView), so K1's (Cin, 3C) and v1's three (H, Cin, D)
// tensors, or strided views of them, need no relayout copy; a flag picks
// the requant order.  One kernel body, attention_core_kernel, serves the
// attention of all four: the entries pass the element strides of qkv's
// (image, slot, head, row) axes and of the output's (image, head, row)
// axes, and pointers to the three scalars, whose order differs between the
// Pallas contracts.  K1/K8 read their (B, Npad, 3C) scratch; K5 reads a
// strided (B, 3, H, N, D) view of the caller's (B, N, 3C) qkv codes with
// no copy; K7a writes the heads' output in the (row, head * D) layout that
// its proj GEMM reads.  The core itself (attention_core.cuh) is shared with
// the resident encoder (resident.cu).
//
// What bounds it on the H100: the qkv GEMM, (B*N, C) @ (C, 3C) in int8, is
// ~75% of K1's operations and is tensor-core work (K7a adds the (C, C)
// proj).  The attention core is small integer/float work per (query, key)
// pair (scores over D=64, the LIS integer exponent, one IEEE division,
// attn@v over the keys) whose operands fit in shared memory.  Device memory
// sees only int8 codes in and out (K7a: and the float32 residual): the
// (N, N) scores and weights never leave the SM.  At DeiT-S b=64 K5 moves
// 19.4 MB (5.8 us at 3.35 TB/s) for 3.8 G operations (1.9 us of int8
// tensor-core peak): by bytes it is memory-bound, in practice it is bound
// by the per-score SIMT chain.
//
// Design, K1/K8 in two launches, K7a in three:
//  1. The int8 GEMM core (int8_gemm.cuh; the weight read through a BView)
//     with the qkv requant epilogue, into a (B, Npad, 3C) int8 scratch.
//  2. The attention core: one block per (query tile of 32 rows, head,
//     image), as attention_core.cuh describes.
//  3. (K7a) the proj GEMM over the (B*Npad, H*D) attention codes, whose
//     epilogue runs acc * mult_p + bias_p, the qact3 fence, the residual
//     add and the qact2 fence with IEEE divisions, as the Pallas kernel
//     divides (K6's proj-step epilogue is the pattern).
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

// The qkv GEMM with its requant epilogue into the (B*Npad, 3C) scratch,
// then the attention core into `out` at the output strides (o_image,
// o_head, o_row) of `ost`.  scalars: [s_a, c1, 1/s1, s1/s2].
cudaError_t launch_qkv_attention(const void* x, const void* wq, const void* wk,
                                 const void* wv, long long w_sh, long long w_sk,
                                 long long w_sd, const void* mb, const float* sp,
                                 int8_t* qkv, int8_t* out, const Strides& ost, int batch,
                                 int npad, int cin, int heads, int d, int n_real, int lis,
                                 int lis_fast, int requant_v1, cudaStream_t s) {
  const int c = heads * d, rows = batch * npad;
  const dvt::BView w{{static_cast<const int8_t*>(wq), static_cast<const int8_t*>(wk),
                      static_cast<const int8_t*>(wv)},
                     w_sh, w_sk, w_sd, c, d};
  dvt::QkvEpilogue epi{static_cast<const float*>(mb), qkv, 3 * c,
                       requant_v1 ? sp + 2 : nullptr};
  dvt::launch_int8_gemm_ops(
      dvt::ViewOperands{static_cast<const int8_t*>(x), cin, rows, 3 * c, cin, w}, epi, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const Strides st{(long long)npad * 3 * c, c, d, 3 * c, ost.o_image, ost.o_head, ost.o_row};
  return launch_core(qkv, CoreScalars{sp + 1, sp + 3, sp}, out, batch, heads, npad, d,
                     n_real, lis, lis_fast, st, s);
}

// K7a's proj: y = acc * mult_p + bias_p; the qact3 fence; the residual
// add; the qact2 fence; float32 out.
struct BlockProjEpilogue {
  const float* pvec;  // (4, n): [mult_p, bias_p, s_qact3, s_qact2]
  const float* h;     // (rows, n) the residual stream in
  float* out;         // (rows, n) the residual stream out
  int n;
  __device__ void operator()(int r, int c, int acc) const {
    const float y = static_cast<float>(acc) * pvec[c] + pvec[n + c];
    const float s3 = pvec[2 * n + c], s2 = pvec[3 * n + c];
    const float y3 = fminf(fmaxf(rintf(y / s3), -128.f), 127.f) * s3;
    const size_t at = (size_t)r * n + c;
    const float hn = h[at] + y3;
    out[at] = fminf(fmaxf(rintf(hn / s2), -128.f), 127.f) * s2;
  }
};

}  // namespace

extern "C" const char* dvt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K1 and K8.  x: (B, Npad, Cin) int8 LN codes; the weight's element (k,
// slot * C + h * D + d) is at w_slot + h * w_sh + k * w_sk + d * w_sd for
// w_slot = wq, wk, wv; mb: (2, 3C) f32, [mult/s1, bias/s1] (requant_v1 0,
// K1) or [mult, bias] (requant_v1 1, K8); scalars: (4,) f32 [s_a, c1, 1/s1,
// s1/s2] on the device; qkv: (B, Npad, 3C) int8 scratch; out: (B, H, Npad,
// D) int8.  lis: 1 for the LIS, 0 for the bfloat16 float softmax.
// Requires n_real <= min(npad, 256), D <= 64, D % 4 == 0 (checked by the
// Python wrapper).
extern "C" int dvt_qkv_attention(const void* x, const void* wq, const void* wk,
                                 const void* wv, long long w_sh, long long w_sk,
                                 long long w_sd, const void* mb, const void* scalars,
                                 void* qkv, void* out, int batch, int npad, int cin,
                                 int heads, int d, int n_real, int lis, int lis_fast,
                                 int requant_v1, void* stream) {
  const Strides ost{0, 0, 0, 0, (long long)heads * npad * d, (long long)npad * d, d};
  return launch_qkv_attention(x, wq, wk, wv, w_sh, w_sk, w_sd, mb,
                              static_cast<const float*>(scalars), static_cast<int8_t*>(qkv),
                              static_cast<int8_t*>(out), ost, batch, npad, cin, heads, d,
                              n_real, lis, lis_fast, requant_v1,
                              static_cast<cudaStream_t>(stream));
}

// K7a.  x, the weight view, mb ([mult, bias]) and scalars as K8's; h: (B,
// Npad, Cout) f32 residual; wp: (H * D, Cout) int8 (the (H, D, Cout) proj
// weight); pvec: (4, Cout) f32 [mult_p, bias_p, s_qact3, s_qact2]; qkv:
// (B, Npad, 3C) and attn: (B, Npad, C) int8 scratch; out: (B, Npad, Cout)
// f32.  Requires what K8 requires.
extern "C" int dvt_attention_block(const void* x, const void* h, const void* wq,
                                   const void* wk, const void* wv, long long w_sh,
                                   long long w_sk, long long w_sd, const void* wp,
                                   const void* mb, const void* pvec, const void* scalars,
                                   void* qkv, void* attn, void* out, int batch, int npad,
                                   int cin, int heads, int d, int cout, int n_real, int lis,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int c = heads * d, rows = batch * npad;
  int8_t* attn_codes = static_cast<int8_t*>(attn);
  const Strides ost{0, 0, 0, 0, (long long)npad * c, d, c};
  cudaError_t err = launch_qkv_attention(
      x, wq, wk, wv, w_sh, w_sk, w_sd, mb, static_cast<const float*>(scalars),
      static_cast<int8_t*>(qkv), attn_codes, ost, batch, npad, cin, heads, d, n_real, lis,
      0, 1, s);
  if (err != cudaSuccess) return err;
  const int8_t* wpp = static_cast<const int8_t*>(wp);
  const dvt::BView wv_p{{wpp, wpp, wpp}, 0, cout, 1, cout, cout};
  BlockProjEpilogue epi{static_cast<const float*>(pvec), static_cast<const float*>(h),
                        static_cast<float*>(out), cout};
  dvt::launch_int8_gemm_ops(dvt::ViewOperands{attn_codes, c, rows, cout, c, wv_p}, epi, s);
  return cudaGetLastError();
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
