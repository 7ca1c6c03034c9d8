// Probe P5: K1 with the LIS replaced by the linear weight w = a * 2^-7.
//
// Replaces the Pallas kernel _nv_kernel of scripts/ab_attn_overlap_r3.py:75
// (v2_nv, called at :105): the qkv GEMM and its requant, the per-head
// scores and their requant, then attn = (a * 2^-7) in bfloat16 over all
// Npad keys (no mask), attn @ v and the requant onto the qact2 grid.
//
// The H100 question: what K1's LIS chain costs.  This kernel is K1's two
// launches (qkv_attention.cu's GEMM with the qkv requant epilogue, then the
// attention core of attention_core.cuh) with the weight rule kRuleLinear in
// place of lis_row, so K1's time minus this one's is the LIS row's cost, and
// K1 with the float softmax minus this one's is the softmax's.
//
// What bounds it: as K1, the qkv GEMM's int8 tensor-core work (at B=256 x
// Npad 200, 45 G of 61 G operations); the scores and attn@v run in SIMT
// (dp4a, then an int32 sum) as in K1's core.
//
// Exactness: a * 2^-7 is exact in bfloat16, and the sum of its products
// with int8 v is a multiple of 2^-7 below 2^15, exact in float32 in any
// order; the kernel sums a * v in int32 and scales by 2^-7, so it equals
// the plain version and the Pallas kernel bit for bit.
#include <cstdint>
#include <cuda_runtime.h>

#include "attention_core.cuh"
#include "int8_gemm.cuh"

namespace {

__global__ void __launch_bounds__(dvt::kAttnWarps * 32)
    linear_core_kernel(const int8_t* __restrict__ qkv, dvt::CoreScalars sc,
                       int8_t* __restrict__ out, int npad, int d, dvt::Strides st) {
  __shared__ dvt::AttnSmem sm;
  dvt::attention_item<dvt::kRuleLinear>(qkv, sc, out, npad, d, npad, 0, 0, st, blockIdx.z,
                                        blockIdx.y, blockIdx.x * dvt::kQueryTile, sm);
}

}  // namespace

// x: (B, Npad, Cin) int8; w: (Cin, 3C) int8, columns [slot, head, d]; mb:
// (2, 3C) f32 [mult/s1, bias/s1]; scalars: (4,) f32 [s_a, c1, 1/s1, s1/s2]
// on the device; qkv: (B, Npad, 3C) int8 scratch; out: (B, H, Npad, D)
// int8.  Requires Npad <= 256, D <= 64, D % 4 == 0 (checked by the
// wrapper).
extern "C" int dvt_probe_qkv_attention_nv(const void* x, const void* w, const void* mb,
                                          const void* scalars, void* qkv, void* out,
                                          int batch, int npad, int cin, int heads, int d,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int c = heads * d, rows = batch * npad;
  const int8_t* wp = static_cast<const int8_t*>(w);
  const dvt::BView view{{wp, wp + c, wp + 2 * c}, d, 3 * c, 1, c, d};
  dvt::QkvEpilogue epi{static_cast<const float*>(mb), static_cast<int8_t*>(qkv), 3 * c};
  dvt::launch_int8_gemm_ops(
      dvt::ViewOperands{static_cast<const int8_t*>(x), cin, rows, 3 * c, cin, view}, epi, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float* sp = static_cast<const float*>(scalars);
  const dvt::Strides st{(long long)npad * 3 * c, c, d, 3 * c,
                        (long long)heads * npad * d, (long long)npad * d, d};
  dim3 grid((npad + dvt::kQueryTile - 1) / dvt::kQueryTile, heads, batch);
  linear_core_kernel<<<grid, dvt::kAttnWarps * 32, 0, s>>>(
      static_cast<const int8_t*>(qkv), dvt::CoreScalars{sp + 1, sp + 3, sp},
      static_cast<int8_t*>(out), npad, d, st);
  return cudaGetLastError();
}
