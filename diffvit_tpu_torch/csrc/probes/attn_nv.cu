// Probe P5: K1 with the LIS replaced by the linear weight w = a * 2^-7.
//
// Replaces the Pallas kernel _nv_kernel of scripts/ab_attn_overlap_r3.py:75
// (v2_nv, called at :105): the qkv GEMM and its requant, the per-head
// scores and their requant, then attn = (a * 2^-7) in bfloat16 over all
// Npad keys (no mask), attn @ v and the requant onto the qact2 grid.
//
// The H100 question: what K1's LIS chain costs.  This kernel is K1's two
// launches as K1 runs them (qkv_core.cuh: the qkv GEMM on the wgmma
// mainloop with the QkvOut requant, then attention_mma.cuh's tensor-core
// core with K1's plan and K/V staging) with one step changed, the weight
// rule: Weight::kLinear in place of the LIS, so the packed int8 codes go
// to attn@v as they stand, one s8 plane, and no exponential table is
// filled.  K1's time minus this one's is then the LIS step (the table, the
// row max and exact sum, a division and a log2 a score, the two u8 planes),
// and K1 with the float softmax minus this one's the softmax's.
//
// What bounds it: as K1, the qkv GEMM's int8 tensor-core work (at B=256 x
// Npad 200, 45 G of 61 G operations; 30.8 us at the int8 peak).
//
// Exactness: a * 2^-7 is exact in bfloat16, and the sum of its products
// with int8 v is a multiple of 2^-7 below 2^15, exact in float32 in any
// order; the kernel sums a * v in int32 (mma.sync s8 x s8) and scales by
// 2^-7, so it equals the plain version and the Pallas kernel bit for bit.
#include <cstdint>
#include <cuda_runtime.h>

#include "qkv_core.cuh"

namespace {

using dvt::amma::Weight;

}  // namespace

// x: (B*Npad, Kp) int8 (K zero-padded to Kp, a multiple of 16; 16-byte
// aligned); wk: (3C, Kp) int8, the (Cin, 3C) weight K-major with rows
// [slot, head, d]; mb: (2, 3C) f32 [mult/s1, bias/s1]; scalars: (4,) f32
// [s_a, c1, 1/s1, s1/s2] on the device; qkv: (B, Npad, 3C) int8 scratch;
// out: (B, H, Npad, D) int8.  bm .. grid: gemm_plan's; a_*:
// attention_plan's for n_real = Npad.  Requires Npad <= 256, D <= 64,
// D % 4 == 0 (checked by the wrapper).
extern "C" int dvt_probe_qkv_attention_nv(const void* x, const void* wk, const void* mb,
                                          const void* scalars, void* qkv, void* out,
                                          int batch, int npad, int kp, int heads, int d, int bm,
                                          int bn, int blocks, int stages, int smem, int grid,
                                          int a_warps, int a_tiles, int a_split, int a_smem,
                                          void* stream) {
  const dvt::Strides ost{0, 0, 0, 0, (long long)heads * npad * d, (long long)npad * d, d};
  const int gp[6] = {bm, bn, blocks, stages, smem, grid};
  // every Npad key weighs in: n_real = Npad
  return dvt::qkv::launch_qkv_attention<Weight::kLinear>(
      x, wk, mb, static_cast<const float*>(scalars), static_cast<int8_t*>(qkv),
      static_cast<int8_t*>(out), ost, batch, npad, kp, heads, d, npad, 0, 0, 0, gp,
      dvt::qkv::AttnPlan{a_warps, a_tiles, a_split, a_smem}, static_cast<cudaStream_t>(stream));
}

// The linear core's footprint for Npad keys and head width d at `warps`
// warps and `smem` bytes: registers and local memory (spills) a thread,
// shared memory a block, blocks an SM.
extern "C" int dvt_probe_linear_core_footprint(int npad, int d, int warps, int smem,
                                               int* registers, int* local_bytes,
                                               int* smem_bytes, int* blocks_per_sm) {
  return dvt::amma::footprint(
      reinterpret_cast<const void*>(dvt::qkv::core_kernel<Weight::kLinear>(npad, d)), warps,
      smem, registers, local_bytes, smem_bytes, blocks_per_sm);
}
