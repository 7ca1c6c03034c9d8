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
//
// What bounds it on the H100: at DeiT-S b=64 K1 does 15.0 G int8
// operations, 11.2 G of them the qkv GEMM (5.7 us of tensor-core peak),
// and moves 10.1 MB; K5 moves 19.4 MB (5.8 us at 3.35 TB/s) for 3.8 G
// operations.  Neither bound is near: what sets the pace is the GEMM's
// epilogue and, in the core, the per-score SIMT chain of the LIS (two IEEE
// divisions and the integer exponential a score) and the staging of each
// head's keys and values.
//
// Design, K1/K8 in two launches (qkv_core.cuh, which probe P5 shares), K7a
// in three:
//  1. The qkv GEMM on wgmma_gemm.cuh's mainloop (TMA into an mbarrier
//     ring, wgmma, persistent blocks; the plan from gemm.gemm_plan) with
//     the requant epilogue QkvOut (attention_core.cuh) in either order,
//     into a (B, Npad, 3C) int8 scratch.  The weight reaches it K-major:
//     the wrapper keeps one cached (3C, Kp) copy of K1's (Cin, 3C) weight
//     (gemm.kmajor), or of v1's three (H, Cin, D) weights laid out as K1's
//     (gemm.per_weight), so no call relays it.
//  2. The attention core on tensor cores (attention_mma.cuh): a block per
//     (image, head, run of query tiles of 16), K and V staged once a
//     block; the plan (ops/kernels/attn_plan.py) sets the tiles a block
//     from the batch, so the grid fills the SMs at b = 1 too.  The entries
//     pass the element strides of qkv's (image, slot, head, row) axes and
//     of the output's (image, head, row) axes, and pointers to the three
//     scalars, whose order differs between the Pallas contracts.  K1/K8
//     read their scratch; K5 reads a strided (B, 3, H, N, D) view of the
//     caller's (B, N, 3C) qkv codes with no copy; K7a writes the heads'
//     output in the (row, head * D) layout that its proj GEMM reads.
//  3. (K7a) the proj GEMM over the (B*Npad, H*D) attention codes on
//     wgmma_gemm.cuh's mainloop (K3's launch), whose value-returning
//     epilogue BlockProjOut runs acc * mult_p + bias_p, the qact3 fence,
//     the residual add and the qact2 fence with IEEE divisions, as the
//     Pallas kernel divides; the mainloop stages the float32 tile in shared
//     memory and stores whole rows in 16-byte vectors.  The proj weight
//     reaches it K-major, as a cached (Cout, Ka) copy of (H*D, Cout)
//     (gemm.per_weight over gemm.kmajor); the core writes the attention
//     codes with a row stride of Ka = H*D rounded up to 16 bytes, TMA's
//     rule.  The pad columns are never written: they meet the copy's zero
//     rows, and an integer product with 0 is 0 whatever they hold.
//     What bounds the proj: its float32 residual, read once and written
//     once (39.3 of the 44.8 MB at DeiT-S b=64, 13.2 us at 3.35 TB/s),
//     against 3.8 G int8 operations (1.9 us).
// K5 is launch 2 alone.  Exactness: see attention_mma.cuh; the float
// softmax's codes agree with the plain version in practice (the order of
// the sums and an ulp of exp in double do not reach the float result; the
// tolerance is 1 code).  The reference takes both in float32.
#include <cstdint>
#include <cuda_runtime.h>

#include "attention_core.cuh"
#include "qkv_core.cuh"
#include "wgmma_gemm.cuh"

namespace {

using dvt::CoreScalars;
using dvt::Strides;
namespace amma = dvt::amma;

using amma::Weight;
using dvt::qkv::AttnPlan;

// The core's weight rule for the entries' `lis` (0, 1, or lis.cuh's
// kLisWide): the LIS or the float softmax.
dvt::qkv::CoreKernel core_kernel(int n_real, int d, int lis) {
  return lis ? dvt::qkv::core_kernel<Weight::kLis>(n_real, d)
             : dvt::qkv::core_kernel<Weight::kSoftmax>(n_real, d);
}

cudaError_t launch_core(const int8_t* codes, CoreScalars sc, int8_t* out, int batch, int heads,
                        int npad, int d, int n_real, int lis, const Strides& st,
                        const AttnPlan& p, cudaStream_t s) {
  const int wide = lis == dvt::kLisWide;
  if (lis)
    return dvt::qkv::launch_core<Weight::kLis>(codes, sc, out, batch, heads, npad, d, n_real,
                                               wide, 0, st, p, s);
  return dvt::qkv::launch_core<Weight::kSoftmax>(codes, sc, out, batch, heads, npad, d, n_real,
                                                 wide, 0, st, p, s);
}

// K1's (and K7a's and K8's) two launches, with the LIS or the float softmax.
cudaError_t launch_qkv_attention(const void* x, const void* wk, const void* mb,
                                 const float* sp, int8_t* codes, int8_t* out,
                                 const Strides& ost, int batch, int npad, int kp, int heads,
                                 int d, int n_real, int lis, int lis_fast, int requant_v1,
                                 const int* gp, const AttnPlan& ap, cudaStream_t s) {
  const int wide = lis == dvt::kLisWide;
  if (lis)
    return dvt::qkv::launch_qkv_attention<Weight::kLis>(x, wk, mb, sp, codes, out, ost, batch,
                                                        npad, kp, heads, d, n_real, wide,
                                                        lis_fast, requant_v1, gp, ap, s);
  return dvt::qkv::launch_qkv_attention<Weight::kSoftmax>(x, wk, mb, sp, codes, out, ost, batch,
                                                          npad, kp, heads, d, n_real, wide,
                                                          lis_fast, requant_v1, gp, ap, s);
}

// K7a's proj epilogue (wgmma_gemm.cuh's contract, with the residual as
// its second operand): y = acc * mult_p + bias_p; the qact3 fence; the
// residual add; the qact2 fence; float32 out.
struct BlockProjOut {
  using Out = float;
  using In = float;
  const float* pvec;  // (4, ld): [mult_p, bias_p, s_qact3, s_qact2]
  const float* h;     // (rows, ld) the residual stream in
  Out* out;           // (rows, ld) the residual stream out
  int ld;             // Cout
  __device__ In load(int r, int c) const { return __ldg(h + static_cast<size_t>(r) * ld + c); }
  __device__ Out operator()(int, int c, int acc, In hv) const {
    const int n = ld;
    const float y = static_cast<float>(acc) * pvec[c] + pvec[n + c];
    const float s3 = pvec[2 * n + c], s2 = pvec[3 * n + c];
    const float y3 = fminf(fmaxf(rintf(y / s3), -128.f), 127.f) * s3;
    const float hn = hv + y3;
    return fminf(fmaxf(rintf(hn / s2), -128.f), 127.f) * s2;
  }
};

// The proj GEMM's footprint as wg::Footprint gives it, with local memory
// (spills) a thread.
struct ProjFootprint {
  int smem;
  int *registers, *local_bytes, *smem_bytes, *blocks_per_sm;
  template <int BM, int BN, int B>
  cudaError_t run() const {
    cudaFuncAttributes attr;
    cudaError_t err = dvt::wg::prepare<BM, BN, B, BlockProjOut>(smem, &attr);
    if (err != cudaSuccess && err != cudaErrorInvalidConfiguration) return err;
    *registers = attr.numRegs;
    *local_bytes = static_cast<int>(attr.localSizeBytes);
    *smem_bytes = smem + static_cast<int>(attr.sharedSizeBytes);
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm,
        reinterpret_cast<const void*>(dvt::wg::wgmma_gemm_kernel<BM, BN, B, BlockProjOut>),
        dvt::wg::kThreads, smem);
  }
};

}  // namespace

extern "C" const char* dvt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K1 and K8.  x: (B*Npad, Kp) int8 LN codes (K zero-padded to Kp, a
// multiple of 16; 16-byte aligned); wk: (3C, Kp) int8, the weight K-major
// with rows ordered [slot, head, d]; mb: (2, 3C) f32, [mult/s1, bias/s1]
// (requant_v1 0, K1) or [mult, bias] (requant_v1 1, K8); scalars: (4,) f32
// [s_a, c1, 1/s1, s1/s2] on the device; qkv: (B, Npad, 3C) int8 scratch;
// out: (B, H, Npad, D) int8.  lis: 1 for the LIS, 2 for the LIS with the
// 128-bit row sum (lis.cuh's kLisWide), 0 for the bfloat16 float softmax.  bm .. grid: gemm_plan's; a_*: attention_plan's.  Requires
// n_real <= min(npad, 256), D <= 64, D % 4 == 0 (checked by the Python
// wrapper).
extern "C" int dvt_qkv_attention(const void* x, const void* wk, const void* mb,
                                 const void* scalars, void* qkv, void* out, int batch,
                                 int npad, int kp, int heads, int d, int n_real, int lis,
                                 int lis_fast, int requant_v1, int bm, int bn, int blocks,
                                 int stages, int smem, int grid, int a_warps, int a_tiles,
                                 int a_split, int a_smem, void* stream) {
  const Strides ost{0, 0, 0, 0, (long long)heads * npad * d, (long long)npad * d, d};
  const int gp[6] = {bm, bn, blocks, stages, smem, grid};
  return launch_qkv_attention(x, wk, mb, static_cast<const float*>(scalars),
                              static_cast<int8_t*>(qkv), static_cast<int8_t*>(out), ost,
                              batch, npad, kp, heads, d, n_real, lis, lis_fast, requant_v1, gp,
                              AttnPlan{a_warps, a_tiles, a_split, a_smem},
                              static_cast<cudaStream_t>(stream));
}

// K7a.  x, wk, mb ([mult, bias]) and scalars as K8's; h: (B, Npad, Cout)
// f32 residual; wpk: (Cout, ka) int8, the (H, D, Cout) proj weight
// K-major, H*D zero-padded to ka (a multiple of 16); pvec: (4, Cout) f32
// [mult_p, bias_p, s_qact3, s_qact2]; qkv: (B, Npad, 3C) and attn: (B *
// Npad, ka) int8 scratch; out: (B, Npad, Cout) f32, 16-byte aligned.  lis
// as K8's; bm .. grid: gemm_plan's for the qkv GEMM, p_bm .. p_grid for
// the proj (B * Npad, Cout, ka).  Requires what K8 requires.
extern "C" int dvt_attention_block(const void* x, const void* h, const void* wk,
                                   const void* wpk, const void* mb, const void* pvec,
                                   const void* scalars, void* qkv, void* attn, void* out,
                                   int batch, int npad, int kp, int heads, int d, int cout,
                                   int n_real, int lis, int ka, int bm, int bn, int blocks,
                                   int stages, int smem, int grid, int p_bm, int p_bn,
                                   int p_blocks, int p_stages, int p_smem, int p_grid,
                                   int a_warps, int a_tiles, int a_split, int a_smem,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ka < heads * d || ka % 16 != 0) return cudaErrorInvalidValue;
  const Strides ost{0, 0, 0, 0, (long long)npad * ka, d, ka};
  const int gp[6] = {bm, bn, blocks, stages, smem, grid};
  cudaError_t err = launch_qkv_attention(
      x, wk, mb, static_cast<const float*>(scalars), static_cast<int8_t*>(qkv),
      static_cast<int8_t*>(attn), ost, batch, npad, kp, heads, d, n_real, lis, 0, 1, gp,
      AttnPlan{a_warps, a_tiles, a_split, a_smem}, s);
  if (err != cudaSuccess) return err;
  const dvt::wg::GemmArgs g{attn, wpk,      batch * npad, cout,   ka,    p_bm,
                            p_bn, p_blocks, p_stages,     p_smem, p_grid};
  return dvt::wg::gemm(g,
                       BlockProjOut{static_cast<const float*>(pvec), static_cast<const float*>(h),
                                    static_cast<float*>(out), cout},
                       s);
}

// K5.  qkv: int8, element (image, slot, head, row, d) at
// image*sq_i + slot*sq_s + head*sq_h + row*sq_r + d; scalars: (3,) f32
// [c1, s1/s2, s_a] on the device; out: int8, element (image, head, row, d)
// at image*so_i + head*so_h + row*so_r + d.  lis: 1 for the slow LIS, 2 for
// it with the 128-bit row sum, 0 for the bfloat16 float softmax.  a_*: attention_plan's.  Requires n_real <=
// min(npad, 256), D <= 64, D % 4 == 0, every qkv stride a multiple of 4
// (checked by the wrapper).
extern "C" int dvt_int_attention(const void* qkv, const void* scalars, void* out, int batch,
                                 int heads, int npad, int d, int n_real, int lis,
                                 long long sq_i, long long sq_s, long long sq_h,
                                 long long sq_r, long long so_i, long long so_h,
                                 long long so_r, int a_warps, int a_tiles, int a_split,
                                 int a_smem, void* stream) {
  const float* sp = static_cast<const float*>(scalars);
  const Strides st{sq_i, sq_s, sq_h, sq_r, so_i, so_h, so_r};
  return launch_core(static_cast<const int8_t*>(qkv), CoreScalars{sp, sp + 1, sp + 2},
                     static_cast<int8_t*>(out), batch, heads, npad, d, n_real, lis, st,
                     AttnPlan{a_warps, a_tiles, a_split, a_smem},
                     static_cast<cudaStream_t>(stream));
}

// The qkv GEMM's footprint (wgmma_gemm.cuh with QkvOut) for tile (bm, bn)
// at `blocks` blocks an SM and `smem` bytes: registers a thread, shared
// memory a block, blocks an SM.
extern "C" int dvt_qkv_gemm_footprint(int bm, int bn, int blocks, int smem, int* registers,
                                      int* smem_bytes, int* blocks_per_sm) {
  return dvt::wg::footprint<dvt::QkvOut>(bm, bn, blocks, smem, registers, smem_bytes,
                                         blocks_per_sm);
}

// K7a's proj GEMM's footprint (wgmma_gemm.cuh with BlockProjOut) for tile
// (bm, bn) at `blocks` blocks an SM and `smem` bytes: registers and local
// memory (spills) a thread, shared memory a block, blocks an SM.
extern "C" int dvt_block_proj_footprint(int bm, int bn, int blocks, int smem, int* registers,
                                        int* local_bytes, int* smem_bytes, int* blocks_per_sm) {
  return dvt::wg::dispatch_tile(
      bm, bn, blocks, ProjFootprint{smem, registers, local_bytes, smem_bytes, blocks_per_sm});
}

// The attention core's footprint for n_real keys, head width d and
// softmax (core_kernel's instance) at `warps` warps and `smem` bytes: registers and local
// memory (spills) a thread, shared memory a block, blocks an SM.
extern "C" int dvt_attention_core_footprint(int n_real, int d, int lis, int warps, int smem,
                                            int* registers, int* local_bytes, int* smem_bytes,
                                            int* blocks_per_sm) {
  return amma::footprint(reinterpret_cast<const void*>(core_kernel(n_real, d, lis)), warps,
                         smem, registers, local_bytes, smem_bytes, blocks_per_sm);
}
