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
// Design, K1/K8 in two launches, K7a in three:
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
//     int8_gemm.cuh's mma.sync tile, whose epilogue runs acc * mult_p +
//     bias_p, the qact3 fence, the residual add and the qact2 fence with
//     IEEE divisions, as the Pallas kernel divides.
// K5 is launch 2 alone.  Exactness: see attention_mma.cuh; the float
// softmax's codes agree with the plain version in practice (the order of
// the sums and an ulp of exp in double do not reach the float result; the
// tolerance is 1 code).  The reference takes both in float32.
#include <cstdint>
#include <cuda_runtime.h>

#include "attention_core.cuh"
#include "attention_mma.cuh"
#include "int8_gemm.cuh"
#include "wgmma_gemm.cuh"

namespace {

using dvt::CoreScalars;
using dvt::Strides;
namespace amma = dvt::amma;

using amma::QkvChain;

constexpr int kMaxKB = 8;     // 256 keys (attention.py's MAX_KEYS)
constexpr int kMidKB = 7;     // 224 keys (DeiT's 197): 7 blocks of attn@v, not 8
constexpr int kQkvWarps = 7;  // warps a block at most (attn_plan.QKV_MAX_WARPS)
// a warp's shared memory: its packed scores (the LIS) or the float
// softmax's buffers
constexpr int kCodeBytes = amma::PackedScores<8 * kMaxKB>::kBytes;

__host__ __device__ int warp_scratch(int lis) {
  return lis ? kCodeBytes : amma::soft_bytes(32 * kMaxKB, 1);
}

// The attention plan (attn_plan.attention_plan): warps a block, query
// tiles a block, blocks an (image, head), dynamic shared memory.
struct AttnPlan {
  int warps, tiles, split, smem;
};

// Block (split index, head, image) takes query tiles [x * tiles, + tiles)
// of 16 rows; warp w the tiles w, w + warps, ...  The LIS runs at three
// blocks an SM, because its chain is latency-bound and wants the warps:
// at most 80 registers a thread (a 7-warp block's registers are allocated
// as 8 warps'); the float softmax's double sums take more.
template <int MaxKB, int DP, bool Lis>
__global__ void __launch_bounds__(kQkvWarps * 32, Lis ? 3 : 1)
    qkv_core_kernel(const int8_t* __restrict__ qkv, CoreScalars sc,
                    int8_t* __restrict__ out, int npad, int d, int n_real, int lis_fast,
                    int lis_wide, Strides st, int tiles) {
  extern __shared__ __align__(16) uint8_t attn_smem[];
  const int bx = blockIdx.x, b = blockIdx.z, h = blockIdx.y;
  const amma::KvGeom g = amma::kv_geom(n_real, d, Lis);
  const float s_a = *sc.s_a;
  const amma::ExpTable et =
      amma::fill_exp_table(attn_smem, dvt::lis_consts(s_a, lis_wide != 0), lis_fast != 0);
  uint8_t* const kv = attn_smem + amma::kExpBytes;
  const int8_t* base = qkv + b * st.q_image + h * st.q_head;
  amma::stage_kv(base + st.q_slot, base + 2 * st.q_slot, st.q_row, n_real, d, g, kv);
  __syncthreads();

  const amma::SoftArgs a{n_real, d, et, s_a, *sc.s1_over_s2};
  const QkvChain chain{*sc.c1, 0.f};
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  uint8_t* scratch = kv + g.bytes() + warp * warp_scratch(Lis);
  int8_t* out_bh = out + b * st.o_image + h * st.o_head;
  const int q_tiles = (npad + amma::kRows - 1) / amma::kRows;
  const int t1 = min((bx + 1) * tiles, q_tiles);
  for (int tile = bx * tiles + warp; tile < t1; tile += warps) {
    const int q0 = tile * amma::kRows;
    const amma::RowTile rt{base + q0 * st.q_row, st.q_row, out_bh + q0 * st.o_row, st.o_row,
                           min(amma::kRows, npad - q0)};
    amma::attend_rows<MaxKB, DP, Lis>(rt, kv, g, a, chain, scratch);
  }
}

// Dynamic shared memory the core needs (attn_plan.py's core_smem).
int core_smem(int n_real, int d, int lis, int warps) {
  return amma::kExpBytes + amma::kv_geom(n_real, d, lis != 0).bytes() + warps * warp_scratch(lis);
}

using CoreKernel = void (*)(const int8_t*, CoreScalars, int8_t*, int, int, int, int, int,
                           Strides, int);

// The core's instance for n_real keys (224 or 256 at most), head width d
// (32 or 64 at most) and softmax.
CoreKernel core_kernel(int n_real, int d, int lis) {
  const bool mid = n_real <= 32 * kMidKB, narrow = d <= 32;
  if (lis)
    return mid ? (narrow ? qkv_core_kernel<kMidKB, 32, true> : qkv_core_kernel<kMidKB, 64, true>)
               : (narrow ? qkv_core_kernel<kMaxKB, 32, true> : qkv_core_kernel<kMaxKB, 64, true>);
  return mid ? (narrow ? qkv_core_kernel<kMidKB, 32, false> : qkv_core_kernel<kMidKB, 64, false>)
             : (narrow ? qkv_core_kernel<kMaxKB, 32, false> : qkv_core_kernel<kMaxKB, 64, false>);
}

cudaError_t launch_core(const int8_t* qkv, CoreScalars sc, int8_t* out, int batch, int heads,
                        int npad, int d, int n_real, int lis, int lis_fast, const Strides& st,
                        const AttnPlan& p, cudaStream_t s) {
  const int q_tiles = (npad + amma::kRows - 1) / amma::kRows;
  if (p.warps < 1 || p.warps > kQkvWarps || p.tiles < 1 ||
      p.split * p.tiles < q_tiles || p.smem < core_smem(n_real, d, lis, p.warps) ||
      n_real > 32 * kMaxKB || d > 64)
    return cudaErrorInvalidValue;
  const CoreKernel kernel = core_kernel(n_real, d, lis);
  cudaError_t err = amma::allow_smem(reinterpret_cast<const void*>(kernel), p.smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.split, heads, batch), 32 * p.warps, p.smem, s>>>(qkv, sc, out, npad, d, n_real,
                                                                   lis_fast, lis == dvt::kLisWide,
                                                                   st, p.tiles);
  return cudaGetLastError();
}

// The qkv GEMM (plan g: gemm_plan's numbers) with its requant epilogue
// into the (B*Npad, 3C) scratch, then the attention core into `out` at the
// output strides (o_image, o_head, o_row) of `ost`.  x: (B*Npad, Kp) int8;
// wk: (3C, Kp) int8, the weight K-major; scalars: [s_a, c1, 1/s1, s1/s2].
cudaError_t launch_qkv_attention(const void* x, const void* wk, const void* mb,
                                 const float* sp, int8_t* qkv, int8_t* out, const Strides& ost,
                                 int batch, int npad, int kp, int heads, int d, int n_real,
                                 int lis, int lis_fast, int requant_v1, const int* gp,
                                 const AttnPlan& ap, cudaStream_t s) {
  const int c = heads * d, rows = batch * npad;
  const dvt::wg::GemmArgs g{x, wk, rows, 3 * c, kp, gp[0], gp[1], gp[2], gp[3], gp[4], gp[5]};
  cudaError_t err = dvt::wg::gemm(
      g, dvt::QkvOut{static_cast<const float*>(mb), qkv, 3 * c, requant_v1 ? sp + 2 : nullptr},
      s);
  if (err != cudaSuccess) return err;
  const Strides st{(long long)npad * 3 * c, c, d, 3 * c, ost.o_image, ost.o_head, ost.o_row};
  return launch_core(qkv, CoreScalars{sp + 1, sp + 3, sp}, out, batch, heads, npad, d, n_real,
                     lis, lis_fast, st, ap, s);
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
// f32 residual; wp: (H * D, Cout) int8 (the (H, D, Cout) proj weight);
// pvec: (4, Cout) f32 [mult_p, bias_p, s_qact3, s_qact2]; qkv: (B, Npad,
// 3C) and attn: (B, Npad, C) int8 scratch; out: (B, Npad, Cout) f32.
// lis as K8's.  Requires what K8 requires.
extern "C" int dvt_attention_block(const void* x, const void* h, const void* wk,
                                   const void* wp, const void* mb, const void* pvec,
                                   const void* scalars, void* qkv, void* attn, void* out,
                                   int batch, int npad, int kp, int heads, int d, int cout,
                                   int n_real, int lis, int bm, int bn, int blocks, int stages,
                                   int smem, int grid, int a_warps, int a_tiles, int a_split,
                                   int a_smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int c = heads * d, rows = batch * npad;
  int8_t* attn_codes = static_cast<int8_t*>(attn);
  const Strides ost{0, 0, 0, 0, (long long)npad * c, d, c};
  const int gp[6] = {bm, bn, blocks, stages, smem, grid};
  cudaError_t err = launch_qkv_attention(
      x, wk, mb, static_cast<const float*>(scalars), static_cast<int8_t*>(qkv), attn_codes, ost,
      batch, npad, kp, heads, d, n_real, lis, 0, 1, gp,
      AttnPlan{a_warps, a_tiles, a_split, a_smem}, s);
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
                     static_cast<int8_t*>(out), batch, heads, npad, d, n_real, lis, 0, st,
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

// The attention core's footprint for n_real keys, head width d and
// softmax (core_kernel's instance) at `warps` warps and `smem` bytes: registers and local
// memory (spills) a thread, shared memory a block, blocks an SM.
extern "C" int dvt_attention_core_footprint(int n_real, int d, int lis, int warps, int smem,
                                            int* registers, int* local_bytes, int* smem_bytes,
                                            int* blocks_per_sm) {
  return amma::footprint(reinterpret_cast<const void*>(core_kernel(n_real, d, lis)), warps,
                         smem, registers, local_bytes, smem_bytes, blocks_per_sm);
}
