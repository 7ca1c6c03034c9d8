// K1's two launches: the qkv GEMM with its requant epilogue on
// wgmma_gemm.cuh, then the attention core on attention_mma.cuh, a block per
// (image, head, run of query tiles of 16).  Shared by K1, K5, K7a and K8
// (qkv_attention.cu) and by probe P5 (probes/attn_nv.cu), which runs the
// same two launches with the core's weight rule switched to the linear
// w = a * 2^-7, so that K1's time minus P5's is the LIS step alone.
//
// The core's instance is chosen by the keys (224 or 256 at most: 7 or 8
// blocks of attn@v; past 256, the LIS alone, attend_rows_long up to
// kLongMaxKeys), the head width (32 or 64 at most) and the weight rule
// (attention_mma.cuh's Weight); the entries pass the plan of
// ops/kernels/attn_plan.attention_plan, which launch_core checks.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "attention_core.cuh"
#include "attention_mma.cuh"
#include "wgmma_gemm.cuh"

namespace dvt {
namespace qkv {

using amma::Weight;

constexpr int kMaxKB = 8;     // 256 keys (attention.py's MAX_KEYS)
constexpr int kMidKB = 7;     // 224 keys (DeiT's 197): 7 blocks of attn@v, not 8
constexpr int kLongKB = 0;    // past 256 keys: attend_rows_long, no packed scores
constexpr int kQkvWarps = 7;  // warps a block at most (attn_plan.QKV_MAX_WARPS)
// a warp's shared memory: its packed scores (the LIS, the linear rule) or
// the float softmax's buffers
constexpr int kCodeBytes = amma::PackedScores<8 * kMaxKB>::kBytes;

__host__ __device__ inline int warp_scratch(Weight w, int n_real) {
  if (n_real > 32 * kMaxKB) return 0;  // attend_rows_long keeps no scores
  return w != Weight::kSoftmax ? kCodeBytes : amma::soft_bytes(32 * kMaxKB, 1);
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
// as 8 warps'); the float softmax's double sums take more.  The linear
// rule takes the LIS's footprint and no exponential table.  Past 256 keys
// (MaxKB kLongKB, the LIS only) two blocks an SM: the keys and values of
// 577 take 88 KB.
template <int MaxKB, int DP, Weight W>
__global__ void __launch_bounds__(kQkvWarps * 32,
                                  W == Weight::kSoftmax ? 1 : (MaxKB == kLongKB ? 2 : 3))
    qkv_core_kernel(const int8_t* __restrict__ qkv, CoreScalars sc,
                    int8_t* __restrict__ out, int npad, int d, int n_real, int lis_fast,
                    int lis_wide, Strides st, int tiles) {
  extern __shared__ __align__(16) uint8_t attn_smem[];
  const int bx = blockIdx.x, b = blockIdx.z, h = blockIdx.y;
  const amma::KvGeom g = amma::kv_geom(n_real, d, W != Weight::kSoftmax);
  const float s_a = *sc.s_a;
  const amma::ExpTable et =
      W == Weight::kLinear
          ? amma::ExpTable{}
          : amma::fill_exp_table(attn_smem, dvt::lis_consts(s_a, lis_wide != 0), lis_fast != 0);
  uint8_t* const kv = attn_smem + amma::kExpBytes;
  const int8_t* base = qkv + b * st.q_image + h * st.q_head;
  amma::stage_kv(base + st.q_slot, base + 2 * st.q_slot, st.q_row, n_real, d, g, kv);
  __syncthreads();

  const amma::SoftArgs a{n_real, d, et, s_a, *sc.s1_over_s2};
  const amma::QkvChain chain{*sc.c1, 0.f};
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  uint8_t* scratch = kv + g.bytes() + warp * warp_scratch(W, n_real);
  int8_t* out_bh = out + b * st.o_image + h * st.o_head;
  const int q_tiles = (npad + amma::kRows - 1) / amma::kRows;
  const int t1 = min((bx + 1) * tiles, q_tiles);
  for (int tile = bx * tiles + warp; tile < t1; tile += warps) {
    const int q0 = tile * amma::kRows;
    const amma::RowTile rt{base + q0 * st.q_row, st.q_row, out_bh + q0 * st.o_row, st.o_row,
                           min(amma::kRows, npad - q0)};
    if constexpr (MaxKB == kLongKB)
      amma::attend_rows_long<DP>(rt, kv, g, a, chain);
    else
      amma::attend_rows<MaxKB, DP, W>(rt, kv, g, a, chain, scratch);
  }
}

// Dynamic shared memory the core needs (attn_plan.py's core_smem).
inline int core_smem(int n_real, int d, Weight w, int warps) {
  return amma::kExpBytes + amma::kv_geom(n_real, d, w != Weight::kSoftmax).bytes() +
         warps * warp_scratch(w, n_real);
}

using CoreKernel = void (*)(const int8_t*, CoreScalars, int8_t*, int, int, int, int, int,
                           Strides, int);

// The core's instance for n_real keys (224 or 256 at most; past 256, the
// LIS's long rows) and head width d (32 or 64 at most).
template <Weight W>
inline CoreKernel core_kernel(int n_real, int d) {
  const bool mid = n_real <= 32 * kMidKB, narrow = d <= 32;
  if constexpr (W == Weight::kLis)
    if (n_real > 32 * kMaxKB)
      return narrow ? qkv_core_kernel<kLongKB, 32, W> : qkv_core_kernel<kLongKB, 64, W>;
  return mid ? (narrow ? qkv_core_kernel<kMidKB, 32, W> : qkv_core_kernel<kMidKB, 64, W>)
             : (narrow ? qkv_core_kernel<kMaxKB, 32, W> : qkv_core_kernel<kMaxKB, 64, W>);
}

// The core on qkv codes at strides `st` into `out`; lis_wide: the LIS's
// 128-bit row sum.
template <Weight W>
inline cudaError_t launch_core(const int8_t* qkv, CoreScalars sc, int8_t* out, int batch,
                               int heads, int npad, int d, int n_real, int lis_wide,
                               int lis_fast, const Strides& st, const AttnPlan& p,
                               cudaStream_t s) {
  const int q_tiles = (npad + amma::kRows - 1) / amma::kRows;
  if (p.warps < 1 || p.warps > kQkvWarps || p.tiles < 1 ||
      p.split * p.tiles < q_tiles || p.smem < core_smem(n_real, d, W, p.warps) ||
      n_real > (W == Weight::kLis ? amma::kLongMaxKeys : 32 * kMaxKB) || d > 64)
    return cudaErrorInvalidValue;
  const CoreKernel kernel = core_kernel<W>(n_real, d);
  cudaError_t err = amma::allow_smem(reinterpret_cast<const void*>(kernel), p.smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.split, heads, batch), 32 * p.warps, p.smem, s>>>(qkv, sc, out, npad, d, n_real,
                                                                   lis_fast, lis_wide, st,
                                                                   p.tiles);
  return cudaGetLastError();
}

// The qkv GEMM (plan gp: gemm_plan's numbers) with its requant epilogue
// into the (B*Npad, 3C) scratch, then the attention core into `out` at the
// output strides (o_image, o_head, o_row) of `ost`.  x: (B*Npad, Kp) int8;
// wk: (3C, Kp) int8, the weight K-major; scalars: [s_a, c1, 1/s1, s1/s2].
template <Weight W>
inline cudaError_t launch_qkv_attention(const void* x, const void* wk, const void* mb,
                                        const float* sp, int8_t* qkv, int8_t* out,
                                        const Strides& ost, int batch, int npad, int kp,
                                        int heads, int d, int n_real, int lis_wide,
                                        int lis_fast, int requant_v1, const int* gp,
                                        const AttnPlan& ap, cudaStream_t s) {
  const int c = heads * d, rows = batch * npad;
  const wg::GemmArgs g{x, wk, rows, 3 * c, kp, gp[0], gp[1], gp[2], gp[3], gp[4], gp[5]};
  cudaError_t err = wg::gemm(
      g, QkvOut{static_cast<const float*>(mb), qkv, 3 * c, requant_v1 ? sp + 2 : nullptr}, s);
  if (err != cudaSuccess) return err;
  const Strides st{(long long)npad * 3 * c, c, d, 3 * c, ost.o_image, ost.o_head, ost.o_row};
  return launch_core<W>(qkv, CoreScalars{sp + 1, sp + 3, sp}, out, batch, heads, npad, d,
                        n_real, lis_wide, lis_fast, st, ap, s);
}

}  // namespace qkv
}  // namespace dvt
