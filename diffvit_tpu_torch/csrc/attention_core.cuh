// The attention core shared by K1, K5, K7a and K8 (qkv_attention.cu) and
// by the resident encoder (resident.cu): for one (image, head, tile of 32 query
// rows), integer scores, the Log-Int-Softmax or the float softmax, attn@v
// and the requant onto the qact2 grid.  Also the qkv GEMM's requant
// epilogue.  Kept in one place so that the kernels cannot drift apart.
//
// The head's K and V rows (N <= 256) sit in shared memory; each warp takes
// one query row at a time and holds its whole score row in registers,
// because LIS quantizes every weight against the final row sum (online
// rescaling as in flash attention would change the codes).
//
// Exactness against the plain PyTorch versions (ops/kernels/attention.py):
//  * built with -fmad=false: every a*b+c rounds twice, as torch does;
//  * rintf rounds half to even, like torch.round;
//  * the LIS row (lis.cuh) is exact; attn@v accumulates v * 2^(15-code) in
//    int32 (|sum| <= 2^30), and the result times 2^-15 is the float attn@v
//    of the reference;
//  * the float softmax (lis=0) is taken in double and rounded once to
//    float, then to bfloat16, and attn@v is summed in double (exact at
//    these exponent spreads) and rounded once.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "int8_gemm.cuh"
#include "lis.cuh"

namespace dvt {

constexpr int kMaxKeys = 256;
constexpr int kMaxHeadDim = 64;
constexpr int kAttnWarps = 4;
constexpr int kQueryTile = 32;
constexpr int kKeysPerLane = kMaxKeys / 32;

// The qkv GEMM's epilogue, in one of two requant orders: K1's
// rint(acc * mult/s1 + bias/s1) (mb folded by the wrapper, s1_inv null),
// or K8's (the Pallas v1, v3-v5) rint((acc * mult + bias) * (1/s1)),
// clipped to int8.
struct QkvEpilogue {
  const float* mb;      // (2, 3C): [mult/s1, bias/s1], or [mult, bias]
  int8_t* out;          // (rows, 3C)
  int n;                // 3C
  const float* s1_inv = nullptr;  // device scalar 1/s1 for K8's order
  __device__ void operator()(int r, int c, int acc) const {
    float y = static_cast<float>(acc) * mb[c] + mb[n + c];
    if (s1_inv != nullptr) y = y * *s1_inv;
    out[(size_t)r * n + c] = clip_i8(rintf(y));
  }
};

struct Strides {
  long long q_image, q_slot, q_head, q_row;  // qkv, in elements
  long long o_image, o_head, o_row;          // out, in elements
};

// Device pointers to the core's three scalars.
struct CoreScalars {
  const float* c1;          // s1^2 * attn_scale / s_a
  const float* s1_over_s2;  // qact1 -> qact2 grid
  const float* s_a;         // softmax scale (qact_attn1)
};

__device__ __forceinline__ double warp_sum_d(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Float softmax of the float32 logits a[u] * s_a over the keys below n_keys
// (lane `lane` holds key lane + 32u), taken in double, rounded to float and
// then to bfloat16: weights[j] for j < n_keys.
template <int KeysPerLane>
__device__ __forceinline__ void softmax_row_bf16(const float (&a)[KeysPerLane],
                                                 int n_keys, float s_a,
                                                 float* weights, int lane) {
  float x[KeysPerLane];
  float row_max = -INFINITY;
#pragma unroll
  for (int u = 0; u < KeysPerLane; ++u) {
    x[u] = a[u] * s_a;
    if (lane + 32 * u < n_keys) row_max = fmaxf(row_max, x[u]);
  }
  row_max = warp_max(row_max);
  double e[KeysPerLane];
  double part = 0.0;
#pragma unroll
  for (int u = 0; u < KeysPerLane; ++u) {
    e[u] = (lane + 32 * u < n_keys) ? exp((double)x[u] - (double)row_max) : 0.0;
    part += e[u];
  }
  const double sum = warp_sum_d(part);
#pragma unroll
  for (int u = 0; u < KeysPerLane; ++u) {
    const int j = lane + 32 * u;
    if (j < n_keys)
      weights[j] = __bfloat162float(__float2bfloat16_rn(__double2float_rn(e[u] / sum)));
  }
}

// One score row's weights per warp, by softmax branch.
template <int Warps, int Keys>
union RowWeightsT {
  int lis[Warps][Keys];     // 2^(15 - code)
  float soft[Warps][Keys];  // bfloat16-rounded float softmax
};
using RowWeights = RowWeightsT<kAttnWarps, kMaxKeys>;

struct AttnSmem {
  int k_words[kMaxKeys][kMaxHeadDim / 4 + 1];  // +1: no bank conflicts
  __align__(16) int8_t v_rows[kMaxKeys][kMaxHeadDim];
  RowWeights weights;
  int q_words[kAttnWarps][kMaxHeadDim / 4];
};

// The weight rules of the attention core: the LIS (lis = 1) or the float
// softmax (lis = 0), which K1, K5, K6, K7a and K8 run; or the probe rule
// w = a * 2^-7 (probes/attn_nv.cu), kept as the integer a.
enum WeightRule { kRuleLisOrSoftmax = 0, kRuleLinear = 1 };

// The query rows q0 .. q0+31 (below npad) of head h of image b, by the
// block's kAttnWarps warps.  qkv is read with plain loads (resident.cu
// passes a buffer that the same launch wrote); keys at or past n_real are
// masked.  Ends with a __syncthreads(), so the caller may reuse `sm`.
template <int Rule = kRuleLisOrSoftmax>
__device__ __forceinline__ void attention_item(const int8_t* qkv, const CoreScalars& sc,
                                               int8_t* out, int npad, int d,
                                               int n_real, int lis, int lis_fast,
                                               const Strides& st, int b, int h,
                                               int q0, AttnSmem& sm) {
  auto& k_words = sm.k_words;
  auto& v_rows = sm.v_rows;
  auto& weights = sm.weights;
  auto& q_words = sm.q_words;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int words = d / 4;
  const int8_t* base = qkv + b * st.q_image + h * st.q_head;

  for (int idx = threadIdx.x; idx < n_real * words; idx += blockDim.x) {
    const int j = idx / words, w = idx % words;
    const int8_t* row = base + j * st.q_row + 4 * w;
    k_words[j][w] = *reinterpret_cast<const int*>(row + st.q_slot);
    *reinterpret_cast<int*>(&v_rows[j][4 * w]) =
        *reinterpret_cast<const int*>(row + 2 * st.q_slot);
  }
  __syncthreads();

  const float c1 = *sc.c1, s1_over_s2 = *sc.s1_over_s2, s_a = *sc.s_a;
  const LisConsts lis_k = lis_consts(s_a);
  int8_t* out_bh = out + b * st.o_image + h * st.o_head;

  const int q_end = min(q0 + kQueryTile, npad);
  for (int i = q0 + warp; i < q_end; i += kAttnWarps) {
    if (lane < words)
      q_words[warp][lane] =
          *reinterpret_cast<const int*>(base + i * st.q_row + 4 * lane);
    __syncwarp();

    // scores -> qact_attn1 codes, then the softmax weights of the row
    float a[kKeysPerLane];
#pragma unroll
    for (int u = 0; u < kKeysPerLane; ++u) {
      const int j = lane + 32 * u;
      a[u] = 0.f;
      if (j < n_real) {
        int s = 0;
        for (int w = 0; w < words; ++w) s = __dp4a(q_words[warp][w], k_words[j][w], s);
        a[u] = fminf(fmaxf(rintf(static_cast<float>(s) * c1), -128.f), 127.f);
      }
    }
    if constexpr (Rule == kRuleLinear) {
#pragma unroll
      for (int u = 0; u < kKeysPerLane; ++u)
        if (lane + 32 * u < n_real) weights.lis[warp][lane + 32 * u] = static_cast<int>(a[u]);
    } else if (lis) {
      lis_row(a, n_real, lis_k, lis_fast != 0, weights.lis[warp], lane);
    } else {
      softmax_row_bf16(a, n_real, s_a, weights.soft[warp], lane);
    }
    __syncwarp();

    // attn @ v, requantized onto the qact2 grid
    for (int dd = lane; dd < d; dd += 32) {
      float o;
      if constexpr (Rule == kRuleLinear) {
        // sum of a * v in int32 (|sum| < 2^22), times 2^-7: exact, as the
        // float32 sum of the bfloat16 products a * 2^-7 * v is
        int acc = 0;
        for (int j = 0; j < n_real; ++j) acc += weights.lis[warp][j] * v_rows[j][dd];
        o = static_cast<float>(acc) * 0x1p-7f;
      } else if (lis) {
        int acc = 0;
        for (int j = 0; j < n_real; ++j) acc += weights.lis[warp][j] * v_rows[j][dd];
        o = static_cast<float>(acc) * 0x1p-15f;
      } else {
        // products of a bfloat16 and an int8 are exact, and so is their
        // double sum at these exponent spreads: one rounding, to float
        double acc = 0.0;
        for (int j = 0; j < n_real; ++j)
          acc += (double)weights.soft[warp][j] * (double)v_rows[j][dd];
        o = __double2float_rn(acc);
      }
      out_bh[i * st.o_row + dd] = clip_i8(rintf(o * s1_over_s2));
    }
    __syncwarp();
  }
  __syncthreads();
}

}  // namespace dvt
