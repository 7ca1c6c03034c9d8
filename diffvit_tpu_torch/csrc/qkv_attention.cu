// Fused int8 qkv projection + Log-Int-Softmax attention, and the attention
// core alone, for Hopper.
//
// Replaces two Pallas kernels of diffvit_tpu/ops/pallas/attention.py:
//  * fused_qkv_attention_v2 (K1; body _qkv_attn_kernel_v2, LIS in
//    _lis_body): the qkv GEMM, then the attention core;
//  * fused_int_attention (K5; body _attn_kernel): the attention core alone,
//    on qkv that the caller has projected and requantized (SmoothQuant off),
//    with the slow LIS or, for lis=False, a float softmax rounded to
//    bfloat16.
// One kernel body, attention_core_kernel, serves both: the entries pass
// the element strides of qkv's (image, slot, head, row) axes and of the
// output's (image, head, row) axes, and pointers to the three scalars, whose
// order differs between the two Pallas contracts.  K1 reads its
// (B, Npad, 3C) scratch; K5 reads a strided (B, 3, H, N, D) view of the
// caller's (B, N, 3C) qkv codes with no copy.
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
//     image).  The head's K and V rows (N <= 256) sit in shared memory; each
//     warp takes one query row at a time and holds its whole score row in
//     registers, because LIS quantizes every weight against the final row
//     sum (online rescaling as in flash attention would change the codes).
// K5 is launch 2 alone.
//
// Exactness against the plain PyTorch versions (ops/kernels/attention.py):
//  * built with -fmad=false: every a*b+c rounds twice, as torch does;
//  * rintf rounds half to even, like torch.round;
//  * the LIS row (lis.cuh, shared with swin_attention.cu) is exact: ldexpf
//    and ilogbf for the powers and logs, an int64 row sum;
//  * LIS attn@v accumulates v * 2^(15-code) in int32 (|sum| <= 2^30),
//    exact; the result times 2^-15 is the float attn@v of the reference;
//  * the float softmax (lis=False) is taken in double and rounded once to
//    float, then to bfloat16, and attn@v is summed in double (exact at
//    these exponent spreads) and rounded once: the order of the sums and
//    an ulp of exp in double do not reach the float result, so the codes
//    agree with the plain version in practice (the tolerance is 1 code).
//    The reference takes both in float32.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "int8_gemm.cuh"
#include "lis.cuh"

namespace {

constexpr int kMaxKeys = 256;
constexpr int kMaxHeadDim = 64;
constexpr int kAttnWarps = 4;
constexpr int kQueryTile = 32;
constexpr int kKeysPerLane = kMaxKeys / 32;

struct QkvEpilogue {
  const float* mb;  // (2, 3C): [mult/s1, bias/s1]
  int8_t* out;      // (rows, 3C)
  int n;            // 3C
  __device__ void operator()(int r, int c, int acc) const {
    const float y = static_cast<float>(acc) * mb[c] + mb[n + c];
    out[(size_t)r * n + c] = dvt::clip_i8(rintf(y));
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
  row_max = dvt::warp_max(row_max);
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
union RowWeights {
  int lis[kAttnWarps][kMaxKeys];     // 2^(15 - code)
  float soft[kAttnWarps][kMaxKeys];  // bfloat16-rounded float softmax
};

__global__ void __launch_bounds__(kAttnWarps * 32)
    attention_core_kernel(const int8_t* __restrict__ qkv, CoreScalars sc,
                          int8_t* __restrict__ out, int npad, int d,
                          int n_real, int lis, int lis_fast, Strides st) {
  __shared__ int k_words[kMaxKeys][kMaxHeadDim / 4 + 1];  // +1: no bank conflicts
  __shared__ __align__(16) int8_t v_rows[kMaxKeys][kMaxHeadDim];
  __shared__ RowWeights weights;
  __shared__ int q_words[kAttnWarps][kMaxHeadDim / 4];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kQueryTile;
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
  const dvt::LisConsts lis_k = dvt::lis_consts(s_a);
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
    if (lis)
      dvt::lis_row(a, n_real, lis_k, lis_fast != 0, weights.lis[warp], lane);
    else
      softmax_row_bf16(a, n_real, s_a, weights.soft[warp], lane);
    __syncwarp();

    // attn @ v, requantized onto the qact2 grid
    for (int dd = lane; dd < d; dd += 32) {
      float o;
      if (lis) {
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
      out_bh[i * st.o_row + dd] = dvt::clip_i8(rintf(o * s1_over_s2));
    }
    __syncwarp();
  }
}

cudaError_t launch_core(const int8_t* qkv, CoreScalars sc, int8_t* out,
                        int batch, int heads, int npad, int d, int n_real,
                        int lis, int lis_fast, const Strides& st,
                        cudaStream_t s) {
  dim3 grid((npad + kQueryTile - 1) / kQueryTile, heads, batch);
  attention_core_kernel<<<grid, kAttnWarps * 32, 0, s>>>(
      qkv, sc, out, npad, d, n_real, lis, lis_fast, st);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* dvt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K1.  x: (B, Npad, Cin) int8 LN codes; w: (Cin, 3C) int8; mb: (2, 3C) f32;
// scalars: (4,) f32 [s_a, c1, 1/s1, s1/s2] on the device; qkv: (B, Npad,
// 3C) int8 scratch; out: (B, H, Npad, D) int8.  Requires n_real <= 256,
// D <= 64, D % 4 == 0, Cin % 32 == 0, 3C % 16 == 0 (checked by the Python
// wrapper).
extern "C" int dvt_qkv_attention(const void* x, const void* w, const void* mb,
                                 const void* scalars, void* qkv, void* out,
                                 int batch, int npad, int cin, int heads, int d,
                                 int n_real, int lis_fast, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int c = heads * d;
  QkvEpilogue epi{static_cast<const float*>(mb), static_cast<int8_t*>(qkv), 3 * c};
  dvt::launch_int8_gemm(static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
                        batch * npad, 3 * c, cin, epi, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float* sp = static_cast<const float*>(scalars);
  const Strides st{(long long)npad * 3 * c, c, d, 3 * c,
                   (long long)heads * npad * d, (long long)npad * d, d};
  return launch_core(static_cast<const int8_t*>(qkv), CoreScalars{sp + 1, sp + 3, sp},
                     static_cast<int8_t*>(out), batch, heads, npad, d, n_real,
                     1, lis_fast, st, s);
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
