// Fused int8 qkv projection + Log-Int-Softmax attention for Hopper.
//
// Replaces the Pallas kernel diffvit_tpu/ops/pallas/attention.py::
// fused_qkv_attention_v2 (body _qkv_attn_kernel_v2, LIS in _lis_body).
//
// What bounds it on the H100: the qkv GEMM, (B*N, C) @ (C, 3C) in int8, is
// ~70% of the block's attention MACs and is tensor-core work; the
// attention core is small integer/float work per (query, key) pair (scores
// over D=64, the LIS integer exponent, one IEEE division, attn@v over the
// keys) whose operands fit in shared memory.  Device memory sees only the
// int8 LN codes, the int8 weight, the int8 qkv scratch and the int8
// output: the (N, N) scores and weights never leave the SM.
//
// Design, two launches:
//  1. The int8 GEMM core (int8_gemm.cuh) with the epilogue
//     rint(acc * mb0 + mb1) clipped to int8, into a (B, Npad, 3C) int8
//     scratch — mb = [mult/s1, bias/s1] as the wrapper folds it.
//  2. One block per (query tile of 32 rows, head, image).  The head's K and
//     V rows (N <= 256) sit in shared memory; each warp takes one query row
//     at a time and holds its whole score row in registers, because LIS
//     quantizes every weight against the final row sum (online rescaling
//     as in flash attention would change the codes).
//
// Exactness against the plain PyTorch version (ops/kernels/attention.py):
//  * built with -fmad=false: every a*b+c rounds twice, as torch does;
//  * rintf rounds half to even, like torch.round;
//  * the LIS row (lis.cuh, shared with swin_attention.cu) is exact: ldexpf
//    and ilogbf for the powers and logs, an int64 row sum;
//  * attn@v accumulates v * 2^(15-code) in int32 (|sum| <= 2^30), exact;
//    the result times 2^-15 is the float attn@v of the reference.
#include <cstdint>
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

// qkv: (B, Npad, 3C) int8 with columns [slot, head, d]; out: (B, H, Npad, D)
__global__ void __launch_bounds__(kAttnWarps * 32)
    lis_attention_kernel(const int8_t* __restrict__ qkv,
                         const float* __restrict__ scalars,
                         int8_t* __restrict__ out, int npad, int c, int heads,
                         int d, int n_real, int lis_fast) {
  __shared__ int k_words[kMaxKeys][kMaxHeadDim / 4 + 1];  // +1: no bank conflicts
  __shared__ __align__(16) int8_t v_rows[kMaxKeys][kMaxHeadDim];
  __shared__ int weights[kAttnWarps][kMaxKeys];
  __shared__ int q_words[kAttnWarps][kMaxHeadDim / 4];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kQueryTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int words = d / 4;
  const size_t row_stride = 3 * (size_t)c;
  const int8_t* base = qkv + (size_t)b * npad * row_stride;

  for (int idx = threadIdx.x; idx < n_real * words; idx += blockDim.x) {
    const int j = idx / words, w = idx % words;
    const int8_t* row = base + j * row_stride + h * d + 4 * w;
    k_words[j][w] = *reinterpret_cast<const int*>(row + c);
    *reinterpret_cast<int*>(&v_rows[j][4 * w]) =
        *reinterpret_cast<const int*>(row + 2 * c);
  }
  __syncthreads();

  // scalars = [s_a, c1, 1/s1, s1/s2]
  const float c1 = scalars[1], s1_over_s2 = scalars[3];
  const dvt::LisConsts lis = dvt::lis_consts(scalars[0]);

  const int q_end = min(q0 + kQueryTile, npad);
  for (int i = q0 + warp; i < q_end; i += kAttnWarps) {
    if (lane < words)
      q_words[warp][lane] =
          *reinterpret_cast<const int*>(base + i * row_stride + h * d + 4 * lane);
    __syncwarp();

    // scores -> qact_attn1 codes, then the LIS weights of the row
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
    dvt::lis_row(a, n_real, lis, lis_fast != 0, weights[warp], lane);
    __syncwarp();

    // attn @ v, requantized onto the qact2 grid
    for (int dd = lane; dd < d; dd += 32) {
      int acc = 0;
      for (int j = 0; j < n_real; ++j) acc += weights[warp][j] * v_rows[j][dd];
      const float o = rintf(static_cast<float>(acc) * 0x1p-15f * s1_over_s2);
      out[(((size_t)b * heads + h) * npad + i) * d + dd] = dvt::clip_i8(o);
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" const char* dvt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: (B, Npad, Cin) int8 LN codes; w: (Cin, 3C) int8; mb: (2, 3C) f32;
// scalars: (4,) f32 on the device; qkv: (B, Npad, 3C) int8 scratch;
// out: (B, H, Npad, D) int8.  Requires n_real <= 256, D <= 64, D % 4 == 0,
// Cin % 32 == 0, 3C % 16 == 0 (checked by the Python wrapper).
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
  dim3 grid((npad + kQueryTile - 1) / kQueryTile, heads, batch);
  lis_attention_kernel<<<grid, kAttnWarps * 32, 0, s>>>(
      static_cast<const int8_t*>(qkv), static_cast<const float*>(scalars),
      static_cast<int8_t*>(out), npad, c, heads, d, n_real, lis_fast);
  return cudaGetLastError();
}
