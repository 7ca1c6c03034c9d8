// Probe P2: does SIMT work overlap tensor-core work in one kernel, and does
// it matter whether the SIMT work consumes the mma result?
//
// Replaces the five Pallas kernels that scripts/overlap_probe.py:70 builds
// (call at :71; bodies k_dot :38, k_vpu :44, k_dot_vpu_consume :49,
// k_dot_vpu_input_join :56, k_dot_vpu_input_split :63; the chain
// _vpu_chain :32).  Every mode writes two (M, N) float32 outputs; y = a @ b
// ((M, K) @ (K, N) bfloat16, float32 accumulation), chain(x) is `iters`
// steps of x = tanh(x) + 0.25 x, and output 2 always depends on v:
//   dot_only         o = y,             o2 = v
//   vpu_only         o = 0,             o2 = chain(v)
//   dot_vpu_consume  o = chain(y),      o2 = v
//   dot_vpu_in_join  o = y + chain(v),  o2 = v
//   dot_vpu_in_split o = y,             o2 = chain(v)
//
// The TPU ran 64 sequential grid steps of 512 rows; here a block of 4
// warps computes a 64x64 tile of both outputs (4,096 blocks at the
// script's 32768 x 512), so the card is full.  The dot is a hand-written
// mma.sync m16n8k16 bf16 loop (K in steps of 32 through shared memory, no
// pipelining); the chain runs on the thread's 32 elements of the tile in
// the accumulator layout, interleaved across them for independent work.
// In the input-rooted modes the chain on v runs before the K loop, so the
// warp has issued it before any mma; in consume it can only follow.
// The chain calls tanhf (CUDA's tanh, within 2 ulp), not tanh.approx.f32,
// which is another function.
//
// What bounds it on the H100: every mode moves v (64 MB) in and two
// outputs (128 MB) out, about 201 MB at 3.35 TB/s (60 us), plus a and b;
// the dot is 17.2 G bf16 operations (17 us at 989 T/s); the chain, which
// has no published rate, is counted as three float32 operations a step
// (tanh as one) at 67 T/s: 165 us at 220 steps over 16.8 M elements.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 32, kThreads = 128;
constexpr int kStride = kBK + 8;  // bf16 per shared row: 80 bytes

enum Mode { kDotOnly = 0, kVpuOnly = 1, kConsume = 2, kInJoin = 3, kInSplit = 4 };

struct Smem {
  __align__(16) __nv_bfloat16 A[kBM][kStride];
  __align__(16) __nv_bfloat16 B[kBN][kStride];  // B[n][k]
};

__device__ __forceinline__ void mma_bf16_m16n8k16(float (&d)[4], const unsigned (&a)[4],
                                                  const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// `iters` steps of x = tanh(x) + 0.25 x on each of the 32 elements, the
// elements innermost so that the chains interleave
__device__ __forceinline__ void chain(float (&x)[32], int iters) {
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int e = 0; e < 32; ++e) x[e] = tanhf(x[e]) + 0.25f * x[e];
}

// Element e = (mi * 4 + ni) * 4 + half * 2 + j of the thread sits at row
// m0 + wm + mi*16 + g + half*8 and column n0 + wn + ni*8 + 2t + j.
template <int M>
__global__ void __launch_bounds__(kThreads)
    overlap_kernel(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
                   const float* __restrict__ v, float* __restrict__ o,
                   float* __restrict__ o2, int n, int k, int iters) {
  __shared__ Smem sm;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  auto at = [&](int e) {
    const int mi = e >> 4, ni = (e >> 2) & 3, half = (e >> 1) & 1;
    return (size_t)(m0 + wm + mi * 16 + g + half * 8) * n + n0 + wn + ni * 8 + 2 * t;
  };

  float vr[32];
#pragma unroll
  for (int e = 0; e < 32; e += 2) {
    const float2 p = *reinterpret_cast<const float2*>(v + at(e));
    vr[e] = p.x;
    vr[e + 1] = p.y;
  }
  float cv[32];
  if constexpr (M == kVpuOnly || M == kInJoin || M == kInSplit) {
#pragma unroll
    for (int e = 0; e < 32; ++e) cv[e] = vr[e];
    chain(cv, iters);
  }

  float y[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) y[e] = 0.f;
  if constexpr (M != kVpuOnly) {
    float acc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;
    for (int k0 = 0; k0 < k; k0 += kBK) {
#pragma unroll
      for (int rep = 0; rep < 2; ++rep) {
        const int ch = tid + rep * kThreads;
        {  // A: 64 rows x 32 bf16, 16-byte chunks
          const int r = ch >> 2, c8 = (ch & 3) * 8;
          *reinterpret_cast<int4*>(&sm.A[r][c8]) =
              *reinterpret_cast<const int4*>(a + (size_t)(m0 + r) * k + k0 + c8);
        }
        {  // B: 32 k-rows x 64 columns, transposed into B[n][k]
          const int kr = ch >> 3, c8 = (ch & 7) * 8;
          const int4 p = *reinterpret_cast<const int4*>(b + (size_t)(k0 + kr) * n + n0 + c8);
          const __nv_bfloat16* pv = reinterpret_cast<const __nv_bfloat16*>(&p);
#pragma unroll
          for (int i = 0; i < 8; ++i) sm.B[c8 + i][kr] = pv[i];
        }
      }
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < kBK; ks += 16) {
        unsigned af[2][4], bf[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int r = wm + mi * 16 + g;
          af[mi][0] = *reinterpret_cast<const unsigned*>(&sm.A[r][ks + 2 * t]);
          af[mi][1] = *reinterpret_cast<const unsigned*>(&sm.A[r + 8][ks + 2 * t]);
          af[mi][2] = *reinterpret_cast<const unsigned*>(&sm.A[r][ks + 2 * t + 8]);
          af[mi][3] = *reinterpret_cast<const unsigned*>(&sm.A[r + 8][ks + 2 * t + 8]);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int c = wn + ni * 8 + g;
          bf[ni][0] = *reinterpret_cast<const unsigned*>(&sm.B[c][ks + 2 * t]);
          bf[ni][1] = *reinterpret_cast<const unsigned*>(&sm.B[c][ks + 2 * t + 8]);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_bf16_m16n8k16(acc[mi][ni], af[mi], bf[ni]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) y[e] = acc[e >> 4][(e >> 2) & 3][e & 3];
  }
  if constexpr (M == kConsume) chain(y, iters);

#pragma unroll
  for (int e = 0; e < 32; e += 2) {
    float2 out, out2;
    if constexpr (M == kInJoin) {
      out = make_float2(y[e] + cv[e], y[e + 1] + cv[e + 1]);
    } else {
      out = make_float2(y[e], y[e + 1]);
    }
    if constexpr (M == kVpuOnly || M == kInSplit) {
      out2 = make_float2(cv[e], cv[e + 1]);
    } else {
      out2 = make_float2(vr[e], vr[e + 1]);
    }
    *reinterpret_cast<float2*>(o + at(e)) = out;
    *reinterpret_cast<float2*>(o2 + at(e)) = out2;
  }
}

}  // namespace

// a: (M, K) bf16; b: (K, N) bf16; v: (M, N) f32; o, o2: (M, N) f32 out.
// mode: 0 dot_only, 1 vpu_only, 2 dot_vpu_consume, 3 dot_vpu_in_join,
// 4 dot_vpu_in_split.  Requires M % 64 == 0, N % 64 == 0, K % 32 == 0
// (checked by the wrapper).
extern "C" int dvt_probe_overlap(const void* a, const void* b, const void* v, void* o,
                                 void* o2, int m, int n, int k, int mode, int iters,
                                 void* stream) {
  dim3 grid(n / kBN, m / kBM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* ap = static_cast<const __nv_bfloat16*>(a);
  const auto* bp = static_cast<const __nv_bfloat16*>(b);
  const auto* vp = static_cast<const float*>(v);
  auto* op = static_cast<float*>(o);
  auto* o2p = static_cast<float*>(o2);
  switch (mode) {
    case kDotOnly: overlap_kernel<kDotOnly><<<grid, kThreads, 0, s>>>(ap, bp, vp, op, o2p, n, k, iters); break;
    case kVpuOnly: overlap_kernel<kVpuOnly><<<grid, kThreads, 0, s>>>(ap, bp, vp, op, o2p, n, k, iters); break;
    case kConsume: overlap_kernel<kConsume><<<grid, kThreads, 0, s>>>(ap, bp, vp, op, o2p, n, k, iters); break;
    case kInJoin: overlap_kernel<kInJoin><<<grid, kThreads, 0, s>>>(ap, bp, vp, op, o2p, n, k, iters); break;
    case kInSplit: overlap_kernel<kInSplit><<<grid, kThreads, 0, s>>>(ap, bp, vp, op, o2p, n, k, iters); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
