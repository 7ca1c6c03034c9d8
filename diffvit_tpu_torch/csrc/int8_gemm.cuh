// Shared int8 GEMM tile core with a fused epilogue, for the kernels in this
// directory (qkv_attention.cu, int_mlp.cu, and resident.cu, whose persistent
// blocks call the tile function for one output tile after another).
//
// Computes C[M, N] = A[M, K] @ B[K, N] for row-major int8 A and B (B is a
// weight in the JAX package's (Cin, Cout) layout), accumulating exactly in
// int32 with the tensor cores' mma.sync m16n8k32 s8 instruction, and hands
// every accumulator to an epilogue functor ``epi(row, col, acc)`` that
// requantizes and stores it.  The whole epilogue runs on the registers, so
// the int32 product never reaches device memory.
//
// Design (simple first): a 64x64 output tile per block of 4 warps, each warp
// 32x32 (2 x 4 mma tiles); K in steps of 32 through shared memory, with no
// double buffering.  B is transposed into shared memory on the way in
// (mma's B operand wants K contiguous per column).  Rows are padded to 48
// bytes so that the fragment loads are free of bank conflicts.  The ragged
// M edge is zero-filled and masked; the caller guarantees K % 32 == 0,
// N % 16 == 0 and 16-byte aligned A and B.  wgmma/TMA pipelining is later
// work.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace dvt {

constexpr int kGemmBM = 64;
constexpr int kGemmBN = 64;
constexpr int kGemmBK = 32;
constexpr int kGemmThreads = 128;
constexpr int kGemmStride = kGemmBK + 16;  // bytes per shared-memory row

__device__ __forceinline__ void mma_s8_m16n8k32(int (&d)[4],
                                                const unsigned (&a)[4],
                                                const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct GemmSmem {
  __align__(16) int8_t As[kGemmBM][kGemmStride];
  __align__(16) int8_t Bs[kGemmBN][kGemmStride];  // Bs[n][k]
};

// The output tile at (m0, n0), by the block's kGemmThreads threads.  A and
// B are read with plain loads (no __restrict__): resident.cu passes
// buffers that the same launch wrote before a grid barrier.  The last use
// of `sm` is followed by a __syncthreads() (the epilogue runs on
// registers), so the caller may reuse `sm` at once.
template <class Epi>
__device__ __forceinline__ void int8_gemm_tile(const int8_t* A, const int8_t* B,
                                               int M, int N, int K, int m0, int n0,
                                               const Epi& epi, GemmSmem& sm) {
  auto& As = sm.As;
  auto& Bs = sm.Bs;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;

  for (int k0 = 0; k0 < K; k0 += kGemmBK) {
    {  // A tile: 64 rows x 32 bytes, 16 bytes per thread
      const int r = tid >> 1, c = (tid & 1) * 16;
      int4 v = make_int4(0, 0, 0, 0);
      if (m0 + r < M)
        v = *reinterpret_cast<const int4*>(A + (size_t)(m0 + r) * K + k0 + c);
      *reinterpret_cast<int4*>(&As[r][c]) = v;
    }
    {  // B tile: 32 k-rows x 64 columns, 16 columns per thread, transposed
      const int kr = tid >> 2, c = (tid & 3) * 16;
      int4 v = make_int4(0, 0, 0, 0);
      if (n0 + c < N)
        v = *reinterpret_cast<const int4*>(B + (size_t)(k0 + kr) * N + n0 + c);
      const int8_t* bytes = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
      for (int i = 0; i < 16; ++i) Bs[c + i][kr] = bytes[i];
    }
    __syncthreads();

    unsigned af[2][4], bf[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int r = wm + mi * 16 + g;
      af[mi][0] = *reinterpret_cast<const unsigned*>(&As[r][t * 4]);
      af[mi][1] = *reinterpret_cast<const unsigned*>(&As[r + 8][t * 4]);
      af[mi][2] = *reinterpret_cast<const unsigned*>(&As[r][t * 4 + 16]);
      af[mi][3] = *reinterpret_cast<const unsigned*>(&As[r + 8][t * 4 + 16]);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int c = wn + ni * 8 + g;
      bf[ni][0] = *reinterpret_cast<const unsigned*>(&Bs[c][t * 4]);
      bf[ni][1] = *reinterpret_cast<const unsigned*>(&Bs[c][t * 4 + 16]);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_s8_m16n8k32(acc[mi][ni], af[mi], bf[ni]);
    __syncthreads();
  }

  // accumulator fragment: c0,c1 at (g, 2t..2t+1), c2,c3 at (g+8, 2t..2t+1)
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + wm + mi * 16 + g + half * 8;
        const int c = n0 + wn + ni * 8 + t * 2;
        if (r < M) {
          if (c < N) epi(r, c, acc[mi][ni][half * 2]);
          if (c + 1 < N) epi(r, c + 1, acc[mi][ni][half * 2 + 1]);
        }
      }
}

template <class Epi>
__global__ void __launch_bounds__(kGemmThreads)
    int8_gemm_kernel(const int8_t* __restrict__ A,
                     const int8_t* __restrict__ B, int M, int N, int K,
                     Epi epi) {
  __shared__ GemmSmem sm;
  int8_gemm_tile(A, B, M, N, K, blockIdx.y * kGemmBM, blockIdx.x * kGemmBN, epi, sm);
}

template <class Epi>
inline void launch_int8_gemm(const int8_t* A, const int8_t* B, int M, int N,
                             int K, Epi epi, cudaStream_t stream) {
  dim3 grid((N + kGemmBN - 1) / kGemmBN, (M + kGemmBM - 1) / kGemmBM);
  int8_gemm_kernel<Epi><<<grid, kGemmThreads, 0, stream>>>(A, B, M, N, K, epi);
}

// clip(v, -128, 127) of an integer-valued float, as int8
__device__ __forceinline__ int8_t clip_i8(float v) {
  return static_cast<int8_t>(fminf(fmaxf(v, -128.f), 127.f));
}

}  // namespace dvt
