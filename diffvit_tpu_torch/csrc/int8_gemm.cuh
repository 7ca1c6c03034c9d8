// Shared int8 GEMM tile core with a fused epilogue (mma.sync), for the
// kernels in this directory that have not moved to wgmma_gemm.cuh: K7a's
// proj (qkv_attention.cu), and the probes (probes/pingpong.cu, which runs
// the tile inside its own kernel, probes/attn_nv.cu, and
// probes/overlap_mlp.cu, whose dot mode is the same-run yardstick of this
// tile and whose staged and pipelined modes run their own double-buffered
// K loop on int8_gemm_mma_step).  K1's qkv GEMM, K2, K3, K6 and K7b run on
// wgmma_gemm.cuh.
//
// Computes C[M, N] = A[M, K] @ B[K, N] for int8 A and B (B is a weight in
// the JAX package's (Cin, Cout) layout), accumulating exactly in int32 with
// the tensor cores' mma.sync m16n8k32 s8 instruction, and hands every
// accumulator to an epilogue functor ``epi(row, col, acc)`` that
// requantizes and stores it.  The whole epilogue runs on the registers, so
// the int32 product never reaches device memory.
//
// Design (simple first): a 64x64 output tile per block of 4 warps, each warp
// 32x32 (2 x 4 mma tiles); K in steps of 32 through shared memory, with no
// double buffering.  B is transposed into shared memory on the way in
// (mma's B operand wants K contiguous per column).  Rows are padded to 48
// bytes so that the fragment loads are free of bank conflicts.  Two operand
// loaders fill the tiles:
//  * DenseOperands: row-major A and B; the caller guarantees K % 32 == 0,
//    N % 16 == 0 and 16-byte aligned A and B (the probes);
//  * ViewOperands: row-major A with any K, and B read through a BView
//    (pointers and element strides, see below) with any N, so that K1's
//    and K8's weights are read in place; the ragged K and N edges are
//    zero-filled, and a 16-byte chunk is one vector load where it is in
//    range and aligned, else loaded byte by byte (K7a's proj, P1, P5).  Its
//    checks cost a dense caller about 19% (K2 on this tile at DeiT-S
//    b=64, H100 80GB HBM3 at 700 W; PERF.md), so the dense callers keep
//    the first.
// The ragged M edge is zero-filled and masked in both.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "codes.cuh"

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

// Each loader's thread fills one 16-byte chunk of the A tile (row tid/2,
// bytes (tid%2)*16..) and one of the B tile (k-row tid/4, columns
// (tid%4)*16..).  A and B are read with plain loads (no __restrict__).
__device__ __forceinline__ void store_b_chunk(GemmSmem& sm, int c, int kr, int4 v) {
  const int8_t* bytes = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
  for (int i = 0; i < 16; ++i) sm.Bs[c + i][kr] = bytes[i];
}

// Row-major A (M, K) and B (K, N); K % 32 == 0, N % 16 == 0, 16-byte
// aligned.
struct DenseOperands {
  const int8_t* A;
  const int8_t* B;
  int M, N, K;
  struct Thread {};
  __device__ Thread thread(int, int, int) const { return {}; }
  __device__ void load(const Thread&, GemmSmem& sm, int m0, int n0, int k0, int tid) const {
    {  // A tile: 64 rows x 32 bytes
      const int r = tid >> 1, c = (tid & 1) * 16;
      int4 v = make_int4(0, 0, 0, 0);
      if (m0 + r < M)
        v = *reinterpret_cast<const int4*>(A + (size_t)(m0 + r) * K + k0 + c);
      *reinterpret_cast<int4*>(&sm.As[r][c]) = v;
    }
    {  // B tile: 32 k-rows x 64 columns, transposed
      const int kr = tid >> 2, c = (tid & 3) * 16;
      int4 v = make_int4(0, 0, 0, 0);
      if (n0 + c < N)
        v = *reinterpret_cast<const int4*>(B + (size_t)(k0 + kr) * N + n0 + c);
      store_b_chunk(sm, c, kr, v);
    }
  }
};

// B read in place through pointers and element strides: column n is
// n = slot * c + h * dh + d, element (k, n) is at
// base[slot] + h * sh + k * sk + d * sd.  A (K, N) row-major weight is
// base[0] = w, c = dh = N, sh = 0, sk = N, sd = 1; K1's (Cin, 3C) weight
// with its [slot, head, d] columns and K8 v1's three (H, Cin, D) per-head
// tensors are the same view with three slots of H heads.
struct BView {
  const int8_t* base[3];
  long long sh, sk, sd;
  int c, dh;
  __device__ __forceinline__ const int8_t* col(int n) const {
    const int slot = n / c, rem = n - slot * c;
    const int h = rem / dh, d = rem - h * dh;
    return base[slot] + h * sh + d * sd;
  }
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// 16 bytes, byte i from *addr(i) for i < valid and 0 past it (unrolled, so
// that the chunk stays in registers).
template <class Addr>
__device__ __forceinline__ int4 gather16(int valid, const Addr& addr) {
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (i < valid)
      w[i >> 2] |= static_cast<unsigned>(static_cast<uint8_t>(*addr(i))) << (8 * (i & 3));
  return make_int4(static_cast<int>(w[0]), static_cast<int>(w[1]), static_cast<int>(w[2]),
                   static_cast<int>(w[3]));
}

// Row-major A (M, K) with row stride lda, any K; B through a BView, any N.
// thread() works out each thread's addresses once per output tile.
struct ViewOperands {
  const int8_t* A;
  long long lda;
  int M, N, K;
  BView b;
  struct Thread {
    const int8_t* a_row;  // nullptr past M
    const int8_t* b_col;  // column n of the chunk; nullptr past N
    int b_n;              // the chunk's first column
    bool a_vec;           // 16-byte loads of A where in range
    bool b_vec;           // the chunk is one aligned 16-byte run of B
    bool b_run;           // the chunk's columns are contiguous in B
  };
  __device__ Thread thread(int m0, int n0, int tid) const {
    Thread t;
    const int r = m0 + (tid >> 1);
    t.a_row = r < M ? A + r * lda : nullptr;
    t.a_vec = lda % 16 == 0 && aligned16(A);
    t.b_n = n0 + (tid & 3) * 16;
    t.b_col = t.b_n < N ? b.col(t.b_n) : nullptr;
    const int d = t.b_n % b.c % b.dh;
    t.b_run = t.b_col != nullptr && b.sd == 1 && d + 16 <= b.dh;
    t.b_vec = t.b_run && t.b_n + 16 <= N && b.sk % 16 == 0 && aligned16(t.b_col);
    return t;
  }
  __device__ void load(const Thread& t, GemmSmem& sm, int, int, int k0, int tid) const {
    {  // A tile: 64 rows x 32 bytes
      const int r = tid >> 1, c = (tid & 1) * 16, kc = k0 + c;
      int4 v = make_int4(0, 0, 0, 0);
      if (t.a_row != nullptr && kc < K) {
        const int8_t* p = t.a_row + kc;
        if (t.a_vec && kc + 16 <= K)
          v = *reinterpret_cast<const int4*>(p);
        else
          v = gather16(K - kc, [p](int i) { return p + i; });
      }
      *reinterpret_cast<int4*>(&sm.As[r][c]) = v;
    }
    {  // B tile: 32 k-rows x 64 columns, transposed
      const int kr = tid >> 2, c = (tid & 3) * 16, k = k0 + kr;
      int4 v = make_int4(0, 0, 0, 0);
      if (t.b_col != nullptr && k < K) {
        const long long koff = k * b.sk;
        const int8_t* p = t.b_col + koff;
        if (t.b_vec)
          v = *reinterpret_cast<const int4*>(p);
        else if (t.b_run)
          v = gather16(N - t.b_n, [p](int i) { return p + i; });
        else
          v = gather16(N - t.b_n, [&](int i) { return b.col(t.b_n + i) + koff; });
      }
      store_b_chunk(sm, c, kr, v);
    }
  }
};

using GemmAcc = int[2][4][4];

// One K step of 32 from the tiles in `sm` into the warp's 32x32 of `acc`:
// the fragments from shared memory, then 2 x 4 mma.
__device__ __forceinline__ void int8_gemm_mma_step(const GemmSmem& sm, GemmAcc& acc) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  unsigned af[2][4], bf[4][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int r = wm + mi * 16 + g;
    af[mi][0] = *reinterpret_cast<const unsigned*>(&sm.As[r][t * 4]);
    af[mi][1] = *reinterpret_cast<const unsigned*>(&sm.As[r + 8][t * 4]);
    af[mi][2] = *reinterpret_cast<const unsigned*>(&sm.As[r][t * 4 + 16]);
    af[mi][3] = *reinterpret_cast<const unsigned*>(&sm.As[r + 8][t * 4 + 16]);
  }
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int c = wn + ni * 8 + g;
    bf[ni][0] = *reinterpret_cast<const unsigned*>(&sm.Bs[c][t * 4]);
    bf[ni][1] = *reinterpret_cast<const unsigned*>(&sm.Bs[c][t * 4 + 16]);
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) mma_s8_m16n8k32(acc[mi][ni], af[mi], bf[ni]);
}

// The K loop of the output tile at (m0, n0), by the block's kGemmThreads
// threads: the thread's accumulators (zeroed here) end in `acc`.  The last
// use of `sm` is followed by a __syncthreads(), so the caller may reuse `sm`
// at once.
template <class Ops>
__device__ __forceinline__ void int8_gemm_mainloop(const Ops& ops, int m0, int n0,
                                                   GemmAcc& acc, GemmSmem& sm) {
  const int K = ops.K;
  const int tid = threadIdx.x;
  const typename Ops::Thread th = ops.thread(m0, n0, tid);

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;

  for (int k0 = 0; k0 < K; k0 += kGemmBK) {
    ops.load(th, sm, m0, n0, k0, tid);
    __syncthreads();
    int8_gemm_mma_step(sm, acc);
    __syncthreads();
  }
}

// Hands the tile's accumulators to ``epi(row, col, acc)`` for the rows
// below M and the columns below N.  Accumulator fragment: c0,c1 at (g,
// 2t..2t+1), c2,c3 at (g+8, 2t..2t+1).
template <class Epi>
__device__ __forceinline__ void int8_gemm_epilogue(int M, int N, int m0, int n0,
                                                   const GemmAcc& acc, const Epi& epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
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

// The output tile at (m0, n0), by the block's kGemmThreads threads: the K
// loop, then the epilogue on the registers.  The last use of `sm` is
// followed by a __syncthreads(), so the caller may reuse `sm` at once.
template <class Ops, class Epi>
__device__ __forceinline__ void int8_gemm_tile_ops(const Ops& ops, int m0, int n0,
                                                   const Epi& epi, GemmSmem& sm) {
  GemmAcc acc;
  int8_gemm_mainloop(ops, m0, n0, acc, sm);
  int8_gemm_epilogue(ops.M, ops.N, m0, n0, acc, epi);
}

// The tile of row-major A and B (K6).
template <class Epi>
__device__ __forceinline__ void int8_gemm_tile(const int8_t* A, const int8_t* B, int M,
                                               int N, int K, int m0, int n0,
                                               const Epi& epi, GemmSmem& sm) {
  int8_gemm_tile_ops(DenseOperands{A, B, M, N, K}, m0, n0, epi, sm);
}

template <class Ops, class Epi>
__global__ void __launch_bounds__(kGemmThreads) int8_gemm_kernel(Ops ops, Epi epi) {
  __shared__ GemmSmem sm;
  int8_gemm_tile_ops(ops, blockIdx.y * kGemmBM, blockIdx.x * kGemmBN, epi, sm);
}

template <class Ops, class Epi>
inline void launch_int8_gemm_ops(const Ops& ops, Epi epi, cudaStream_t stream) {
  dim3 grid((ops.N + kGemmBN - 1) / kGemmBN, (ops.M + kGemmBM - 1) / kGemmBM);
  int8_gemm_kernel<Ops, Epi><<<grid, kGemmThreads, 0, stream>>>(ops, epi);
}

// The dense GEMM launch of K7b and the probes.
template <class Epi>
inline void launch_int8_gemm(const int8_t* A, const int8_t* B, int M, int N,
                             int K, Epi epi, cudaStream_t stream) {
  launch_int8_gemm_ops(DenseOperands{A, B, M, N, K}, epi, stream);
}

}  // namespace dvt
