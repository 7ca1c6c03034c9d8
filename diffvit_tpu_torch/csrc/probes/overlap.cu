// Probe P2: does SIMT work overlap tensor-core work in one kernel, and does
// it matter whether the SIMT work consumes the product?
//
// Replaces the five Pallas kernels that scripts/overlap_probe.py:71
// `build` makes (bodies k_dot :38, k_vpu :44, k_dot_vpu_consume :49,
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
// What bounds it on the H100: every mode moves v (64 MB at the script's
// 32768 x 512) in and o and o2 (128 MB) out, 201 of dot_only's 235 MB
// (70 us at 3.35 TB/s); the dot is 17.2 G bf16 operations (17 us at 989
// T/s).  A chain step is CUDA's accurate tanhf: two special-function
// (MUFU) results and a dozen float32 instructions (counted in this
// library's SASS by overlap.chain_instructions), so the chain modes are
// bound by the special-function units, 16 results a clock an SM.
//
// Design, the served GEMMs' Hopper shape (wgmma_gemm.cuh's roles and ring,
// its TMA, barrier and descriptor helpers; the bf16 instruction, B's
// descriptor and the epilogue are this file's):
//  * A (M, K) and B (K, N) reach shared memory by TMA, 64 K (128 bytes of
//    bf16) a stage, with the 128-byte swizzle, through a ring of
//    mbarrier-guarded stages (overlap_plan's count).  One producer thread
//    issues the loads; two consumer warpgroups each issue wgmma.mma_async
//    m64n64k16 f32.bf16.bf16 on 64 rows of a 128 x 64 output tile, both
//    operands in shared memory.  B is read as it lies, N-major: for 16-bit
//    operands wgmma has the transpose bit (imm-trans-b), so B needs no
//    K-major copy and no transpose in shared memory.  Blocks are
//    persistent over the output tiles (n fastest), two an SM as K2's, with
//    setmaxnreg's moves as the served kernel makes them (24 registers a
//    producer thread, 104 a consumer's: 32 accumulators and 32 elements of
//    v or of the chain, no spill).
//  * v streams through registers in 16-byte vectors (__ldcs, evict-first):
//    a consumer loads its tile's v (8 float4 a thread) before it issues
//    the products, so the loads are in flight while the wgmma run.  o is
//    staged through shared memory 32 columns (128 bytes) at a time, two
//    buffers in turn, and stored, with o2, as 16-byte vectors (__stcs),
//    consecutive threads on consecutive addresses.  Rows past M are
//    neither loaded nor stored; TMA's zero fill covers A's and B's edges.
//  * The chain, where the question lives, runs on the consumer warpgroups
//    themselves (not on warps of their own): in the input-rooted modes
//    (in_join, in_split) a slice of its steps runs after each stage's
//    wgmma.commit_group and before its wgmma.wait_group, so the SIMT work
//    is issued while the products are in flight; in consume it can only
//    follow the last wait_group, on the accumulators; vpu_only runs it
//    with no products.  One role keeps the chain beside the products it
//    is to overlap (in the same warps, as the TPU's one core did) and
//    needs no second barrier protocol; chain warps of their own would
//    measure two roles' sharing of an SM, which P1 already measures.
//    The chain calls tanhf (CUDA's tanh, within 2 ulp), not
//    tanh.approx.f32, which is another function; the library is built with
//    -fmad=false, so x = tanhf(x) + 0.25 x rounds as the plain version's.
//  * The tile, stages, shared memory, grid and register split come from
//    ops/kernels/overlap_plan.py (overlap_plan), plain Python.
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "probe_launch.cuh"
#include "wgmma_gemm.cuh"

namespace {

namespace wg = dvt::wg;

enum Mode { kDotOnly = 0, kVpuOnly = 1, kConsume = 2, kInJoin = 3, kInSplit = 4 };
constexpr int kBM = 128, kBN = 64;  // the output tile; a consumer warpgroup takes 64 rows
constexpr int kBlocks = 2;          // blocks an SM (overlap_plan.BLOCKS)
constexpr int kKStage = wg::kBK / 2;  // K a stage: one 128-byte swizzle row of bf16
constexpr int kChunk = 32;            // columns a staging chunk: 128 bytes of float32

// wgmma descriptor of B's stage, N-major with the 128-byte swizzle: a K row
// of 64 N (128 bytes), 8-row groups 1024 bytes apart (the stride offset,
// from K row 0-7 to 8-15 of a k16 step).  The leading offset would step to
// the next 64 N; a 64-wide tile has one, and it is given the same 1024.
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr) {
  return wg::smem_desc(addr) | (static_cast<uint64_t>(1024 >> 4) << 16);
}

// D[64 x 64] += A[64 x 16] @ B[16 x 64] (bf16 x bf16 -> f32), A K-major and
// B N-major (imm-trans-b = 1) in shared memory; d holds 32 accumulators a
// thread, at row 16 * warp + g (+ 8 for i % 4 >= 2), column 8 * (i / 4) +
// 2 * q + i % 2 of the 64 x 64 tile.
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17,"
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void fence_f(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// `iters` steps of x = tanh(x) + 0.25 x on each of the 32 elements, the
// elements innermost so that the chains interleave; the step loop is not
// unrolled, so that its body in the SASS is 32 steps (chain_instructions).
__device__ __forceinline__ void chain(float (&x)[32], int iters) {
#pragma unroll 1
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int e = 0; e < 32; ++e) x[e] = tanhf(x[e]) + 0.25f * x[e];
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Element 4 * (4 * ch + u) + l of a consumer thread's v (x below) sits at
// row vr + 16 u and column 32 ch + 4 vx + l of its 64 x 64 part of the
// tile, vr = t / 8 and vx = t % 8: the layout in which it reads a staged
// chunk of o back, so that v, chain(v) and y meet element for element.
template <int M>
__global__ void __launch_bounds__(wg::kThreads, kBlocks)
    overlap_kernel(const __grid_constant__ CUtensorMap tma_a,
                   const __grid_constant__ CUtensorMap tma_b, const float* __restrict__ v,
                   float* __restrict__ o, float* __restrict__ o2, int m, int n, int k, int iters,
                   int stages) {
  constexpr bool kDot = M != kVpuOnly;
  constexpr bool kChainV = M == kVpuOnly || M == kInJoin || M == kInSplit;
  extern __shared__ uint8_t overlap_smem[];
  const wg::Ring ring = wg::ring_layout(overlap_smem, kBM * wg::kBK, kBN * wg::kBK, stages);
  wg::ring_init(ring);
  __syncthreads();
  const int tiles_n = (n + kBN - 1) / kBN;
  const int tiles = (m + kBM - 1) / kBM * tiles_n;
  const int k_tiles = (k + kKStage - 1) / kKStage;

  if (threadIdx.x < 128) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(wg::kProducerRegs<kBlocks>));
    if (kDot && threadIdx.x == 0) {
      wg::RingPos pos{0, 0};
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / tiles_n * kBM, n0 = tile % tiles_n * kBN;
        for (int kt = 0; kt < k_tiles; ++kt) {
          const int s = pos.stage;
          wg::mbar_wait(ring.empty + 8 * s, pos.phase ^ 1);
          wg::mbar_expect_tx(ring.full + 8 * s, (kBM + kBN) * wg::kBK);
          // A's box at (K byte, row), B's at (N byte, K row)
          wg::tma_load_2d(ring.a + s * ring.a_slot, &tma_a, kt * wg::kBK, m0, ring.full + 8 * s);
          wg::tma_load_2d(ring.b + s * ring.b_slot, &tma_b, 2 * n0, kt * kKStage,
                          ring.full + 8 * s);
          pos.next(ring.stages);
        }
      }
    }
  } else {  // two consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(wg::kConsumerRegs<kBlocks>));
    const int c = threadIdx.x / 128 - 1, t = threadIdx.x % 128;
    const int warp = t / 32, g = t % 32 / 4, q = t % 4, vr = t / 8, vx = t % 8;
    uint8_t* const st = ring.staging + c * 2 * 64 * wg::kPitch;
    int buf = 0;  // the staging buffer next in turn
    wg::RingPos pos{0, 0};
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / tiles_n * kBM + 64 * c, n0 = tile % tiles_n * kBN;
      float x[32];  // v, then chain(v) in the input-rooted modes
#pragma unroll
      for (int ch = 0; ch < 2; ++ch)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int r = m0 + vr + 16 * u;
          const float4 p = r < m ? __ldcs(reinterpret_cast<const float4*>(
                                       v + static_cast<size_t>(r) * n + n0 + kChunk * ch + 4 * vx))
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
          float* xe = x + 4 * (4 * ch + u);
          xe[0] = p.x;
          xe[1] = p.y;
          xe[2] = p.z;
          xe[3] = p.w;
        }
      auto store4 = [&](float* out, int ch, int u, float4 val) {
        const int r = m0 + vr + 16 * u;
        if (r < m)
          __stcs(reinterpret_cast<float4*>(out + static_cast<size_t>(r) * n + n0 + kChunk * ch +
                                           4 * vx),
                 val);
      };
      auto x4 = [&](int ch, int u) {
        const float* xe = x + 4 * (4 * ch + u);
        return make_float4(xe[0], xe[1], xe[2], xe[3]);
      };

      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      if constexpr (kDot) {
        for (int kt = 0; kt < k_tiles; ++kt) {
          const int s = pos.stage;
          wg::mbar_wait(ring.full + 8 * s, pos.phase);
          const uint32_t a = ring.a + s * ring.a_slot + 64 * c * wg::kBK;
          const uint32_t b = ring.b + s * ring.b_slot;
#pragma unroll
          for (int i = 0; i < 32; ++i) fence_f(acc[i]);
          wg::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kKStage / 16; ++kk)  // A: 32 bytes a k16 step; B: 16 K rows
            wgmma_bf16(acc, wg::smem_desc(a + 32 * kk), desc_mn(b + 16 * 128 * kk));
          wg::wgmma_commit();
          if constexpr (M == kInJoin) {
            if (kt == 0) {  // o2 = v, before the chain takes x over
#pragma unroll
              for (int ch = 0; ch < 2; ++ch)
#pragma unroll
                for (int u = 0; u < 4; ++u) store4(o2, ch, u, x4(ch, u));
            }
          }
          if constexpr (kChainV)  // this stage's share of the steps, under its wgmma
            chain(x, iters * (kt + 1) / k_tiles - iters * kt / k_tiles);
          wg::wgmma_wait_all();
#pragma unroll
          for (int i = 0; i < 32; ++i) fence_f(acc[i]);
          if (t == 0) wg::mbar_arrive(ring.empty + 8 * s);
          pos.next(ring.stages);
        }
        if (k_tiles == 0) {  // K = 0: y = 0, and the chain still runs
          if constexpr (M == kInJoin) {
#pragma unroll
            for (int ch = 0; ch < 2; ++ch)
#pragma unroll
              for (int u = 0; u < 4; ++u) store4(o2, ch, u, x4(ch, u));
          }
          if constexpr (kChainV) chain(x, iters);
        }
      } else {
        chain(x, iters);
      }
      if constexpr (M == kConsume) chain(acc, iters);

#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
        uint8_t* const sb = st + buf * 64 * wg::kPitch;
        buf ^= 1;
        if constexpr (kDot) {
#pragma unroll
          for (int j = 4 * ch; j < 4 * ch + 4; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = 16 * warp + g + 8 * h, col = 8 * j + 2 * q - kChunk * ch;
              *reinterpret_cast<float2*>(sb + row * wg::kPitch + 4 * col) =
                  make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
            }
          wg::warpgroup_sync(1 + c);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
          if constexpr (kDot)
            y = *reinterpret_cast<const float4*>(sb + (vr + 16 * u) * wg::kPitch + 16 * vx);
          if constexpr (M == kInJoin) y = add4(y, x4(ch, u));
          store4(o, ch, u, y);
          if constexpr (M != kInJoin) store4(o2, ch, u, x4(ch, u));
        }
      }
    }
  }
}

const void* kernel_of(int mode) {
  switch (mode) {
    case kDotOnly: return reinterpret_cast<const void*>(overlap_kernel<kDotOnly>);
    case kVpuOnly: return reinterpret_cast<const void*>(overlap_kernel<kVpuOnly>);
    case kConsume: return reinterpret_cast<const void*>(overlap_kernel<kConsume>);
    case kInJoin: return reinterpret_cast<const void*>(overlap_kernel<kInJoin>);
    case kInSplit: return reinterpret_cast<const void*>(overlap_kernel<kInSplit>);
    default: return nullptr;
  }
}

template <int M>
void launch(const CUtensorMap& ta, const CUtensorMap& tb, const float* v, float* o, float* o2,
            int m, int n, int k, int iters, int stages, int smem, int grid, cudaStream_t s) {
  overlap_kernel<M><<<grid, wg::kThreads, smem, s>>>(ta, tb, v, o, o2, m, n, k, iters, stages);
}

}  // namespace

// a: (M, K) bf16; b: (K, N) bf16; v: (M, N) f32; o, o2: (M, N) f32 out; all
// 16-byte aligned.  mode: 0 dot_only, 1 vpu_only, 2 dot_vpu_consume, 3
// dot_vpu_in_join, 4 dot_vpu_in_split.  bm, bn, blocks, stages, smem and
// grid are overlap_plan's (ops/kernels/overlap_plan.py); M % 64 == 0,
// N % 64 == 0, K % 32 == 0 (checked by the wrapper and the plan).
extern "C" int dvt_probe_overlap(const void* a, const void* b, const void* v, void* o,
                                 void* o2, int m, int n, int k, int mode, int iters, int bm,
                                 int bn, int blocks, int stages, int smem, int grid,
                                 void* stream) {
  if (bm != kBM || bn != kBN || blocks != kBlocks || stages < 2 || stages > wg::kMaxStages ||
      grid < 1 || smem < wg::smem_bytes(kBM, kBN, stages) || n % kBN != 0 || k % 32 != 0)
    return cudaErrorInvalidValue;
  CUtensorMap ta, tb;  // K = 0: no loads, and no maps to read
  std::memset(&ta, 0, sizeof ta);
  std::memset(&tb, 0, sizeof tb);
  cudaError_t err;
  if (k > 0 && ((err = wg::tensor_map(&ta, a, 2 * k, m, 2LL * k, kBM)) != cudaSuccess ||
                (err = wg::tensor_map(&tb, b, 2 * n, k, 2LL * n, kKStage)) != cudaSuccess))
    return err;
  const void* f = kernel_of(mode);
  if (f == nullptr) return cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  if ((err = dvt::probe::prepare<kBlocks>(f, smem, &attr)) != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* vp = static_cast<const float*>(v);
  auto *op = static_cast<float*>(o), *o2p = static_cast<float*>(o2);
  switch (mode) {
    case kDotOnly: launch<kDotOnly>(ta, tb, vp, op, o2p, m, n, k, iters, stages, smem, grid, s); break;
    case kVpuOnly: launch<kVpuOnly>(ta, tb, vp, op, o2p, m, n, k, iters, stages, smem, grid, s); break;
    case kConsume: launch<kConsume>(ta, tb, vp, op, o2p, m, n, k, iters, stages, smem, grid, s); break;
    case kInJoin: launch<kInJoin>(ta, tb, vp, op, o2p, m, n, k, iters, stages, smem, grid, s); break;
    default: launch<kInSplit>(ta, tb, vp, op, o2p, m, n, k, iters, stages, smem, grid, s); break;
  }
  return cudaGetLastError();
}

// The footprint of mode `mode`'s kernel with `smem` bytes of dynamic shared
// memory: registers a thread at launch, local memory (spills) a thread,
// shared memory a block, blocks an SM.
extern "C" int dvt_probe_overlap_footprint(int mode, int smem, int* registers, int* local_bytes,
                                           int* smem_bytes, int* blocks_per_sm) {
  const void* f = kernel_of(mode);
  if (f == nullptr) return cudaErrorInvalidValue;
  return dvt::probe::footprint<kBlocks>(f, smem, registers, local_bytes, smem_bytes,
                                         blocks_per_sm);
}
