// Probe P4: the sum of a float32 array into an (8, 128) float32 tile, the
// kernel that the ingest probe feeds.
//
// Replaces the Pallas kernel _sum_kernel of scripts/ab_regime_discriminate.py
// :45, as pallas_sum (:51, called at :52, grid 8) and xla_plus_mosaic_step
// (:63, called at :66 on a device constant) call it: every element of the
// (8, 128) output is the sum of the whole input.
//
// The H100 question (asked by the probe's timing legs, not by this kernel):
// what does ingesting a b=64 batch (9.6 MB) cost from pageable against
// pinned host memory, beside the same device buffer and fresh ones.
//
// What bounds it: reading the input once, 38.5 MB of float32 at the legs'
// (9408, 1024): 11.5 us at 3.35 TB/s.  A float64 add an element is far
// below the card's rate, so the bytes bound it, and what the design has to
// do is keep enough of them in flight (some 3 MB across the card at HBM3's
// latency) and hide the launch.
//
// Design, one launch:
//  * Persistent blocks, one an SM, each over a contiguous share of the
//    input (the plan, probes/ingest.py `plan`: a multiple of 4 elements, so
//    every copy's address and size are multiples of 16 bytes).  A block
//    streams its share through a ring of shared-memory stages of 1-D bulk
//    asynchronous copies (cp.async.bulk ... mbarrier::complete_tx, the
//    bulk engine computes no addresses on the SMs), each stage with a full
//    and an empty mbarrier (wgmma_gemm.cuh's barrier helpers and RingPos).
//    One producer thread, the first of a ninth warp, keeps every free
//    stage loading: 6 stages of 32 KB a block, 25 MB in flight across 132
//    SMs.  The eight consumer warps add each stage from shared memory into
//    float64 in 16-byte reads, consecutive threads on consecutive vectors,
//    and release it (one arrival a warp).  A block's last stage may be
//    short; a share shorter than a stage, or an input of 4 elements, is
//    one short stage.
//  * Fixed order across blocks: each block sums its threads in a fixed
//    tree, writes its float64 partial, then __threadfence() and an atomic
//    ticket.  The block that draws the last ticket reads the partials
//    (past L1), sums them in a fixed tree by index, rounds once to float32,
//    fills the tile and resets the ticket to 0 for the next launch on the
//    stream.  No block waits for another, so any grid runs.  The result
//    does not depend on the scheduling; the probe's inputs are integers <=
//    255 (a uint8 batch cast on the device) or halves, whose float64 sums
//    are exact in any order: at the full 9.6 M elements the sum is about
//    1.2e9, far above 2^24, where a float32 accumulator would round.
//  * The input is written before the launch (the kernel boundary orders
//    those generic writes before the copies' async-proxy reads); within
//    the launch the copies write only shared memory that the consumers
//    read after the full barrier's phase.  The partials and the ticket are
//    generic on both sides.  The wrapper keeps them per card and stream, so
//    two streams never share them.
#include <cstdint>
#include <cuda_runtime.h>

#include "wgmma_gemm.cuh"

namespace {

namespace wg = dvt::wg;

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kMaxStages = 8;              // barrier slots (ingest.MAX_STAGES)
constexpr int kRingOffset = 128;           // the barriers, then the stages

// 1-D bulk copy of `bytes` (a multiple of 16) from global `src` to shared
// `dst` (both 16-byte aligned), completing its bytes on barrier `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The block's sum of v over its threads, in a fixed tree (xor shuffles,
// then the warps in order), in thread 0.  Ends with the block synchronized
// after `red` was written; the caller synchronizes before `red` is
// written again.
__device__ __forceinline__ double block_sum(double v, double* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  double total = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kThreads / 32; ++w) total += red[w];
  return total;
}

__global__ void __launch_bounds__(kThreads, 1)
    tile_sum_kernel(const float* __restrict__ x, long long n, long long share,
                    int stage_bytes, int stages, double* __restrict__ partials,
                    unsigned* __restrict__ ticket, float* __restrict__ out) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ double red[kThreads / 32];
  __shared__ bool last;
  __shared__ float result;
  const uint32_t full = wg::smem_u32(smem), empty = full + kMaxStages * 8;
  const uint32_t ring = wg::smem_u32(smem + kRingOffset);
  const long long lo = static_cast<long long>(blockIdx.x) * share;
  const long long hi = lo + share < n ? lo + share : n;
  const int stage_elems = stage_bytes / 4;
  const int n_stages = lo < hi ? static_cast<int>((hi - lo + stage_elems - 1) / stage_elems) : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      wg::mbar_init(full + 8 * s, 1);
      wg::mbar_init(empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  double s = 0.0;
  wg::RingPos pos{0, 0};
  if (threadIdx.x == kConsumers) {  // the producer
    for (int k = 0; k < n_stages; ++k) {
      const long long at = lo + static_cast<long long>(k) * stage_elems;
      const long long len = hi - at < stage_elems ? hi - at : stage_elems;
      const uint32_t bytes = static_cast<uint32_t>(len * 4);
      wg::mbar_wait(empty + 8 * pos.stage, pos.phase ^ 1);
      wg::mbar_expect_tx(full + 8 * pos.stage, bytes);
      bulk_load(ring + pos.stage * stage_bytes, x + at, bytes, full + 8 * pos.stage);
      pos.next(stages);
    }
  } else if (threadIdx.x < kConsumers) {
    const int t = threadIdx.x;
    for (int k = 0; k < n_stages; ++k) {
      const long long at = lo + static_cast<long long>(k) * stage_elems;
      const int vecs = static_cast<int>((hi - at < stage_elems ? hi - at : stage_elems) / 4);
      wg::mbar_wait(full + 8 * pos.stage, pos.phase);
      const float4* st =
          reinterpret_cast<const float4*>(smem + kRingOffset + pos.stage * stage_bytes);
#pragma unroll 4
      for (int i = t; i < vecs; i += kConsumers) {
        const float4 p = st[i];
        s += static_cast<double>(p.x) + static_cast<double>(p.y) + static_cast<double>(p.z) +
             static_cast<double>(p.w);
      }
      __syncwarp();
      if (t % 32 == 0) wg::mbar_arrive(empty + 8 * pos.stage);
      pos.next(stages);
    }
  }

  const double total = block_sum(s, red);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = total;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  double p = 0.0;
  for (int i = threadIdx.x; i < static_cast<int>(gridDim.x); i += kThreads)
    p += __ldcg(partials + i);
  const double sum = block_sum(p, red);
  if (threadIdx.x == 0) {
    result = __double2float_rn(sum);
    *ticket = 0u;
  }
  __syncthreads();
  if (threadIdx.x < 8 * 128 / 4)
    reinterpret_cast<float4*>(out)[threadIdx.x] = make_float4(result, result, result, result);
}

// Sets the kernel's dynamic shared memory limit once per card and limit.
cudaError_t prepare(int smem) {
  constexpr int kCards = 16;
  static int ready[kCards] = {};
  int card = 0;
  cudaError_t err = cudaGetDevice(&card);
  if (err != cudaSuccess) return err;
  if (card >= kCards) return cudaErrorInvalidDevice;
  if (smem > ready[card]) {
    err = cudaFuncSetAttribute(tile_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    ready[card] = smem;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" const char* dvt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: n float32, n % 4 == 0, 16-byte aligned; partials: at least `grid`
// float64 and ticket: one uint32, 0 before the first launch (each launch
// leaves it 0), both kept for one stream; out: (8, 128) float32.  share,
// grid, stage_bytes, stages and smem are ingest.plan's: block b sums
// [b * share, min(n, (b + 1) * share)).
extern "C" int dvt_probe_tile_sum(const void* x, void* partials, void* ticket, void* out,
                                  long long n, long long share, int grid, int stage_bytes,
                                  int stages, int smem, void* stream) {
  if (n < 0 || n % 4 != 0 || share < 0 || share % 4 != 0 ||
      static_cast<long long>(grid) * share < n || grid < 1 ||
      stage_bytes < 16 || stage_bytes % 16 != 0 || stages < 2 || stages > kMaxStages ||
      smem < kRingOffset + stages * stage_bytes)
    return cudaErrorInvalidValue;
  cudaError_t err = prepare(smem);
  if (err != cudaSuccess) return err;
  tile_sum_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, share, stage_bytes, stages,
      static_cast<double*>(partials), static_cast<unsigned*>(ticket), static_cast<float*>(out));
  return cudaGetLastError();
}
