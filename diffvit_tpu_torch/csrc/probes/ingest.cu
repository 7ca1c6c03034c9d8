// Probe P4: the sum of a float32 array into an (8, 128) float32 tile, the
// kernel that the ingest probe feeds.
//
// Replaces the Pallas kernel _sum_kernel of scripts/ab_regime_discriminate.py
// :45, as pallas_sum (:51, called at :52, grid 8) and xla_plus_mosaic_step
// (:63, called at :66 on a device constant) call it: every element of the
// (8, 128) output is the sum of the whole input.
//
// The TPU kernel carries the sum from one sequential grid step to the next
// (initialised at step 0).  Blocks on the H100 run in parallel, in no
// order, so this takes two passes: each of a fixed number of blocks sums a
// fixed strided share of the input in float64 (a fixed tree in each
// block), then one block sums the partials in a fixed order and rounds
// once to float32.  The result does not depend on the scheduling.  The
// probe's inputs are integers <= 255 (a uint8 batch cast on the device) or
// halves, whose float64 sums are exact in any order: at the full 9.6 M
// elements the sum is about 1.2e9, far above 2^24, where a float32
// accumulator would round.
//
// The H100 question (asked by the probe's timing legs, not by this kernel):
// what does ingesting a b=64 batch (9.6 MB) cost from pageable against
// pinned host memory, beside the same device buffer and fresh ones.
//
// What bounds it: reading 38.5 MB of float32 at 3.35 TB/s, 11.5 us.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocks = 264;  // two blocks an SM on an H100's 132

__device__ __forceinline__ double block_sum(double v, double* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  double total = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kThreads / 32; ++w) total += red[w];
  return total;  // in thread 0
}

__global__ void __launch_bounds__(kThreads)
    partial_kernel(const float* __restrict__ x, long long n, double* __restrict__ partial) {
  __shared__ double red[kThreads / 32];
  double s = 0.0;
  const long long n4 = n / 4;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n4; i += stride) {
    const float4 p = reinterpret_cast<const float4*>(x)[i];
    s += (double)p.x + (double)p.y + (double)p.z + (double)p.w;
  }
  const double total = block_sum(s, red);
  if (threadIdx.x == 0) partial[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kThreads)
    final_kernel(const double* __restrict__ partial, int n_partial, float* __restrict__ out) {
  __shared__ double red[kThreads / 32];
  __shared__ float result;
  double s = 0.0;
  for (int i = threadIdx.x; i < n_partial; i += kThreads) s += partial[i];
  const double total = block_sum(s, red);
  if (threadIdx.x == 0) result = __double2float_rn(total);
  __syncthreads();
  for (int i = threadIdx.x; i < 8 * 128; i += kThreads) out[i] = result;
}

}  // namespace

extern "C" const char* dvt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: n float32, n % 4 == 0, 16-byte aligned; partial: (264,) float64
// scratch; out: (8, 128) float32.
extern "C" int dvt_probe_tile_sum(const void* x, void* partial, void* out, long long n,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  partial_kernel<<<kBlocks, kThreads, 0, s>>>(static_cast<const float*>(x), n,
                                              static_cast<double*>(partial));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  final_kernel<<<1, kThreads, 0, s>>>(static_cast<const double*>(partial), kBlocks,
                                      static_cast<float*>(out));
  return cudaGetLastError();
}
