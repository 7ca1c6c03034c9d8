// Probe P1: K1 split at the scores into a producer and a consumer, and the
// two paired in one launch.
//
// Replaces the Pallas kernels of scripts/ab_pingpong_probe.py: producer_part
// (:80, called at :141), consumer_part (:102, called at :159) and
// paired_kernel (:119, called at :177).
//  * producer: the qkv GEMM of one image with K1's requant epilogue
//    (rint(acc * mult/s1 + bias/s1), clipped), then per head the scores
//    q . k^T and their requant clip(rint(s * c1)) -> int8 scores (B, H,
//    Npad, Npad) in device memory.  The v third of the product is computed,
//    as the script's full-width dot computes it, and dropped.
//  * consumer: K1's LIS row (lis.cuh, the fast form) on int8 scores read
//    from device memory, keys at or past n_real masked, then attn @ v with
//    v (B, H, Npad, D) int8 and the requant rint(o * s1/s2) -> int8 (B, H,
//    Npad, D).
//  * paired: both in one grid.  The two roles go to different blocks, spread
//    evenly over the block indices so that the scheduler keeps both in
//    flight on every SM: each role is block-synchronous (the GEMM tile and
//    the K/V staging end in __syncthreads) and needs its own shared
//    memory, so splitting the warps of one block would need named barriers
//    and the larger footprint in every block.  Its outputs equal the
//    producer's and the consumer's bit for bit: the blocks run the same
//    device functions.
//
// The H100 question: does the consumer's SIMT work (the LIS chain) hide
// under the producer's tensor-core work when the scores cross a kernel
// boundary, i.e. does paired take max(producer, consumer) or their sum?
//
// What bounds it: the producer is int8 tensor-core work (at B=128: 22.6 G
// of GEMM and 3.9 G of scores operations, 13.5 us at the int8 peak); the
// consumer reads 30.7 MB of scores and writes 9.8 MB (about 15 us at 3.35
// TB/s) and runs the LIS chain, one exponent and one division per score, in
// SIMT.
//
// Design (simple first): one producer block per (image, head) computes that
// head's q and k (Npad x D each, int8) with the shared GEMM tile
// (int8_gemm.cuh, the weight read through a BView) into shared memory, then
// the scores with mma.sync m16n8k32 from shared memory; one consumer block
// per (query tile of 32 rows, head, image), a warp a query row, as K1's
// attention core.
#include <cstdint>
#include <cuda_runtime.h>

#include "attention_core.cuh"
#include "int8_gemm.cuh"
#include "lis.cuh"

namespace {

constexpr int kMaxRows = dvt::kMaxKeys;    // Npad <= 256
constexpr int kQkStride = dvt::kMaxHeadDim + 16;  // bytes per q/k row

struct ProducerSmem {
  dvt::GemmSmem gemm;
  __align__(16) int8_t q[kMaxRows][kQkStride];
  __align__(16) int8_t k[kMaxRows][kQkStride];
};

struct ConsumerSmem {
  __align__(16) int8_t v_rows[dvt::kMaxKeys][dvt::kMaxHeadDim];
  int weights[dvt::kAttnWarps][dvt::kMaxKeys];
};

union PairedSmem {
  ProducerSmem p;
  ConsumerSmem c;
};

struct Geometry {
  int batch, npad, cin, heads, d, n_real;
};

// The qkv GEMM's epilogue for head h: K1's requant, q and k into shared
// memory; the v third is dropped.
struct HeadEpilogue {
  const float* mb;  // (2, 3C) [mult/s1, bias/s1]
  ProducerSmem* sm;
  int c, d, h;
  __device__ void operator()(int r, int n, int acc) const {
    const int slot = n / d, dd = n - slot * d;
    if (slot == 2) return;
    const int gc = slot * c + h * d + dd;
    const float y = static_cast<float>(acc) * mb[gc] + mb[3 * c + gc];
    (slot == 0 ? sm->q : sm->k)[r][dd] = dvt::clip_i8(rintf(y));
  }
};

__device__ void producer_item(const int8_t* x, const int8_t* w, const float* mb,
                              const float* scalars, int8_t* scores, const Geometry& g,
                              int b, int h, ProducerSmem& sm) {
  const int c = g.heads * g.d, npad = g.npad;
  const int rows16 = (npad + 15) / 16 * 16;
  // zero the padding rows and columns that the scores' mma reads
  for (int i = threadIdx.x; i < rows16 * (dvt::kMaxHeadDim / 4); i += blockDim.x) {
    const int r = i / (dvt::kMaxHeadDim / 4), wd = i % (dvt::kMaxHeadDim / 4);
    reinterpret_cast<int*>(sm.q[r])[wd] = 0;
    reinterpret_cast<int*>(sm.k[r])[wd] = 0;
  }
  __syncthreads();

  const int8_t* wh = w + h * g.d;
  const dvt::BView view{{wh, wh + c, wh + 2 * c}, 0, 3 * c, 1, g.d, g.d};
  const dvt::ViewOperands ops{x + (size_t)b * npad * g.cin, g.cin, npad, 3 * g.d, g.cin, view};
  const HeadEpilogue epi{mb, &sm, c, g.d, h};
  for (int m0 = 0; m0 < npad; m0 += dvt::kGemmBM)
    for (int n0 = 0; n0 < 3 * g.d; n0 += dvt::kGemmBN)
      dvt::int8_gemm_tile_ops(ops, m0, n0, epi, sm.gemm);
  __syncthreads();

  // scores = q . k^T over D (int32, exact), requantized to int8
  const float c1 = scalars[1];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, t = lane & 3;
  const int ksteps = (g.d + 31) / 32;
  int8_t* out = scores + ((size_t)b * g.heads + h) * npad * npad;
  for (int mt = warp; mt < rows16 / 16; mt += dvt::kAttnWarps) {
    const int r = mt * 16 + gr;
    unsigned af[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int k0 = ks * 32;
      af[ks][0] = *reinterpret_cast<const unsigned*>(&sm.q[r][k0 + t * 4]);
      af[ks][1] = *reinterpret_cast<const unsigned*>(&sm.q[r + 8][k0 + t * 4]);
      af[ks][2] = *reinterpret_cast<const unsigned*>(&sm.q[r][k0 + t * 4 + 16]);
      af[ks][3] = *reinterpret_cast<const unsigned*>(&sm.q[r + 8][k0 + t * 4 + 16]);
    }
    for (int n0 = 0; n0 < npad; n0 += 8) {
      const int col = n0 + gr;
      int acc[4] = {0, 0, 0, 0};
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        if (ks >= ksteps) break;
        const unsigned bf[2] = {
            *reinterpret_cast<const unsigned*>(&sm.k[col][ks * 32 + t * 4]),
            *reinterpret_cast<const unsigned*>(&sm.k[col][ks * 32 + t * 4 + 16])};
        dvt::mma_s8_m16n8k32(acc, af[ks], bf);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = r + half * 8;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = n0 + 2 * t + e;
          if (i < npad && j < npad)
            out[(size_t)i * npad + j] =
                dvt::clip_i8(rintf(static_cast<float>(acc[half * 2 + e]) * c1));
        }
      }
    }
  }
}

__device__ void consumer_item(const int8_t* scores, const int8_t* v, const float* scalars,
                              int8_t* out, const Geometry& g, int b, int h, int q0,
                              ConsumerSmem& sm) {
  const int npad = g.npad, d = g.d, n_real = g.n_real, words = d / 4;
  const size_t bh = (size_t)b * g.heads + h;
  const int8_t* vb = v + bh * npad * d;
  for (int idx = threadIdx.x; idx < n_real * words; idx += blockDim.x) {
    const int j = idx / words, wd = idx % words;
    reinterpret_cast<int*>(sm.v_rows[j])[wd] = reinterpret_cast<const int*>(vb + j * d)[wd];
  }
  __syncthreads();

  const float s_a = scalars[0], s1_over_s2 = scalars[3];
  const dvt::LisConsts lis_k = dvt::lis_consts(s_a);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int8_t* sb = scores + bh * npad * npad;
  int8_t* ob = out + bh * npad * d;
  const int q_end = min(q0 + dvt::kQueryTile, npad);
  for (int i = q0 + warp; i < q_end; i += dvt::kAttnWarps) {
    float a[dvt::kKeysPerLane];
#pragma unroll
    for (int u = 0; u < dvt::kKeysPerLane; ++u) {
      const int j = lane + 32 * u;
      a[u] = j < n_real ? static_cast<float>(sb[(size_t)i * npad + j]) : 0.f;
    }
    dvt::lis_row(a, n_real, lis_k, true, sm.weights[warp], lane);
    __syncwarp();
    for (int dd = lane; dd < d; dd += 32) {
      int acc = 0;
      for (int j = 0; j < n_real; ++j) acc += sm.weights[warp][j] * sm.v_rows[j][dd];
      const float o = static_cast<float>(acc) * 0x1p-15f;
      ob[(size_t)i * d + dd] = dvt::clip_i8(rintf(o * s1_over_s2));
    }
    __syncwarp();
  }
  __syncthreads();
}

__global__ void __launch_bounds__(dvt::kGemmThreads)
    producer_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ mb, const float* __restrict__ scalars,
                    int8_t* __restrict__ scores, Geometry g) {
  __shared__ ProducerSmem sm;
  producer_item(x, w, mb, scalars, scores, g, blockIdx.y, blockIdx.x, sm);
}

__global__ void __launch_bounds__(dvt::kGemmThreads)
    consumer_kernel(const int8_t* __restrict__ scores, const int8_t* __restrict__ v,
                    const float* __restrict__ scalars, int8_t* __restrict__ out, Geometry g) {
  __shared__ ConsumerSmem sm;
  consumer_item(scores, v, scalars, out, g, blockIdx.z, blockIdx.y,
                blockIdx.x * dvt::kQueryTile, sm);
}

// Block i is a producer item when floor((i+1) P / T) > floor(i P / T), for
// P producer items among T blocks: the producers are spread evenly.
__global__ void __launch_bounds__(dvt::kGemmThreads)
    paired_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ mb, const int8_t* __restrict__ scores_in,
                  const int8_t* __restrict__ v, const float* __restrict__ scalars,
                  int8_t* __restrict__ scores_out, int8_t* __restrict__ out, Geometry g,
                  int n_producer, int n_total) {
  __shared__ PairedSmem sm;
  const long long i = blockIdx.x;
  const int before = static_cast<int>(i * n_producer / n_total);
  const int after = static_cast<int>((i + 1) * n_producer / n_total);
  if (after > before) {
    producer_item(x, w, mb, scalars, scores_out, g, before / g.heads, before % g.heads, sm.p);
  } else {
    const int item = static_cast<int>(i) - before;
    const int nq = (g.npad + dvt::kQueryTile - 1) / dvt::kQueryTile;
    consumer_item(scores_in, v, scalars, out, g, item / (nq * g.heads), (item / nq) % g.heads,
                  (item % nq) * dvt::kQueryTile, sm.c);
  }
}

int query_tiles(int npad) { return (npad + dvt::kQueryTile - 1) / dvt::kQueryTile; }

}  // namespace

// x: (B, Npad, Cin) int8; w: (Cin, 3C) int8, columns [slot, head, d]; mb:
// (2, 3C) f32 [mult/s1, bias/s1]; scalars: (4,) f32 [s_a, c1, 1/s1, s1/s2]
// on the device; scores: (B, H, Npad, Npad) int8 out.  Requires Npad <= 256,
// D <= 64, D % 4 == 0, Cin % 16 == 0 (checked by the wrapper).
extern "C" int dvt_probe_producer(const void* x, const void* w, const void* mb,
                                  const void* scalars, void* scores, int batch, int npad,
                                  int cin, int heads, int d, void* stream) {
  const Geometry g{batch, npad, cin, heads, d, npad};
  producer_kernel<<<dim3(heads, batch), dvt::kGemmThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(mb), static_cast<const float*>(scalars),
      static_cast<int8_t*>(scores), g);
  return cudaGetLastError();
}

// scores: (B, H, Npad, Npad) int8; v: (B, H, Npad, D) int8; scalars as the
// producer's; out: (B, H, Npad, D) int8.  Keys at or past n_real are
// masked.  The LIS is the fast form: s_a must lie in [2^-10, ln 2].
// Requires n_real <= Npad <= 256, D <= 64, D % 4 == 0.
extern "C" int dvt_probe_consumer(const void* scores, const void* v, const void* scalars,
                                  void* out, int batch, int npad, int heads, int d,
                                  int n_real, void* stream) {
  const Geometry g{batch, npad, 0, heads, d, n_real};
  consumer_kernel<<<dim3(query_tiles(npad), heads, batch), dvt::kAttnWarps * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(scores), static_cast<const int8_t*>(v),
      static_cast<const float*>(scalars), static_cast<int8_t*>(out), g);
  return cudaGetLastError();
}

// The producer on (x, w, mb) into scores_out and the consumer on
// (scores_in, v) into out, in one grid; the same requirements.
extern "C" int dvt_probe_paired(const void* x, const void* w, const void* mb,
                                const void* scores_in, const void* v, const void* scalars,
                                void* scores_out, void* out, int batch, int npad, int cin,
                                int heads, int d, int n_real, void* stream) {
  const Geometry g{batch, npad, cin, heads, d, n_real};
  const int n_producer = batch * heads;
  const int n_total = n_producer + query_tiles(npad) * heads * batch;
  paired_kernel<<<n_total, dvt::kGemmThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(mb), static_cast<const int8_t*>(scores_in),
      static_cast<const int8_t*>(v), static_cast<const float*>(scalars),
      static_cast<int8_t*>(scores_out), static_cast<int8_t*>(out), g, n_producer, n_total);
  return cudaGetLastError();
}

// The kernel of role `role` (0 producer, 1 consumer, 2 paired): its registers
// a thread, its shared memory and how many of its blocks an SM holds at once
// (the occupancy API).  The paired kernel's footprint is the larger of the
// two roles' in every block.
extern "C" int dvt_probe_pingpong_occupancy(int role, int* registers, int* smem_bytes,
                                            int* blocks_per_sm) {
  const void* f = nullptr;
  int threads = dvt::kGemmThreads;
  switch (role) {
    case 0: f = reinterpret_cast<const void*>(producer_kernel); break;
    case 1:
      f = reinterpret_cast<const void*>(consumer_kernel);
      threads = dvt::kAttnWarps * 32;
      break;
    case 2: f = reinterpret_cast<const void*>(paired_kernel); break;
    default: return cudaErrorInvalidValue;
  }
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, f);
  if (err != cudaSuccess) return err;
  *registers = attr.numRegs;
  *smem_bytes = static_cast<int>(attr.sharedSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, f, threads, 0);
}
