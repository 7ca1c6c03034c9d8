// Probe P1: K1 split at the scores into a producer and a consumer, and the
// two paired in one warp-specialized launch.
//
// Replaces the Pallas kernels of scripts/ab_pingpong_probe.py: producer_part
// (:80, called at :141), consumer_part (:102, called at :159) and
// paired_kernel (:119, called at :177).
//  * producer: the qkv GEMM of one image with K1's requant epilogue
//    (rint(acc * mult/s1 + bias/s1), clipped), then per head the scores
//    q . k^T and their requant clip(rint(s * c1)) -> int8 scores (B, H,
//    Npad, Npad) in device memory.  The v third of the product is computed,
//    as the script's full-width dot computes it, and dropped.
//  * consumer: K1's LIS (the fast form) on int8 scores read from device
//    memory, keys at or past n_real masked, then attn @ v with v (B, H,
//    Npad, D) int8 and the requant rint(o * s1/s2) -> int8 (B, H, Npad, D).
//  * paired: both in one launch, on the same SMs at once.
//
// The H100 question: does the consumer's SIMT work (the LIS chain) hide
// under the producer's tensor-core work (wgmma) when the two share every
// SM, i.e. does paired take max(producer, consumer) or their sum?
//
// What bounds it: the producer is int8 tensor-core work (at B=128: 22.6 G
// of GEMM and 3.9 G of scores operations, 13.4 us at the int8 peak); the
// consumer reads 40.3 MB of scores and values and writes 9.8 MB (15.0 us
// at 3.35 TB/s) and runs the LIS chain, a table lookup, a division and a
// log2 a score, in SIMT.
//
// Design, on the parts K1 runs:
//  * producer: persistent blocks of 384 threads, one an SM, block i taking
//    the (image, head) items i, i + grid, ...  An item's qkv GEMM is the
//    head's q, k and v columns (3D rows of a K-major weight copy whose rows
//    the wrapper orders [head, slot, d]) over the image's Npad rows, on
//    wgmma_gemm.cuh's tile routine gemm_tiles (thread 0 issues TMA into
//    the mbarrier ring, warpgroups 1 and 2 run wgmma) with K1's requant
//    (HeadOut, qkv_code), stored by the routine's staged 16-byte stores
//    into the head's q | k | v rows in shared memory.  Then the two wgmma
//    warpgroups run the scores on attention_mma.cuh's score step (mma.sync
//    m16n8k32 s8, a warp a 16-row query tile against every key), K1's c1
//    requant (QkvChain), and store the codes.  The TMA thread runs ahead
//    into the next item's stages while the scores run.  setmaxnreg: 40
//    registers a thread for warpgroup 0, 232 for the others, as the
//    standalone GEMM.
//  * consumer: K1's core (attend_rows with the LIS) on a chain whose
//    scores are loaded (amma::LoadedChain), a block an item (image, head,
//    run of query tiles) of K1's attention plan, three blocks an SM; the
//    block stages V^T only.
//  * paired: persistent blocks of 896 threads, one an SM: the producer's
//    three warpgroups and four consumer warpgroups (16 warps: the LIS is
//    latency-bound and wants warps; with 8 a paired launch took twice the
//    longer role alone), each role walking its own list of items (block
//    i: producer items i, i + grid, ...; consumer items likewise, an
//    (image, head) and up to 16 query tiles each).  The roles share the SM
//    and nothing else: each synchronizes on its own named barriers
//    (bar.sync id, n) and the ring's mbarriers, never on __syncthreads.
//    setmaxnreg moves registers from warpgroup 0 (24 a thread) to the
//    wgmma warpgroups (96); the consumer's keep the launch's 72.  The plan
//    (ops/kernels/pingpong_plan.py) sets the ring's stages (the shared
//    memory leaves it 2), the shared memory and the grids.  Its outputs
//    equal the producer's and the consumer's bit for bit: the roles run
//    the same device functions.
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "attention_core.cuh"  // qkv_code
#include "attention_mma.cuh"
#include "lis.cuh"
#include "wgmma_gemm.cuh"

namespace {

namespace amma = dvt::amma;
namespace wg = dvt::wg;
using amma::Weight;

constexpr int kBM = 128, kBN = 64;     // the producer's GEMM tile (pingpong_plan.BM, BN)
constexpr int kProducerThreads = 384;  // warpgroup 0 issues TMA, 1 and 2 run wgmma
constexpr int kMmaThreads = 256;       // the wgmma warpgroups
constexpr int kAttnThreads = 512;      // paired's consumer warpgroups
constexpr int kPairedThreads = kProducerThreads + kAttnThreads;
constexpr int kConsumerWarps = 7;      // a consumer block at most (attn_plan.QKV_MAX_WARPS)
constexpr int kMaxKB = 8;              // 256 keys
constexpr int kMidKB = 7;              // 224 keys (DeiT's 197)
constexpr int kCodeBytes = amma::PackedScores<8 * kMaxKB>::kBytes;  // a consumer warp's
// named barriers; 1 and 2 are the GEMM epilogue's (wg::store_tile)
constexpr int kBarRing = 3;    // the producer's warps, once the ring is set up
constexpr int kBarScores = 4;  // the wgmma warpgroups, around an item's scores
constexpr int kBarAttn = 5;    // the consumer's warps
// setmaxnreg's registers a thread: the producer alone, and paired (whose
// consumer warpgroups keep the launch's 72)
constexpr int kTmaRegs = 40, kMmaRegs = 232;
constexpr int kPairedTmaRegs = 24, kPairedMmaRegs = 96, kPairedAttnRegs = 72;

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Bytes between rows of the head buffer: q | k | v (3D bytes), rounded to
// an odd multiple of 16 so that the score step's fragment loads (8 rows x
// 4 words) fall in 32 distinct banks.
__host__ __device__ inline int head_pitch(int d) {
  const int ld = (3 * d + 15) / 16 * 16;
  return (ld / 16) % 2 ? ld : ld + 16;
}

// The head buffer: Npad rows rounded up to 16, and 64 bytes of slack for
// the key fragments of the last rows, which read up to 32 bytes past D.
inline int head_bytes(int npad, int d) { return (npad + 15) / 16 * 16 * head_pitch(d) + 64; }

// The producer's dynamic shared memory: the ring and its staging, then the
// head buffer.
inline int producer_smem(int npad, int d, int stages) {
  return wg::smem_bytes(kBM, kBN, stages) + head_bytes(npad, d);
}

// A consumer's: the exponential table, V^T, each warp's packed scores.
inline int consumer_smem(int n_real, int d, int warps) {
  const amma::KvGeom g = amma::kv_geom(n_real, d, true);
  return amma::kExpBytes + g.dp * g.v_pitch() + warps * kCodeBytes;
}

struct ProducerArgs {
  const float* mb;       // (2, 3C) [mult/s1, bias/s1]
  const float* scalars;  // (4,) [s_a, c1, 1/s1, s1/s2]
  int8_t* scores;        // (B, H, Npad, Npad)
  int batch, npad, kp, heads, d, stages;
  int head_off;          // the head buffer's offset in the shared memory
};

struct ConsumerArgs {
  const int8_t* scores;  // (B, H, Npad, Npad)
  const int8_t* v;       // (B, H, Npad, D)
  const float* scalars;
  int8_t* out;           // (B, H, Npad, D)
  int batch, npad, heads, d, n_real, tiles, split;
  int attn_off;          // the consumer's offset in the shared memory
};

// K1's requant of one item's columns n = slot * D + channel (q | k | v of
// head h) into the head buffer.
struct HeadOut {
  using Out = int8_t;
  const float* mb;
  int8_t* out;  // the head buffer (shared memory, through a generic pointer)
  int ld;
  int c3, c, d, h;
  __device__ int8_t operator()(int, int n, int acc) const {
    const int slot = (n >= d) + (n >= 2 * d);
    return dvt::qkv_code(mb, c3, nullptr, slot * c + h * d + n - slot * d, acc);
  }
};

// An item's scores from its q and k rows in the head buffer `hb` (q at
// byte 0 of a row, k at byte D) by the wgmma warpgroups' 8 warps, this
// thread's warp `warp` of them taking the query tiles warp, warp + 8, ...:
// attention_mma.cuh's score step (mma.sync m16n8k32 s8 against 8 keys at
// a time; D in chunks of 32 bytes), K1's chain, the codes into `out`
// (Npad x Npad).  The accumulator holds keys 8j + 2t, 8j + 2t + 1 of rows
// gq and gq + 8: one 2-byte store a row where Npad is even.
__device__ __forceinline__ void head_scores(const int8_t* hb, int ld, int npad, int d, float c1,
                                            int8_t* out, int warp) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, t = lane & 3;
  const amma::QkvChain chain{c1, 0.f};
  const int q_tiles = (npad + amma::kRows - 1) / amma::kRows;
  const bool pairs = (npad & 1) == 0;
  for (int qt = warp; qt < q_tiles; qt += kMmaThreads / 32) {
    const int q0 = amma::kRows * qt, rows = min(amma::kRows, npad - q0);
    uint32_t qa[2][4];
#pragma unroll
    for (int kc = 0; kc < 2; ++kc)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = gq + 8 * (i & 1), col = 32 * kc + 16 * (i >> 1) + 4 * t;
        qa[kc][i] = row < rows && col < d ? amma::load_word(hb + (q0 + row) * ld + col) : 0u;
      }
    int8_t* const orow = out + (size_t)q0 * npad;
    for (int j = 0; 8 * j < npad; ++j) {
      int acc[4] = {0, 0, 0, 0};
      const int8_t* kr = hb + (8 * j + gq) * ld + d + 4 * t;
#pragma unroll
      for (int kc = 0; kc < 2; ++kc)
        if (32 * kc < d)
          amma::mma_s8(acc, qa[kc], amma::load_word(kr + 32 * kc),
                       amma::load_word(kr + 32 * kc + 16));
      const int key = 8 * j + 2 * t;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = gq + 8 * r;
        if (row < rows && key < npad) {
          const int8_t c0 = static_cast<int8_t>(static_cast<int>(chain(acc[2 * r], 0, 0)));
          const int8_t c1v = static_cast<int8_t>(static_cast<int>(chain(acc[2 * r + 1], 0, 0)));
          int8_t* dst = orow + (size_t)row * npad + key;
          if (pairs) {
            *reinterpret_cast<uint16_t*>(dst) =
                static_cast<uint16_t>(static_cast<uint8_t>(c0) | static_cast<uint8_t>(c1v) << 8);
          } else {
            dst[0] = c0;
            if (key + 1 < npad) dst[1] = c1v;
          }
        }
      }
    }
  }
}

// The producer's warps, threads 0-383 of the block: block `item0`'s items
// item0, item0 + step, ...  TmaRegs and MmaRegs: setmaxnreg's registers for
// warpgroup 0 and for warpgroups 1-2.
template <int TmaRegs, int MmaRegs>
__device__ __forceinline__ void producer_role(const CUtensorMap* tma_x, const CUtensorMap* tma_w,
                                              const ProducerArgs& p, uint8_t* smem, int item0,
                                              int step) {
  const wg::Ring ring = wg::ring_layout(smem, kBM * wg::kBK, kBN * wg::kBK, p.stages);
  wg::ring_init(ring);
  named_sync(kBarRing, kProducerThreads);
  int8_t* const hb = reinterpret_cast<int8_t*>(smem + p.head_off);
  const int ld = head_pitch(p.d), c = p.heads * p.d, n3 = 3 * p.d;
  wg::RingPos pos{0, 0};
  const int items = p.batch * p.heads;
  // The two roles run their own loops over the items, so that no code of
  // one is reachable from the other's setmaxnreg (ptxas ignores a move
  // that code past it could need more registers than).  gemm_tiles tests
  // threadIdx.x < 128 again, which the compiler folds in each loop.
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(TmaRegs));
    for (int item = item0; item < items; item += step) {
      const int b = item / p.heads, h = item % p.heads;
      wg::gemm_tiles<kBM, kBN, 0, false>(tma_x, tma_w, p.npad, n3, p.kp, n3 * h,
                                         HeadOut{p.mb, hb, ld, 3 * c, c, p.d, h}, ring, pos, 0,
                                         1, b * p.npad);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(MmaRegs));
    const float c1 = p.scalars[1];
    for (int item = item0; item < items; item += step) {
      const int b = item / p.heads, h = item % p.heads;
      wg::gemm_tiles<kBM, kBN, 0, false>(tma_x, tma_w, p.npad, n3, p.kp, n3 * h,
                                         HeadOut{p.mb, hb, ld, 3 * c, c, p.d, h}, ring, pos, 0,
                                         1, b * p.npad);
      named_sync(kBarScores, kMmaThreads);  // the head's q and k are stored
      head_scores(hb, ld, p.npad, p.d, c1, p.scores + (size_t)item * p.npad * p.npad,
                  (threadIdx.x - 128) >> 5);
      named_sync(kBarScores, kMmaThreads);  // and read, before the next epilogue
    }
  }
}

// The consumer's warps: `threads` threads, this one `tid` of them (from a
// warp boundary), synchronizing on named barrier `bar`; items item0,
// item0 + step, ... of (image, head, run of `tiles` query tiles).
template <int MaxKB, int DP>
__device__ __forceinline__ void consumer_role(const ConsumerArgs& p, uint8_t* smem, int item0,
                                              int step, int tid, int threads, int bar) {
  uint8_t* const base = smem + p.attn_off;
  const float s_a = p.scalars[0];
  const amma::ExpTable et =
      amma::fill_exp_table(base, dvt::lis_consts(s_a), true, tid, threads);
  const amma::KvGeom g = amma::kv_geom(p.n_real, p.d, true);
  uint8_t* const vt = base + amma::kExpBytes;
  const int warp = tid >> 5, warps = threads >> 5;
  uint8_t* const scratch = vt + g.dp * g.v_pitch() + warp * kCodeBytes;
  const amma::SoftArgs a{p.n_real, p.d, et, s_a, p.scalars[3]};
  const int q_tiles = (p.npad + amma::kRows - 1) / amma::kRows;
  const int items = p.batch * p.heads * p.split;
  for (int item = item0; item < items; item += step) {
    const int x = item % p.split;
    const size_t head = (size_t)(item / p.split) * p.npad;  // the (image, head)'s first row
    named_sync(bar, threads);  // the table is filled; the last item's V^T read
    amma::stage_vt(p.v + head * p.d, p.d, p.n_real, p.d, g, vt, tid, threads);
    named_sync(bar, threads);
    const int t1 = min((x + 1) * p.tiles, q_tiles);
    for (int tile = x * p.tiles + warp; tile < t1; tile += warps) {
      const int q0 = tile * amma::kRows;
      const amma::RowTile rt{p.scores + (head + q0) * p.npad, p.npad, p.out + (head + q0) * p.d,
                             p.d, min(amma::kRows, p.npad - q0)};
      amma::attend_rows<MaxKB, DP, Weight::kLis>(rt, vt, g, a, amma::LoadedChain{}, scratch);
    }
  }
}

__global__ void __launch_bounds__(kProducerThreads, 1)
    producer_kernel(const __grid_constant__ CUtensorMap tma_x,
                    const __grid_constant__ CUtensorMap tma_w, const ProducerArgs p) {
  extern __shared__ __align__(16) uint8_t pp_smem[];
  producer_role<kTmaRegs, kMmaRegs>(&tma_x, &tma_w, p, pp_smem, blockIdx.x, gridDim.x);
}

// Three blocks an SM of at most 7 warps, as K1's core.
template <int MaxKB, int DP>
__global__ void __launch_bounds__(kConsumerWarps * 32, 3) consumer_kernel(const ConsumerArgs p) {
  extern __shared__ __align__(16) uint8_t pp_smem[];
  consumer_role<MaxKB, DP>(p, pp_smem, blockIdx.x, gridDim.x, threadIdx.x, blockDim.x, kBarAttn);
}

template <int MaxKB, int DP>
__global__ void __launch_bounds__(kPairedThreads, 1)
    paired_kernel(const __grid_constant__ CUtensorMap tma_x,
                  const __grid_constant__ CUtensorMap tma_w, const ProducerArgs pp,
                  const ConsumerArgs cp) {
  extern __shared__ __align__(16) uint8_t pp_smem[];
  if (threadIdx.x < kProducerThreads) {
    producer_role<kPairedTmaRegs, kPairedMmaRegs>(&tma_x, &tma_w, pp, pp_smem, blockIdx.x,
                                                  gridDim.x);
  } else {
    consumer_role<MaxKB, DP>(cp, pp_smem, blockIdx.x, gridDim.x, threadIdx.x - kProducerThreads,
                             kAttnThreads, kBarAttn);
  }
}

// The consumer's and paired's instance for n_real keys (224 or 256 at
// most) and head width d (32 or 64 at most), as K1's core chooses.
const void* consumer_fn(int n_real, int d) {
  const bool mid = n_real <= 32 * kMidKB, narrow = d <= 32;
  if (mid)
    return narrow ? reinterpret_cast<const void*>(consumer_kernel<kMidKB, 32>)
                  : reinterpret_cast<const void*>(consumer_kernel<kMidKB, 64>);
  return narrow ? reinterpret_cast<const void*>(consumer_kernel<kMaxKB, 32>)
                : reinterpret_cast<const void*>(consumer_kernel<kMaxKB, 64>);
}

const void* paired_fn(int n_real, int d) {
  const bool mid = n_real <= 32 * kMidKB, narrow = d <= 32;
  if (mid)
    return narrow ? reinterpret_cast<const void*>(paired_kernel<kMidKB, 32>)
                  : reinterpret_cast<const void*>(paired_kernel<kMidKB, 64>);
  return narrow ? reinterpret_cast<const void*>(paired_kernel<kMaxKB, 32>)
                : reinterpret_cast<const void*>(paired_kernel<kMaxKB, 64>);
}

// Sets f's dynamic shared memory limit and checks that its register count
// at launch leaves setmaxnreg's moves their budget: `budget` registers over
// `threads` threads, no role moved below the count (`least`) or raised
// above it (`most`); a short budget would stall setmaxnreg.inc.
cudaError_t prepare(const void* f, int smem, int threads, int budget, int least, int most) {
  cudaError_t err = amma::allow_smem(f, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, f);
  if (err != cudaSuccess) return err;
  if (attr.numRegs * threads < budget || attr.numRegs < least || attr.numRegs > most)
    return cudaErrorInvalidConfiguration;
  return cudaSuccess;
}

constexpr int kProducerBudget = kTmaRegs * 128 + kMmaRegs * kMmaThreads;
constexpr int kPairedBudget =
    kPairedTmaRegs * 128 + kPairedMmaRegs * kMmaThreads + kPairedAttnRegs * kAttnThreads;
constexpr int kPairedAttnWarps = kAttnThreads / 32;

// The producer's TMA maps: x (B*Npad, Kp) in boxes of kBM rows, wk (H*3D,
// Kp) in boxes of kBN rows.
cudaError_t producer_maps(const void* x, const void* wk, int batch, int npad, int kp, int heads,
                          int d, CUtensorMap* tx, CUtensorMap* tw) {
  cudaError_t err = wg::tensor_map(tx, x, kp, batch * npad, kp, kBM);
  if (err != cudaSuccess) return err;
  return wg::tensor_map(tw, wk, kp, heads * 3 * d, kp, kBN);
}

bool shape_ok(int npad, int d, int n_real) {
  return npad > 0 && npad <= 32 * kMaxKB && d > 0 && d <= 64 && d % 4 == 0 && n_real > 0 &&
         n_real <= npad;
}

bool consumer_plan_ok(int npad, int tiles, int split) {
  return tiles >= 1 && split >= 1 && split * tiles >= (npad + amma::kRows - 1) / amma::kRows;
}

}  // namespace

// x: (B*Npad, Kp) int8 (K zero-padded to Kp, a multiple of 16; 16-byte
// aligned); wk: (H*3D, Kp) int8, the (Cin, 3C) weight K-major with rows
// [head, slot, d]; mb: (2, 3C) f32 [mult/s1, bias/s1]; scalars: (4,) f32
// [s_a, c1, 1/s1, s1/s2] on the device; scores: (B, H, Npad, Npad) int8
// out.  stages, smem, grid: pingpong_plan.producer_plan's.  Requires
// Npad <= 256, D <= 64, D % 4 == 0.
extern "C" int dvt_probe_producer(const void* x, const void* wk, const void* mb,
                                  const void* scalars, void* scores, int batch, int npad, int kp,
                                  int heads, int d, int stages, int smem, int grid,
                                  void* stream) {
  if (!shape_ok(npad, d, npad) || stages < 2 || stages > wg::kMaxStages || grid < 1 ||
      kp % 16 != 0 || smem < producer_smem(npad, d, stages))
    return cudaErrorInvalidValue;
  const void* f = reinterpret_cast<const void*>(producer_kernel);
  cudaError_t err = prepare(f, smem, kProducerThreads, kProducerBudget, kTmaRegs, kMmaRegs);
  if (err != cudaSuccess) return err;
  CUtensorMap tx, tw;
  if ((err = producer_maps(x, wk, batch, npad, kp, heads, d, &tx, &tw)) != cudaSuccess) return err;
  const ProducerArgs p{static_cast<const float*>(mb), static_cast<const float*>(scalars),
                       static_cast<int8_t*>(scores), batch, npad, kp, heads, d, stages,
                       wg::smem_bytes(kBM, kBN, stages)};
  void* args[] = {&tx, &tw, const_cast<ProducerArgs*>(&p)};
  return cudaLaunchKernel(f, dim3(grid), dim3(kProducerThreads), args, smem,
                          static_cast<cudaStream_t>(stream));
}

// scores: (B, H, Npad, Npad) int8; v: (B, H, Npad, D) int8; scalars as the
// producer's; out: (B, H, Npad, D) int8.  Keys at or past n_real are
// masked.  The LIS is the fast form: s_a must lie in [2^-10, ln 2].
// warps, tiles, split, smem: pingpong_plan.consumer_plan's.  Requires
// n_real <= Npad <= 256, D <= 64, D % 4 == 0.
extern "C" int dvt_probe_consumer(const void* scores, const void* v, const void* scalars,
                                  void* out, int batch, int npad, int heads, int d, int n_real,
                                  int warps, int tiles, int split, int smem, void* stream) {
  if (!shape_ok(npad, d, n_real) || !consumer_plan_ok(npad, tiles, split) || warps < 1 ||
      warps > kConsumerWarps || smem < consumer_smem(n_real, d, warps))
    return cudaErrorInvalidValue;
  const void* f = consumer_fn(n_real, d);
  cudaError_t err = amma::allow_smem(f, smem);
  if (err != cudaSuccess) return err;
  const ConsumerArgs p{static_cast<const int8_t*>(scores), static_cast<const int8_t*>(v),
                       static_cast<const float*>(scalars), static_cast<int8_t*>(out),
                       batch, npad, heads, d, n_real, tiles, split, 0};
  void* args[] = {const_cast<ConsumerArgs*>(&p)};
  return cudaLaunchKernel(f, dim3(batch * heads * split), dim3(32 * warps), args, smem,
                          static_cast<cudaStream_t>(stream));
}

// The producer on (x, wk, mb) into scores_out and the consumer on
// (scores_in, v) into out, in one launch; the arguments and requirements
// as theirs, with stages, smem, grid, tiles and split from
// pingpong_plan.paired_plan (16 consumer warps).
extern "C" int dvt_probe_paired(const void* x, const void* wk, const void* mb,
                                const void* scores_in, const void* v, const void* scalars,
                                void* scores_out, void* out, int batch, int npad, int kp,
                                int heads, int d, int n_real, int stages, int smem, int grid,
                                int tiles, int split, void* stream) {
  const int attn_off = producer_smem(npad, d, stages);
  if (!shape_ok(npad, d, n_real) || !consumer_plan_ok(npad, tiles, split) || stages < 2 ||
      stages > wg::kMaxStages || grid < 1 || kp % 16 != 0 ||
      smem < attn_off + consumer_smem(n_real, d, kPairedAttnWarps))
    return cudaErrorInvalidValue;
  const void* f = paired_fn(n_real, d);
  cudaError_t err =
      prepare(f, smem, kPairedThreads, kPairedBudget, kPairedAttnRegs, kPairedMmaRegs);
  if (err != cudaSuccess) return err;
  CUtensorMap tx, tw;
  if ((err = producer_maps(x, wk, batch, npad, kp, heads, d, &tx, &tw)) != cudaSuccess) return err;
  const ProducerArgs pp{static_cast<const float*>(mb), static_cast<const float*>(scalars),
                        static_cast<int8_t*>(scores_out), batch, npad, kp, heads, d, stages,
                        wg::smem_bytes(kBM, kBN, stages)};
  const ConsumerArgs cp{static_cast<const int8_t*>(scores_in), static_cast<const int8_t*>(v),
                        static_cast<const float*>(scalars), static_cast<int8_t*>(out),
                        batch, npad, heads, d, n_real, tiles, split, attn_off};
  void* args[] = {&tx, &tw, const_cast<ProducerArgs*>(&pp), const_cast<ConsumerArgs*>(&cp)};
  return cudaLaunchKernel(f, dim3(grid), dim3(kPairedThreads), args, smem,
                          static_cast<cudaStream_t>(stream));
}

// The footprint of role `role`'s kernel (0 producer, 1 consumer, 2 paired)
// for n_real keys and head width d at `warps` warps a block and `smem`
// bytes: registers a thread at launch (setmaxnreg moves them after), local
// memory (spills) a thread, shared memory a block, blocks an SM.
extern "C" int dvt_probe_pingpong_occupancy(int role, int n_real, int d, int warps, int smem,
                                            int* registers, int* local_bytes, int* smem_bytes,
                                            int* blocks_per_sm) {
  const void* f = nullptr;
  switch (role) {
    case 0: f = reinterpret_cast<const void*>(producer_kernel); break;
    case 1: f = consumer_fn(n_real, d); break;
    case 2: f = paired_fn(n_real, d); break;
    default: return cudaErrorInvalidValue;
  }
  return amma::footprint(f, warps, smem, registers, local_bytes, smem_bytes, blocks_per_sm);
}
