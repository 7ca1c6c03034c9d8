// Probe P3: K2's structure in five modes, to see what the GELU costs, and
// whether running it under the next products (within a warpgroup, or on
// ping-pong warpgroups) buys time.
//
// Replaces the Pallas kernel _kernel of scripts/overlap_probe_mlp.py:36
// (built at :95, called at :97), in its four modes and one more:
//   dot        g = gelu(mid), mid = fc1(x) * mult1 + bias1 (K2's order)
//   input      g = gelu(g_src), a kernel input; mid stays alive through
//              the output
//   nogelu     g = mid
//   pipelined  as dot, with the next tile's fc1 wgmma committed before the
//              current tile's GELU epilogue (the script's "fc1(i+1) issued
//              before gelu(i)"), within each consumer warpgroup
//   staged     as dot, on ping-pong consumers: the two warpgroups take
//              alternate tiles, so that one's GELU epilogue runs under the
//              other's wgmma (the other Hopper form of the same idea)
// then h = clip(rint(g * s_q1_inv)) int8, acc2 = h @ w2, y = acc2 * mult2 +
// bias2, codes = clip(rint(y * inv_out)), and in every mode the keep-alive
// out = codes * out_scale + mid[:, :Cout] * 1e-8 (float32).
//
// What bounds it on the H100: 2 x rows x 384 x 1536 x 2 int8 operations
// (119.6 G at rows 50,688, the script's DeiT-S b=256: 60 us at 1,979 T/s);
// `input` also reads the 311 MB float32 g_src (122 us at 3.35 TB/s, so it
// is bound by bytes).  The keep-alive adds 78 MB written and read back
// (mid's first Cout columns, float32), and fc2's float32 output 78 MB.
// The GELU's 30-odd float32 operations an element are SIMT work outside
// that count.
//
// Design: K2's two launches on the Hopper GEMM mainloop (wgmma_gemm.cuh:
// TMA into an mbarrier ring, wgmma m64n64k32, persistent blocks, the
// epilogue staged through shared memory), on K-major weights (the wrapper
// passes gemm.kmajor copies) and plans from gemm.gemm_plan and
// ops/kernels/overlap_plan.py.  The fc1 epilogue is a functor under
// wgmma_gemm.cuh's contract (Fc1Probe<M>: returns the int8 hidden code);
// the keep-alive is a side store from inside the functor, masked as the
// functor is (it sees only rows < M and columns < N): 4-byte stores in the
// accumulator layout, which the legs' production_over_dot prices.  fc2
// runs the keep-alive epilogue (Fc2Keep), which reads the keep-alive
// where it adds it.
//  * dot, input and nogelu run K2's own schedule, wg::gemm with K2's plan
//    (128 x 64 tiles, two blocks an SM past 256 rows): the two consumer
//    warpgroups share a tile, and the producer loads the next tile's
//    stages while they run the epilogue.
//  * pipelined (fc1_pipelined_kernel) shares a 128 x 64 tile between the
//    consumers as K2 does, and each consumer holds two accumulator sets
//    (2 x 32 registers): it commits the next tile's wgmma, runs the GELU
//    epilogue of the current one, then waits.  One block an SM with a ring
//    of 6 or more stages, so that the next tile's stages are loaded while
//    the current tile's are in use (at two blocks an SM, 104 registers a
//    consumer thread, the two sets and the epilogue spill 128 bytes).  A
//    tile of more K stages than the ring (Cin past 128 x stages, 896 at the
//    plan's 7) would have its producer wait for a stage that only the
//    tile's own uncommitted products free: from the ring's depth on, the
//    consumer waits for all but its last group before each stage and
//    releases what those read, so any K runs, with the last stage's group
//    in flight under the epilogue.
//  * staged (fc1_staged_kernel) gives each consumer warpgroup whole 64 x 64
//    tiles in turn (consumer c the block's tiles c, c + 2, ...): the
//    producer loads them in order, each stage released by the one
//    consumer that used it, so one consumer's epilogue runs while the other
//    issues its products.  Two blocks an SM as K2, 4 stages: it differs
//    from dot in the schedule alone.  The consumers' mainloops take turns
//    (two named barriers, the ping-pong's order): a consumer starts a
//    tile's products only once the other has issued and waited for all of
//    its previous tile's.  Without that turn, a consumer that skips the
//    other's tile could wait on a stage a whole ring ahead of what the
//    producer has filled, where the full barrier's parity reads as
//    complete (a tile of as many K stages as the ring or more: Cin past
//    384 at the plan's 4).
// Built with -fmad=false, so every multiply and add rounds on its own: the
// int32 sums are exact in any order, so pipelined and staged equal dot bit
// for bit, and each mode equals its plain version.
#include <cstdint>
#include <cuda_runtime.h>

#include "int_mlp.cuh"
#include "probe_launch.cuh"
#include "wgmma_gemm.cuh"

namespace {

namespace wg = dvt::wg;

enum Mode { kDot = 0, kInput = 1, kNoGelu = 2, kPipelined = 3, kStaged = 4 };

// fc1's epilogue of mode M: the hidden code, and the keep-alive side store.
template <int M>
struct Fc1Probe {
  using Out = int8_t;
  const float* v1;     // (2, Hid) [mult1, bias1]
  const float* g_src;  // (rows, Hid), read in mode input
  const float* scal;   // (1,) [s_q1_inv]
  float* keep;         // (rows, Cout): mid's first Cout columns
  int8_t* out;         // (rows, ld) hidden
  int ld, hid, cout;
  __device__ int8_t operator()(int r, int c, int acc) const {
    const float mid = static_cast<float>(acc) * v1[c] + v1[hid + c];
    const float src = M == kInput ? g_src[static_cast<size_t>(r) * hid + c] : mid;
    const float g = M == kNoGelu ? src : dvt::gelu_poly(src);
    if (c < cout) keep[static_cast<size_t>(r) * cout + c] = mid;
    return dvt::clip_i8(rintf(g * scal[0]));
  }
};

// fc2's epilogue: the output codes' values plus the keep-alive term.
struct Fc2Keep {
  using Out = float;
  const float* v2;    // (4, Cout) [mult2, bias2, out_scale, inv_out]
  const float* keep;  // (rows, Cout)
  float* out;         // (rows, Cout)
  int ld, cout;
  __device__ float operator()(int r, int c, int acc) const {
    const float y = static_cast<float>(acc) * v2[c] + v2[cout + c];
    const float code = fminf(fmaxf(rintf(y * v2[3 * cout + c]), -128.f), 127.f);
    return code * v2[2 * cout + c] + keep[static_cast<size_t>(r) * cout + c] * 1e-8f;
  }
};

constexpr int kWN = 64;  // a consumer's columns: one m64n64k32 wgmma a K step

// Waits for the stage at `pos` to fill and issues its wgmma into acc (64
// rows at A byte offset `a_off` of the stage), then moves pos on.
__device__ __forceinline__ void issue_stage(const wg::Ring& ring, wg::RingPos& pos,
                                            int (&acc)[kWN / 2], int a_off) {
  const int s = pos.stage;
  wg::mbar_wait(ring.full + 8 * s, pos.phase);
  const uint32_t a = ring.a + s * ring.a_slot + a_off, b = ring.b + s * ring.b_slot;
#pragma unroll
  for (int i = 0; i < kWN / 2; ++i) wg::fence_reg(acc[i]);
  wg::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < wg::kBK; kk += 32)
    wg::Wgmma<kWN>::mma(acc, wg::smem_desc(a + kk), wg::smem_desc(b + kk));
  wg::wgmma_commit();
  pos.next(ring.stages);
}

// Releases `count` stages from `pos` on (one arrival a consumer warpgroup);
// returns the position after them.
__device__ __forceinline__ wg::RingPos release(const wg::Ring& ring, wg::RingPos pos, int count,
                                               int t) {
  for (int i = 0; i < count; ++i) {
    if (t == 0) wg::mbar_arrive(ring.empty + 8 * pos.stage);
    pos.next(ring.stages);
  }
  return pos;
}

// Waits until at most one committed wgmma group of the warpgroup is pending.
__device__ __forceinline__ void wgmma_wait_but_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// The stages a consumer has issued and not released: from `at`, `held`.
struct Held {
  wg::RingPos at;
  int held;
};

// The producer thread: every stage of the block's tiles tile0, tile0 +
// step, ... in order, A's rows from m0 (box `bm` rows), W's from n0.
__device__ __forceinline__ void produce(const wg::Ring& ring, const CUtensorMap* tma_a,
                                        const CUtensorMap* tma_b, int tiles, int tiles_n,
                                        int k_tiles, int bm, int bn, int tile0, int step) {
  wg::RingPos pos{0, 0};
  for (int tile = tile0; tile < tiles; tile += step) {
    const int m0 = tile / tiles_n * bm, n0 = tile % tiles_n * bn;
    for (int kt = 0; kt < k_tiles; ++kt) {
      const int s = pos.stage;
      wg::mbar_wait(ring.empty + 8 * s, pos.phase ^ 1);
      wg::mbar_expect_tx(ring.full + 8 * s, (bm + bn) * wg::kBK);
      wg::tma_load_2d(ring.a + s * ring.a_slot, tma_a, kt * wg::kBK, m0, ring.full + 8 * s);
      wg::tma_load_2d(ring.b + s * ring.b_slot, tma_b, kt * wg::kBK, n0, ring.full + 8 * s);
      pos.next(ring.stages);
    }
  }
}

// Mode pipelined: 128 x 64 tiles, the consumers' 64 rows each; a consumer
// commits tile i+1's wgmma into one accumulator set, runs tile i's GELU
// epilogue from the other, then waits.  The tile loop is unrolled by two,
// so that each set is indexed at compile time.
template <int B>
__global__ void __launch_bounds__(wg::kThreads, B)
    fc1_pipelined_kernel(const __grid_constant__ CUtensorMap tma_a,
                         const __grid_constant__ CUtensorMap tma_b, int M, int N, int K,
                         int stages, Fc1Probe<kPipelined> epi) {
  constexpr int BM = 128, BN = kWN;
  extern __shared__ uint8_t pipelined_smem[];
  const wg::Ring ring = wg::ring_layout(pipelined_smem, BM * wg::kBK, BN * wg::kBK, stages);
  wg::ring_init(ring);
  __syncthreads();
  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = (M + BM - 1) / BM * tiles_n;
  const int k_tiles = (K + wg::kBK - 1) / wg::kBK;
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(wg::kProducerRegs<B>));
    if (threadIdx.x == 0)
      produce(ring, &tma_a, &tma_b, tiles, tiles_n, k_tiles, BM, BN, blockIdx.x, gridDim.x);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(wg::kConsumerRegs<B>));
    const int c = threadIdx.x / 128 - 1, t = threadIdx.x % 128;
    uint8_t* const st = ring.staging + c * 2 * 64 * wg::kPitch;
    int buf = 0;
    int acc0[kWN / 2], acc1[kWN / 2];
    wg::RingPos pos{0, 0};
    // tile's products into acc; returns the stages it holds.  Past the
    // ring's depth the ring comes round to the tile's own stages: all but
    // the last group are waited for, and the stages they read released,
    // before each further stage (the only groups pending are this tile's).
    auto issue = [&](int (&acc)[kWN / 2]) {
      Held h{pos, 0};
#pragma unroll
      for (int i = 0; i < kWN / 2; ++i) acc[i] = 0;
      for (int kt = 0; kt < k_tiles; ++kt) {
        if (kt >= ring.stages) {
          wgmma_wait_but_one();
          h.at = release(ring, h.at, h.held - 1, t);
          h.held = 1;
        }
        issue_stage(ring, pos, acc, 64 * c * wg::kBK);
        ++h.held;
      }
      return h;
    };
    auto finish = [&](int (&acc)[kWN / 2], const Held& h) {
      wg::wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < kWN / 2; ++i) wg::fence_reg(acc[i]);
      release(ring, h.at, h.held, t);
    };
    auto store = [&](const int (&acc)[kWN / 2], int tile) {
      wg::store_tile<kWN>(epi, acc, st, buf, tile / tiles_n * BM + 64 * c, tile % tiles_n * BN,
                          M, N, t, c);
    };
    int tile = blockIdx.x;
    if (tile < tiles) finish(acc0, issue(acc0));
    while (tile < tiles) {  // tile's sums are in acc0
      int next = tile + gridDim.x;
      if (next < tiles) {
        const Held h = issue(acc1);
        store(acc0, tile);
        finish(acc1, h);
      } else {
        store(acc0, tile);
        break;
      }
      tile = next;  // its sums are in acc1
      next = tile + gridDim.x;
      if (next < tiles) {
        const Held h = issue(acc0);
        store(acc1, tile);
        finish(acc0, h);
      } else {
        store(acc1, tile);
        break;
      }
      tile = next;
    }
  }
}

// The consumers' turns in mode staged: consumer c waits on named barrier
// 3 + c before a tile's products (but the block's first tile) and, after
// them, arrives on the other's, 4 - c, where the other has a next tile.
// Barriers 1 and 2 are the epilogue's (wg::store_tile).
__device__ __forceinline__ void turn_wait(int c) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(3 + c) : "memory");
}
__device__ __forceinline__ void turn_pass(int c) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - c) : "memory");
}

// Mode staged: ping-pong consumers on 64 x 64 tiles; consumer c takes the
// block's tiles c, c + 2, ..., each stage released by that one consumer,
// their mainloops in turn.
template <int B>
__global__ void __launch_bounds__(wg::kThreads, B)
    fc1_staged_kernel(const __grid_constant__ CUtensorMap tma_a,
                      const __grid_constant__ CUtensorMap tma_b, int M, int N, int K,
                      int stages, Fc1Probe<kStaged> epi) {
  constexpr int BM = 64, BN = kWN;
  extern __shared__ uint8_t staged_smem[];
  const wg::Ring ring = wg::ring_layout(staged_smem, BM * wg::kBK, BN * wg::kBK, stages);
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      wg::mbar_init(ring.full + 8 * s, 1);
      wg::mbar_init(ring.empty + 8 * s, 1);  // the one consumer of the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = (M + BM - 1) / BM * tiles_n;
  const int k_tiles = (K + wg::kBK - 1) / wg::kBK;
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(wg::kProducerRegs<B>));
    if (threadIdx.x == 0)
      produce(ring, &tma_a, &tma_b, tiles, tiles_n, k_tiles, BM, BN, blockIdx.x, gridDim.x);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(wg::kConsumerRegs<B>));
    const int c = threadIdx.x / 128 - 1, t = threadIdx.x % 128;
    uint8_t* const st = ring.staging + c * 2 * 64 * wg::kPitch;
    int buf = 0;
    int acc[kWN / 2];
    wg::RingPos pos{0, 0};
    auto skip = [&]() {  // the other consumer's tile
      for (int kt = 0; kt < k_tiles; ++kt) pos.next(ring.stages);
    };
    if (c == 1) skip();
    for (int tile = blockIdx.x + c * gridDim.x; tile < tiles; tile += 2 * gridDim.x) {
#pragma unroll
      for (int i = 0; i < kWN / 2; ++i) acc[i] = 0;
      if (tile != blockIdx.x) turn_wait(c);
      for (int kt = 0; kt < k_tiles; ++kt) {
        const wg::RingPos at = pos;
        issue_stage(ring, pos, acc, 0);
        wg::wgmma_wait_all();
#pragma unroll
        for (int i = 0; i < kWN / 2; ++i) wg::fence_reg(acc[i]);
        release(ring, at, 1, t);
      }
      if (tile + gridDim.x < tiles) turn_pass(c);
      wg::store_tile<kWN>(epi, acc, st, buf, tile / tiles_n * BM, tile % tiles_n * BN, M, N, t,
                          c);
      skip();
    }
  }
}

// The plans' tiles of the two kernels above (overlap_plan.mlp_plans), at
// one or two blocks an SM.
constexpr int kPipelinedBM = 128, kStagedBM = 64;

template <int M, int B>
const void* own_kernel() {
  if constexpr (M == kPipelined)
    return reinterpret_cast<const void*>(fc1_pipelined_kernel<B>);
  else
    return reinterpret_cast<const void*>(fc1_staged_kernel<B>);
}

// fn.template run<B>(kernel) for mode `mode`'s own kernel at the plan's
// tile and blocks an SM.
template <int M, class Fn>
cudaError_t with_kernel(int bm, int bn, int blocks, const Fn& fn) {
  if (bn != kWN || bm != (M == kPipelined ? kPipelinedBM : kStagedBM))
    return cudaErrorInvalidValue;
  if (blocks == 1) return fn.template run<1>(own_kernel<M, 1>());
  if (blocks == 2) return fn.template run<2>(own_kernel<M, 2>());
  return cudaErrorInvalidValue;
}

template <int M>
struct OwnLaunch {
  const wg::GemmArgs& g;
  const Fc1Probe<M>& epi;
  cudaStream_t s;
  template <int B>
  cudaError_t run(const void* f) const {
    cudaFuncAttributes attr;
    cudaError_t err = dvt::probe::prepare<B>(f, g.smem, &attr);
    if (err != cudaSuccess) return err;
    CUtensorMap ta, tb;
    if ((err = wg::tensor_map(&ta, g.a, g.k, g.m, g.k, g.bm)) != cudaSuccess) return err;
    if ((err = wg::tensor_map(&tb, g.w, g.k, g.n, g.k, g.bn)) != cudaSuccess) return err;
    if constexpr (M == kPipelined)
      fc1_pipelined_kernel<B><<<g.grid, wg::kThreads, g.smem, s>>>(ta, tb, g.m, g.n, g.k,
                                                                    g.stages, epi);
    else
      fc1_staged_kernel<B><<<g.grid, wg::kThreads, g.smem, s>>>(ta, tb, g.m, g.n, g.k, g.stages,
                                                                 epi);
    return cudaGetLastError();
  }
};

struct OwnFootprint {
  int smem;
  int *registers, *local_bytes, *smem_bytes, *blocks_per_sm;
  template <int B>
  cudaError_t run(const void* f) const {
    return dvt::probe::footprint<B>(f, smem, registers, local_bytes, smem_bytes, blocks_per_sm);
  }
};

template <int M>
cudaError_t launch_fc1(const wg::GemmArgs& g, const Fc1Probe<M>& epi, cudaStream_t s) {
  if constexpr (M != kPipelined && M != kStaged) {
    return wg::gemm(g, epi, s);  // K2's kernel and schedule
  } else {
    if (g.stages < 2 || g.stages > wg::kMaxStages || g.smem < wg::smem_bytes(g.bm, g.bn, g.stages) ||
        g.grid < 1 || g.k % 16 != 0)
      return cudaErrorInvalidValue;
    return with_kernel<M>(g.bm, g.bn, g.blocks, OwnLaunch<M>{g, epi, s});
  }
}

// probe::report for K2's kernel with fc1 epilogue Epi.
template <class Epi>
struct ServedFootprint {
  int smem;
  int *registers, *local_bytes, *smem_bytes, *blocks_per_sm;
  template <int BM, int BN, int B>
  cudaError_t run() const {
    cudaFuncAttributes attr;
    const cudaError_t err = wg::prepare<BM, BN, B, Epi>(smem, &attr);
    return dvt::probe::report(reinterpret_cast<const void*>(wg::wgmma_gemm_kernel<BM, BN, B, Epi>),
                              attr, err, smem, registers, local_bytes, smem_bytes, blocks_per_sm);
  }
};

template <int M>
cudaError_t served_footprint(int bm, int bn, int blocks, int smem, int* registers,
                             int* local_bytes, int* smem_bytes, int* blocks_per_sm) {
  return wg::dispatch_tile(bm, bn, blocks,
                           ServedFootprint<Fc1Probe<M>>{smem, registers, local_bytes, smem_bytes,
                                                        blocks_per_sm});
}

}  // namespace

// x: (rows, Cin_p) int8; w1k: (Hid, Cin_p) and w2k: (Cout, Hid_p) int8, the
// weights K-major (gemm.kmajor); v1: (2, Hid) f32; v2: (4, Cout) f32;
// g_src: (rows, Hid) f32; scal: (1,) f32; hidden: (rows, Hid_p) int8 and
// keep: (rows, Cout) f32 scratch; out: (rows, Cout) f32.  mode: 0 dot, 1
// input, 2 nogelu, 3 pipelined, 4 staged.  plan1 and plan2 (bm, bn,
// blocks, stages, smem, grid) are fc1's and fc2's
// (overlap_plan.mlp_plans).  x 16-byte aligned (checked by the wrapper).
extern "C" int dvt_probe_overlap_mlp(const void* x, const void* w1k, const void* w2k,
                                     const void* v1, const void* v2, const void* g_src,
                                     const void* scal, void* hidden, void* keep, void* out,
                                     int rows, int cin_p, int hid, int hid_p, int cout, int mode,
                                     int bm1, int bn1, int blocks1, int stages1, int smem1,
                                     int grid1, int bm2, int bn2, int blocks2, int stages2,
                                     int smem2, int grid2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const wg::GemmArgs g1{x, w1k, rows, hid, cin_p, bm1, bn1, blocks1, stages1, smem1, grid1};
  const float* v1p = static_cast<const float*>(v1);
  const float* gp = static_cast<const float*>(g_src);
  const float* sp = static_cast<const float*>(scal);
  int8_t* hp = static_cast<int8_t*>(hidden);
  float* kp = static_cast<float*>(keep);
  cudaError_t err;
  switch (mode) {
    case kDot: err = launch_fc1(g1, Fc1Probe<kDot>{v1p, gp, sp, kp, hp, hid_p, hid, cout}, s); break;
    case kInput: err = launch_fc1(g1, Fc1Probe<kInput>{v1p, gp, sp, kp, hp, hid_p, hid, cout}, s); break;
    case kNoGelu: err = launch_fc1(g1, Fc1Probe<kNoGelu>{v1p, gp, sp, kp, hp, hid_p, hid, cout}, s); break;
    case kPipelined:
      err = launch_fc1(g1, Fc1Probe<kPipelined>{v1p, gp, sp, kp, hp, hid_p, hid, cout}, s);
      break;
    case kStaged: err = launch_fc1(g1, Fc1Probe<kStaged>{v1p, gp, sp, kp, hp, hid_p, hid, cout}, s); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  const wg::GemmArgs g2{hidden, w2k, rows, cout, hid_p, bm2, bn2, blocks2, stages2, smem2, grid2};
  return wg::gemm(g2, Fc2Keep{static_cast<const float*>(v2), kp, static_cast<float*>(out), cout, cout},
                  s);
}

// The fc1 kernel of mode `mode` for plan (bm, bn, blocks) with `smem`
// bytes of dynamic shared memory: its registers a thread at launch, local
// memory (spills) a thread, shared memory a block and blocks an SM (the
// occupancy API), so that a time can be read beside what the kernel's
// footprint allows.
extern "C" int dvt_probe_overlap_mlp_fc1_occupancy(int mode, int bm, int bn, int blocks, int smem,
                                                   int* registers, int* local_bytes,
                                                   int* smem_bytes, int* blocks_per_sm) {
  switch (mode) {
    case kDot: return served_footprint<kDot>(bm, bn, blocks, smem, registers, local_bytes, smem_bytes, blocks_per_sm);
    case kInput: return served_footprint<kInput>(bm, bn, blocks, smem, registers, local_bytes, smem_bytes, blocks_per_sm);
    case kNoGelu: return served_footprint<kNoGelu>(bm, bn, blocks, smem, registers, local_bytes, smem_bytes, blocks_per_sm);
    case kPipelined:
      return with_kernel<kPipelined>(
          bm, bn, blocks, OwnFootprint{smem, registers, local_bytes, smem_bytes, blocks_per_sm});
    case kStaged:
      return with_kernel<kStaged>(
          bm, bn, blocks, OwnFootprint{smem, registers, local_bytes, smem_bytes, blocks_per_sm});
    default: return cudaErrorInvalidValue;
  }
}
