// Hopper int8 GEMM mainloop with a fused epilogue, for K2 (int_mlp.cu), K3
// (int_linear.cu), the qkv GEMM of K1, K7a and K8 (qkv_core.cuh) and of
// probe P5, K7b's fc1 and fc2 (int_mlp_block.cu), the four GEMM steps of
// the resident encoder K6 (resident.cu) and probe P1's per-head qkv GEMM
// (probes/pingpong.cu); the last two call the tile routine gemm_tiles
// inside their persistent launches.  Probe P3 (probes/overlap_mlp.cu) runs
// K2's kernel with its own epilogues and builds its pipelined and staged
// fc1 kernels from the ring, the wgmma and the staged epilogue below;
// probe P2 (probes/overlap.cu) takes the ring, TMA, barrier and
// descriptor helpers for its bf16 kernel.
//
// Serves the Pallas kernels diffvit_tpu/ops/pallas/linear.py:69
// fused_int_linear and diffvit_tpu/ops/pallas/mlp.py:290 fused_int_mlp (and
// the GEMMs inside the others):
// C[M, N] = A[M, K] @ W[K, N] for int8 A and W, summed exactly in int32,
// every accumulator handed to an epilogue functor ``epi(row, col, acc)``
// that requantizes it (LinearOut, Fc1Hidden, Fc2Out), so the int32 product
// never reaches device memory.  An int32 sum is exact in any order, so the
// outputs equal those of the plain versions bit for bit whatever the tile.
//
// The epilogue contract: ``Epi::Out`` is the output element (float or
// int8_t), ``Out operator()(int row, int col, int acc) const`` the output
// element of one accumulator, and ``Out* out`` with row stride ``int ld``
// (elements) where the mainloop stores it.  The functor returns the value
// instead of storing it (as int8_gemm.cuh's functors do) so that the
// mainloop can stage the tile in shared memory and store whole rows.
//
// What bounds it on the H100: at the large sites the tensor cores (DeiT-S
// b=64 fc1 + fc2: 29.7 G int8 operations, 15 us at 1,979 T op/s) or the
// bytes (Swin-T stage-0 qkv b=64 writes 231 MB of float32: 75 us at 3.35
// TB/s); at b=1 (197 rows) the launch and one tile's latency.
//
// Design (the usual Hopper shape):
//  * Operands reach shared memory by TMA (cp.async.bulk.tensor), one
//    128-byte K slice of A (BM rows) and of W (BN rows) a stage, with the
//    128-byte swizzle that the wgmma descriptors below name.  W is read
//    K-major, (N, Kp) row-major: for int8, wgmma takes only K-major A and
//    B (the transpose bits exist for 16-bit types only), so the Python
//    side keeps one K-major copy of each weight (ops/kernels/gemm.py,
//    kmajor).  TMA's out-of-bounds zero fill covers the ragged M, N and K
//    edges; the epilogue masks the ragged M and N edges on its stores.
//  * A ring of `stages` stages (gemm_plan's 3 or 4) with a full and an
//    empty mbarrier each.  One producer thread keeps the TMA loads in
//    flight; two consumer warpgroups issue wgmma.mma_async m64nNk32
//    s32.s8.s8 with both operands in shared memory, wait with
//    wgmma.wait_group, and release each stage.  setmaxnreg moves
//    registers from the producer warpgroup to the consumers (40 and 232
//    at one block an SM, 24 and 104 at two) in the standalone kernel.  The
//    tile loop is one device routine (gemm_tiles) over a ring whose
//    position (RingPos) the caller carries, so that K6 runs its 4 x depth
//    GEMMs on one ring, its barriers' phases continuing; K6 runs it on 288
//    threads (the producer a ninth warp, after the two consumer
//    warpgroups), which leave its other steps 112 registers a thread at
//    two blocks an SM, and moves none.  BM = 128: each consumer takes 64
//    rows of the tile; BM = 64 (the b = 1 sites): each takes half its
//    columns.
//  * Persistent blocks: a grid of at most `blocks` blocks an SM walks the
//    output tiles (n fastest, so neighbouring blocks share A rows in L2),
//    and the producer loads the next tile's stages while the consumers
//    run the epilogue of the last one.  Past 256 rows gemm_plan puts two
//    blocks on each SM (128 x 64 tiles, 80 registers a thread at launch,
//    3 stages): the epilogue, not the products, sets the pace there, and
//    16 consumer warps an SM hide its latency better than 8, while one
//    block's epilogue overlaps the other's products.
//  * The epilogue stages each consumer's 64-row tile through shared
//    memory (two buffers in turn), 128 bytes of columns at a time, and
//    stores it as 16-byte vectors, consecutive threads on consecutive
//    addresses.  Stored from the accumulator registers, a warp's store
//    covers 8 rows with 2-byte (int8) or 4-byte (float) gaps between its
//    lanes, and on an H100 that store set the pace (K3's int8 output at
//    DeiT-S fc1 b=64 took longer than its float32 output).
//  * The tile (BM, BN), the stage count, the dynamic shared memory and
//    the grid come from gemm_plan (ops/kernels/gemm.py), plain Python.
//  * cuTensorMapEncodeTiled is a driver function: it is fetched once
//    through cudaGetDriverEntryPoint(ByVersion), so the library links
//    against the runtime alone (no -lcuda).
//  * A barrier wait that spins for ~10 s traps (an error at the next
//    synchronize) instead of hanging the card.
#pragma once

#include <cstdint>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

namespace dvt {
namespace wg {

constexpr int kBK = 128;        // K bytes a stage: one 128-byte swizzle row
constexpr int kThreads = 384;   // a producer warpgroup, two consumer warpgroups
constexpr int kMaxStages = 8;  // barrier slots (gemm.py's MAX_STAGES)
// setmaxnreg's registers a thread for the producer and the consumer
// warpgroups, with B blocks an SM (1 or 2): they fill the register file
// that __launch_bounds__(kThreads, B) leaves (168 or 80 a thread at launch).
template <int B>
constexpr int kProducerRegs = B == 1 ? 40 : 24;
template <int B>
constexpr int kConsumerRegs = B == 1 ? 232 : 104;
constexpr long long kHangCycles = 20000000000LL;  // ~10 s at 1.98 GHz
constexpr int kPitch = 128 + 16;  // bytes a row of the epilogue's staging tile

// Dynamic shared memory of a plan: the full and empty barriers, 1024
// bytes of alignment slack, the stages and the two consumers' two 64-row
// epilogue staging buffers each (gemm.py's smem_bytes; Ring's layout).
inline int smem_bytes(int bm, int bn, int stages) {
  return 1024 + stages * (bm + bn) * kBK + 2 * kMaxStages * 8 + 4 * 64 * kPitch;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits for the phase of parity `parity` of the barrier to complete.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > kHangCycles) __trap();
}

// TMA: the box at (c0 = K byte, c1 = row) of `map` into shared memory at
// `dst`, completing its bytes on barrier `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (SBO); the
// leading offset is unused for this layout.  A K step of 32 bytes inside
// the swizzle row advances the start address by 32.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Synchronizes the 128 threads of one consumer warpgroup (barrier `id`;
// 0 is __syncthreads').
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// Keeps the compiler from moving uses of an accumulator register across
// the asynchronous wgmma that writes it.
__device__ __forceinline__ void fence_reg(int& r) { asm volatile("" : "+r"(r)::"memory"); }

// D[64 x N] += A[64 x 32] @ B[32 x N] (s8 x s8 -> s32), both operands in
// shared memory through descriptors; d holds N / 2 accumulators a thread.
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void mma(int* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(int* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17,"
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(int* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17,"
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33,"
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
          "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
          "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

// The epilogue of one consumer warpgroup's 64 x WN accumulator tile at
// (r0, c0), by its 128 threads (t = 0..127), staged through `st`: two
// buffers of 64 rows of kPitch bytes used in turn (`buf` carries the turn
// from tile to tile), CW columns (at most 128 bytes) at a time, one
// barrier a chunk.  Accumulator i of a thread sits at row 16 * warp + g
// (+ 8 for i % 4 >= 2), column 8 * (i / 4) + 2 * q + i % 2 of the tile.
// Rows past M and columns past N are not stored; a chunk whose rows are
// not 16-byte aligned or that crosses N is stored element by element.
template <int WN, class Epi>
__device__ __forceinline__ void store_tile(const Epi& epi, const int (&acc)[WN / 2], uint8_t* st,
                                           int& buf, int r0, int c0, int M, int N, int t,
                                           int c) {
  using Out = typename Epi::Out;
  constexpr int kOut = sizeof(Out);
  constexpr int CW = WN * kOut < 128 ? WN : 128 / kOut;  // columns a chunk
  constexpr int VR = CW * kOut / 16;                      // 16-byte vectors a chunk row
  constexpr int VE = 16 / kOut;                           // elements a vector
  const int warp = t / 32, g = t % 32 / 4, q = t % 4;
  const bool rows16 = (static_cast<long long>(epi.ld) * kOut) % 16 == 0;
#pragma unroll
  for (int ch = 0; ch < WN / CW; ++ch) {
    // the buffer last read two chunks ago: every thread has passed the
    // last chunk's barrier, so it has finished that read
    uint8_t* const sb = st + buf * 64 * kPitch;
    buf ^= 1;
#pragma unroll
    for (int j = ch * CW / 8; j < (ch + 1) * CW / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * warp + g + 8 * (e >> 1), col = 8 * j + 2 * q + (e & 1);
        const int r = r0 + row, cc = c0 + col;
        reinterpret_cast<Out*>(sb + row * kPitch)[col - ch * CW] =
            r < M && cc < N ? epi(r, cc, acc[4 * j + e]) : Out(0);
      }
    warpgroup_sync(1 + c);
    const int cb = c0 + ch * CW;
    const bool vec = rows16 && cb + CW <= N;
#pragma unroll
    for (int u = 0; u < 64 * VR / 128; ++u) {
      const int v = t + 128 * u, row = v / VR, x = v % VR, r = r0 + row;
      if (r >= M) continue;
      const uint8_t* src = sb + row * kPitch + x * 16;
      Out* dst = epi.out + static_cast<size_t>(r) * epi.ld + cb + x * VE;
      if (vec) {
        *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
      } else {
#pragma unroll
        for (int e = 0; e < VE; ++e)
          if (cb + x * VE + e < N) dst[e] = reinterpret_cast<const Out*>(src)[e];
      }
    }
  }
}

// The mainloop's shared memory: a full and an empty barrier a stage
// (kBarrierBytes at the start, so that a caller that reuses the rest for
// other work, as K6 does, leaves them be), then A and W stage slots
// (`a_slot` and `b_slot` bytes apart, each a multiple of 1024 so that
// every stage keeps the swizzle's alignment) from the first 1024-byte
// boundary past the barriers, then the two consumers' two 64-row epilogue
// staging buffers each.
constexpr int kBarrierBytes = 2 * kMaxStages * 8;

struct Ring {
  uint32_t a, b;         // the first A and W stage
  uint32_t full, empty;  // kMaxStages barriers each
  uint8_t* staging;      // 4 x 64 x kPitch bytes
  int a_slot, b_slot, stages;
};

// The ring in the dynamic shared memory `smem` (at least 16-byte aligned;
// smem_bytes(bm, bn, stages) bytes for slots of bm and bn rows).
__device__ __forceinline__ Ring ring_layout(uint8_t* smem, int a_slot, int b_slot,
                                            int stages) {
  Ring r;
  r.full = smem_u32(smem);
  r.empty = r.full + kMaxStages * 8;
  r.a = (r.full + kBarrierBytes + 1023) & ~1023u;
  r.b = r.a + stages * a_slot;
  r.staging = smem + (r.b + stages * b_slot - r.full);
  r.a_slot = a_slot;
  r.b_slot = b_slot;
  r.stages = stages;
  return r;
}

// Initializes the ring's barriers (thread 0); the caller synchronizes the
// block before the first tile.
__device__ __forceinline__ void ring_init(const Ring& r) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < r.stages; ++s) {
      mbar_init(r.full + 8 * s, 1);
      mbar_init(r.empty + 8 * s, 2);  // one arrival a consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// Where a thread stands in the ring: the stage next in turn and the parity
// of its phase.  The producer thread and every consumer thread each carry
// their own, which stay in step because they walk the same stages; a
// caller that runs several GEMMs on one ring (the resident encoder K6)
// carries it from one call to the next, so the barriers' phases continue.
struct RingPos {
  int stage;
  uint32_t phase;
  __device__ void next(int stages) {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// Output tiles tile0, tile0 + step, ... of C[M, N] = A[M, K] @ W[K, N]
// (BM x BN tiles, n fastest) on the ring, with epilogue `epi`, by every
// thread of the block, in one of two layouts: a kThreads block whose
// thread 0 issues the TMA loads, whose warpgroups 1 and 2 consume and
// whose threads 1-127 pass through; or (ProducerLast, K6's 288 threads)
// warpgroups 0 and 1 consume and thread 256, the first of a ninth warp,
// issues.  A consumer c holds a 64 x WN accumulator: rows 64 * c of the
// tile for BM = 128, columns WN * c for BM = 64.  W's rows are read from
// row w_row0 of its map (a layer's offset in a stack of weights), A's from
// row a_row0 of its map (an image's offset in a batch: probe P1's
// producer); the epilogue sees rows and columns from 0.
// MoveRegs (1 or 2, the blocks an SM; first layout only) moves registers
// from the producer warpgroup to the consumers with setmaxnreg; 0 leaves
// every warp the launch's count.  Every stage this call loads it also
// consumes and releases, so a caller may reuse the shared memory, or run
// another GEMM on the ring, once the block has synchronized.
template <int BM, int BN, int MoveRegs, bool ProducerLast, class Epi>
__device__ __forceinline__ void gemm_tiles(const CUtensorMap* tma_a, const CUtensorMap* tma_b,
                                           int M, int N, int K, int w_row0, const Epi& epi,
                                           const Ring& ring, RingPos& pos, int tile0,
                                           int step, int a_row0 = 0) {
  constexpr int WN = BM == 128 ? BN : BN / 2;  // a consumer's columns: one wgmma's
  static_assert(BM == 64 || BM == 128, "BM is 64 or 128");
  static_assert(WN == 32 || WN == 64 || WN == 128, "BN is 64 or 128");
  static_assert(!ProducerLast || MoveRegs == 0, "setmaxnreg moves need the first layout");
  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = (M + BM - 1) / BM * tiles_n;
  const int k_tiles = (K + kBK - 1) / kBK;
  constexpr int kIssuer = ProducerLast ? 256 : 0;  // the thread that issues TMA

  if (ProducerLast ? threadIdx.x >= 256 : threadIdx.x < 128) {  // the producer's warps
    if constexpr (MoveRegs != 0)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs<MoveRegs>));
    if (threadIdx.x == kIssuer) {
      for (int tile = tile0; tile < tiles; tile += step) {
        const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
        for (int kt = 0; kt < k_tiles; ++kt) {
          const int s = pos.stage;
          mbar_wait(ring.empty + 8 * s, pos.phase ^ 1);
          mbar_expect_tx(ring.full + 8 * s, (BM + BN) * kBK);
          tma_load_2d(ring.a + s * ring.a_slot, tma_a, kt * kBK, a_row0 + m0,
                      ring.full + 8 * s);
          tma_load_2d(ring.b + s * ring.b_slot, tma_b, kt * kBK, w_row0 + n0, ring.full + 8 * s);
          pos.next(ring.stages);
        }
      }
    }
  } else {  // two consumer warpgroups
    if constexpr (MoveRegs != 0)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs<MoveRegs>));
    const int c = threadIdx.x / 128 - (ProducerLast ? 0 : 1), t = threadIdx.x % 128;
    const int row_off = BM == 128 ? 64 * c : 0, col_off = BM == 128 ? 0 : WN * c;
    int acc[WN / 2];
    int buf = 0;  // the epilogue's staging buffer next in turn
    for (int tile = tile0; tile < tiles; tile += step) {
      const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
#pragma unroll
      for (int i = 0; i < WN / 2; ++i) acc[i] = 0;
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = pos.stage;
        mbar_wait(ring.full + 8 * s, pos.phase);
        const uint32_t a = ring.a + s * ring.a_slot + row_off * kBK;
        const uint32_t b = ring.b + s * ring.b_slot + col_off * kBK;
#pragma unroll
        for (int i = 0; i < WN / 2; ++i) fence_reg(acc[i]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK; kk += 32)
          Wgmma<WN>::mma(acc, smem_desc(a + kk), smem_desc(b + kk));
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int i = 0; i < WN / 2; ++i) fence_reg(acc[i]);
        if (t == 0) mbar_arrive(ring.empty + 8 * s);
        pos.next(ring.stages);
      }
      store_tile<WN>(epi, acc, ring.staging + c * 2 * 64 * kPitch, buf, m0 + row_off,
                     n0 + col_off, M, N, t, c);
    }
  }
}

// The persistent kernel (K1's qkv GEMM, K2, K3, K7b): block-stride over
// the (M / BM) x (N / BN) output tiles with the ring laid out for this
// tile, setmaxnreg's moves on.
template <int BM, int BN, int B, class Epi>
__global__ void __launch_bounds__(kThreads, B)
    wgmma_gemm_kernel(const __grid_constant__ CUtensorMap tma_a,
                      const __grid_constant__ CUtensorMap tma_b, int M, int N, int K,
                      int stages, Epi epi) {
  extern __shared__ uint8_t wgmma_smem[];
  const Ring ring = ring_layout(wgmma_smem, BM * kBK, BN * kBK, stages);
  ring_init(ring);
  __syncthreads();
  RingPos pos{0, 0};
  gemm_tiles<BM, BN, B, false>(&tma_a, &tma_b, M, N, K, 0, epi, ring, pos, blockIdx.x,
                               gridDim.x);
}

// The operands and the plan of one GEMM: A (m, k) and W K-major (n, k),
// both row-major with rows of k bytes; k a multiple of 16 and both bases
// 16-byte aligned (TMA's rules; the Python side pads and checks); the
// epilogue's `out` 16-byte aligned.  bm, bn, blocks, stages, smem and
// grid are gemm_plan's.
struct GemmArgs {
  const void* a;
  const void* w;
  int m, n, k;
  int bm, bn, blocks, stages, smem, grid;
};

inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A 2-D uint8 tensor map over `rows` rows of `cols` bytes (row stride
// `stride` bytes), box 128 bytes x `box_rows`, 128-byte swizzle, zero
// fill out of bounds.
inline cudaError_t tensor_map(CUtensorMap* map, const void* base, int cols, int rows,
                              long long stride, int box_rows) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(stride)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBK), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// cudaErrorInvalidConfiguration where a kernel of `attr` (384 threads,
// setmaxnreg's moves at B blocks an SM) would stall: its register count at
// launch short of the budget the moves give out, or above the consumers'.
template <int B>
inline cudaError_t register_budget(const cudaFuncAttributes& attr) {
  return attr.numRegs * kThreads < kProducerRegs<B> * 128 + kConsumerRegs<B> * 256 ||
                 attr.numRegs > kConsumerRegs<B>
             ? cudaErrorInvalidConfiguration
             : cudaSuccess;
}

// Sets the kernel's dynamic shared memory limit (once per card and
// limit: the launch path pays no driver call for it after the first) and
// checks that its register count leaves setmaxnreg's budget (40 x 128 +
// 232 x 256) within what the launch allocates: a short budget would stall
// setmaxnreg.inc.  The cache is keyed by the kernel's address too: two
// libraries that instantiate the same kernel (the served one and the
// probes') share these statics (g++ makes a template's statics unique
// process-wide), and each library's kernel needs its own limit set.
template <int BM, int BN, int B, class Epi>
inline cudaError_t prepare(int smem, cudaFuncAttributes* attr) {
  constexpr int kCards = 16;
  static int ready_smem[kCards] = {};
  static const void* ready_fn[kCards] = {};
  static cudaFuncAttributes attrs[kCards];
  const void* f = reinterpret_cast<const void*>(wgmma_gemm_kernel<BM, BN, B, Epi>);
  int card = 0;
  cudaError_t err = cudaGetDevice(&card);
  if (err != cudaSuccess) return err;
  if (card >= kCards) return cudaErrorInvalidDevice;
  if (smem > ready_smem[card] || ready_fn[card] != f) {
    err = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncGetAttributes(&attrs[card], f);
    if (err != cudaSuccess) return err;
    ready_smem[card] = smem;
    ready_fn[card] = f;
  }
  *attr = attrs[card];
  return register_budget<B>(*attr);
}

template <int BM, int BN, int B, class Epi>
inline cudaError_t launch(const GemmArgs& g, const Epi& epi, cudaStream_t stream) {
  cudaFuncAttributes attr;
  cudaError_t err = prepare<BM, BN, B, Epi>(g.smem, &attr);
  if (err != cudaSuccess) return err;
  CUtensorMap ta, tb;
  if ((err = tensor_map(&ta, g.a, g.k, g.m, g.k, BM)) != cudaSuccess) return err;
  if ((err = tensor_map(&tb, g.w, g.k, g.n, g.k, BN)) != cudaSuccess) return err;
  wgmma_gemm_kernel<BM, BN, B, Epi>
      <<<g.grid, kThreads, g.smem, stream>>>(ta, tb, g.m, g.n, g.k, g.stages, epi);
  return cudaGetLastError();
}

// Runs `fn.template run<BM, BN, B>()` for the plan's tile and blocks an
// SM: gemm_plan's 128 x 64 at two blocks and 64 x 64 or 64 x 128 at one,
// and 128 x 64 and 128 x 128 at one for scripts/port_gemm.py's sweep.
template <class Fn>
inline cudaError_t dispatch_tile(int bm, int bn, int blocks, const Fn& fn) {
  if (blocks == 2) return bm == 128 && bn == 64 ? fn.template run<128, 64, 2>()
                                                : cudaErrorInvalidValue;
  if (blocks != 1) return cudaErrorInvalidValue;
  if (bm == 64 && bn == 64) return fn.template run<64, 64, 1>();
  if (bm == 64 && bn == 128) return fn.template run<64, 128, 1>();
  if (bm == 128 && bn == 64) return fn.template run<128, 64, 1>();
  if (bm == 128 && bn == 128) return fn.template run<128, 128, 1>();
  return cudaErrorInvalidValue;
}

template <class Epi>
struct Launch {
  const GemmArgs& g;
  const Epi& epi;
  cudaStream_t stream;
  template <int BM, int BN, int B>
  cudaError_t run() const {
    return launch<BM, BN, B>(g, epi, stream);
  }
};

// One GEMM with epilogue `epi` on `stream`, with the plan's tile.
template <class Epi>
inline cudaError_t gemm(const GemmArgs& g, const Epi& epi, cudaStream_t stream) {
  if (g.stages < 2 || g.stages > kMaxStages || g.smem < smem_bytes(g.bm, g.bn, g.stages) ||
      g.grid < 1 || g.k % 16 != 0)
    return cudaErrorInvalidValue;
  return dispatch_tile(g.bm, g.bn, g.blocks, Launch<Epi>{g, epi, stream});
}

// The footprint of the kernel for tile (bm, bn) at `blocks` blocks an SM
// and epilogue Epi:
// registers a thread, dynamic + static shared memory a block, and blocks
// an SM at `smem` bytes of dynamic shared memory (the occupancy API).
template <class Epi>
struct Footprint {
  int smem;
  int* registers;
  int* smem_bytes;
  int* blocks_per_sm;
  template <int BM, int BN, int B>
  cudaError_t run() const {
    cudaFuncAttributes attr;
    cudaError_t err = prepare<BM, BN, B, Epi>(smem, &attr);
    if (err != cudaSuccess && err != cudaErrorInvalidConfiguration) return err;
    *registers = attr.numRegs;
    *smem_bytes = smem + static_cast<int>(attr.sharedSizeBytes);
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, reinterpret_cast<const void*>(wgmma_gemm_kernel<BM, BN, B, Epi>), kThreads,
        smem);
  }
};

template <class Epi>
inline cudaError_t footprint(int bm, int bn, int blocks, int smem, int* registers,
                             int* smem_bytes, int* blocks_per_sm) {
  return dispatch_tile(bm, bn, blocks,
                       Footprint<Epi>{smem, registers, smem_bytes, blocks_per_sm});
}

}  // namespace wg
}  // namespace dvt
