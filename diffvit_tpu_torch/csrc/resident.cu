// Resident whole-encoder serving kernel (K6) for Hopper.
//
// Replaces diffvit_tpu/ops/pallas/serve.py::resident_codes (body
// _serve_kernel, LayerNorm _ln_emit): every encoder block of a ViT in one
// launch, on the int8 codes of the residual stream.  Per block, op for op
// the integer codes path of models/vit_int._block_int: int LN1, the qkv
// GEMM with K1's requant, the attention core, the proj GEMM, the qact3 /
// residual / qact2 fences, int LN2 with the norm2 rescale, fc1 with the
// polynomial GELU and the qact1 requant, fc2 with the qact2 codes, the
// residual / qact4 fence.
//
// What bounds it on the H100: at DeiT-S b=64 it does 581 G int8 operations
// (294 us of tensor-core peak) on 21.2 MB of weights and 9.7 MB of codes;
// at b=1, 9.1 G operations and the weights' bytes (6.6 us).  Between the
// GEMMs are row reductions (the LNs) and per-(image, head) attention,
// which need every block's output of the step before.
//
// Design: one cooperative launch of persistent blocks of 288 threads (two
// consumer warpgroups of the GEMM mainloop and its producer warp), as
// many as the largest step has work items and the card holds at once:
// one an SM up to 256 rows (b = 1), where the GEMM ring's 8 stages take
// most of the shared memory; past 256 rows two an SM (the instance with
// __launch_bounds__(288, 2): 112 registers a thread, a ring of 4 stages),
// because the attention and the GEMM epilogues are latency-bound and want
// the warps: one block of 12 warps gave the attention 5-7 busy warps an
// SM at b = 8 and 64 and the epilogues 8, against K1's 15-21 and K2's 16,
// and at 384 threads two blocks leave 80 registers a thread, which the
// attention core and the fence epilogues exceed.  Every GEMM step runs
// 64 x 64 output tiles (the tile two blocks an SM hold without spilling;
// at b = 1 it also gives the most tiles).  A loop over the blocks of the
// encoder runs seven steps each,
// separated by a grid-wide barrier; each step spreads its work
// grid-stride over every image of the batch, with the two cores that the
// per-kernel path runs:
//  1. LN1, one warp a row (9 warps a block) -> int8 codes (act scratch)
//  2. qkv GEMM tiles on wgmma_gemm.cuh's mainloop (gemm_tiles: thread 256
//     issues TMA into the mbarrier ring, warpgroups 0-1 run wgmma and the
//     epilogue) with K1's requant QkvOut -> qkv scratch (rows, 3C)
//  3. attention items on attention_mma.cuh's tensor-core core: an item is
//     (image, head, run of query tiles of 16), split as attn_plan's
//     attention_plan splits K1's core, so that b=1 still spreads over ~80
//     blocks; the block stages the head's K and V (stage_kv), each warp
//     runs attend_rows on a tile (an item has at most 7), and the warps
//     past the item's tiles only stage.  The LIS exponential table
//     (fill_exp_table) is refilled each layer from its softmax scale ->
//     act scratch, in the (row, head*D) layout the proj reads
//  4. proj GEMM tiles; the epilogue ProjFenceOut runs the qact3, residual
//     and qact2 fences -> hc2 scratch
//  5. LN2 with the rescale, one warp a row -> act scratch
//  6. fc1 GEMM tiles with K2's GELU epilogue (int_mlp.cuh's Fc1Hidden) ->
//     hidden
//  7. fc2 GEMM tiles; the epilogue Fc2FenceOut runs the qact2 codes, the
//     residual and the qact4 fence -> the residual codes (out)
// The weights are K-major stacks (depth, N, K) that the Python side keeps
// (ops/kernels/serve.py), read through 2-D TMA maps from row l * N: no N
// tile crosses a layer (C and hid are multiples of 64).  The A maps read
// the act and hidden scratch.  The ring's barriers' phases carry from one
// GEMM step to the next across the whole forward; every stage a step
// loads it also consumes, so the attention step may reuse the ring's
// shared memory (the barriers sit before it, untouched).  The plan
// (stages, shared memory, blocks an SM, grid, the attention split) is
// serve.resident_plan's, in plain Python; the entry checks it and refuses
// one the card cannot co-schedule (occupancy below the plan's blocks an
// SM).  The scratch (act, hc2, qkv, hidden) is in device memory; at
// DeiT-S it fits in L2 with the 12 layers' weights.
//
// The grid barrier is cooperative_groups' own arrive-and-flip scheme on a
// counter in device memory that the wrapper zeroes: block 0 adds
// 2^31 - (blocks - 1), every other block 1, so the counter's top bit flips
// once all have arrived; __threadfence on both sides orders the steps'
// writes, and fence.proxy.async orders the generic stores of steps 1, 3, 5
// and 6 (and the epilogues') before the TMA (async proxy) reads of the
// next step: every thread fences its own writes before the arrival, and
// again after the block leaves the barrier (the TMA-issuing thread among
// them).  The
// cooperative launch guarantees that every block is resident; a wait
// beyond ~17 s traps rather than hang the card.  With a `stamps` buffer
// (scripts/port_resident.py; null when serving), thread 0 of block 0
// writes %globaltimer at the start and at each barrier's arrival and
// departure, and a last barrier closes step 7 of the last block.
//
// Exactness against resident_codes_plain (ops/kernels/serve.py): built with
// -fmad=false; rintf rounds half to even; the LayerNorm sums the codes in
// int64, converts the sums to float (round to nearest), takes the root in
// double rounded to float, gets floor(log2) from ilogbf and 2^n from
// ldexpf, and divides with IEEE divisions (nvcc's -prec-div=true default);
// the GEMMs' int32 sums are exact in any order; the attention core, the
// GEMM epilogues and the GELU are the ones K1 and K2 run.
#include <cstdint>
#include <cuda_runtime.h>

#include "attention_core.cuh"
#include "attention_mma.cuh"
#include "int_ln.cuh"
#include "int_mlp.cuh"
#include "lis.cuh"
#include "wgmma_gemm.cuh"

namespace {

namespace amma = dvt::amma;
namespace wg = dvt::wg;

// vec slots (per layer, C-wide f32) and scal slots (per layer, f32), as in
// ops/kernels/serve.py
constexpr int kVInScale = 0, kVLn1Mask = 1, kVLn1W = 2, kVLn1B = 3, kVLn1Out = 4,
              kVProjMult = 5, kVProjB = 6, kVS3 = 7, kVSblk2 = 8, kVLn2Mask = 9,
              kVLn2W = 10, kVLn2B = 11, kVLn2Out = 12, kVLn2Rescale = 13, kVS4 = 14,
              kNV = 15;
constexpr int kSSa = 0, kSC1 = 1, kSS1OverS2 = 2, kSM1Inv = 3, kSLn1Min = 4,
              kSLn2Min = 5, kNS = 6;
// two consumer warpgroups and a producer warp (gemm_tiles' ProducerLast
// layout): 112 registers a thread at two blocks an SM
constexpr int kThreads = 288;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;  // every GEMM step's output tile: kTile x kTile
constexpr int kMaxKB = 8;               // 256 keys a row (attention.py's MAX_KEYS)
constexpr int kDP = 64;                 // the head width, zero-padded to 64
constexpr float kStdFloor = 1e-37f;
// a warp's attention scratch: its packed scores (the LIS) or the float
// softmax's buffers (attn_plan.py's CODE_BYTES, soft_bytes(256, 1))
constexpr int kLisScratch = amma::PackedScores<8 * kMaxKB>::kBytes;
constexpr int kSoftScratch = amma::kRows * 32 * kMaxKB + 32 * kMaxKB * 4;

struct Params {
  const int8_t* x;  // (rows, C) codes on the qact1 grid
  int8_t* out;      // (rows, C) residual codes; the result
  const float *mb, *vec, *vhid, *vout, *scal;
  int8_t *act, *hc2, *qkv, *hidden;  // scratch
  unsigned* barrier;
  unsigned long long* stamps;  // null, or 1 + 2 * 7 * depth %globaltimer slots
  int depth, nelems, npad, n_real, c, hid, heads, d, lis, lis_fast;
  int stages, a_tiles, a_split;  // the plan
};

// The TMA maps: A over the act (rows, C) and hidden (rows, hid) scratch,
// W over the four K-major weight stacks (depth * N rows of K bytes).
struct Maps {
  CUtensorMap act, hidden, wqkv, wproj, w1, w2;
};

// The attention part of the dynamic shared memory, past the ring's
// barriers: the exponential table, one (image, head)'s keys and values and
// each warp's scratch (resident_plan's attn_smem).
__host__ __device__ amma::KvGeom kv_geom(int n_real, int lis) {
  return amma::KvGeom{(n_real + 31) / 32 * 32, kDP, lis == 0};
}

int attn_smem(int n_real, int lis) {
  return wg::kBarrierBytes + amma::kExpBytes + kv_geom(n_real, lis).bytes() +
         kWarps * (lis ? kLisScratch : kSoftScratch);
}

// A block that waits longer than this many clock cycles (~17 s at the H100's
// clock) traps: the launch then fails with an error instead of hanging.
constexpr long long kBarrierTimeout = 1ll << 35;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// `stamp`: null, or block 0's two slots for this barrier (its arrival and
// its departure).
__device__ __forceinline__ void grid_barrier(unsigned* bar, unsigned long long* stamp) {
  asm volatile("fence.proxy.async;\n" ::: "memory");  // this thread's stores before TMA reads
  __syncthreads();
  if (threadIdx.x == 0) {
    if (stamp != nullptr) stamp[0] = global_ns();
    const unsigned add = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    __threadfence();
    const unsigned old = atomicAdd(bar, add);
    const long long t0 = clock64();
    while (((old ^ *reinterpret_cast<volatile unsigned*>(bar)) & 0x80000000u) == 0)
      if (clock64() - t0 > kBarrierTimeout) __trap();
    __threadfence();
    if (stamp != nullptr) stamp[1] = global_ns();
  }
  __syncthreads();
  // the other blocks' stores before this block's TMA reads (the issuing
  // thread among these)
  asm volatile("fence.proxy.async;\n" ::: "memory");
}

// The integer LayerNorm of one row by one warp (ops/int_layernorm.ln_codes
// with the std floor of _ln_emit), then the optional rescale and the clip.
// Lane l takes channels 4l .. 4l + 3 of every 128 (C % 64 == 0): a word of
// codes and a float4 of each vector a step, so that a pass over a 384-wide
// row is three steps of a few wide loads a lane rather than twelve of
// five narrow ones, each waiting on the last; the int64 sums are exact in
// any order, and each channel's arithmetic is the plain version's.
__device__ void ln_row(const int8_t* xrow, int8_t* yrow, int c, const float* mask,
                       float s_min, const float* w, const float* b,
                       const float* out_scale, const float* rescale, int lane) {
  long long sx = 0, sx2 = 0;
#pragma unroll 2
  for (int j = 4 * lane; j < c; j += 128) {
    const char4 xv = *reinterpret_cast<const char4*>(xrow + j);
    const float4 mv = *reinterpret_cast<const float4*>(mask + j);
    const float x4[4] = {static_cast<float>(xv.x), static_cast<float>(xv.y),
                         static_cast<float>(xv.z), static_cast<float>(xv.w)};
    const float m4[4] = {mv.x, mv.y, mv.z, mv.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long xq = static_cast<long long>(x4[e] * m4[e]);
      sx += xq;
      sx2 += xq * xq;
    }
  }
  sx = dvt::warp_sum(sx);
  sx2 = dvt::warp_sum(sx2);
  const float fsx = static_cast<float>(sx), fsx2 = static_cast<float>(sx2);
  const float cf = static_cast<float>(c);
  const float mean = (fsx / cf) * s_min;
  const float var = cf * fsx2 - fsx * fsx;
  float std = (s_min / cf) * static_cast<float>(sqrt(static_cast<double>(var)));
  if (std < kStdFloor) std = kStdFloor;  // a NaN stays NaN, as torch.maximum
  const float sd = s_min / std, ms = mean / std;
#pragma unroll 2
  for (int j = 4 * lane; j < c; j += 128) {
    const char4 xv = *reinterpret_cast<const char4*>(xrow + j);
    const float4 mv = *reinterpret_cast<const float4*>(mask + j);
    const float4 wv = *reinterpret_cast<const float4*>(w + j);
    const float4 bv = *reinterpret_cast<const float4*>(b + j);
    const float4 ov = *reinterpret_cast<const float4*>(out_scale + j);
    const float4 rv = rescale != nullptr ? *reinterpret_cast<const float4*>(rescale + j)
                                         : make_float4(1.f, 1.f, 1.f, 1.f);
    const float x4[4] = {static_cast<float>(xv.x), static_cast<float>(xv.y),
                         static_cast<float>(xv.z), static_cast<float>(xv.w)};
    const float m4[4] = {mv.x, mv.y, mv.z, mv.w}, w4[4] = {wv.x, wv.y, wv.z, wv.w};
    const float b4[4] = {bv.x, bv.y, bv.z, bv.w}, o4[4] = {ov.x, ov.y, ov.z, ov.w};
    const float r4[4] = {rv.x, rv.y, rv.z, rv.w};
    int8_t y4[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float xq = x4[e] * m4[e];
      const float a = (sd * w4[e]) / o4[e];
      const dvt::Mn mn = dvt::get_mn(fabsf(a));
      const float sgn = a > 0.f ? 1.f : (a < 0.f ? -1.f : 0.f);
      const float bq = rintf((b4[e] - ms * w4[e]) / o4[e] * mn.p2n);
      float y = rintf((sgn * mn.m * xq + bq) / mn.p2n);
      if (rescale != nullptr) y = rintf(y * r4[e]);
      y4[e] = dvt::clip_i8(y);
    }
    *reinterpret_cast<char4*>(yrow + j) = make_char4(y4[0], y4[1], y4[2], y4[3]);
  }
}

// The epilogues carry one base pointer to the layer's vectors rather than
// one a vector, and index rows in 32 bits (the entry checks rows * 3C and
// rows * hid against 2^31): each step's functor, the ring and the
// per-layer pointers are rebuilt inside the step from the launch's
// parameters (param space) and the layer, so that little stays live across
// steps and the two-block instance's 80 registers hold every step without
// spilling.

// proj (wgmma_gemm.cuh's returning contract): y = acc * mult + b; qact3
// codes; residual with the block's input codes at (r, c); qact2 codes ->
// hc2.
struct ProjFenceOut {
  using Out = int8_t;
  const float* v;    // the layer's (15, ld) vectors
  const int8_t* hc;  // the block's input codes (rows, ld)
  int8_t* out;       // hc2 (rows, ld)
  int ld;
  __device__ int8_t operator()(int r, int c, int acc) const {
    const float s3 = v[kVS3 * ld + c];
    const float y = static_cast<float>(acc) * v[kVProjMult * ld + c] + v[kVProjB * ld + c];
    const float yq3 = fminf(fmaxf(rintf(y / s3), -128.f), 127.f);
    const float hs = static_cast<float>(hc[r * ld + c]) * v[kVInScale * ld + c] + yq3 * s3;
    return dvt::clip_i8(rintf(hs / v[kVSblk2 * ld + c]));
  }
};

// fc2: y2 = acc * mult + b; mlp.qact2 codes; residual with hc2 at (r, c);
// qact4 codes -> the residual stream.
struct Fc2FenceOut {
  using Out = int8_t;
  const float* vo;    // the layer's (4, ld) [mult, bias, s_m2, 1/s_m2]
  const float* v;     // the layer's (15, ld) vectors
  const int8_t* hc2;  // (rows, ld)
  int8_t* out;        // (rows, ld)
  int ld;
  __device__ int8_t operator()(int r, int c, int acc) const {
    const float y2 = static_cast<float>(acc) * vo[c] + vo[ld + c];
    const float y2c = fminf(fmaxf(rintf(y2 * vo[3 * ld + c]), -128.f), 127.f);
    const float hs =
        static_cast<float>(hc2[r * ld + c]) * v[kVSblk2 * ld + c] + y2c * vo[2 * ld + c];
    return dvt::clip_i8(rintf(hs / v[kVS4 * ld + c]));
  }
};

// The ring in the dynamic shared memory, as the plan lays it out.
__device__ __forceinline__ wg::Ring ring_of(const Params& p, uint8_t* smem) {
  return wg::ring_layout(smem, kTile * wg::kBK, kTile * wg::kBK, p.stages);
}

// One GEMM step: this block's kTile x kTile output tiles of C[M, N] =
// A @ W, W from row w_row0 of its stack.  The ring's position carries
// from step to step in `shared_pos` (every thread reads it at the start; a
// consumer thread, which has walked every stage the step loaded, writes it
// at the end), so that nothing of the ring stays live in registers through
// the other steps.
template <class Epi>
__device__ __forceinline__ void gemm_step(const Params& p, uint8_t* smem, const CUtensorMap* a,
                                          const CUtensorMap* w, int N, int K, int w_row0,
                                          const Epi& epi, wg::RingPos& shared_pos) {
  wg::RingPos pos = shared_pos;
  __syncthreads();  // every thread has read it before a consumer writes it
  wg::gemm_tiles<kTile, kTile, 0, true>(a, w, p.nelems * p.npad, N, K, w_row0, epi,
                                        ring_of(p, smem), pos, blockIdx.x, gridDim.x);
  if (threadIdx.x == 0) shared_pos = pos;
}

// Steps 1 and 5: the LN of every row, one warp a row over the grid.  LN1
// reads the block's input codes (x, then the last block's out), LN2 hc2
// with the norm2 rescale.
__device__ __forceinline__ void ln_step(const Params& p, int l, bool second) {
  const int rows = p.nelems * p.npad, c = p.c;
  const float* v = p.vec + (size_t)l * kNV * c;
  const float* s = p.scal + l * kNS;
  const int8_t* src = second ? p.hc2 : (l == 0 ? p.x : p.out);
  const int lane = threadIdx.x & 31;
  const int nwarps = gridDim.x * kWarps;
  for (int r = blockIdx.x * kWarps + (threadIdx.x >> 5); r < rows; r += nwarps) {
    if (second)
      ln_row(src + (size_t)r * c, p.act + (size_t)r * c, c, v + kVLn2Mask * c, s[kSLn2Min],
             v + kVLn2W * c, v + kVLn2B * c, v + kVLn2Out * c, v + kVLn2Rescale * c, lane);
    else
      ln_row(src + (size_t)r * c, p.act + (size_t)r * c, c, v + kVLn1Mask * c, s[kSLn1Min],
             v + kVLn1W * c, v + kVLn1B * c, v + kVLn1Out * c, nullptr, lane);
  }
}

// Step 3: every (image, head, run of a_tiles query tiles) item of this
// block: the block's threads stage the head's keys and values, then warp
// w takes the item's tiles w, w + kWarps, ...  `attn`: the attention part
// of the shared memory.
template <bool Lis>
__device__ __forceinline__ void attention_items(const Params& p, int l, uint8_t* attn) {
  const int c = p.c, c3 = 3 * c;
  const float* s = p.scal + l * kNS;
  const int warp = threadIdx.x >> 5;
  const amma::KvGeom g = kv_geom(p.n_real, Lis);
  const float s_a = s[kSSa];
  const amma::ExpTable et = amma::fill_exp_table(attn, dvt::lis_consts(s_a, p.lis == dvt::kLisWide),
                                                 p.lis_fast != 0);
  uint8_t* const kv = attn + amma::kExpBytes;
  uint8_t* const scratch = kv + g.bytes() + warp * (Lis ? kLisScratch : kSoftScratch);
  const amma::SoftArgs a{p.n_real, p.d, et, s_a, s[kSS1OverS2]};
  const amma::QkvChain chain{s[kSC1], 0.f};
  const int q_tiles = (p.npad + amma::kRows - 1) / amma::kRows;
  const int items = p.nelems * p.heads * p.a_split;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int x = item % p.a_split, h = item / p.a_split % p.heads;
    const int b = item / (p.a_split * p.heads);
    // the block is done with the last item's keys (and has filled the table)
    __syncthreads();
    const int8_t* base = p.qkv + (size_t)b * p.npad * c3 + h * p.d;
    amma::stage_kv(base + c, base + 2 * c, c3, p.n_real, p.d, g, kv);
    __syncthreads();
    const int t1 = min((x + 1) * p.a_tiles, q_tiles);
    for (int tile = x * p.a_tiles + warp; tile < t1; tile += kWarps) {
      const int q0 = tile * amma::kRows;
      const amma::RowTile rt{base + (size_t)q0 * c3, c3,
                             p.act + ((size_t)b * p.npad + q0) * c + h * p.d, c,
                             min(amma::kRows, p.npad - q0)};
      amma::attend_rows<kMaxKB, kDP, Lis>(rt, kv, g, a, chain, scratch);
    }
  }
}

// The grid barrier after step `step` of layer l, with block 0's stamps
// when the launch keeps them.
__device__ __forceinline__ void step_barrier(const Params& p, int l, int step) {
  unsigned long long* stamp = nullptr;
  if (p.stamps != nullptr && blockIdx.x == 0) stamp = p.stamps + 1 + 2 * (7 * l + step);
  grid_barrier(p.barrier, stamp);
}

// B: blocks an SM (1, or 2 past 256 rows where the plan's footprint
// admits them).
template <int B>
__global__ void __launch_bounds__(kThreads, B)
    resident_kernel(const __grid_constant__ Maps maps, const Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ wg::RingPos pos;  // the ring's place, carried across the steps
  wg::ring_init(ring_of(p, smem));
  if (threadIdx.x == 0) {
    pos = wg::RingPos{0, 0};
    if (p.stamps != nullptr && blockIdx.x == 0) p.stamps[0] = global_ns();
  }
  __syncthreads();

  for (int l = 0; l < p.depth; ++l) {
    const int c = p.c, c3 = 3 * c, hid = p.hid;
    ln_step(p, l, false);  // 1. LN1
    step_barrier(p, l, 0);

    gemm_step(p, smem, &maps.act, &maps.wqkv, c3, c, l * c3,  // 2. qkv
                 dvt::QkvOut{p.mb + (size_t)l * 2 * c3, p.qkv, c3, nullptr}, pos);
    step_barrier(p, l, 1);

    if (p.lis)  // 3. attention
      attention_items<true>(p, l, smem + wg::kBarrierBytes);
    else
      attention_items<false>(p, l, smem + wg::kBarrierBytes);
    step_barrier(p, l, 2);

    gemm_step(p, smem, &maps.act, &maps.wproj, c, c, l * c,  // 4. proj + fences
                 ProjFenceOut{p.vec + (size_t)l * kNV * c, l == 0 ? p.x : p.out, p.hc2, c},
                 pos);
    step_barrier(p, l, 3);

    ln_step(p, l, true);  // 5. LN2
    step_barrier(p, l, 4);

    const float* vh = p.vhid + (size_t)l * 2 * hid;
    gemm_step(p, smem, &maps.act, &maps.w1, hid, c, l * hid,  // 6. fc1 + GELU
                 dvt::Fc1Hidden{vh, vh + hid, p.scal + l * kNS + kSM1Inv, p.hidden, hid}, pos);
    step_barrier(p, l, 5);

    gemm_step(p, smem, &maps.hidden, &maps.w2, c, hid, l * c,  // 7. fc2 + fences
                 Fc2FenceOut{p.vout + (size_t)l * 4 * c, p.vec + (size_t)l * kNV * c, p.hc2,
                             p.out, c},
                 pos);
    if (l + 1 < p.depth || p.stamps != nullptr) step_barrier(p, l, 6);
  }
}

const void* kernel(int blocks) {
  return blocks == 2 ? reinterpret_cast<const void*>(resident_kernel<2>)
                     : reinterpret_cast<const void*>(resident_kernel<1>);
}

}  // namespace

// x: (nelems * npad, C) int8 codes on the qact1 grid; out: the same shape,
// the residual codes after the last block; the weights K-major: wqkv
// (depth, 3C, C), wproj (depth, C, H*D) (K in the head-major order of the
// attention output), w1 (depth, hid, C), w2 (depth, C, hid) int8; mb
// (depth, 2, 3C), vec (depth, 15, C), vhid (depth, 2, hid), vout (depth, 4,
// C), scal (depth, 6) f32 (slots as in ops/kernels/serve.py); scratch:
// nelems * npad * (5C + hid) bytes, 16-byte aligned; barrier: one zeroed
// unsigned; stamps: null, or 1 + 14 * depth zeroed uint64 (step times).
// lis: 1 for the LIS, 2 for the LIS with the 128-bit row sum (lis.cuh's
// kLisWide), 0 for the bfloat16 float softmax.  stages .. a_split:
// serve.resident_plan's.  Requires n_real <= min(npad, 256), D <= 64,
// D % 4 == 0, C and hid multiples of 64 (checked by the Python wrapper;
// the plan's checks again here).
extern "C" int dvt_resident_codes(const void* x, void* out, const void* wqkv,
                                  const void* wproj, const void* w1, const void* w2,
                                  const void* mb, const void* vec, const void* vhid,
                                  const void* vout, const void* scal, void* scratch,
                                  void* barrier, void* stamps, int depth, int nelems, int npad,
                                  int n_real, int c, int hid, int heads, int d, int lis,
                                  int lis_fast, int stages, int smem, int blocks, int grid,
                                  int a_tiles, int a_split, void* stream) {
  const int rows = nelems * npad;
  const int q_tiles = (npad + dvt::amma::kRows - 1) / dvt::amma::kRows;
  // N % kTile == 0 at every step: no tile crosses a layer of a weight stack
  if (c % kTile != 0 || hid % kTile != 0 || stages < 2 || stages > wg::kMaxStages ||
      smem < wg::smem_bytes(kTile, kTile, stages) || smem < attn_smem(n_real, lis) ||
      a_tiles < 1 || a_tiles > kWarps || a_split * a_tiles < q_tiles || grid < 1 ||
      blocks < 1 || blocks > 2 || nelems < 1 || n_real < 1 || n_real > npad ||
      n_real > 32 * kMaxKB || d > kDP || d % 4 != 0 || heads * d != c ||
      (long long)rows * (3 * c > hid ? 3 * c : hid) >= (1ll << 31))
    return cudaErrorInvalidValue;

  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  // refused here rather than by cudaFuncSetAttribute, whose error the
  // next launch's cudaGetLastError would report again
  if (smem > optin) return cudaErrorInvalidValue;
  err = dvt::amma::allow_smem(kernel(blocks), smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel(blocks), kThreads, smem);
  if (err != cudaSuccess) return err;
  // the plan's blocks an SM must be resident at once, as must the grid
  if (per_sm < blocks || grid > blocks * sms) return cudaErrorCooperativeLaunchTooLarge;

  int8_t* sp = static_cast<int8_t*>(scratch);
  int8_t* act = sp;
  int8_t* hidden = sp + (size_t)5 * rows * c;
  Maps maps;
  const long long lc = c, lh = hid;
  if ((err = wg::tensor_map(&maps.act, act, c, rows, lc, kTile)) != cudaSuccess ||
      (err = wg::tensor_map(&maps.hidden, hidden, hid, rows, lh, kTile)) != cudaSuccess ||
      (err = wg::tensor_map(&maps.wqkv, wqkv, c, depth * 3 * c, lc, kTile)) != cudaSuccess ||
      (err = wg::tensor_map(&maps.wproj, wproj, c, depth * c, lc, kTile)) != cudaSuccess ||
      (err = wg::tensor_map(&maps.w1, w1, c, depth * hid, lc, kTile)) != cudaSuccess ||
      (err = wg::tensor_map(&maps.w2, w2, hid, depth * c, lh, kTile)) != cudaSuccess)
    return err;
  Params p{static_cast<const int8_t*>(x),
           static_cast<int8_t*>(out),
           static_cast<const float*>(mb),
           static_cast<const float*>(vec),
           static_cast<const float*>(vhid),
           static_cast<const float*>(vout),
           static_cast<const float*>(scal),
           act,
           sp + (size_t)rows * c,
           sp + (size_t)2 * rows * c,
           hidden,
           static_cast<unsigned*>(barrier),
           static_cast<unsigned long long*>(stamps),
           depth, nelems, npad, n_real, c, hid, heads, d, lis, lis_fast,
           stages, a_tiles, a_split};
  void* args[] = {&maps, &p};
  err = cudaLaunchCooperativeKernel(kernel(blocks), dim3(static_cast<unsigned>(grid)), dim3(kThreads),
                                    args, static_cast<size_t>(smem),
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The footprint of K6's instance for `blocks` blocks an SM at `smem` bytes
// of dynamic shared memory: registers and local memory (spills) a thread,
// shared memory a block, blocks an SM.
extern "C" int dvt_resident_footprint(int blocks, int smem, int* registers, int* local_bytes,
                                      int* smem_bytes, int* blocks_per_sm) {
  return dvt::amma::footprint(kernel(blocks), kWarps, smem, registers, local_bytes, smem_bytes,
                              blocks_per_sm);
}
