// The tensor-core attention core of K1, K5, K7a and K8 (qkv_attention.cu),
// of K4/K4b (swin_attention.cu) and of the resident encoder K6
// (resident.cu, inside its persistent launch): for 16 query rows a warp, integer
// scores on mma.sync, a per-score chain onto the softmax's grid (K1's c1
// requant, or Swin's bias / requant / mask), the Log-Int-Softmax (or the
// float softmax) and attn@v, requantized onto the output grid.
//
// Replaces the SIMT core (attention_core.cuh's attention_item, which the
// probes P1 and P5 keep): one warp a query row, scores
// by __dp4a over shared-memory words, attn@v a per-lane loop over the keys
// with two shared-memory loads for every 32 multiply-adds.  At DeiT-S b=64
// that loop alone issued ~60 M warp-level loads (~0.27 ms at one a clock
// an SM) and the scores ~0.07 ms more, most of K1's and K4's ~0.49 ms.
//
// What bounds it on the H100: the products are small tensor-core work
// (DeiT-S b=64: 1.9 G int8 MACs, ~2 us of peak) and the bytes are few
// (K5: 19.4 MB, 5.8 us); what is left is the per-score SIMT chain of the
// LIS (an IEEE division and a log2 a weight, a max and an exact int64
// sum a row), latency-bound, so the design spends registers on warps:
//  * Scores: mma.sync.m16n8k32 s8 x s8 -> s32, A = 16 query rows (loaded
//    from global memory straight into fragments), B = 8 keys a tile from
//    shared memory; D is zero-padded to DP = 32 or 64.  The int32 sums are
//    exact, so they equal __dp4a's bit for bit.
//  * The chain maps each int32 score onto the softmax's grid at once and
//    the results go to the warp's shared memory, lane-interleaved: K1's
//    int8 codes four a word (PackedScores), Swin's float values
//    (FloatScores; a float mask is added).  Held in registers, a 256-key
//    row cost 32 registers a thread and the LIS spilled at two blocks an
//    SM.
//  * The LIS row on the accumulator layout (lis.cuh's lis_row_quad): a row
//    is held by the four lanes of a quad, its max and its exact int64 sum
//    reduce over shfl_xor 1 and 2; the two rows run side by side, a few
//    words of slots a loop step.  Each weight is kept as the selectors of
//    its two u8 planes, written over its score in the A-fragment order of
//    attn@v.
//  * The integer exponential depends only on x = max(a - row_max, x_lo),
//    an integer in [-255, 0] or x_lo for these scores, so each block fills
//    a table of it once (ExpTable) from lis_exp itself; a Swin tile whose
//    x the table lacks (a vote) computes it.  That leaves one IEEE
//    division a score.
//  * attn@v on mma.sync.m16n8k32 u8 x s8: a weight w = 2^(15-code) in
//    {0, 1, ..., 2^15} splits into two u8 planes, hi = w >> 8 and
//    lo = w & 255 (each <= 128), and acc = 256 * (P_hi V) + (P_lo V) in
//    int32 is the exact sum of w * v (|256 * P_hi V| <= 2^30).  The
//    accumulator layout holds keys {2t, 2t+1, 8+2t, 9+2t} of a 32-key
//    block where the A fragment expects {4t .. 4t+3}, so V^T is staged
//    with its keys in that order (key_slot) and the planes are built from
//    the lane's own words, two byte permutes a word (weight_planes).  D in
//    steps of 16 columns: 16 accumulators a thread.
//  * The float softmax (Lis = false, its own kernel instance; off the main
//    paths) takes its scores from the same mma, writes them to a per-warp
//    buffer and runs attention_core.cuh's softmax_row_bf16 and double
//    attn@v a row at a time, as the SIMT core does: exact in any order of
//    the sum.
//  * Shared memory: K (keys x DP, words padded to an odd multiple of 4:
//    the fragment loads hit 32 distinct banks) and V^T (DP x keys, same
//    rule), staged once per block; a block takes one (image, head) and
//    several query tiles, or one head and several windows (attn_plan.py
//    chooses, so the grid fills the SMs at b = 1 too).  Keys at or past
//    n_real get weight 0; query rows past npad are not stored.
// Every register array is indexed with compile-time indices only (fully
// unrolled loops with run-time guards), so nothing spills to local memory
// (the card tests check the footprint).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "attention_core.cuh"  // softmax_row_bf16, clip_i8
#include "lis.cuh"

namespace dvt {
namespace amma {

constexpr int kRows = 16;     // query rows a warp: mma.sync's m16

// D[16 x 8] += A[16 x 32] B[32 x 8], s8 x s8 -> s32, A row-major, B
// column-major (K-major).
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The same with an unsigned A: u8 x s8 -> s32.
__device__ __forceinline__ void mma_u8s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The column of key j in the staged V^T rows: inside each block of 32
// keys, lane t of a quad holds keys 2t, 2t+1, 8+2t, 9+2t of each half in
// its score accumulators, and the A fragment of attn@v reads them as k
// indices 4t .. 4t+3 (attn_plan.key_slot).
__host__ __device__ constexpr int key_slot(int j) {
  return (j & ~15) + 4 * ((j & 7) >> 1) + 2 * ((j >> 3) & 1) + (j & 1);
}

// Shared-memory geometry of one (image or window, head)'s keys and values:
// K rows of DP + 16 bytes, V^T rows of keys_pad + 16 bytes (both an odd
// multiple of 16 bytes: a fragment load's 8 rows x 4 words fall in 32
// distinct banks); keys_pad = n_real rounded up to 32.  The float softmax
// also keeps V's rows as they are, for its per-lane attn@v over the keys
// (V^T's columns would put a warp's 32 lanes on 8 banks).
struct KvGeom {
  int keys_pad, dp;
  bool v_rows;  // V also in its natural rows (keys_pad x DP): the float softmax's
  __host__ __device__ int k_pitch() const { return dp + 16; }
  __host__ __device__ int v_pitch() const { return keys_pad + 16; }
  __host__ __device__ int bytes() const {
    return keys_pad * k_pitch() + dp * v_pitch() + (v_rows ? keys_pad * dp : 0);
  }
};

__host__ __device__ inline KvGeom kv_geom(int n_real, int d, bool lis) {
  return KvGeom{(n_real + 31) / 32 * 32, d <= 32 ? 32 : 64, !lis};
}

// Bytes of the float softmax's per-warp buffers: a row of max_keys values
// for each of the 16 rows, and one row of weights (attn_plan.py's
// soft_bytes).
__host__ __device__ inline int soft_bytes(int max_keys, int value_bytes) {
  return kRows * max_keys * value_bytes + max_keys * 4;
}

// The LIS integer exponentials of one launch's softmax scale, a table a
// block: lis_exp of x = 0, -1, ..., -255 and of x_lo (entry 256), as float
// and as int64.  lis_exp depends on x = max(a - row_max, x_lo) alone, so a
// lookup is the computation's bit for bit.  K1's scores are int8 codes, so
// row_max - a is an integer in [0, 255] and always in the table; Swin's
// are too but for a masked key (a float mask is added), whose x is x_lo in
// practice: a tile whose x the table lacks anywhere computes its
// exponentials (table_covers).  The table takes the integer exponential
// (a division, a floor, a power of two) off the per-score chain.
constexpr int kExpEntries = 257;
constexpr int kExpBytes = (kExpEntries * 12 + 15) / 16 * 16;

struct ExpTable {
  const long long* ti;  // [kExpEntries] as int64
  const float* tf;      // [kExpEntries] as float
  LisConsts k;
  bool fast;
  // the entry of x = max(a - row_max, x_lo), or -1 where there is none
  __device__ int index(float x) const {
    if (x == k.x_lo) return 256;
    return x >= -255.f && x <= 0.f && x == rintf(x) ? static_cast<int>(-x) : -1;
  }
};

// lis_row_quad's exponentials from the table, for scores whose every x has
// an entry: int8 codes (Integral: row_max - a is the entry) or a tile that
// table_covers.
template <bool Integral>
struct ExpLookup {
  ExpTable t;
  __device__ int index(float a, float row_max) const {
    if (Integral) return static_cast<int>(row_max - a) & 255;
    const float x = fmaxf(a - row_max, t.k.x_lo);
    return x == t.k.x_lo ? 256 : static_cast<int>(-x);
  }
  __device__ float e(float a, float row_max) const { return t.tf[index(a, row_max)]; }
  __device__ long long ei(float a, float row_max) const { return t.ti[index(a, row_max)]; }
};

// lis_row_quad's exponentials computed (a tile the table does not cover).
struct ExpDirect {
  LisConsts k;
  bool fast;
  __device__ float e(float a, float row_max) const { return lis_exp(a, row_max, k, fast); }
  __device__ long long ei(float a, float row_max) const {
    return static_cast<long long>(lis_exp(a, row_max, k, fast));
  }
};

// Whether the table holds the exponential of every valid score of the
// warp's tile (a warp-wide vote: every lane gets the same answer).
template <int N, class Scores>
__device__ __forceinline__ bool table_covers(const Scores& sc, int n_keys, const ExpTable& et,
                                             int t) {
  bool bad = false;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float m = -INFINITY;
#pragma unroll(4 * Scores::kUnroll)
    for (int u = 0; u < N; ++u)
      if (sc.key(u, t) < n_keys) m = fmaxf(m, sc.get(r, u));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
#pragma unroll(4 * Scores::kUnroll)
    for (int u = 0; u < N; ++u)
      if (sc.key(u, t) < n_keys) bad |= et.index(fmaxf(sc.get(r, u) - m, et.k.x_lo)) < 0;
  }
  return !__any_sync(0xffffffffu, bad);
}

// Fills the table at `smem` (kExpBytes) with the block's threads; the
// caller synchronizes before the first lookup.
__device__ __forceinline__ ExpTable fill_exp_table(uint8_t* smem, const LisConsts& k,
                                                   bool fast) {
  long long* const ti = reinterpret_cast<long long*>(smem);
  float* const tf = reinterpret_cast<float*>(smem + kExpEntries * 8);
  for (int n = threadIdx.x; n < kExpEntries; n += blockDim.x) {
    const float x = n < 256 ? -static_cast<float>(n) : k.x_lo;
    const float e = lis_exp(x, 0.f, k, fast);
    tf[n] = e;
    ti[n] = static_cast<long long>(e);
  }
  return ExpTable{ti, tf, k, fast};
}

__device__ __forceinline__ uint32_t load_word(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Stages n_real keys and values (rows `row` bytes apart from k_src and
// v_src, d bytes each) into `kv` (geometry g) with the block's threads:
// K as words, zero past d and past n_real; V^T with its keys in key_slot
// order, zero likewise (and, where g.v_rows, V's rows as they are).  A
// thread takes one word of D of four keys that share a word of V^T, and
// transposes them with byte permutes, so every store is a whole word and
// consecutive threads store consecutive words.
__device__ __forceinline__ void stage_kv(const int8_t* k_src, const int8_t* v_src,
                                         long long row, int n_real, int d, const KvGeom& g,
                                         uint8_t* kv) {
  uint32_t* const k = reinterpret_cast<uint32_t*>(kv);
  uint32_t* const vt = reinterpret_cast<uint32_t*>(kv + g.keys_pad * g.k_pitch());
  const int kw = g.k_pitch() / 4, vw = g.v_pitch() / 4, dw = g.dp / 4;
  const int words = d / 4;
  // unrolled so that a thread has several loads in flight before it stores
#pragma unroll 8
  for (int idx = threadIdx.x; idx < g.keys_pad * dw; idx += blockDim.x) {
    const int j = idx / dw, w = idx % dw;
    k[j * kw + w] = j < n_real && w < words ? load_word(k_src + j * row + 4 * w) : 0u;
  }
  // quartets of keys {j0, j0 + 1, j0 + 8, j0 + 9}: one word of V^T a row
  const int quartets = g.keys_pad / 4;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < quartets * dw; idx += blockDim.x) {
    const int qd = idx % quartets, w = idx / quartets;
    const int j0 = (qd & ~7) * 4 + (qd >> 2 & 1) * 16 + (qd & 3) * 2;
    uint32_t x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = j0 + (i & 1) + 8 * (i >> 1);
      x[i] = j < n_real && w < words ? load_word(v_src + j * row + 4 * w) : 0u;
    }
    // byte b of x[i] is element (key i, d = 4w + b); row 4w + b of V^T
    // takes byte b of each x[i], in order i
    const uint32_t lo01 = __byte_perm(x[0], x[1], 0x5140);  // b0 b0' b1 b1'
    const uint32_t hi01 = __byte_perm(x[0], x[1], 0x7362);  // b2 b2' b3 b3'
    const uint32_t lo23 = __byte_perm(x[2], x[3], 0x5140);
    const uint32_t hi23 = __byte_perm(x[2], x[3], 0x7362);
    const int col = key_slot(j0) / 4;
    vt[(4 * w + 0) * vw + col] = __byte_perm(lo01, lo23, 0x5410);
    vt[(4 * w + 1) * vw + col] = __byte_perm(lo01, lo23, 0x7632);
    vt[(4 * w + 2) * vw + col] = __byte_perm(hi01, hi23, 0x5410);
    vt[(4 * w + 3) * vw + col] = __byte_perm(hi01, hi23, 0x7632);
    if (g.v_rows) {
      uint32_t* const vr = vt + g.dp * vw;
#pragma unroll
      for (int i = 0; i < 4; ++i) vr[(j0 + (i & 1) + 8 * (i >> 1)) * dw + w] = x[i];
    }
  }
}

// The LIS weights w = 2^shift (shift = 15 - code, 0 for kLisZero) of four
// keys as the two u8 planes of attn@v, hi = w >> 8 and lo = w & 255, each
// one byte permute of the table {1, 2, 4, ..., 128}: a key's selector
// nibble picks its power of two, or (nibble 8: the sign of the byte 1)
// zero.  A word keeps the four keys' lo selectors in bits 0-15 and their
// hi selectors in bits 16-31 (plane_selectors), so building the planes of
// a block of keys costs two instructions a word.
__device__ __forceinline__ uint32_t plane_selectors(int shift, int slot) {
  const uint32_t lo = shift < 8 ? shift : 8u;
  const uint32_t hi = shift >= 8 && shift < 16 ? shift - 8 : 8u;
  return lo << (4 * slot) | hi << (16 + 4 * slot);
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

__device__ __forceinline__ void weight_planes(uint32_t sel, uint32_t& hi, uint32_t& lo) {
  constexpr uint32_t kPow0 = 0x08040201u, kPow1 = 0x80402010u;  // 2^0 .. 2^7
  lo = prmt(kPow0, kPow1, sel & 0xFFFFu);
  hi = prmt(kPow0, kPow1, sel >> 16);
}

// A thread's scores of its quad's two rows r = 0, 1 (rows g and g + 8 of
// the warp's 16): slot u = 2j + e holds key 8j + 2t + e of key tile j.
template <int N>
struct SlotKeys {
  __device__ static int key(int u, int t) { return 8 * (u >> 1) + 2 * t + (u & 1); }
};

// int8 values, four a word, in the A-fragment order of attn@v (word
// u / 4 of row r holds slots 4(u / 4) .. +3), kept in the warp's shared
// memory rather than in registers: 2 * N / 4 words a lane, lane
// interleaved (consecutive lanes, consecutive words), read back with one
// load for four slots.  K1's 256-key row would otherwise hold 32 registers
// a thread through the LIS and cost the core half its blocks an SM.
template <int N>
struct PackedScores : SlotKeys<N> {
  static constexpr int kBytes = 2 * (N / 4) * 32 * 4;  // a warp's buffer
  // words a loop step: two, so that the LIS's chains of a few words
  // interleave without holding a 256-key row's in registers
  static constexpr int kUnroll = 2;
  uint32_t* w;                                          // this lane's first word
  __device__ PackedScores(uint32_t* buf, int lane) : w(buf + lane) {}
  // slots 4p .. 4p+3 of both rows: v[tile][2r + e] of key tiles 2p, 2p+1
  __device__ void put4(int p, const float (&v)[2][4]) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      uint32_t word = 0u;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        word |= static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int>(v[i >> 1][2 * r + (i & 1)])))
                << (8 * i);
      w[(r * (N / 4) + p) * 32] = word;
    }
  }
  __device__ float get(int r, int u) const {
    return static_cast<float>(
        static_cast<int8_t>(w[(r * (N / 4) + (u >> 2)) * 32] >> (8 * (u & 3))));
  }
  // the LIS weights' plane selectors replace the codes word by word, in
  // place: a word is stored once its four slots have been read
  uint32_t word_[2];
  __device__ void put_shift(int r, int u, int s) {
    if ((u & 3) == 0) word_[r] = 0u;
    word_[r] |= plane_selectors(s, u & 3);
    if ((u & 3) == 3) w[(r * (N / 4) + (u >> 2)) * 32] = word_[r];
  }
  __device__ uint32_t selectors(int r, int p) const { return w[(r * (N / 4) + p) * 32]; }
};

// float values (Swin's: a float mask is added), kept in the warp's shared
// memory as PackedScores keeps its codes: 2 * N floats a lane, lane
// interleaved.  The plane selectors of slots 4p .. 4p+3 replace the value
// of slot 4p once the four have been read.
template <int N>
struct FloatScores : SlotKeys<N> {
  static constexpr int kBytes = 2 * N * 32 * 4;  // a warp's buffer
  static constexpr int kUnroll = 2;
  float* w;  // this lane's first value
  __device__ FloatScores(uint32_t* buf, int lane) : w(reinterpret_cast<float*>(buf) + lane) {}
  __device__ void put4(int p, const float (&x)[2][4]) {
#pragma unroll
    for (int tt = 0; tt < 2; ++tt)
#pragma unroll
      for (int i = 0; i < 4; ++i) w[((i >> 1) * N + 4 * p + 2 * tt + (i & 1)) * 32] = x[tt][i];
  }
  __device__ float get(int r, int u) const { return w[(r * N + u) * 32]; }
  uint32_t word_[2];
  __device__ void put_shift(int r, int u, int s) {
    if ((u & 3) == 0) word_[r] = 0u;
    word_[r] |= plane_selectors(s, u & 3);
    if ((u & 3) == 3) w[(r * N + (u & ~3)) * 32] = __uint_as_float(word_[r]);
  }
  __device__ uint32_t selectors(int r, int p) const {
    return __float_as_uint(w[(r * N + 4 * p) * 32]);
  }
};

// Where a warp's rows go and what they read.
struct RowTile {
  const int8_t* q;   // the tile's first query row (row q0 of the image or window)
  long long q_row;   // bytes between query rows
  int8_t* out;       // the tile's first output row
  long long o_row;   // bytes between output rows
  int rows;          // rows of the tile below npad (1..16)
};

// The softmax's constants for one launch.
struct SoftArgs {
  int n_real, d;
  ExpTable exp;      // the LIS exponentials (exp.k: the LIS constants)
  float soft_scale;  // the float softmax's logit scale
  float out_scale;   // attn@v -> output grid
};

// K1's chain (K1, K5, K7a, K8 and the resident encoder K6): a score's
// qact_attn1 code, clip(rint(s * c1)), as int8.
struct QkvChain {
  template <int N>
  using Scores = PackedScores<N>;
  using Value = int8_t;
  static constexpr bool kIntegral = true;  // int8 codes: every x is in ExpTable
  float c1;
  float weight_floor;  // 0: every float-softmax weight is kept
  __device__ float operator()(int s, int, int) const {
    return fminf(fmaxf(rintf(static_cast<float>(s) * c1), -128.f), 127.f);
  }
};

// One warp's 16 query rows against the staged keys and values `kv`
// (geometry g): scores, chain(s, i, j) -> the softmax's input for query
// row i (of the tile) and key j, the softmax, attn@v, the output codes.
// `scratch` is the warp's shared memory: for the LIS its scores
// (Chain::Scores<N>::kBytes), for the float softmax its buffers.
// MaxKB: 32-key blocks a row holds at most; DP: the padded head width.
template <int MaxKB, int DP, bool Lis, class Chain>
__device__ __forceinline__ void attend_rows(const RowTile& tile, const uint8_t* kv,
                                            const KvGeom& g, const SoftArgs& a,
                                            const Chain& chain, uint8_t* scratch) {
  constexpr int NKT = 4 * MaxKB;  // key tiles of 8
  constexpr int N = 2 * NKT;      // slots a row a thread
  constexpr int KC = DP / 32;     // k chunks of the scores
  using Scores = typename Chain::template Scores<N>;
  const int lane = threadIdx.x & 31, gq = lane >> 2, t = lane & 3;
  const uint32_t* const k = reinterpret_cast<const uint32_t*>(kv);
  const uint32_t* const vt = reinterpret_cast<const uint32_t*>(kv + g.keys_pad * g.k_pitch());
  const int kw = g.k_pitch() / 4, vw = g.v_pitch() / 4;
  constexpr int kRowKeys = 32 * MaxKB;  // the float softmax's rows
  using Value = typename Chain::Value;
  Value* const vals = reinterpret_cast<Value*>(scratch);

  // the query fragments: rows gq and gq + 8, D bytes 4t.. and 16 + 4t..
  uint32_t qa[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = gq + 8 * (i & 1), col = 32 * kc + 16 * (i >> 1) + 4 * t;
      qa[kc][i] = row < tile.rows && col < a.d ? load_word(tile.q + row * tile.q_row + col) : 0u;
    }

  // scores, two key tiles at a time
  Scores sc(reinterpret_cast<uint32_t*>(scratch), lane);
#pragma unroll(Scores::kUnroll)
  for (int p = 0; p < NKT / 2; ++p) {
    if (16 * p < a.n_real) {
      float v[2][4];
#pragma unroll
      for (int tt = 0; tt < 2; ++tt) {
        const int j = 2 * p + tt;
        int acc[4] = {0, 0, 0, 0};
        if (8 * j < a.n_real) {
          const uint32_t* kr = k + (8 * j + gq) * kw + t;
#pragma unroll
          for (int kc = 0; kc < KC; ++kc) mma_s8(acc, qa[kc], kr[8 * kc], kr[8 * kc + 4]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[tt][i] = chain(acc[i], gq + 8 * (i >> 1), 8 * j + 2 * t + (i & 1));
      }
      if constexpr (Lis) {
        sc.put4(p, v);
      } else {  // straight into the float softmax's rows, keys in order
#pragma unroll
        for (int tt = 0; tt < 2; ++tt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int key = 8 * (2 * p + tt) + 2 * t + (i & 1);
            if (key < a.n_real)
              vals[(gq + 8 * (i >> 1)) * kRowKeys + key] = static_cast<Value>(v[tt][i]);
          }
      }
    }
  }

  if constexpr (Lis) {
    const auto put = [&](int r, int u, int s) { sc.put_shift(r, u, s); };
    if constexpr (Chain::kIntegral)
      lis_row_quad<N>(sc, a.n_real, a.exp.k, ExpLookup<true>{a.exp}, t, put);
    else if (table_covers<N>(sc, a.n_real, a.exp, t))
      lis_row_quad<N>(sc, a.n_real, a.exp.k, ExpLookup<false>{a.exp}, t, put);
    else
      lis_row_quad<N>(sc, a.n_real, a.exp.k, ExpDirect{a.exp.k, a.exp.fast}, t, put);

    // attn@v, 16 columns of D at a time: the weight planes are rebuilt
    // for each (8 instructions a block of 32 keys), so that a thread holds
    // 16 accumulators
    constexpr int NT = 2;  // n tiles of 8 columns a step
#pragma unroll
    for (int d0 = 0; d0 < DP; d0 += 8 * NT) {
      if (d0 < a.d) {
        int hi[NT][4], lo[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) hi[nt][i] = lo[nt][i] = 0;
#pragma unroll(Scores::kUnroll)
        for (int kb = 0; kb < MaxKB; ++kb) {
          if (32 * kb < a.n_real) {
            uint32_t ph[4], pl[4];
            weight_planes(sc.selectors(0, 2 * kb), ph[0], pl[0]);
            weight_planes(sc.selectors(1, 2 * kb), ph[1], pl[1]);
            weight_planes(sc.selectors(0, 2 * kb + 1), ph[2], pl[2]);
            weight_planes(sc.selectors(1, 2 * kb + 1), ph[3], pl[3]);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              if (d0 + 8 * nt < a.d) {
                const uint32_t* vr = vt + (d0 + 8 * nt + gq) * vw + 8 * kb + t;
                mma_u8s8(hi[nt], ph, vr[0], vr[4]);
                mma_u8s8(lo[nt], pl, vr[0], vr[4]);
              }
            }
          }
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (d0 + 8 * nt < a.d) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int row = gq + 8 * r;
              if (row < tile.rows) {
                int8_t c[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int acc = hi[nt][2 * r + e] * 256 + lo[nt][2 * r + e];
                  const float o = static_cast<float>(acc) * 0x1p-15f;
                  c[e] = clip_i8(rintf(o * a.out_scale));
                }
                *reinterpret_cast<uint16_t*>(tile.out + row * tile.o_row + d0 + 8 * nt +
                                             2 * t) =
                    static_cast<uint16_t>(static_cast<uint8_t>(c[0]) |
                                          static_cast<uint8_t>(c[1]) << 8);
              }
            }
          }
        }
      }
    }
  } else {
    // the float softmax: the scores through the warp's buffer, a row at a time
    float* const wrow = reinterpret_cast<float*>(scratch + kRows * kRowKeys * sizeof(Value));
    __syncwarp();
    const int8_t* const v_rows = reinterpret_cast<const int8_t*>(vt) + g.dp * g.v_pitch();
    for (int row = 0; row < tile.rows; ++row) {
      float x[MaxKB];
#pragma unroll
      for (int u = 0; u < MaxKB; ++u) {
        const int j = lane + 32 * u;
        x[u] = j < a.n_real ? static_cast<float>(vals[row * kRowKeys + j]) : 0.f;
      }
      softmax_row_bf16(x, a.n_real, a.soft_scale, wrow, lane);
#pragma unroll
      for (int u = 0; u < MaxKB; ++u) {  // each lane its own keys
        const int j = lane + 32 * u;
        if (j < a.n_real && wrow[j] < chain.weight_floor) wrow[j] = 0.f;
      }
      __syncwarp();
      for (int dd = lane; dd < a.d; dd += 32) {
        // products of a bfloat16 and an int8 are exact, and so is their
        // double sum at these exponent spreads: one rounding, to float
        double acc = 0.0;
        for (int j = 0; j < a.n_real; ++j) acc += (double)wrow[j] * (double)v_rows[j * g.dp + dd];
        const float o = __double2float_rn(acc);
        tile.out[row * tile.o_row + dd] = clip_i8(rintf(o * a.out_scale));
      }
      __syncwarp();
    }
  }
}

// Sets a kernel's dynamic shared memory limit once per kernel, card and
// limit: the launch path pays no driver call for it after the first.
inline cudaError_t allow_smem(const void* kernel, int smem) {
  constexpr int kSlots = 64;
  static const void* kernels[kSlots];
  static int cards[kSlots], ready[kSlots], used = 0;
  int card = 0;
  cudaError_t err = cudaGetDevice(&card);
  if (err != cudaSuccess) return err;
  int i = 0;
  while (i < used && !(kernels[i] == kernel && cards[i] == card)) ++i;
  if (i < used && smem <= ready[i]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess || i == kSlots) return err;
  if (i == used) {
    kernels[i] = kernel;
    cards[i] = card;
    ++used;
  }
  ready[i] = smem;
  return cudaSuccess;
}

// A kernel's footprint: registers and local memory (spills) a thread,
// shared memory a block (dynamic `smem` + static), blocks an SM at `warps`
// warps and `smem`.
inline cudaError_t footprint(const void* kernel, int warps, int smem, int* registers,
                             int* local_bytes, int* smem_bytes, int* blocks_per_sm) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  *registers = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *smem_bytes = smem + static_cast<int>(attr.sharedSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, 32 * warps, smem);
}

}  // namespace amma
}  // namespace dvt
