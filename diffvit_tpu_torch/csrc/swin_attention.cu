// Fused Swin window attention (scores, relative-position bias, shift mask,
// Log-Int-Softmax or float softmax, attn@v) for Hopper.
//
// Replaces the Pallas kernels diffvit_tpu/ops/pallas/attention.py::
// fused_swin_attention (body _swin_attn_kernel, the (Bw, 3, H, npad, D)
// contract) and ::fused_swin_attention_v2 (body _swin_attn_kernel_v2, the
// natural (Bw, npad, 3C) contract).  One kernel serves both: the wrapper
// (ops/kernels/swin_attention.py) passes the element strides of qkv's
// (window, slot, head, row) axes and of the output's (window, head, row)
// axes, so the two contracts differ only in those strides, and v1 can read
// a strided view of the natural qkv without a copy.
//
// What bounds it on the H100: not the bytes and not the products.  At
// Swin-T b=64 stage 0 one launch reads 57.8 MB of int8 qkv and writes 19.3
// MB (23 us of HBM time at 3.35 TB/s) and does 1.9 G integer MACs (~2 us of
// int8 tensor-core peak) in 12,288 small (49 x 49) window-head problems.
// What is left is the chain of dependent float steps per score (the bias,
// the requant, the mask, the LIS integer exponential, two IEEE divisions)
// and each window's staging.  The first port ran all of it SIMT (dp4a
// scores, a per-lane attn@v loop with two shared-memory loads for every 32
// multiply-adds); a 49 x 32 tile is small, but the m16n8k32 mma takes it
// in 7 key tiles and 2 blocks of 32 keys, so the products now cost next to
// nothing beside the chain.
//
// Design: attention_mma.cuh's core with Swin's chain.
//  * A block takes one head and a run of consecutive windows (the plan,
//    ops/kernels/attn_plan.py, sets how many so the grid keeps two blocks
//    on every SM); it stages the head's (npad x npad) bias tile in shared
//    memory once, and each window's K and V^T beside it; a warp takes one
//    (window, 16 query rows) item at a time.
//  * Scores on mma.sync; then the per-score chain in today's order and
//    roundings: a1c = clip(rint(s * c1)), + bias, the qact2 requant, + the
//    shift mask of window (win mod nW) read through the read-only path;
//    the values stay float (the mask is a float), two rows of 64 keys a
//    quad.
//  * The LIS on the quad layout (fast = false, as the Pallas kernel runs
//    it), attn@v on mma.sync with the weights' two u8 planes, exact.
//
// Exactness against the plain PyTorch version (swin_attention_plain):
//  * built with -fmad=false: a1c * s_a1 + bias rounds twice, as torch does;
//  * rintf rounds half to even, like torch.round;
//  * the LIS row is lis.cuh's (exact powers, logs and row sum);
//  * attn@v accumulates v * 2^(15-code) in int32, converted once to float;
//  * the float softmax (lis = 0) is attention_core.cuh's softmax_row_bf16
//    (double, rounded once to float, then to bfloat16) on the logits
//    (a2c + mask) * s_a2, and attn@v a double sum rounded once.  The shift
//    mask puts weights near e^-100 (bfloat16 subnormals) beside weights
//    near 1; a weight below 2^-32 is set to 0 here and in the plain version,
//    so that every partial sum is a multiple of 2^-39 of at most 2^13: the
//    double sum is exact in any order, and subnormals never reach it.
#include <cstdint>
#include <cuda_runtime.h>

#include "attention_mma.cuh"

namespace {

namespace amma = dvt::amma;

constexpr int kMaxKB = 2;                 // 64 keys (swin_attention.py's MAX_KEYS)
constexpr int kSwinWarps = 8;             // warps a block at most (attn_plan.SWIN_MAX_WARPS)
constexpr float kWeightFloor = 0x1p-32f;  // float-softmax weights below it are 0

struct Strides {
  long long q_window, q_slot, q_head, q_row;  // qkv, in elements
  long long o_window, o_head, o_row;          // out, in elements
};

// Swin's chain for query row q0 + i and key j of one window: scores ->
// qact_attn1 codes -> + bias -> qact2 codes -> + mask.
struct SwinChain {
  template <int N>
  using Scores = amma::FloatScores<N>;
  using Value = float;
  static constexpr bool kIntegral = false;  // the mask is a float
  float c1, s_a1, inv_s2;
  float weight_floor;
  const float* bias;  // the head's (npad, npad) tile in shared memory
  const float* mask;  // the window's (npad, npad) mask, or null
  int npad, n_real, q0;
  __device__ float operator()(int s, int i, int j) const {
    const int row = q0 + i;
    if (row >= npad || j >= n_real) return 0.f;
    const float a1c = fminf(fmaxf(rintf(static_cast<float>(s) * c1), -128.f), 127.f);
    const float af = a1c * s_a1 + bias[row * npad + j];
    float am = fminf(fmaxf(rintf(af * inv_s2), -128.f), 127.f);
    if (mask) am = am + __ldg(mask + row * npad + j);
    return am;
  }
};

// Dynamic shared memory (attn_plan.py's swin_smem): the bias tile, the
// windows' keys and values, the warps' float-softmax buffers.
__host__ __device__ int bias_bytes(int npad) { return (npad * npad * 4 + 15) / 16 * 16; }

// a warp's shared memory: its scores (the LIS) or the float softmax's
// buffers
constexpr int kScoreBytes = amma::FloatScores<8 * kMaxKB>::kBytes;

__host__ __device__ int warp_scratch(int lis) {
  return lis ? kScoreBytes : amma::soft_bytes(32 * kMaxKB, 4);
}

int swin_smem(int npad, int n_real, int d, int lis, int warps, int wpb) {
  return amma::kExpBytes + bias_bytes(npad) + wpb * amma::kv_geom(n_real, d, lis != 0).bytes() +
         warps * warp_scratch(lis);
}

// Block (x, head) takes windows [x * wpb, + wpb); warp w the items
// (window, query tile) w, w + warps, ...
// Three blocks an SM for the LIS (at most 85 registers a thread); the
// float softmax's double sums take more.
template <int DP, bool Lis>
__global__ void __launch_bounds__(kSwinWarps * 32, Lis ? 3 : 1)
    swin_core_kernel(const int8_t* __restrict__ qkv, const float* __restrict__ bias,
                     const float* __restrict__ mask, const float* __restrict__ scalars,
                     int8_t* __restrict__ out, int windows, int npad, int d, int n_real,
                     int n_windows, int lis_wide, Strides st, int wpb) {
  extern __shared__ __align__(16) uint8_t attn_smem[];
  const int h = blockIdx.y, w0 = blockIdx.x * wpb;
  const int nw = min(wpb, windows - w0);
  const amma::KvGeom g = amma::kv_geom(n_real, d, Lis);
  // scalars = [c1, s_a1, 1/s_a2, s_a2, c2]
  const float s_a2 = scalars[3];
  const amma::ExpTable et = amma::fill_exp_table(attn_smem, dvt::lis_consts(s_a2, lis_wide != 0),
                                                 false);
  float* const bias_s = reinterpret_cast<float*>(attn_smem + amma::kExpBytes);
  uint8_t* const kv0 = attn_smem + amma::kExpBytes + bias_bytes(npad);
  const float* bias_h = bias + (size_t)h * npad * npad;
  for (int i = threadIdx.x; i < npad * npad; i += blockDim.x) bias_s[i] = bias_h[i];
  for (int wi = 0; wi < nw; ++wi) {
    const int8_t* base = qkv + (w0 + wi) * st.q_window + h * st.q_head;
    amma::stage_kv(base + st.q_slot, base + 2 * st.q_slot, st.q_row, n_real, d, g,
                   kv0 + wi * g.bytes());
  }
  __syncthreads();

  const amma::SoftArgs a{n_real, d, et, s_a2, scalars[4]};
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  uint8_t* scratch = kv0 + wpb * g.bytes() + warp * warp_scratch(Lis);
  const int q_tiles = (npad + amma::kRows - 1) / amma::kRows;
  for (int item = warp; item < nw * q_tiles; item += warps) {
    const int wi = item / q_tiles, q0 = item % q_tiles * amma::kRows, win = w0 + wi;
    const int8_t* base = qkv + win * st.q_window + h * st.q_head;
    const SwinChain chain{scalars[0], scalars[1], scalars[2], kWeightFloor, bias_s,
                          mask ? mask + (size_t)(win % n_windows) * npad * npad : nullptr,
                          npad, n_real, q0};
    const amma::RowTile rt{base + q0 * st.q_row, st.q_row,
                           out + win * st.o_window + h * st.o_head + q0 * st.o_row, st.o_row,
                           min(amma::kRows, npad - q0)};
    amma::attend_rows<kMaxKB, DP, Lis>(rt, kv0 + wi * g.bytes(), g, a, chain, scratch);
  }
}

using SwinKernel = void (*)(const int8_t*, const float*, const float*, const float*, int8_t*,
                           int, int, int, int, int, int, Strides, int);

SwinKernel kernel_for(int d, int lis) {
  return lis ? (d <= 32 ? swin_core_kernel<32, true> : swin_core_kernel<64, true>)
             : (d <= 32 ? swin_core_kernel<32, false> : swin_core_kernel<64, false>);
}

}  // namespace

// qkv: int8, element (window, slot, head, row, d) at
// window*sq_w + slot*sq_s + head*sq_h + row*sq_r + d; bias: (H, npad, npad)
// f32; mask: (nW, npad, npad) f32 or null; scalars: (5,) f32 on the device;
// out: int8, element (window, head, row, d) at
// window*so_w + head*so_h + row*so_r + d.  lis: 1 the Log-Int-Softmax, 2 it
// with the 128-bit row sum (lis.cuh's kLisWide), 0 the float softmax.
// warps, wpb (windows a block) and smem: the plan's
// (attn_plan.swin_attention_plan).  Requires n_real <= min(npad, 64), D <=
// 64, D % 4 == 0, every stride a multiple of 4 (checked by the Python
// wrapper).
extern "C" int dvt_swin_attention(const void* qkv, const void* bias, const void* mask,
                                  const void* scalars, void* out, int windows, int heads,
                                  int npad, int d, int n_real, int n_windows, int lis,
                                  long long sq_w, long long sq_s, long long sq_h,
                                  long long sq_r, long long so_w, long long so_h,
                                  long long so_r, int warps, int wpb, int smem, void* stream) {
  if (warps < 1 || warps > kSwinWarps || wpb < 1 || n_real > 32 * kMaxKB || d > 64 ||
      smem < swin_smem(npad, n_real, d, lis, warps, wpb))
    return cudaErrorInvalidValue;
  const SwinKernel kernel = kernel_for(d, lis);
  cudaError_t err = amma::allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return err;
  const Strides st{sq_w, sq_s, sq_h, sq_r, so_w, so_h, so_r};
  const dim3 grid((windows + wpb - 1) / wpb, heads);
  kernel<<<grid, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<const float*>(scalars),
      static_cast<int8_t*>(out), windows, npad, d, n_real, n_windows, lis == dvt::kLisWide, st,
      wpb);
  return cudaGetLastError();
}

// The kernel's footprint for head width d and softmax at `warps` warps
// and `smem` bytes: registers and local memory (spills) a thread, shared memory a
// block, blocks an SM.
extern "C" int dvt_swin_attention_footprint(int d, int lis, int warps, int smem,
                                            int* registers, int* local_bytes, int* smem_bytes,
                                            int* blocks_per_sm) {
  return amma::footprint(reinterpret_cast<const void*>(kernel_for(d, lis)), warps, smem,
                         registers, local_bytes, smem_bytes, blocks_per_sm);
}
