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
// What bounds it on the H100: latency and occupancy, not bytes.  At Swin-T
// b=64 stage 0 one launch reads 57.8 MB of int8 qkv and writes 19.3 MB
// (about 23 us of HBM time at 3.35 TB/s) but runs ~1.9 G integer MACs in
// 12,288 tiny (49 x 49) window-head problems, each with a row reduction
// and a chain of dependent float steps per score (the LIS integer
// exponential, one IEEE division).  Tensor cores would idle on 49 x 32
// tiles, so the work is warp-synchronous SIMT: dp4a for the scores, int32
// multiply-adds for attn@v.
//
// Design (right before fast):
//  * one block of 4 warps per (window, head); its K and V rows (49 x 32
//    int8 each) are staged in shared memory with 4-byte loads;
//  * a warp takes one query at a time and holds its whole score row, two
//    keys a lane, because LIS quantizes every weight against the final row
//    sum (flash-style online rescaling would change the codes);
//  * the bias (H, npad, npad) and mask (nW, npad, npad) rows are read
//    through the read-only cache: each is 9.4 KB per head or window, shared
//    by every block of that head or window, so L2 serves them;
//  * about 10 KB of shared memory a block, so the SM holds as many blocks
//    as its thread limit allows and one block's load latency hides behind
//    the others' arithmetic.
// No wgmma or TMA yet; several windows a block, to amortize the staging,
// is later work.
//
// Exactness against the plain PyTorch version (swin_attention_plain):
//  * built with -fmad=false: a1c * s_a1 + bias rounds twice, as torch does;
//  * rintf rounds half to even, like torch.round;
//  * the LIS row is lis.cuh's, shared with qkv_attention.cu (exact powers,
//    logs and int64 row sum; fast = false, as the Pallas kernel runs it);
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

#include "attention_core.cuh"  // dvt::softmax_row_bf16, RowWeightsT, clip_i8
#include "lis.cuh"

namespace {

constexpr int kMaxKeys = 64;  // two keys per lane
constexpr int kKeysPerLane = kMaxKeys / 32;
constexpr int kMaxHeadDim = 64;
constexpr int kWarps = 4;
constexpr float kWeightFloor = 0x1p-32f;  // float-softmax weights below it are 0

struct Strides {
  long long q_window, q_slot, q_head, q_row;  // qkv, in elements
  long long o_window, o_head, o_row;          // out, in elements
};

__global__ void __launch_bounds__(kWarps * 32)
    swin_attention_kernel(const int8_t* __restrict__ qkv,
                          const float* __restrict__ bias,
                          const float* __restrict__ mask,
                          const float* __restrict__ scalars,
                          int8_t* __restrict__ out, int npad, int d,
                          int n_real, int n_windows, int lis, Strides st) {
  __shared__ int k_words[kMaxKeys][kMaxHeadDim / 4 + 1];  // +1: no bank conflicts
  __shared__ __align__(16) int8_t v_rows[kMaxKeys][kMaxHeadDim];
  __shared__ dvt::RowWeightsT<kWarps, kMaxKeys> weights;
  __shared__ int q_words[kWarps][kMaxHeadDim / 4];

  const int win = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int words = d / 4;
  const int8_t* base = qkv + win * st.q_window + h * st.q_head;

  for (int idx = threadIdx.x; idx < n_real * words; idx += blockDim.x) {
    const int j = idx / words, w = idx % words;
    const int8_t* row = base + j * st.q_row + 4 * w;
    k_words[j][w] = *reinterpret_cast<const int*>(row + st.q_slot);
    *reinterpret_cast<int*>(&v_rows[j][4 * w]) =
        *reinterpret_cast<const int*>(row + 2 * st.q_slot);
  }
  __syncthreads();

  // scalars = [c1, s_a1, 1/s_a2, s_a2, c2]
  const float c1 = scalars[0], s_a1 = scalars[1], inv_s2 = scalars[2];
  const float s_a2 = scalars[3], c2 = scalars[4];
  const dvt::LisConsts lis_k = dvt::lis_consts(s_a2);
  const float* bias_h = bias + (size_t)h * npad * npad;
  const float* mask_w =
      mask ? mask + (size_t)(win % n_windows) * npad * npad : nullptr;
  int8_t* out_wh = out + win * st.o_window + h * st.o_head;

  for (int i = warp; i < npad; i += kWarps) {
    if (lane < words)
      q_words[warp][lane] = *reinterpret_cast<const int*>(base + i * st.q_row + 4 * lane);
    __syncwarp();

    // scores -> qact_attn1 codes -> + bias -> qact2 codes -> + mask
    float a[kKeysPerLane];
#pragma unroll
    for (int u = 0; u < kKeysPerLane; ++u) {
      const int j = lane + 32 * u;
      a[u] = 0.f;
      if (j < n_real) {
        int s = 0;
        for (int w = 0; w < words; ++w) s = __dp4a(q_words[warp][w], k_words[j][w], s);
        const float a1c = fminf(fmaxf(rintf(static_cast<float>(s) * c1), -128.f), 127.f);
        const float af = a1c * s_a1 + __ldg(bias_h + i * npad + j);
        float am = fminf(fmaxf(rintf(af * inv_s2), -128.f), 127.f);
        if (mask_w) am = am + __ldg(mask_w + i * npad + j);
        a[u] = am;
      }
    }
    if (lis) {
      dvt::lis_row(a, n_real, lis_k, false, weights.lis[warp], lane);
    } else {
      dvt::softmax_row_bf16(a, n_real, s_a2, weights.soft[warp], lane);
#pragma unroll
      for (int u = 0; u < kKeysPerLane; ++u) {  // each lane its own keys
        const int j = lane + 32 * u;
        if (j < n_real && weights.soft[warp][j] < kWeightFloor) weights.soft[warp][j] = 0.f;
      }
    }
    __syncwarp();

    // attn @ v, requantized onto the qact3 grid
    for (int dd = lane; dd < d; dd += 32) {
      float o;
      if (lis) {
        int acc = 0;
        for (int j = 0; j < n_real; ++j) acc += weights.lis[warp][j] * v_rows[j][dd];
        o = static_cast<float>(acc) * 0x1p-15f;
      } else {
        double acc = 0.0;  // exact: see the note on the weight floor above
        for (int j = 0; j < n_real; ++j)
          acc += (double)weights.soft[warp][j] * (double)v_rows[j][dd];
        o = __double2float_rn(acc);
      }
      out_wh[i * st.o_row + dd] = dvt::clip_i8(rintf(o * c2));
    }
    __syncwarp();
  }
}

}  // namespace

// qkv: int8, element (window, slot, head, row, d) at
// window*sq_w + slot*sq_s + head*sq_h + row*sq_r + d; bias: (H, npad, npad)
// f32; mask: (nW, npad, npad) f32 or null; scalars: (5,) f32 on the device;
// out: int8, element (window, head, row, d) at
// window*so_w + head*so_h + row*so_r + d.  lis: 1 the Log-Int-Softmax, 0 the
// float softmax.  Requires n_real <= 64, D <= 64, D % 4 == 0, every stride a
// multiple of 4 (checked by the Python wrapper).
extern "C" int dvt_swin_attention(const void* qkv, const void* bias,
                                  const void* mask, const void* scalars,
                                  void* out, int windows, int heads, int npad,
                                  int d, int n_real, int n_windows, int lis,
                                  long long sq_w, long long sq_s,
                                  long long sq_h, long long sq_r,
                                  long long so_w, long long so_h,
                                  long long so_r, void* stream) {
  const Strides st{sq_w, sq_s, sq_h, sq_r, so_w, so_h, so_r};
  dim3 grid(windows, heads);
  swin_attention_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<const float*>(scalars),
      static_cast<int8_t*>(out), npad, d, n_real, n_windows, lis, st);
  return cudaGetLastError();
}
