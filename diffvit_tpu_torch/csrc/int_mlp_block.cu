// The whole MLP half-block on the float32 residual stream (K7b) for Hopper.
//
// Replaces the Pallas kernel diffvit_tpu/ops/pallas/mlp.py::
// fused_int_mlp_block (body _mlp_block_kernel): attn.qact3 of the proj
// output y, the residual add to h, the qact2 fence, its own integer
// LayerNorm (int8 codes), fc1, the polynomial GELU, the qact1 requant,
// fc2, the mlp.qact2 fence, the residual add and the qact4 fence.  The
// fences multiply by the reciprocals the wrapper folds (1/s3, 1/s2, 1/s4,
// 1/out_scale), as the Pallas kernel does.
//
// What bounds it on the H100: the two int8 GEMMs of K2, (R, C) @ (C, 4C)
// and (R, 4C) @ (4C, C) (at DeiT-S b=64, 29.7 G operations, 15 us of
// tensor-core peak), plus two float32 (R, C) inputs and one output (9.7 MB
// at b=64, 2.9 us at 3.35 TB/s): bound by operations.
//
// Design: three launches.
//  1. A row pass, one warp per row: the qact3 / residual / qact2 fences,
//     then the LN in _mlp_block_kernel's order (x_q = codes2 * r; exact
//     int64 sums of x_q and x_q^2 over the row, rounded once to float;
//     mean, std = (s2min/c) * sqrt(c*sum_x2 - sum_x^2) with the root in
//     double rounded once; a = (s2min/std) * lnw/out; get_mn; b =
//     rint((lnb/out - (mean/std) * lnw/out) * 2^n); rint(rint((sign(a) * m
//     * x_q + b) / 2^n) * rescale), clipped) -> int8 codes, and the fenced
//     residual h2 in float32;
//  2. fc1 on wgmma_gemm.cuh's mainloop, as K2's fc1 launches it (TMA into
//     an mbarrier ring, wgmma, persistent blocks; gemm_plan's tile; the
//     weight's cached K-major copy, gemm.kmajor) with K2's GELU epilogue
//     (int_mlp.cuh's Fc1Hidden) -> the int8 hidden stream (row stride Hid
//     rounded up to 16 bytes for TMA);
//  3. fc2 on the same mainloop, whose returning epilogue Fc2BlockOut runs
//     the mlp.qact2 fence, + h2 and the qact4 fence -> float32 out.
// The codes, h2 and the hidden stream go through device memory between the
// launches; fusing them is later work.
//
// Exactness against the plain PyTorch version (ops/kernels/mlp.py and
// ops/int_layernorm.mlp_block_ln_codes): built with -fmad=false; rintf
// rounds half to even; IEEE divisions; the sums are exact where the
// Pallas kernel sums float32 terms past 2^24 (the one licensed
// difference, with XLA's fma contraction).
#include <cstdint>
#include <cuda_runtime.h>

#include "int_ln.cuh"
#include "int_mlp.cuh"
#include "lis.cuh"
#include "wgmma_gemm.cuh"

namespace {

constexpr int kRowWarps = 4;
// v rows (C wide each), as the wrapper packs them (mlp.py:250-256)
constexpr int kInvS3 = 0, kS3 = 1, kInvS2 = 2, kS2 = 3, kInvS4 = 4, kS4 = 5, kR = 6,
              kLnwOut = 7, kLnbOut = 8, kRescale = 9;

__global__ void __launch_bounds__(kRowWarps * 32)
    mlp_block_rows(const float* __restrict__ y, const float* __restrict__ h,
                   const float* __restrict__ v, const float* __restrict__ scal,
                   int8_t* __restrict__ x_codes, float* __restrict__ h2, int rows, int c) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (r >= rows) return;  // whole warps leave together
  const size_t row = (size_t)r * c;
  auto codes2_at = [&](int j) {  // qact3, residual, qact2 codes
    const float yq = fminf(fmaxf(rintf(y[row + j] * v[kInvS3 * c + j]), -128.f), 127.f) *
                     v[kS3 * c + j];
    return fminf(fmaxf(rintf((h[row + j] + yq) * v[kInvS2 * c + j]), -128.f), 127.f);
  };

  long long sx = 0, sx2 = 0;
  for (int j = lane; j < c; j += 32) {
    const float c2 = codes2_at(j);
    h2[row + j] = c2 * v[kS2 * c + j];
    const long long xq = static_cast<long long>(c2 * v[kR * c + j]);
    sx += xq;
    sx2 += xq * xq;
  }
  sx = dvt::warp_sum(sx);
  sx2 = dvt::warp_sum(sx2);
  const float fsx = static_cast<float>(sx), fsx2 = static_cast<float>(sx2);
  const float cf = scal[2], s_min = scal[0];
  const float mean = (fsx / cf) * s_min;
  const float var = cf * fsx2 - fsx * fsx;
  const float sdev = (s_min / cf) * static_cast<float>(sqrt(static_cast<double>(var)));
  const float sd = s_min / sdev, ms = mean / sdev;
  for (int j = lane; j < c; j += 32) {
    const float xq = codes2_at(j) * v[kR * c + j];
    const float lnw = v[kLnwOut * c + j];
    const float a = sd * lnw;
    const dvt::Mn mn = dvt::get_mn(fabsf(a));
    const float sgn = a > 0.f ? 1.f : (a < 0.f ? -1.f : 0.f);
    const float bq = rintf((v[kLnbOut * c + j] - ms * lnw) * mn.p2n);
    const float yl = rintf((sgn * mn.m * xq + bq) / mn.p2n);
    x_codes[row + j] = dvt::clip_i8(rintf(yl * v[kRescale * c + j]));
  }
}

// fc2 (wgmma_gemm.cuh's returning contract): the mlp.qact2 fence, + h2 at
// (r, c), the qact4 fence; float32 out.
struct Fc2BlockOut {
  using Out = float;
  const float* v2;  // (4, ld): [mult2, bias2, out_scale, 1/out_scale]
  const float* v;   // (10, ld): the row pass's vectors
  const float* h2;  // (rows, ld)
  float* out;       // (rows, ld)
  int ld;
  __device__ float operator()(int r, int c, int acc) const {
    const int n = ld;
    float ym = static_cast<float>(acc) * v2[c] + v2[n + c];
    ym = fminf(fmaxf(rintf(ym * v2[3 * n + c]), -128.f), 127.f) * v2[2 * n + c];
    const float hn = h2[(size_t)r * n + c] + ym;
    return fminf(fmaxf(rintf(hn * v[kInvS4 * n + c]), -128.f), 127.f) * v[kS4 * n + c];
  }
};

}  // namespace

// y, h: (R, C) f32; v: (10, C) f32 [1/s3, s3, 1/s2, s2, 1/s4, s4, r,
// lnw/out, lnb/out, rescale]; w1k: (Hid, C) and w2k: (C, Hid_p) int8, the
// weights K-major (gemm.kmajor: K zero-padded to a multiple of 16); v1:
// (2, Hid) f32 [mult1, bias1]; v2: (4, C) f32 [mult2, bias2, out_scale,
// 1/out_scale]; scal: (3,) f32 [s2min, 1/s_q1, C]; scratch x_codes (R, C)
// int8, h2 (R, C) f32, hidden (R, Hid_p) int8; out: (R, C) f32.  plan1
// and plan2 are gemm_plan's (bm, bn, blocks, stages, smem, grid) of fc1
// and fc2.  Requires R >= 1, C % 32 == 0 and Hid % 32 == 0 (checked by
// the Python wrapper).
extern "C" int dvt_int_mlp_block(const void* y, const void* h, const void* v,
                                 const void* w1k, const void* w2k, const void* v1,
                                 const void* v2, const void* scal, void* x_codes, void* h2,
                                 void* hidden, void* out, int rows, int c, int hid, int hid_p,
                                 int bm1, int bn1, int blocks1, int stages1, int smem1,
                                 int grid1, int bm2, int bn2, int blocks2, int stages2,
                                 int smem2, int grid2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* vv = static_cast<const float*>(v);
  const float* sc = static_cast<const float*>(scal);
  mlp_block_rows<<<(rows + kRowWarps - 1) / kRowWarps, kRowWarps * 32, 0, s>>>(
      static_cast<const float*>(y), static_cast<const float*>(h), vv, sc,
      static_cast<int8_t*>(x_codes), static_cast<float*>(h2), rows, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float* vh = static_cast<const float*>(v1);
  const dvt::wg::GemmArgs g1{x_codes, w1k, rows, hid, c, bm1, bn1, blocks1, stages1, smem1,
                             grid1};
  err = dvt::wg::gemm(g1, dvt::Fc1Hidden{vh, vh + hid, sc + 1, static_cast<int8_t*>(hidden), hid_p},
                      s);
  if (err != cudaSuccess) return err;
  const dvt::wg::GemmArgs g2{hidden, w2k, rows, c, hid_p, bm2, bn2, blocks2, stages2, smem2,
                             grid2};
  return dvt::wg::gemm(g2,
                       Fc2BlockOut{static_cast<const float*>(v2), vv,
                                   static_cast<const float*>(h2), static_cast<float*>(out), c},
                       s);
}

// The footprint of fc1's kernel (layer 1) or fc2's (layer 2) for tile
// (bm, bn) at `blocks` blocks an SM and `smem` bytes of dynamic shared
// memory: registers a thread, shared memory a block, blocks an SM.
extern "C" int dvt_int_mlp_block_footprint(int layer, int bm, int bn, int blocks, int smem,
                                           int* registers, int* smem_bytes, int* blocks_per_sm) {
  if (layer == 1)
    return dvt::wg::footprint<dvt::Fc1Hidden>(bm, bn, blocks, smem, registers, smem_bytes,
                                              blocks_per_sm);
  return dvt::wg::footprint<Fc2BlockOut>(bm, bn, blocks, smem, registers, smem_bytes,
                                         blocks_per_sm);
}
