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
//  2. fc1 on the shared int8 GEMM tile with K2's GELU epilogue
//     (int_mlp.cuh) -> the int8 hidden stream;
//  3. fc2 on the tile, whose epilogue runs the mlp.qact2 fence, + h2 and
//     the qact4 fence -> float32 out.
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

#include "int8_gemm.cuh"
#include "int_ln.cuh"
#include "int_mlp.cuh"
#include "lis.cuh"

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

// fc2: the mlp.qact2 fence, + h2, the qact4 fence; float32 out.
struct Fc2BlockEpilogue {
  const float* v2;  // (4, n): [mult2, bias2, out_scale, 1/out_scale]
  const float* v;   // (10, n): the row pass's vectors
  const float* h2;  // (rows, n)
  float* out;       // (rows, n)
  int n;
  __device__ void operator()(int r, int c, int acc) const {
    float ym = static_cast<float>(acc) * v2[c] + v2[n + c];
    ym = fminf(fmaxf(rintf(ym * v2[3 * n + c]), -128.f), 127.f) * v2[2 * n + c];
    const size_t at = (size_t)r * n + c;
    const float hn = h2[at] + ym;
    out[at] = fminf(fmaxf(rintf(hn * v[kInvS4 * n + c]), -128.f), 127.f) * v[kS4 * n + c];
  }
};

}  // namespace

// y, h: (R, C) f32; v: (10, C) f32 [1/s3, s3, 1/s2, s2, 1/s4, s4, r,
// lnw/out, lnb/out, rescale]; w1: (C, Hid), w2: (Hid, C) int8; v1: (2,
// Hid) f32 [mult1, bias1]; v2: (4, C) f32 [mult2, bias2, out_scale,
// 1/out_scale]; scal: (3,) f32 [s2min, 1/s_q1, C]; scratch x_codes (R, C)
// int8, h2 (R, C) f32, hidden (R, Hid) int8; out: (R, C) f32.  Requires
// R >= 1, C % 32 == 0 and Hid % 32 == 0 (checked by the Python wrapper).
extern "C" int dvt_int_mlp_block(const void* y, const void* h, const void* v,
                                 const void* w1, const void* w2, const void* v1,
                                 const void* v2, const void* scal, void* x_codes, void* h2,
                                 void* hidden, void* out, int rows, int c, int hid,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* vv = static_cast<const float*>(v);
  const float* sc = static_cast<const float*>(scal);
  mlp_block_rows<<<(rows + kRowWarps - 1) / kRowWarps, kRowWarps * 32, 0, s>>>(
      static_cast<const float*>(y), static_cast<const float*>(h), vv, sc,
      static_cast<int8_t*>(x_codes), static_cast<float*>(h2), rows, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float* vh = static_cast<const float*>(v1);
  dvt::Fc1Epilogue e1{vh, vh + hid, sc + 1, static_cast<int8_t*>(hidden), hid};
  dvt::launch_int8_gemm(static_cast<const int8_t*>(x_codes), static_cast<const int8_t*>(w1),
                        rows, hid, c, e1, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  Fc2BlockEpilogue e2{static_cast<const float*>(v2), vv, static_cast<const float*>(h2),
                      static_cast<float*>(out), c};
  dvt::launch_int8_gemm(static_cast<const int8_t*>(hidden), static_cast<const int8_t*>(w2),
                        rows, c, hid, e2, s);
  return cudaGetLastError();
}
