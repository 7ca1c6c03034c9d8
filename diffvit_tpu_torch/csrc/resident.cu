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
// at b=1, 9.1 G operations and the weights' bytes (6.3 us).  Between the
// GEMMs are row reductions (the LNs) and per-(image, head) attention,
// which need every block's output of the step before.
//
// Design (simple first): one cooperative launch of persistent blocks, as
// many as can be resident at once (occupancy x SMs, and no more than the
// largest step has work items).  A loop over the blocks of the encoder runs
// seven steps each, separated by a grid-wide barrier; each step spreads
// its work grid-stride over every image of the batch:
//  1. LN1, one warp per row -> int8 codes (act scratch)
//  2. qkv GEMM tiles (int8_gemm.cuh) with K1's epilogue -> qkv scratch
//  3. (image, head, 32 query rows) items of the attention core
//     (attention_core.cuh) -> act scratch, in the (row, head*D) layout
//  4. proj GEMM tiles; the epilogue runs the qact3, residual and qact2
//     fences -> hc2 scratch
//  5. LN2 with the rescale, one warp per row -> act scratch
//  6. fc1 GEMM tiles with K2's GELU epilogue (int_mlp.cuh) -> hidden
//  7. fc2 GEMM tiles; the epilogue runs the qact2 codes, the residual and
//     the qact4 fence -> the residual codes (out)
// Per-layer parameters are addressed by layer stride, as the Pallas
// BlockSpec index maps did.  The scratch (act, hc2, qkv, hidden) is in
// device memory; at DeiT-S it fits in L2 with the 12 layers' weights.
// Fast designs (wgmma/TMA GEMMs, fewer barriers, overlapping steps) are
// later work.
//
// The grid barrier is cooperative_groups' own arrive-and-flip scheme on a
// counter in device memory that the wrapper zeroes: block 0 adds
// 2^31 - (blocks - 1), every other block 1, so the counter's top bit flips
// once all have arrived; __threadfence on both sides orders the steps'
// writes.  The cooperative launch guarantees that every block is resident;
// a wait beyond ~17 s traps rather than hang the card.
// Scratch written by the launch itself is read with plain loads, never
// through the read-only path.
//
// Exactness against resident_codes_plain (ops/kernels/serve.py): built with
// -fmad=false; rintf rounds half to even; the LayerNorm sums the codes in
// int64, converts the sums to float (round to nearest), takes the root in
// double rounded to float, gets floor(log2) from ilogbf and 2^n from
// ldexpf, and divides with IEEE divisions (nvcc's -prec-div=true default);
// the attention core, the GEMM epilogues and the GELU are the ones K1 and
// K2 run.
#include <cstdint>
#include <cuda_runtime.h>

#include "attention_core.cuh"
#include "int8_gemm.cuh"
#include "int_ln.cuh"
#include "int_mlp.cuh"
#include "lis.cuh"

namespace {

// vec slots (per layer, C-wide f32) and scal slots (per layer, f32), as in
// ops/kernels/serve.py
constexpr int kVInScale = 0, kVLn1Mask = 1, kVLn1W = 2, kVLn1B = 3, kVLn1Out = 4,
              kVProjMult = 5, kVProjB = 6, kVS3 = 7, kVSblk2 = 8, kVLn2Mask = 9,
              kVLn2W = 10, kVLn2B = 11, kVLn2Out = 12, kVLn2Rescale = 13, kVS4 = 14,
              kNV = 15;
constexpr int kSSa = 0, kSC1 = 1, kSS1OverS2 = 2, kSM1Inv = 3, kSLn1Min = 4,
              kSLn2Min = 5, kNS = 6;
constexpr int kThreads = 128;  // the GEMM tile's and the attention core's
constexpr int kWarps = kThreads / 32;
constexpr float kStdFloor = 1e-37f;

struct Params {
  const int8_t* x;  // (rows, C) codes on the qact1 grid
  int8_t* out;      // (rows, C) residual codes; the result
  const int8_t *wqkv, *wproj, *w1, *w2;  // per layer (C,3C) (C,C) (C,hid) (hid,C)
  const float *mb, *vec, *vhid, *vout, *scal;
  int8_t *act, *hc2, *qkv, *hidden;  // scratch
  unsigned* barrier;
  int depth, nelems, npad, n_real, c, hid, heads, d, lis, lis_fast;
};

union Smem {
  dvt::GemmSmem gemm;
  dvt::AttnSmem attn;
};

// A block that waits longer than this many clock cycles (~17 s at the H100's
// clock) traps: the launch then fails with an error instead of hanging.
constexpr long long kBarrierTimeout = 1ll << 35;

__device__ __forceinline__ void grid_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned add = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    __threadfence();
    const unsigned old = atomicAdd(bar, add);
    const long long t0 = clock64();
    while (((old ^ *reinterpret_cast<volatile unsigned*>(bar)) & 0x80000000u) == 0)
      if (clock64() - t0 > kBarrierTimeout) __trap();
    __threadfence();
  }
  __syncthreads();
}

// The integer LayerNorm of one row by one warp (ops/int_layernorm.ln_codes
// with the std floor of _ln_emit), then the optional rescale and the clip.
__device__ void ln_row(const int8_t* xrow, int8_t* yrow, int c, const float* mask,
                       float s_min, const float* w, const float* b,
                       const float* out_scale, const float* rescale, int lane) {
  long long sx = 0, sx2 = 0;
  for (int j = lane; j < c; j += 32) {
    const long long xq = static_cast<long long>(static_cast<float>(xrow[j]) * mask[j]);
    sx += xq;
    sx2 += xq * xq;
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
  for (int j = lane; j < c; j += 32) {
    const float xq = static_cast<float>(xrow[j]) * mask[j];
    const float a = (sd * w[j]) / out_scale[j];
    const dvt::Mn mn = dvt::get_mn(fabsf(a));
    const float sgn = a > 0.f ? 1.f : (a < 0.f ? -1.f : 0.f);
    const float bq = rintf((b[j] - ms * w[j]) / out_scale[j] * mn.p2n);
    float y = rintf((sgn * mn.m * xq + bq) / mn.p2n);
    if (rescale != nullptr) y = rintf(y * rescale[j]);
    yrow[j] = dvt::clip_i8(y);
  }
}

// proj: y = acc * mult + b; qact3 codes; residual with the block's input
// codes; qact2 codes -> hc2.
struct ProjFenceEpilogue {
  const float *mult, *bias, *s3, *in_scale, *s_blk2;
  const int8_t* hc;  // the block's input codes
  int8_t* hc2;
  int n;
  __device__ void operator()(int r, int c, int acc) const {
    const float y = static_cast<float>(acc) * mult[c] + bias[c];
    const float yq3 = fminf(fmaxf(rintf(y / s3[c]), -128.f), 127.f);
    const size_t at = (size_t)r * n + c;
    const float hs = static_cast<float>(hc[at]) * in_scale[c] + yq3 * s3[c];
    hc2[at] = dvt::clip_i8(rintf(hs / s_blk2[c]));
  }
};

// fc2: y2 = acc * mult + b; mlp.qact2 codes; residual with hc2; qact4
// codes -> the residual stream.
struct Fc2FenceEpilogue {
  const float *mult, *bias, *s_m2, *inv_m2, *s_blk2, *s4;
  const int8_t* hc2;
  int8_t* out;
  int n;
  __device__ void operator()(int r, int c, int acc) const {
    const float y2 = static_cast<float>(acc) * mult[c] + bias[c];
    const float y2c = fminf(fmaxf(rintf(y2 * inv_m2[c]), -128.f), 127.f);
    const size_t at = (size_t)r * n + c;
    const float hs = static_cast<float>(hc2[at]) * s_blk2[c] + y2c * s_m2[c];
    out[at] = dvt::clip_i8(rintf(hs / s4[c]));
  }
};

template <class Epi>
__device__ __forceinline__ void gemm_step(const int8_t* A, const int8_t* B, int M, int N,
                                          int K, const Epi& epi, dvt::GemmSmem& sm) {
  const int tn = (N + dvt::kGemmBN - 1) / dvt::kGemmBN;
  const int tiles = (M + dvt::kGemmBM - 1) / dvt::kGemmBM * tn;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x)
    dvt::int8_gemm_tile(A, B, M, N, K, t / tn * dvt::kGemmBM, t % tn * dvt::kGemmBN, epi,
                        sm);
}

__global__ void __launch_bounds__(kThreads) resident_kernel(Params p) {
  __shared__ Smem sm;
  const int rows = p.nelems * p.npad, c = p.c, c3 = 3 * c, hid = p.hid;
  const int lane = threadIdx.x & 31;
  const int gwarp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int nwarps = gridDim.x * kWarps;
  const int q_tiles = (p.npad + dvt::kQueryTile - 1) / dvt::kQueryTile;
  const int attn_items = p.nelems * p.heads * q_tiles;
  // qkv scratch (image, row, slot, head, d) -> act (image, row, head, d)
  const dvt::Strides st{(long long)p.npad * c3, c, p.d, c3, (long long)p.npad * c, p.d, c};

  for (int l = 0; l < p.depth; ++l) {
    const int8_t* hc = l == 0 ? p.x : p.out;
    const float* v = p.vec + (size_t)l * kNV * c;
    const float* vh = p.vhid + (size_t)l * 2 * hid;
    const float* vo = p.vout + (size_t)l * 4 * c;
    const float* s = p.scal + l * kNS;
    if (l > 0) grid_barrier(p.barrier);

    for (int r = gwarp; r < rows; r += nwarps)  // 1. LN1
      ln_row(hc + (size_t)r * c, p.act + (size_t)r * c, c, v + kVLn1Mask * c, s[kSLn1Min],
             v + kVLn1W * c, v + kVLn1B * c, v + kVLn1Out * c, nullptr, lane);
    grid_barrier(p.barrier);

    gemm_step(p.act, p.wqkv + (size_t)l * c * c3, rows, c3, c,  // 2. qkv
              dvt::QkvEpilogue{p.mb + (size_t)l * 2 * c3, p.qkv, c3}, sm.gemm);
    grid_barrier(p.barrier);

    const dvt::CoreScalars cs{s + kSC1, s + kSS1OverS2, s + kSSa};
    for (int t = blockIdx.x; t < attn_items; t += gridDim.x) {  // 3. attention
      const int qt = t % q_tiles, h = t / q_tiles % p.heads, b = t / (q_tiles * p.heads);
      dvt::attention_item(p.qkv, cs, p.act, p.npad, p.d, p.n_real, p.lis, p.lis_fast, st,
                          b, h, qt * dvt::kQueryTile, sm.attn);
    }
    grid_barrier(p.barrier);

    gemm_step(p.act, p.wproj + (size_t)l * c * c, rows, c, c,  // 4. proj + fences
              ProjFenceEpilogue{v + kVProjMult * c, v + kVProjB * c, v + kVS3 * c,
                                v + kVInScale * c, v + kVSblk2 * c, hc, p.hc2, c},
              sm.gemm);
    grid_barrier(p.barrier);

    for (int r = gwarp; r < rows; r += nwarps)  // 5. LN2
      ln_row(p.hc2 + (size_t)r * c, p.act + (size_t)r * c, c, v + kVLn2Mask * c,
             s[kSLn2Min], v + kVLn2W * c, v + kVLn2B * c, v + kVLn2Out * c,
             v + kVLn2Rescale * c, lane);
    grid_barrier(p.barrier);

    gemm_step(p.act, p.w1 + (size_t)l * c * hid, rows, hid, c,  // 6. fc1 + GELU
              dvt::Fc1Epilogue{vh, vh + hid, s + kSM1Inv, p.hidden, hid}, sm.gemm);
    grid_barrier(p.barrier);

    gemm_step(p.hidden, p.w2 + (size_t)l * hid * c, rows, c, hid,  // 7. fc2 + fences
              Fc2FenceEpilogue{vo, vo + c, vo + 2 * c, vo + 3 * c, v + kVSblk2 * c,
                               v + kVS4 * c, p.hc2, p.out, c},
              sm.gemm);
  }
}

}  // namespace

// x: (nelems * npad, C) int8 codes on the qact1 grid; out: the same shape,
// the residual codes after the last block; wqkv (depth, C, 3C), wproj
// (depth, H, D, C), w1 (depth, C, hid), w2 (depth, hid, C) int8; mb
// (depth, 2, 3C), vec (depth, 15, C), vhid (depth, 2, hid), vout (depth, 4,
// C), scal (depth, 6) f32 (slots as in ops/kernels/serve.py); scratch:
// nelems * npad * (5C + hid) bytes; barrier: one zeroed unsigned.  lis: 1
// for the LIS, 0 for the bfloat16 float softmax.  Requires n_real <=
// min(npad, 256), D <= 64, D % 4 == 0, C % 32 == 0, hid % 32 == 0 (checked
// by the Python wrapper).
extern "C" int dvt_resident_codes(const void* x, void* out, const void* wqkv,
                                  const void* wproj, const void* w1, const void* w2,
                                  const void* mb, const void* vec, const void* vhid,
                                  const void* vout, const void* scal, void* scratch,
                                  void* barrier, int depth, int nelems, int npad,
                                  int n_real, int c, int hid, int heads, int d, int lis,
                                  int lis_fast, void* stream) {
  const size_t rows = (size_t)nelems * npad;
  int8_t* sp = static_cast<int8_t*>(scratch);
  Params p{static_cast<const int8_t*>(x),  static_cast<int8_t*>(out),
           static_cast<const int8_t*>(wqkv), static_cast<const int8_t*>(wproj),
           static_cast<const int8_t*>(w1), static_cast<const int8_t*>(w2),
           static_cast<const float*>(mb), static_cast<const float*>(vec),
           static_cast<const float*>(vhid), static_cast<const float*>(vout),
           static_cast<const float*>(scal), sp, sp + rows * c, sp + 2 * rows * c,
           sp + 5 * rows * c, static_cast<unsigned*>(barrier), depth, nelems, npad,
           n_real, c, hid, heads, d, lis, lis_fast};

  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, resident_kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // no more blocks than the largest step has work items
  const long long m_tiles = ((long long)rows + dvt::kGemmBM - 1) / dvt::kGemmBM;
  const int widest = 3 * c > hid ? 3 * c : hid;
  long long items = m_tiles * ((widest + dvt::kGemmBN - 1) / dvt::kGemmBN);
  const long long attn =
      (long long)nelems * heads * ((npad + dvt::kQueryTile - 1) / dvt::kQueryTile);
  const long long ln = ((long long)rows + kWarps - 1) / kWarps;
  if (attn > items) items = attn;
  if (ln > items) items = ln;
  long long grid = (long long)per_sm * sms;
  if (items < grid) grid = items;

  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(resident_kernel),
                                    dim3(static_cast<unsigned>(grid)), dim3(kThreads), args,
                                    0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
