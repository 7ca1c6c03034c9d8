// Probe P3: K2's structure in five modes, to see what the GELU costs and
// what a software-pipelined K loop, and issuing the next sub-block's fc1
// before the current GELU, buy.
//
// Replaces the Pallas kernel _kernel of scripts/overlap_probe_mlp.py:36
// (built at :95, called at :97), in its four modes and one more:
//   dot        g = gelu(mid), mid = fc1(x) * mult1 + bias1 (K2's order)
//   input      g = gelu(g_src), a kernel input; mid stays alive through
//              the output
//   nogelu     g = mid
//   pipelined  as dot, with the next sub-block's fc1 (its cp.async loads
//              and its first mma) issued before the current sub-block's GELU
//   staged     as dot, with the K loop software-pipelined as in pipelined,
//              but each sub-block's GELU right after its own K loop (the
//              next sub-block's first loads in flight), so that it holds
//              one sub-block's accumulators: what the staged K loop buys
//              apart from the early issue
// then h = clip(rint(g * s_q1_inv)) int8, acc2 = h @ w2, y = acc2 * mult2 +
// bias2, codes = clip(rint(y * inv_out)), and in every mode the keep-alive
// out = codes * out_scale + mid[:, :Cout] * 1e-8 (float32).
//
// Design: K2's two launches on the shared GEMM tile (int8_gemm.cuh,
// DenseOperands) and its GELU (int_mlp.cuh).  The fc1 launch gives each
// block two 64-row sub-blocks of one 64-column tile (a 128-row block, as
// the TPU's 512-row block held two 256-row sub-blocks).  In dot, input and
// nogelu each sub-block runs K2's K loop (plain loads into one shared-memory
// stage, a barrier, the mma, a barrier) and then its epilogue.  In staged
// and pipelined the two sub-blocks' K steps run as one software-pipelined
// sequence over two shared-memory stages and one barrier a step: while step
// i's mma runs, step i+1's A chunk is in flight by cp.async and its B chunk
// by a register load (B is transposed on its way into shared memory, which
// cp.async cannot do).  Pipelined runs the first sub-block's epilogue (its
// GELU) after the second sub-block's first mma is issued, so both
// sub-blocks' accumulators are live across it.  The epilogue writes the int8
// hidden tensor and mid's first Cout columns (the keep-alive, float32); the
// fc2 launch's epilogue (K2's tile) requantizes and adds the keep-alive.
// Built with -fmad=false, so every multiply and add rounds on its own:
// staged and pipelined equal dot bit for bit, and each mode equals its
// plain version.
//
// What bounds it on the H100: 2 x rows x 384 x 1536 x 2 int8 operations
// (119.6 G at rows 50,688, the script's DeiT-S b=256: 60 us at 1,979 T/s);
// `input` also reads the 311 MB float32 g_src (122 us at 3.35 TB/s, so it
// is bound by bytes).  The GELU's 30-odd float32 operations an element are
// SIMT work outside that count.
#include <cstdint>
#include <cuda_runtime.h>

#include "int8_gemm.cuh"
#include "int_mlp.cuh"

namespace {

enum Mode { kDot = 0, kInput = 1, kNoGelu = 2, kPipelined = 3, kStaged = 4 };
constexpr int kSubRows = dvt::kGemmBM;  // rows of a sub-block
constexpr int kSubs = 2;                // sub-blocks of a block

template <int M>
struct Fc1Epilogue {
  const float* v1;     // (2, Hid) [mult1, bias1]
  const float* g_src;  // (rows, Hid), read in mode input
  const float* scal;   // (1,) [s_q1_inv]
  int8_t* hidden;      // (rows, Hid)
  float* keep;         // (rows, Cout): mid's first Cout columns
  int hid, cout;
  __device__ void operator()(int r, int c, int acc) const {
    const float mid = static_cast<float>(acc) * v1[c] + v1[hid + c];
    const size_t at = (size_t)r * hid + c;
    const float src = M == kInput ? g_src[at] : mid;
    const float g = M == kNoGelu ? src : dvt::gelu_poly(src);
    hidden[at] = dvt::clip_i8(rintf(g * scal[0]));
    if (c < cout) keep[(size_t)r * cout + c] = mid;
  }
};

struct Fc2Epilogue {
  const float* v2;  // (4, Cout) [mult2, bias2, out_scale, inv_out]
  const float* keep;
  float* out;       // (rows, Cout)
  int cout;
  __device__ void operator()(int r, int c, int acc) const {
    const float y = static_cast<float>(acc) * v2[c] + v2[cout + c];
    const float code = fminf(fmaxf(rintf(y * v2[3 * cout + c]), -128.f), 127.f);
    const size_t at = (size_t)r * cout + c;
    out[at] = code * v2[2 * cout + c] + keep[at] * 1e-8f;
  }
};

template <int M>
__global__ void __launch_bounds__(dvt::kGemmThreads)
    fc1_kernel(dvt::DenseOperands ops, Fc1Epilogue<M> epi) {
  __shared__ dvt::GemmSmem sm;
  const int m0 = blockIdx.y * kSubRows * kSubs, n0 = blockIdx.x * dvt::kGemmBN;
#pragma unroll
  for (int s = 0; s < kSubs; ++s) {
    dvt::GemmAcc acc;
    dvt::int8_gemm_mainloop(ops, m0 + s * kSubRows, n0, acc, sm);
    dvt::int8_gemm_epilogue(ops.M, ops.N, m0 + s * kSubRows, n0, acc, epi);
  }
}

// 16 bytes from global to shared memory, asynchronously; zero-filled when
// src_bytes is 0.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// Modes staged and pipelined (see the head of this file); requires K % 32
// == 0 and 16-byte aligned A and B (the wrapper checks).
template <int M>
__global__ void __launch_bounds__(dvt::kGemmThreads)
    fc1_staged_kernel(dvt::DenseOperands ops, Fc1Epilogue<M> epi) {
  constexpr bool kEarly = M == kPipelined;  // next fc1 before this GELU
  __shared__ dvt::GemmSmem sm[2];
  const int m0 = blockIdx.y * kSubRows * kSubs, n0 = blockIdx.x * dvt::kGemmBN;
  const int tid = threadIdx.x;
  const int ar = tid >> 1, ac = (tid & 1) * 16;  // this thread's A chunk
  const int bk = tid >> 2, bc = (tid & 3) * 16;  // and its B chunk
  const int kt = ops.K / dvt::kGemmBK;           // K steps a sub-block
  const int steps = kSubs * kt;

  // step i = sub-block i / kt, K offset (i % kt) * 32
  auto issue_a = [&](int i, dvt::GemmSmem& st) {
    const int row = m0 + (i / kt) * kSubRows + ar;
    const bool in = row < ops.M;
    const int8_t* src = ops.A + (size_t)(in ? row : 0) * ops.K + (i % kt) * dvt::kGemmBK + ac;
    cp_async16(&st.As[ar][ac], src, in ? 16 : 0);
    cp_async_commit();
  };
  auto load_b = [&](int i) {
    int4 v = make_int4(0, 0, 0, 0);
    if (n0 + bc < ops.N)
      v = *reinterpret_cast<const int4*>(ops.B + (size_t)((i % kt) * dvt::kGemmBK + bk) * ops.N +
                                         n0 + bc);
    return v;
  };

  dvt::GemmAcc acc[kSubs];
#pragma unroll
  for (int s = 0; s < kSubs; ++s)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[s][i][j][k] = 0;

  issue_a(0, sm[0]);
  dvt::store_b_chunk(sm[0], bc, bk, load_b(0));
#pragma unroll
  for (int s = 0; s < kSubs; ++s) {
    for (int ks = 0; ks < kt; ++ks) {
      const int i = s * kt + ks;
      dvt::GemmSmem& cur = sm[i & 1];
      dvt::GemmSmem& nxt = sm[(i & 1) ^ 1];
      cp_async_wait_all();
      __syncthreads();  // step i's stage is full; step i-1's reads are done
      const bool more = i + 1 < steps;
      int4 b_next = make_int4(0, 0, 0, 0);
      if (more) {
        issue_a(i + 1, nxt);
        b_next = load_b(i + 1);
      }
      dvt::int8_gemm_mma_step(cur, acc[s]);
      if (kEarly && s > 0 && ks == 0)  // the previous sub-block's GELU
        dvt::int8_gemm_epilogue(ops.M, ops.N, m0 + (s - 1) * kSubRows, n0, acc[s > 0 ? s - 1 : 0],
                                epi);
      if (more) dvt::store_b_chunk(nxt, bc, bk, b_next);
    }
    if (!kEarly || s == kSubs - 1)  // this sub-block's GELU
      dvt::int8_gemm_epilogue(ops.M, ops.N, m0 + s * kSubRows, n0, acc[s], epi);
  }
}

template <int M>
void launch_fc1(const dvt::DenseOperands& ops, const Fc1Epilogue<M>& epi, cudaStream_t s) {
  const int block_rows = kSubRows * kSubs;
  dim3 grid((ops.N + dvt::kGemmBN - 1) / dvt::kGemmBN, (ops.M + block_rows - 1) / block_rows);
  if constexpr (M == kPipelined || M == kStaged)
    fc1_staged_kernel<M><<<grid, dvt::kGemmThreads, 0, s>>>(ops, epi);
  else
    fc1_kernel<M><<<grid, dvt::kGemmThreads, 0, s>>>(ops, epi);
}

}  // namespace

// x: (rows, Cin) int8; w1: (Cin, Hid) int8; w2: (Hid, Cin) int8; v1: (2,
// Hid) f32; v2: (4, Cin) f32; g_src: (rows, Hid) f32; scal: (1,) f32;
// hidden: (rows, Hid) int8 and keep: (rows, Cin) f32 scratch; out: (rows,
// Cin) f32.  mode: 0 dot, 1 input, 2 nogelu, 3 pipelined, 4 staged.
// Requires Cin % 32 == 0, Hid % 32 == 0, Hid >= Cin and 16-byte aligned x,
// w1 and w2 (checked by the wrapper).
extern "C" int dvt_probe_overlap_mlp(const void* x, const void* w1, const void* w2,
                                     const void* v1, const void* v2, const void* g_src,
                                     const void* scal, void* hidden, void* keep, void* out,
                                     int rows, int cin, int hid, int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dvt::DenseOperands ops{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w1),
                               rows, hid, cin};
  const float* v1p = static_cast<const float*>(v1);
  const float* gp = static_cast<const float*>(g_src);
  const float* sp = static_cast<const float*>(scal);
  int8_t* hp = static_cast<int8_t*>(hidden);
  float* kp = static_cast<float*>(keep);
  switch (mode) {
    case kDot: launch_fc1(ops, Fc1Epilogue<kDot>{v1p, gp, sp, hp, kp, hid, cin}, s); break;
    case kInput: launch_fc1(ops, Fc1Epilogue<kInput>{v1p, gp, sp, hp, kp, hid, cin}, s); break;
    case kNoGelu: launch_fc1(ops, Fc1Epilogue<kNoGelu>{v1p, gp, sp, hp, kp, hid, cin}, s); break;
    case kPipelined:
      launch_fc1(ops, Fc1Epilogue<kPipelined>{v1p, gp, sp, hp, kp, hid, cin}, s);
      break;
    case kStaged: launch_fc1(ops, Fc1Epilogue<kStaged>{v1p, gp, sp, hp, kp, hid, cin}, s); break;
    default: return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dvt::launch_int8_gemm(hp, static_cast<const int8_t*>(w2), rows, cin, hid,
                        Fc2Epilogue{static_cast<const float*>(v2), kp, static_cast<float*>(out),
                                    cin},
                        s);
  return cudaGetLastError();
}

// The fc1 kernel of mode `mode`: its registers a thread, its shared memory
// and how many of its blocks an SM holds at once (the occupancy API), so
// that a time can be read beside what the kernel's footprint allows.
extern "C" int dvt_probe_overlap_mlp_fc1_occupancy(int mode, int* registers, int* smem_bytes,
                                                   int* blocks_per_sm) {
  const void* f = nullptr;
  switch (mode) {
    case kDot: f = reinterpret_cast<const void*>(fc1_kernel<kDot>); break;
    case kInput: f = reinterpret_cast<const void*>(fc1_kernel<kInput>); break;
    case kNoGelu: f = reinterpret_cast<const void*>(fc1_kernel<kNoGelu>); break;
    case kPipelined: f = reinterpret_cast<const void*>(fc1_staged_kernel<kPipelined>); break;
    case kStaged: f = reinterpret_cast<const void*>(fc1_staged_kernel<kStaged>); break;
    default: return cudaErrorInvalidValue;
  }
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, f);
  if (err != cudaSuccess) return err;
  *registers = attr.numRegs;
  *smem_bytes = static_cast<int>(attr.sharedSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, f, dvt::kGemmThreads, 0);
}
