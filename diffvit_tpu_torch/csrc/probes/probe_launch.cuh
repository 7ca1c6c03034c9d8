// The launch checks and footprints of the probes' own warp-specialized
// wgmma kernels (P2's in overlap.cu, P3's pipelined and staged fc1 in
// overlap_mlp.cu), which run wgmma_gemm.cuh's roles (a producer warpgroup,
// two consumer warpgroups, setmaxnreg's moves) with loops of their own.
#pragma once

#include <cuda_runtime.h>

#include "wgmma_gemm.cuh"

namespace dvt {
namespace probe {

// Sets kernel `f`'s dynamic shared memory limit (once per card, kernel
// and limit) and checks its register count (wg::register_budget), as
// wg::prepare does for the served kernel, whose cache is one per template
// instance; this one serves the probes' own kernels, which are not
// wgmma_gemm_kernel instances.
template <int B>
inline cudaError_t prepare(const void* f, int smem, cudaFuncAttributes* attr) {
  constexpr int kSlots = 64;
  static const void* fns[kSlots] = {};
  static int cards[kSlots] = {}, smems[kSlots] = {};
  static cudaFuncAttributes attrs[kSlots];
  int card = 0;
  cudaError_t err = cudaGetDevice(&card);
  if (err != cudaSuccess) return err;
  int i = 0;
  while (i < kSlots && fns[i] != nullptr && !(fns[i] == f && cards[i] == card)) ++i;
  if (i == kSlots) return cudaErrorMemoryAllocation;
  if (fns[i] == nullptr || smem > smems[i]) {
    err = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncGetAttributes(&attrs[i], f);
    if (err != cudaSuccess) return err;
    fns[i] = f;
    cards[i] = card;
    smems[i] = smem;
  }
  *attr = attrs[i];
  return wg::register_budget<B>(*attr);
}

// Registers a thread at launch, local memory (spills) a thread, shared
// memory a block (dynamic + static) and blocks an SM of kernel `f`, whose
// attributes a prepare returned as `attr` with `err`, with `smem` bytes of
// dynamic shared memory.  A served kernel is prepared by wg::prepare, which
// keeps its own record of the limit it set.
inline cudaError_t report(const void* f, const cudaFuncAttributes& attr, cudaError_t err,
                          int smem, int* registers, int* local_bytes, int* smem_bytes,
                          int* blocks_per_sm) {
  if (err != cudaSuccess && err != cudaErrorInvalidConfiguration) return err;
  *registers = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *smem_bytes = smem + static_cast<int>(attr.sharedSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, f, wg::kThreads, smem);
}

// report() for a probe's own kernel `f` at B blocks an SM.
template <int B>
inline cudaError_t footprint(const void* f, int smem, int* registers, int* local_bytes,
                             int* smem_bytes, int* blocks_per_sm) {
  cudaFuncAttributes attr;
  const cudaError_t err = prepare<B>(f, smem, &attr);
  return report(f, attr, err, smem, registers, local_bytes, smem_bytes, blocks_per_sm);
}

}  // namespace probe
}  // namespace dvt
