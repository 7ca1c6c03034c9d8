"""Integer linear with a fused epilogue (counterpart of
``diffvit_tpu/ops/pallas/linear.py::fused_int_linear``, K3).

    y     = x_i8 @ w_int * mult + bias                 (raw: float32 y)
    codes = clip(rint(y * (1/out_scale)), -128, 127)   (codes: int8)
    fq    = codes * out_scale                          (fq: float32)

The reciprocal ``1/out_scale`` is taken once in float32 and multiplied, as
the Pallas wrapper folds it (``linear.py:91``).  The CUDA kernel is
``csrc/int_linear.cu``, on the Hopper GEMM mainloop (``wgmma_gemm.cuh``)
with the weight's cached K-major copy (``gemm.kmajor``) and, where K % 16
!= 0, x's K padded with zeros (``gemm.pad_k``); the plain version below is
its exact
specification: every product and sum rounds on its own, as the kernel
(built with ``-fmad=false``) and as the forward's ``int_matmul(x, w) *
mult + b`` do, so the raw mode equals that expression bit for bit.

Neither package routes a model's GEMM through this kernel: the JAX package
leaves the patch, proj, head and Swin sites to XLA, and the port to
``ops/quant.int_matmul`` (``linear.py:11`` says why)."""
from __future__ import annotations

import torch

from ..quant import int_matmul
from . import check_for_kernel, require, route
from .build import check, load_library
from .gemm import (device_plan, gemm_footprint, kmajor, pad_k, per_weight,
                   require_tma_operand)

MODES = {"raw": 0, "fq": 1, "codes": 2}


def linear_vectors(mult, bias, out_scale, n):
    """The (4, N) float32 rows the kernel reads, as the Pallas wrapper
    stacks them: [mult, bias, out_scale, 1/out_scale] (ones for the raw
    mode); the reciprocal is one IEEE division by a tensor."""
    f32 = torch.float32
    out_b = torch.ones(n, dtype=f32, device=mult.device) if out_scale is None \
        else torch.as_tensor(out_scale, dtype=f32,
                             device=mult.device).expand(n)
    return torch.stack([mult.to(f32).expand(n), bias.to(f32).expand(n),
                        out_b, torch.ones_like(out_b) / out_b])


def _mode(out_scale, emit_codes):
    return "raw" if out_scale is None else ("codes" if emit_codes else "fq")


def fused_int_linear_plain(x_i8, w_int, mult, bias, *, out_scale=None,
                           emit_codes=False, bf16_dot=True):
    """Plain PyTorch version of :func:`fused_int_linear`."""
    del bf16_dot  # exact either way (see fused_int_linear)
    v = linear_vectors(mult, bias, out_scale, w_int.shape[1])
    y = int_matmul(x_i8, w_int).to(torch.float32) * v[0] + v[1]
    mode = _mode(out_scale, emit_codes)
    if mode == "raw":
        return y
    codes = torch.clamp(torch.round(y * v[3]), -128, 127)
    return codes.to(torch.int8) if mode == "codes" else codes * v[2]


def fused_int_linear(x_i8, w_int, mult, bias, *, out_scale=None,
                     emit_codes=False, bf16_dot=True):
    """(R, K) int8 @ (K, N) int8 -> ``acc * mult + bias`` and its epilogue,
    in one kernel.

    mult/bias: (N,) or scalar float32.  ``out_scale`` None: returns the
    raw (R, N) float32 y; set (scalar or (N,)): quantizes y onto that grid,
    as int8 codes with ``emit_codes=True``, else as float32 codes *
    out_scale.  Any R, K and N: unlike the Pallas kernel, R needs no
    padding, and the TPU's block_rows/sub/interpret knobs have no
    counterpart.  ``bf16_dot`` is accepted and has no effect: the Pallas
    kernel's bfloat16 dot is exact by its caller's contract (K * 128 *
    max|w| < 2^24), and the product here is an exact int32 one.

    A CUDA tensor runs ``csrc/int_linear.cu``; a CPU tensor runs
    :func:`fused_int_linear_plain`.  On the card ``x_i8`` must be
    16-byte aligned (TMA reads it; ``ValueError`` otherwise)."""
    tensors = [t for t in (x_i8, w_int, mult, bias, out_scale)
               if isinstance(t, torch.Tensor)]
    if route(*tensors) == "cpu":
        return fused_int_linear_plain(x_i8, w_int, mult, bias,
                                      out_scale=out_scale,
                                      emit_codes=emit_codes,
                                      bf16_dot=bf16_dot)
    check_for_kernel(x_i8, "x_i8", torch.int8, 2)
    check_for_kernel(w_int, "w_int", torch.int8, 2)
    rows, k = x_i8.shape
    n = w_int.shape[1]
    require(w_int.shape[0] == k,
            f"w_int {tuple(w_int.shape)} does not match x {tuple(x_i8.shape)}")
    require(rows > 0 and n > 0 and k > 0,
            f"fused_int_linear: empty product {tuple(x_i8.shape)} @ "
            f"{tuple(w_int.shape)}")
    mode = _mode(out_scale, emit_codes)
    v = per_weight(
        lambda: linear_vectors(mult, bias, out_scale, n).contiguous(),
        mult, bias, out_scale, n)
    wk = kmajor(w_int)
    kp = wk.shape[1]
    x_p = pad_k(x_i8, kp)
    require_tma_operand(x_p, "x_i8")
    plan = device_plan(rows, n, kp, x_i8.device)
    out = torch.empty((rows, n), device=x_i8.device,
                      dtype=torch.int8 if mode == "codes" else torch.float32)
    err = load_library().dvt_int_linear(
        x_p.data_ptr(), wk.data_ptr(), v.data_ptr(), out.data_ptr(),
        rows, kp, n, MODES[mode], *plan.launch_args(),
        torch.cuda.current_stream(x_i8.device).cuda_stream)
    check(err, "fused_int_linear")
    fused_int_linear.launches += 1
    return out


fused_int_linear.launches = 0


def footprint(rows: int, n: int, k: int, device, mode: str = "raw") -> dict:
    """{"registers", "smem_bytes", "blocks_per_sm"} of the kernel that
    :func:`fused_int_linear` launches in ``mode`` for an (rows, k) @ (k, n)
    product on ``device``, with the plan's tile and shared memory.  Needs
    a card."""
    plan = device_plan(rows, n, -(-k // 16) * 16, device)
    return gemm_footprint(load_library().dvt_int_linear_footprint, plan,
                          MODES[mode])
