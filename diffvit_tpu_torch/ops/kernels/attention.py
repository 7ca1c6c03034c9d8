"""Fused int8 qkv projection + Log-Int-Softmax attention (counterpart of
``diffvit_tpu/ops/pallas/attention.py::fused_qkv_attention_v2``, K1), and
the attention core alone on projected qkv (``::fused_int_attention``, K5).

    qkv    = clip(rint(x_i8 @ w * mult/s1 + bias/s1))          (qact1 codes)
    a_int  = clip(rint(q_h @ k_h^T * c1))                      (qact_attn1)
    w      = LogIntSoftmax(a_int)                               (2^-code)
    out    = clip(rint((w @ v_h) * s1/s2))                      (qact2 codes)

K5 runs the last three lines, with the slow LIS.  For ``lis=False`` both
run a float softmax rounded to bfloat16 instead of the LIS, taken in
float64 with attn@v, each rounded once (:func:`attention_core_plain`, the
core that the resident encoder K6 runs too).  Both kernels are
``csrc/qkv_attention.cu``; the plain versions below are their
specification, exact for the LIS, and both differ from the JAX reference
only where the reference's own arithmetic is order- or
approximation-dependent:

* the row sum of the integer exponentials is exact (an int64 sum, rounded
  once to float32), where the reference sums float32 terms of up to 2^55;
* ``2^(32-q)`` and ``floor(log2 y)`` are exact (exponent bits), where XLA's
  ``exp2``/``log2`` on the CPU are off by an ulp for some integers;
* the LIS weights are carried as the integers ``2^(15-code)`` and attn@v is
  an exact integer sum, equal to the reference's float attn@v times 2^15.

The int64 sum holds the row's terms only while they cannot overflow it:
``lis_sum_fits(s_a, n_keys)``, which ``models/convert.py`` checks for
every block (for ViT's 197 keys it admits ``s_a >= 2^-10``).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..quant import int_matmul, pow2
from . import check_for_kernel, require, route
from .build import check, load_library

# float32 roundings of _lis_body's weakly typed Python constants
_X0 = float(np.float32(-0.6931))
_B = float(np.float32(0.96963238 / 0.35815147))
_C = float(np.float32(1.0 / 0.35815147))
_NUDGE = float(np.float32(4.0 / 3.0 * (1.0 + 2.0**-17)))
MAX_KEYS = 256  # keys per head the kernel keeps in shared memory


def lis_sum_fits(scale_value: float, n_keys: int) -> bool:
    """Whether the exact int64 row sum of ``n_keys`` integer exponentials
    cannot overflow at the softmax scale ``scale_value``.  The largest term
    is ``floor(C / s^2) * 2^32`` (the polynomial at r = 0, q = 0; it falls
    for every other r of the clamped range), so the sum fits while
    ``n_keys * floor(C / s^2) * 2^32 < 2^63``.  49 keys (a 7x7 Swin
    window) admit s = 2^-11; 197 keys (ViT) need s >= 2^-10."""
    s = np.float32(scale_value)
    c_int = math.floor(np.float32(_C) / (s * s))
    return n_keys * c_int < 2**31


def lis_fast_ok(scale_value: float) -> bool:
    """Validity window of the fast LIS form (no floor/max on the integer
    exponential) — ``diffvit_tpu/ops/pallas/attention.py:43``."""
    return 2.0**-10 <= scale_value <= 0.6931


def lis_tail_plain(exp_sum: torch.Tensor, exp_int: torch.Tensor):
    """The folded log2 quantization of ``_lis_body``: m = rint(exp_sum /
    exp_int), y = 4m/3 * (1 + 2^-17), code = floor(log2 y), taken exactly
    from the exponent bits.  Returns the int32 weight 2^(15 - code), 0 where
    y >= 2^16 saturates (and for masked columns, where exp_int = 0)."""
    y = torch.round(exp_sum / exp_int) * _NUDGE
    code = torch.frexp(y).exponent - 1
    keep = y < 65536.0
    shift = torch.where(keep, 15 - code, 0)
    w = torch.ones_like(shift) << shift
    return torch.where(keep, w, 0).to(torch.int32)


def lis_body_plain(a_int: torch.Tensor, scale: torch.Tensor, bits: int,
                   col_ok: torch.Tensor, fast: bool = False) -> torch.Tensor:
    """Log-Int-Softmax on integer scores (float32 carrier) over the columns
    ``col_ok`` (``_lis_body``, ``attention.py:51-137``).  Returns int32
    weights scaled by 2^15: ``2^(15 - code)``, 0 where saturated or masked."""
    if bits > 4:
        raise NotImplementedError(
            "LIS tail supports bits <= 4 only (the reference's uint4)")
    row_max = torch.where(col_ok, a_int, -torch.inf).amax(-1, keepdim=True)
    x_int = a_int - row_max
    # a constant over a tensor: torch computes ``number / t`` as
    # ``t.reciprocal() * number``, two roundings where the kernels and the
    # reference take one IEEE quotient
    const = lambda v: torch.full_like(scale, v)  # noqa: E731
    x0_int = torch.floor(const(_X0) / scale)
    x_int = torch.maximum(x_int, 32.0 * x0_int)
    q = torch.floor(x_int / x0_int)
    r = x_int - x0_int * q
    b_int = torch.floor(const(_B) / scale)
    c_int = torch.floor(const(_C) / (scale * scale))
    poly = r * (r + b_int) + c_int
    exp_int = poly * pow2(32.0 - q)
    if not fast:
        exp_int = torch.clamp(torch.floor(exp_int), min=0.0)
    exp_int = torch.where(col_ok, exp_int, 0.0)
    exp_sum = exp_int.to(torch.int64).sum(-1, keepdim=True).to(torch.float32)
    return lis_tail_plain(exp_sum, exp_int)


def fold_requant(mult, bias, s1_inv, c3):
    """The wrapper's fold of the qact1 grid into the epilogue
    (``attention.py:307-310``): (2, 3C) float32 [mult/s1, bias/s1]."""
    return torch.stack([mult.expand(c3) * s1_inv, bias.expand(c3) * s1_inv])


def qkv_projection_plain(x_i8, w_all, mb):
    """First stage: (B, Npad, Cin) int8 @ (Cin, 3C) -> qact1 int8 codes."""
    y = int_matmul(x_i8, w_all).to(torch.float32) * mb[0] + mb[1]
    return torch.clamp(torch.round(y), -128, 127).to(torch.int8)


def lis_weights_plain(qkv, scalars, *, num_heads, head_dim, n_real,
                      bits=4, lis_fast=False):
    """Second stage up to the softmax: (B, Npad, 3C) int8 qkv codes ->
    (B, H, Npad, Npad) int32 LIS weights (x 2^15, pad keys 0)."""
    b, npad, _ = qkv.shape
    t = qkv.reshape(b, npad, 3, num_heads, head_dim).permute(2, 0, 3, 1, 4)
    scores = int_matmul(t[0], t[1].transpose(-1, -2))
    a_int = torch.clamp(torch.round(scores.to(torch.float32) * scalars[1]),
                        -128, 127)
    col_ok = torch.arange(npad, device=qkv.device) < n_real
    return lis_body_plain(a_int, scalars[0], bits, col_ok, fast=lis_fast)


def _weighted_values(weights, v):
    """Exact int32 ``weights @ v`` (|sum| <= 2^30): int32 on the CPU, float64
    (exact below 2^53) on CUDA, which has no integer matmul."""
    if weights.device.type == "cpu":
        return torch.matmul(weights, v.to(torch.int32))
    return torch.matmul(weights.to(torch.float64),
                        v.to(torch.float64)).to(torch.int32)


def _softmax_weights_plain(a_int, s_a, col_ok):
    """The float-softmax branch (``lis=False``) of ``_attn_kernel`` and
    ``_qkv_attn_kernel_v2``: softmax of the float32 logits ``a_int * s_a``
    over the columns ``col_ok``, taken in float64, rounded to float32 and
    then to bfloat16; returned as float64.  (The reference takes it in
    float32, where the exponential and the order of the row sum differ by
    an ulp between devices; float64 rounded once does not.)"""
    logits = torch.where(col_ok, a_int * s_a, -torch.inf)
    p = torch.softmax(logits.to(torch.float64), dim=-1)
    return p.to(torch.float32).to(torch.bfloat16).to(torch.float64)


def attention_core_plain(q, k, v, c1, s_a, s1_over_s2, *, n_real, bits=4,
                         lis=True, lis_fast=False):
    """The attention core that K1, K5 and K6 run, on int8 codes q, k, v
    (..., Npad, D) of the qact1 grid: scores -> qact_attn1 codes -> the
    LIS (weights x 2^15, attn@v exact) or the bfloat16 float softmax
    (attn@v in float64, rounded once: products of bfloat16 weights and int8
    values are exact, and so is their float64 sum at these exponent
    spreads) -> x s1/s2 -> int8 on the qact2 grid.  Keys at or past
    ``n_real`` are masked."""
    scores = int_matmul(q, k.transpose(-1, -2))
    a_int = torch.clamp(torch.round(scores.to(torch.float32) * c1), -128, 127)
    col_ok = torch.arange(k.shape[-2], device=k.device) < n_real
    if lis:
        weights = lis_body_plain(a_int, s_a, bits, col_ok, fast=lis_fast)
        acc = _weighted_values(weights, v).to(torch.float32) * 2.0**-15
    else:
        weights = _softmax_weights_plain(a_int, s_a, col_ok)
        acc = torch.matmul(weights, v.to(torch.float64)).to(torch.float32)
    o = torch.round(acc * s1_over_s2)
    return torch.clamp(o, -128, 127).to(torch.int8)


def _check_contract(bits, lis):
    if lis and bits > 4:
        raise NotImplementedError(
            "fused_qkv_attention_v2: LIS supports bits <= 4 only")


def fused_qkv_attention_v2_plain(x_i8, w_all, mult, bias, scalars, *,
                                 num_heads, head_dim, n_real, bits=4,
                                 lis=True, lis_fast=False):
    """Plain PyTorch version of :func:`fused_qkv_attention_v2`."""
    _check_contract(bits, lis)
    mb = fold_requant(mult, bias, scalars[2], w_all.shape[1])
    qkv = qkv_projection_plain(x_i8, w_all, mb)
    b, npad, _ = qkv.shape
    t = qkv.reshape(b, npad, 3, num_heads, head_dim).permute(2, 0, 3, 1, 4)
    return attention_core_plain(t[0], t[1], t[2], scalars[1], scalars[0],
                                scalars[3], n_real=n_real, bits=bits,
                                lis=lis, lis_fast=lis_fast)


def fused_qkv_attention_v2(x_i8, w_all, mult, bias, scalars, *, num_heads,
                           head_dim, n_real, bits=4, lis=True,
                           lis_fast=False):
    """Fused qkv projection + attention (the LIS, or for ``lis=False`` the
    float softmax rounded to bfloat16).

    x_i8: (B, Npad, Cin) int8 LN codes (rows at or past ``n_real`` are
    padding: they are computed, and never used as keys); w_all: (Cin, 3C)
    int8 with columns ordered [slot, head, d]; mult/bias: (3C,) float32 (or
    broadcastable); scalars: (4,) float32 [s_a, c1, 1/s1, s1/s2].
    lis_fast: caller guarantees s_a in [2^-10, ln2].
    Returns (B, H, Npad, D) int8 on the qact2 grid.

    A CUDA tensor runs ``csrc/qkv_attention.cu``; a CPU tensor runs
    :func:`fused_qkv_attention_v2_plain`."""
    _check_contract(bits, lis)
    if route(x_i8, w_all, mult, bias, scalars) == "cpu":
        return fused_qkv_attention_v2_plain(
            x_i8, w_all, mult, bias, scalars, num_heads=num_heads,
            head_dim=head_dim, n_real=n_real, bits=bits, lis=lis,
            lis_fast=lis_fast)
    b, npad, cin = x_i8.shape
    c3 = w_all.shape[1]
    check_for_kernel(x_i8, "x_i8", torch.int8, 3)
    check_for_kernel(w_all, "w_all", torch.int8, 2)
    check_for_kernel(scalars, "scalars", torch.float32, 1)
    require(w_all.shape[0] == cin and c3 == 3 * num_heads * head_dim,
            f"w_all {tuple(w_all.shape)} does not match x {tuple(x_i8.shape)}"
            f" and {num_heads} heads of {head_dim}")
    require(scalars.numel() == 4, "scalars must hold [s_a, c1, 1/s1, s1/s2]")
    require(0 < n_real <= min(npad, MAX_KEYS),
            f"n_real={n_real}: the kernel takes 1..min(Npad, {MAX_KEYS}) keys")
    require(head_dim <= 64 and head_dim % 4 == 0,
            f"head_dim={head_dim}: the kernel takes multiples of 4 up to 64")
    require(cin % 32 == 0 and c3 % 16 == 0,
            f"Cin={cin} must be a multiple of 32, 3C={c3} of 16")
    mb = fold_requant(mult, bias, scalars[2], c3)
    qkv = torch.empty((b, npad, c3), dtype=torch.int8, device=x_i8.device)
    out = torch.empty((b, num_heads, npad, head_dim), dtype=torch.int8,
                      device=x_i8.device)
    err = load_library().dvt_qkv_attention(
        x_i8.data_ptr(), w_all.data_ptr(), mb.data_ptr(), scalars.data_ptr(),
        qkv.data_ptr(), out.data_ptr(), b, npad, cin, num_heads, head_dim,
        n_real, int(lis), int(lis_fast),
        torch.cuda.current_stream(x_i8.device).cuda_stream)
    check(err, "fused_qkv_attention_v2")
    fused_qkv_attention_v2.launches += 1
    return out


fused_qkv_attention_v2.launches = 0


def fused_int_attention_plain(qkv_i8, scalars, *, num_heads, n_real, bits=4,
                              lis=True):
    """Plain PyTorch version of :func:`fused_int_attention` (the slow LIS)."""
    return attention_core_plain(qkv_i8[:, 0], qkv_i8[:, 1], qkv_i8[:, 2],
                                scalars[0], scalars[2], scalars[1],
                                n_real=n_real, bits=bits, lis=lis)


def fused_int_attention(qkv_i8, scalars, *, num_heads, n_real, bits=4,
                        lis=True):
    """Attention core on projected qkv codes (SmoothQuant off).

    qkv_i8: (B, 3, H, N, D) int8 on the qact1 grid — any strides whose
    innermost is 1, e.g. the view ``qkv.view(B, N, 3, H, D).permute(0, 2,
    3, 1, 4)`` of the qkv GEMM's (B, N, 3C) output, read without a copy.
    Rows at or past ``n_real`` are never used as keys.  scalars: (3,)
    float32 [c1, s1/s2, s_a] (c1 = s1^2 * attn_scale / s_a).  ``lis``: the
    Log-Int-Softmax (slow form, as the Pallas kernel runs it), else the
    float softmax rounded to bfloat16.
    Returns (B, H, N, D) int8 on the qact2 grid.

    A CUDA tensor runs ``csrc/qkv_attention.cu``'s attention core (the one
    K1 runs after its qkv GEMM); a CPU tensor runs
    :func:`fused_int_attention_plain`."""
    if lis and bits > 4:
        raise NotImplementedError(
            "fused_int_attention: LIS supports bits <= 4 only")
    if route(qkv_i8, scalars) == "cpu":
        return fused_int_attention_plain(qkv_i8, scalars,
                                         num_heads=num_heads, n_real=n_real,
                                         bits=bits, lis=lis)
    b, three, h, npad, d = qkv_i8.shape
    require(qkv_i8.dtype == torch.int8 and three == 3 and h == num_heads,
            f"qkv_i8 {tuple(qkv_i8.shape)} {qkv_i8.dtype}: expected int8 "
            f"(B, 3, {num_heads}, N, D)")
    check_for_kernel(scalars, "scalars", torch.float32, 1)
    require(scalars.numel() == 3, "scalars must hold [c1, s1/s2, s_a]")
    require(0 < n_real <= min(npad, MAX_KEYS),
            f"n_real={n_real}: the kernel takes 1..min(N, {MAX_KEYS}) keys")
    require(d <= 64 and d % 4 == 0,
            f"head_dim={d}: the kernel takes multiples of 4 up to 64")
    st = qkv_i8.stride()
    require(st[4] == 1 and all(s % 4 == 0 for s in st[:4])
            and qkv_i8.data_ptr() % 4 == 0,
            f"qkv_i8 strides {st}: the innermost must be 1 and the others "
            "multiples of 4 (4-byte loads)")
    out = torch.empty((b, h, npad, d), dtype=torch.int8, device=qkv_i8.device)
    so = out.stride()
    err = load_library().dvt_int_attention(
        qkv_i8.data_ptr(), scalars.data_ptr(), out.data_ptr(), b, h, npad, d,
        n_real, int(lis), *st[:4], *so[:3],
        torch.cuda.current_stream(qkv_i8.device).cuda_stream)
    check(err, "fused_int_attention")
    fused_int_attention.launches += 1
    return out


fused_int_attention.launches = 0
