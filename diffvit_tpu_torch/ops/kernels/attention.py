"""Fused int8 qkv projection + Log-Int-Softmax attention (counterparts of
``diffvit_tpu/ops/pallas/attention.py``): ``fused_qkv_attention_v2`` (K1);
``fused_qkv_attention`` (v1) and ``_v3``/``_v4``/``_v5`` (K8); the
attention core alone on projected qkv, ``fused_int_attention`` (K5); and
the whole attention half-block, ``fused_attention_block`` (K7a).

    qkv    = clip(rint(x_i8 @ w * mult/s1 + bias/s1))          (qact1 codes)
    a_int  = clip(rint(q_h @ k_h^T * c1))                      (qact_attn1)
    w      = LogIntSoftmax(a_int)                               (2^-code)
    out    = clip(rint((w @ v_h) * s1/s2))                      (qact2 codes)

K8 computes K1's function with the requant order of the Pallas v1,
``clip(rint((x_i8 @ w * mult + bias) * (1/s1)))``, and the slow LIS; K7a
is K8 v1 followed by the proj and the qact3 / residual / qact2 fences.
K5 runs the last three lines, with the slow LIS.  For ``lis=False`` all
run a float softmax rounded to bfloat16 instead of the LIS, taken in
float64 with attn@v, each rounded once (:func:`attention_core_plain`, the
core that the resident encoder K6 runs too).  All kernels are
``csrc/qkv_attention.cu``: the qkv GEMM and K7a's proj on the wgmma
mainloop (``wgmma_gemm.cuh``, the weights' cached K-major copies from
``gemm``), the attention core on the tensor cores (``attention_mma.cuh``,
its blocks from ``attn_plan.attention_plan``).  The plain versions below
are their specification, exact for the LIS, and they differ from the JAX
reference only where the reference's own arithmetic is order- or
approximation-dependent:

* the row sum of the integer exponentials is exact, rounded once to
  float32, where the reference sums float32 terms of up to 2^68 in its own
  order: an int64 sum, or where ``lis_sum_fits(s_a, n_keys)`` fails
  (``lis_wide``), the 128-bit :func:`~..lis.wide_row_sum`;
* ``2^(32-q)`` and ``floor(log2 y)`` are exact (exponent bits), where XLA's
  ``exp2``/``log2`` on the CPU are off by an ulp for some integers;
* the LIS weights are carried as the integers ``2^(15-code)`` and attn@v is
  an exact integer sum, equal to the reference's float attn@v times 2^15.

``models/convert.py`` sets ``lis_wide`` for every block whose softmax
scale fails ``lis_sum_fits`` (for ViT's 197 keys, ``s_a < 2^-10``), and
refuses a scale below ``LIS_MIN_SCALE`` = 2^-17, the reference's own bound.
The kernels take the flag in their ``lis`` argument (:func:`lis_code`).
"""
from __future__ import annotations

import torch

# the LIS arithmetic every LIS of the port shares (re-exported here)
from ..lis import (_B, _C, _X0, LIS_MIN_SCALE, int_exp,  # noqa: F401
                   lis_sum_fits, lis_tail_plain, wide_row_sum)
from ..quant import int_matmul
from . import check_for_kernel, require, route
from .attn_plan import attention_plan
from .build import check, load_library
from .gemm import (TMA_ALIGN, device_plan, gemm_footprint, kmajor, pad_k,
                   per_weight, require_tma_operand, round_up, sm_count)

MAX_KEYS = 256  # keys per head the kernel keeps in shared memory


def lis_fast_ok(scale_value: float) -> bool:
    """Validity window of the fast LIS form (no floor/max on the integer
    exponential) — ``diffvit_tpu/ops/pallas/attention.py:43``."""
    return 2.0**-10 <= scale_value <= 0.6931


def lis_code(lis: bool, lis_wide: bool = False) -> int:
    """The ``lis`` argument of the C entries: 0 the float softmax, 1 the
    LIS, 2 the LIS with the 128-bit row sum (``csrc/lis.cuh``'s
    ``kLisWide``)."""
    return 0 if not lis else 2 if lis_wide else 1


def lis_body_plain(a_int: torch.Tensor, scale: torch.Tensor, bits: int,
                   col_ok: torch.Tensor, fast: bool = False,
                   wide: bool = False) -> torch.Tensor:
    """Log-Int-Softmax on integer scores (float32 carrier) over the columns
    ``col_ok`` (``_lis_body``, ``attention.py:51-137``).  Returns int32
    weights scaled by 2^15: ``2^(15 - code)``, 0 where saturated or masked.
    ``wide``: the row sum is :func:`wide_row_sum` (the slow form only),
    else an int64 sum."""
    if bits > 4:
        raise NotImplementedError(
            "LIS tail supports bits <= 4 only (the reference's uint4)")
    if fast and wide:
        raise ValueError("the 128-bit LIS row sum takes the slow form only")
    row_max = torch.where(col_ok, a_int, -torch.inf).amax(-1, keepdim=True)
    exp_int = int_exp(a_int - row_max, scale, fast)
    exp_int = torch.where(col_ok, exp_int, 0.0)
    if wide:
        exp_sum = wide_row_sum(exp_int)
    else:
        exp_sum = exp_int.to(torch.int64).sum(-1, keepdim=True).to(
            torch.float32)
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
                      bits=4, lis_fast=False, lis_wide=False):
    """Second stage up to the softmax: (B, Npad, 3C) int8 qkv codes ->
    (B, H, Npad, Npad) int32 LIS weights (x 2^15, pad keys 0)."""
    b, npad, _ = qkv.shape
    t = qkv.reshape(b, npad, 3, num_heads, head_dim).permute(2, 0, 3, 1, 4)
    scores = int_matmul(t[0], t[1].transpose(-1, -2))
    a_int = torch.clamp(torch.round(scores.to(torch.float32) * scalars[1]),
                        -128, 127)
    col_ok = torch.arange(npad, device=qkv.device) < n_real
    return lis_body_plain(a_int, scalars[0], bits, col_ok, fast=lis_fast,
                          wide=lis_wide)


def weighted_values(weights, v):
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
                         lis=True, lis_fast=False, lis_wide=False):
    """The attention core that K1, K5, K6, K7a and K8 run, on int8 codes
    q, k, v (..., Npad, D) of the qact1 grid: scores -> qact_attn1 codes -> the
    LIS (weights x 2^15, attn@v exact) or the bfloat16 float softmax
    (attn@v in float64, rounded once: products of bfloat16 weights and int8
    values are exact, and so is their float64 sum at these exponent
    spreads) -> x s1/s2 -> int8 on the qact2 grid.  Keys at or past
    ``n_real`` are masked; ``lis_wide``: the LIS row sum is 128-bit."""
    scores = int_matmul(q, k.transpose(-1, -2))
    a_int = torch.clamp(torch.round(scores.to(torch.float32) * c1), -128, 127)
    col_ok = torch.arange(k.shape[-2], device=k.device) < n_real
    if lis:
        weights = lis_body_plain(a_int, s_a, bits, col_ok, fast=lis_fast,
                                 wide=lis_wide)
        acc = weighted_values(weights, v).to(torch.float32) * 2.0**-15
    else:
        weights = _softmax_weights_plain(a_int, s_a, col_ok)
        acc = torch.matmul(weights, v.to(torch.float64)).to(torch.float32)
    o = torch.round(acc * s1_over_s2)
    return torch.clamp(o, -128, 127).to(torch.int8)


def _check_contract(bits, lis, what="fused_qkv_attention_v2"):
    if lis and bits > 4:
        raise NotImplementedError(f"{what}: LIS supports bits <= 4 only")


def _attention_of_qkv(qkv, scalars, *, num_heads, head_dim, n_real, bits,
                      lis, lis_fast=False, lis_wide=False):
    """The attention core on (B, Npad, 3C) qkv codes with columns ordered
    [slot, head, d]; scalars [s_a, c1, 1/s1, s1/s2]."""
    b, npad, _ = qkv.shape
    t = qkv.reshape(b, npad, 3, num_heads, head_dim).permute(2, 0, 3, 1, 4)
    return attention_core_plain(t[0], t[1], t[2], scalars[1], scalars[0],
                                scalars[3], n_real=n_real, bits=bits,
                                lis=lis, lis_fast=lis_fast, lis_wide=lis_wide)


def fused_qkv_attention_v2_plain(x_i8, w_all, mult, bias, scalars, *,
                                 num_heads, head_dim, n_real, bits=4,
                                 lis=True, lis_fast=False, lis_wide=False):
    """Plain PyTorch version of :func:`fused_qkv_attention_v2`."""
    _check_contract(bits, lis)
    mb = fold_requant(mult, bias, scalars[2], w_all.shape[1])
    qkv = qkv_projection_plain(x_i8, w_all, mb)
    return _attention_of_qkv(qkv, scalars, num_heads=num_heads,
                             head_dim=head_dim, n_real=n_real, bits=bits,
                             lis=lis, lis_fast=lis_fast, lis_wide=lis_wide)


def _attention_plan(batch, heads, npad, d, n_real, lis, device):
    """:func:`attn_plan.attention_plan` for the SM count of ``device``."""
    return attention_plan(batch, heads, npad, d, n_real, bool(lis),
                          sm_count(device))


def _launch_qkv(x_i8, wk, mb, scalars, *, num_heads, head_dim, n_real, lis,
                lis_fast, lis_wide, requant_v1, what):
    """One launch pair of ``csrc/qkv_attention.cu`` (the qkv GEMM, then the
    attention core) after the checks every entry shares; ``wk`` is the
    (3C, Kp) K-major weight."""
    b, npad, cin = x_i8.shape
    check_for_kernel(x_i8, "x_i8", torch.int8, 3)
    check_for_kernel(scalars, "scalars", torch.float32, 1)
    require(b * npad > 0, f"{what}: empty input {tuple(x_i8.shape)}")
    require(scalars.numel() == 4, "scalars must hold [s_a, c1, 1/s1, s1/s2]")
    require(0 < n_real <= min(npad, MAX_KEYS),
            f"n_real={n_real}: the kernel takes 1..min(Npad, {MAX_KEYS}) keys")
    require(head_dim <= 64 and head_dim % 4 == 0,
            f"head_dim={head_dim}: the kernel takes multiples of 4 up to 64")
    c3 = 3 * num_heads * head_dim
    kp = wk.shape[1]
    x2 = pad_k(x_i8.view(b * npad, cin), kp)
    require_tma_operand(x2, "x_i8")
    gp = device_plan(b * npad, c3, kp, x_i8.device)
    ap = _attention_plan(b, num_heads, npad, head_dim, n_real, lis,
                         x_i8.device)
    qkv = torch.empty((b, npad, c3), dtype=torch.int8, device=x_i8.device)
    out = torch.empty((b, num_heads, npad, head_dim), dtype=torch.int8,
                      device=x_i8.device)
    err = load_library().dvt_qkv_attention(
        x2.data_ptr(), wk.data_ptr(), mb.data_ptr(), scalars.data_ptr(),
        qkv.data_ptr(), out.data_ptr(), b, npad, kp, num_heads, head_dim,
        n_real, lis_code(lis, lis_wide), int(lis_fast), int(requant_v1),
        *gp.launch_args(),
        *ap.launch_args(),
        torch.cuda.current_stream(x_i8.device).cuda_stream)
    check(err, what)
    return out


def _check_w_all(x_i8, w_all, num_heads, head_dim):
    require(w_all.dtype == torch.int8 and w_all.dim() == 2,
            f"w_all: expected a 2-dim int8 tensor, got {w_all.dtype} "
            f"{tuple(w_all.shape)}")
    require(w_all.shape == (x_i8.shape[-1], 3 * num_heads * head_dim),
            f"w_all {tuple(w_all.shape)} does not match x "
            f"{tuple(x_i8.shape)} and {num_heads} heads of {head_dim}")


def fused_qkv_attention_v2(x_i8, w_all, mult, bias, scalars, *, num_heads,
                           head_dim, n_real, bits=4, lis=True,
                           lis_fast=False, lis_wide=False):
    """Fused qkv projection + attention (the LIS, or for ``lis=False`` the
    float softmax rounded to bfloat16).

    x_i8: (B, Npad, Cin) int8 LN codes (rows at or past ``n_real`` are
    padding: they are computed, and never used as keys); w_all: (Cin, 3C)
    int8 with columns ordered [slot, head, d]; mult/bias: (3C,) float32 (or
    broadcastable); scalars: (4,) float32 [s_a, c1, 1/s1, s1/s2].
    lis_fast: caller guarantees s_a in [2^-10, ln2]; lis_wide: the LIS row
    sum is 128-bit (for a scale that fails ``lis_sum_fits``; slow form).
    Returns (B, H, Npad, D) int8 on the qact2 grid.

    A CUDA tensor runs ``csrc/qkv_attention.cu``; a CPU tensor runs
    :func:`fused_qkv_attention_v2_plain`."""
    _check_contract(bits, lis)
    if route(x_i8, w_all, mult, bias, scalars) == "cpu":
        return fused_qkv_attention_v2_plain(
            x_i8, w_all, mult, bias, scalars, num_heads=num_heads,
            head_dim=head_dim, n_real=n_real, bits=bits, lis=lis,
            lis_fast=lis_fast, lis_wide=lis_wide)
    _check_w_all(x_i8, w_all, num_heads, head_dim)
    c3 = w_all.shape[1]
    mb = per_weight(
        lambda: fold_requant(mult, bias, scalars[2], c3).contiguous(),
        mult, bias, scalars, c3, "k1_mb")
    out = _launch_qkv(x_i8, kmajor(w_all), mb, scalars, num_heads=num_heads,
                      head_dim=head_dim, n_real=n_real, lis=lis,
                      lis_fast=lis_fast, lis_wide=lis_wide, requant_v1=False,
                      what="fused_qkv_attention_v2")
    fused_qkv_attention_v2.launches += 1
    return out


fused_qkv_attention_v2.launches = 0


# ---- K8: fused_qkv_attention (v1) and its scheduling variants v3-v5 ----

def qkv_projection_v1_plain(x_i8, w_all, mult, bias, s1_inv):
    """The qkv projection in the requant order of the Pallas v1 and v3-v5:
    ``rint((acc * mult + bias) * (1/s1))`` clipped to int8, where K1 folds
    1/s1 into mult and bias first."""
    y = int_matmul(x_i8, w_all).to(torch.float32) * mult + bias
    return torch.clamp(torch.round(y * s1_inv), -128, 127).to(torch.int8)


def heads_to_all(wq, wk, wv):
    """v1's per-head (H, Cin, D) weights as K1's (Cin, 3C) weight with
    columns [slot, head, d] (the inverse of ``qkv_head_blocks``)."""
    h, cin, d = wq.shape
    return torch.stack([wq, wk, wv]).permute(2, 0, 1, 3).reshape(cin,
                                                                 3 * h * d)


def _v1_order_plain(x_i8, w_all, mult, bias, scalars, *, num_heads,
                    head_dim, n_real, bits, lis, lis_wide=False):
    c3 = 3 * num_heads * head_dim
    qkv = qkv_projection_v1_plain(x_i8, w_all, mult.reshape(-1).expand(c3),
                                  bias.reshape(-1).expand(c3), scalars[2])
    return _attention_of_qkv(qkv, scalars, num_heads=num_heads,
                             head_dim=head_dim, n_real=n_real, bits=bits,
                             lis=lis, lis_wide=lis_wide)


def fused_qkv_attention_plain(x_i8, wq, wk, wv, mult, bias, scalars, *,
                              n_real, bits=4, lis=True, lis_wide=False):
    """Plain PyTorch version of :func:`fused_qkv_attention`."""
    _check_contract(bits, lis, "fused_qkv_attention")
    h, _, d = wq.shape
    return _v1_order_plain(x_i8, heads_to_all(wq, wk, wv), mult, bias,
                           scalars, num_heads=h, head_dim=d, n_real=n_real,
                           bits=bits, lis=lis, lis_wide=lis_wide)


def fused_qkv_attention(x_i8, wq, wk, wv, mult, bias, scalars, *, n_real,
                        bits=4, lis=True, lis_wide=False):
    """Fused attention with per-head weights (the Pallas v1, K8): the qkv
    projection ``rint((acc * mult + bias) * (1/s1))`` per head, then K1's
    attention core with the slow LIS (or the float softmax).

    x_i8: (B, Npad, Cin) int8 LN codes; wq/wk/wv: (H, Cin, D) int8, any
    strides as long as the three share them (e.g. the per-head views of
    K1's (Cin, 3C) weight; the kernel reads one K-major copy of the three,
    made once per weight triple and kept); mult/bias: (3, H, D) float32;
    scalars: (4,) float32 [s_a, c1, 1/s1, s1/s2]; lis_wide as K1's.
    Returns (B, H, Npad, D) int8 on the qact2 grid.

    A CUDA tensor runs ``csrc/qkv_attention.cu`` (K1's launches, with the
    v1 requant order); a CPU tensor runs :func:`fused_qkv_attention_plain`."""
    _check_contract(bits, lis, "fused_qkv_attention")
    if route(x_i8, wq, wk, wv, mult, bias, scalars) == "cpu":
        return fused_qkv_attention_plain(x_i8, wq, wk, wv, mult, bias,
                                         scalars, n_real=n_real, bits=bits,
                                         lis=lis, lis_wide=lis_wide)
    out = _launch_qkv(x_i8, _heads_kmajor(x_i8, wq, wk, wv),
                      _v1_mb(mult, bias, wq), scalars,
                      num_heads=wq.shape[0], head_dim=wq.shape[2],
                      n_real=n_real, lis=lis, lis_fast=False,
                      lis_wide=lis_wide, requant_v1=True,
                      what="fused_qkv_attention")
    fused_qkv_attention.launches += 1
    return out


fused_qkv_attention.launches = 0


def _heads_kmajor(x_i8, wq, wk, wv):
    """The (3C, Kp) K-major copy of v1's three (H, Cin, D) weights laid out
    as K1's (Cin, 3C) (:func:`heads_to_all`), made once per weight triple
    and kept (``gemm.per_weight``)."""
    for name, w in (("wq", wq), ("wk", wk), ("wv", wv)):
        require(w.dtype == torch.int8 and w.dim() == 3,
                f"{name}: expected a 3-dim int8 tensor, got {w.dtype} "
                f"{tuple(w.shape)}")
    require(wq.shape == wk.shape == wv.shape
            and wq.stride() == wk.stride() == wv.stride(),
            "wq, wk and wv must share their shape and strides")
    require(wq.shape[1] == x_i8.shape[-1],
            f"weights {tuple(wq.shape)} do not match x {tuple(x_i8.shape)}")
    return per_weight(lambda: kmajor(heads_to_all(wq, wk, wv)), wq, wk, wv,
                      "heads_kmajor")


def _v1_mb(mult, bias, wq):
    """[mult, bias] as the (2, 3C) float32 rows the kernel reads, kept per
    (mult, bias)."""
    h, _, d = wq.shape
    return per_weight(
        lambda: torch.stack([mult.expand(3, h, d).reshape(-1),
                             bias.expand(3, h, d).reshape(-1)])
        .to(torch.float32).contiguous(), mult, bias, h, d, "v1_mb")


def fused_qkv_attention_v3_plain(x_i8, w_all, mult, bias, scalars, *,
                                 num_heads, head_dim, n_real, bits=4,
                                 lis=True, lis_wide=False):
    """Plain PyTorch version of :func:`fused_qkv_attention_v3` (and of v4
    and v5, which compute the same function)."""
    _check_contract(bits, lis, "fused_qkv_attention_v3")
    return _v1_order_plain(x_i8, w_all, mult, bias, scalars,
                           num_heads=num_heads, head_dim=head_dim,
                           n_real=n_real, bits=bits, lis=lis,
                           lis_wide=lis_wide)


def _fused_v345(fn, x_i8, w_all, mult, bias, scalars, *, num_heads,
                head_dim, n_real, bits, lis, lis_wide):
    _check_contract(bits, lis, fn.__name__)
    if route(x_i8, w_all, mult, bias, scalars) == "cpu":
        return fused_qkv_attention_v3_plain(
            x_i8, w_all, mult, bias, scalars, num_heads=num_heads,
            head_dim=head_dim, n_real=n_real, bits=bits, lis=lis,
            lis_wide=lis_wide)
    _check_w_all(x_i8, w_all, num_heads, head_dim)
    c3 = w_all.shape[1]
    mb = per_weight(
        lambda: torch.stack([mult.expand(c3), bias.expand(c3)])
        .to(torch.float32).contiguous(), mult, bias, c3, "v3_mb")
    out = _launch_qkv(x_i8, kmajor(w_all), mb, scalars, num_heads=num_heads,
                      head_dim=head_dim, n_real=n_real, lis=lis,
                      lis_fast=False, lis_wide=lis_wide, requant_v1=True,
                      what=fn.__name__)
    fn.launches += 1
    return out


def fused_qkv_attention_v3(x_i8, w_all, mult, bias, scalars, *, num_heads,
                           head_dim, n_real, bits=4, lis=True, lis_wide=False):
    """The Pallas ``fused_qkv_attention_v3``: K1's contract (x_i8, w_all,
    mult/bias (3C,), scalars) with v1's requant order and the slow LIS.  On
    the TPU it pipelined one image's qkv matmul under the previous image's
    LIS across grid steps; the function is v1's, and here it is one launch
    of K8's kernel (``csrc/qkv_attention.cu``).  A CPU tensor runs
    :func:`fused_qkv_attention_v3_plain`."""
    return _fused_v345(fused_qkv_attention_v3, x_i8, w_all, mult, bias,
                       scalars, num_heads=num_heads, head_dim=head_dim,
                       n_real=n_real, bits=bits, lis=lis, lis_wide=lis_wide)


def fused_qkv_attention_v4(x_i8, w_all, mult, bias, scalars, *, num_heads,
                           head_dim, n_real, bits=4, lis=True, group=2,
                           lis_wide=False):
    """The Pallas ``fused_qkv_attention_v4`` (``group`` images a program on
    the TPU, halved until it divides B): v3's function and kernel.
    ``group`` is accepted and changes nothing here."""
    del group  # a TPU scheduling knob: the function does not depend on it
    return _fused_v345(fused_qkv_attention_v4, x_i8, w_all, mult, bias,
                       scalars, num_heads=num_heads, head_dim=head_dim,
                       n_real=n_real, bits=bits, lis=lis, lis_wide=lis_wide)


def fused_qkv_attention_v5(x_i8, w_all, mult, bias, scalars, *, num_heads,
                           head_dim, n_real, bits=4, lis=True, lis_wide=False):
    """The Pallas ``fused_qkv_attention_v5`` (two images a program on the
    TPU): v3's function and kernel, for an even B only.  The Pallas kernel's
    grid is ``B // 2``, so for an odd B it leaves the last image unwritten;
    this raises ``ValueError`` instead."""
    require(x_i8.shape[0] % 2 == 0,
            f"fused_qkv_attention_v5 takes an even batch (two images a "
            f"program), got B={x_i8.shape[0]}")
    return _fused_v345(fused_qkv_attention_v5, x_i8, w_all, mult, bias,
                       scalars, num_heads=num_heads, head_dim=head_dim,
                       n_real=n_real, bits=bits, lis=lis, lis_wide=lis_wide)


for _fn in (fused_qkv_attention_v3, fused_qkv_attention_v4,
            fused_qkv_attention_v5):
    _fn.launches = 0
del _fn


def fused_int_attention_plain(qkv_i8, scalars, *, num_heads, n_real, bits=4,
                              lis=True, lis_wide=False):
    """Plain PyTorch version of :func:`fused_int_attention` (the slow LIS)."""
    return attention_core_plain(qkv_i8[:, 0], qkv_i8[:, 1], qkv_i8[:, 2],
                                scalars[0], scalars[2], scalars[1],
                                n_real=n_real, bits=bits, lis=lis,
                                lis_wide=lis_wide)


def fused_int_attention(qkv_i8, scalars, *, num_heads, n_real, bits=4,
                        lis=True, lis_wide=False):
    """Attention core on projected qkv codes (SmoothQuant off).

    qkv_i8: (B, 3, H, N, D) int8 on the qact1 grid — any strides whose
    innermost is 1, e.g. the view ``qkv.view(B, N, 3, H, D).permute(0, 2,
    3, 1, 4)`` of the qkv GEMM's (B, N, 3C) output, read without a copy.
    Rows at or past ``n_real`` are never used as keys.  scalars: (3,)
    float32 [c1, s1/s2, s_a] (c1 = s1^2 * attn_scale / s_a).  ``lis``: the
    Log-Int-Softmax (slow form, as the Pallas kernel runs it), else the
    float softmax rounded to bfloat16; ``lis_wide``: the LIS row sum is
    128-bit.  Returns (B, H, N, D) int8 on the qact2 grid.

    A CUDA tensor runs ``csrc/qkv_attention.cu``'s attention core (the one
    K1 runs after its qkv GEMM, ``attention_mma.cuh``); a CPU tensor runs
    :func:`fused_int_attention_plain`."""
    if lis and bits > 4:
        raise NotImplementedError(
            "fused_int_attention: LIS supports bits <= 4 only")
    if route(qkv_i8, scalars) == "cpu":
        return fused_int_attention_plain(qkv_i8, scalars,
                                         num_heads=num_heads, n_real=n_real,
                                         bits=bits, lis=lis, lis_wide=lis_wide)
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
    ap = _attention_plan(b, h, npad, d, n_real, lis, qkv_i8.device)
    err = load_library().dvt_int_attention(
        qkv_i8.data_ptr(), scalars.data_ptr(), out.data_ptr(), b, h, npad, d,
        n_real, lis_code(lis, lis_wide), *st[:4], *so[:3], *ap.launch_args(),
        torch.cuda.current_stream(qkv_i8.device).cuda_stream)
    check(err, "fused_int_attention")
    fused_int_attention.launches += 1
    return out


fused_int_attention.launches = 0


# ---- K7a: the whole attention half-block ----

def fused_attention_block_plain(x_i8, h, wq, wk, wv, wp, mult, bias, pvec,
                                scalars, *, n_real, bits=4, lis=True,
                                lis_wide=False):
    """Plain PyTorch version of :func:`fused_attention_block`: K8 v1, the
    proj as one exact int32 (H, D) contraction (the per-head int32 sums of
    the Pallas kernel add up to it exactly), then the fences, dividing by
    the device tensors s_qact3 and s_qact2 as the Pallas kernel divides."""
    _check_contract(bits, lis, "fused_attention_block")
    o = fused_qkv_attention_plain(x_i8, wq, wk, wv, mult, bias, scalars,
                                  n_real=n_real, bits=bits, lis=lis,
                                  lis_wide=lis_wide)
    b, heads, npad, d = o.shape
    o = o.permute(0, 2, 1, 3).reshape(b, npad, heads * d)
    y = int_matmul(o, wp.reshape(heads * d, -1)).to(torch.float32) \
        * pvec[0] + pvec[1]
    y3 = torch.clamp(torch.round(y / pvec[2]), -128, 127) * pvec[2]  # qact3
    hn = h + y3  # residual
    return torch.clamp(torch.round(hn / pvec[3]), -128, 127) * pvec[3]  # qact2


def fused_attention_block(x_i8, h, wq, wk, wv, wp, mult, bias, pvec, scalars,
                          *, n_real, bits=4, lis=True, lis_wide=False):
    """The attention half of a block (the Pallas ``fused_attention_block``,
    K7a): per-head qkv projection in v1's requant order, the LIS (slow) or
    float-softmax attention, the proj accumulated over the heads in int32,
    ``acc * mult_p + bias_p``, the qact3 fence, the residual add and the
    block's qact2 fence.

    x_i8: (B, Npad, Cin) int8 LN codes; h: (B, Npad, C) float32 residual
    stream; wq/wk/wv: (H, Cin, D) int8 (as :func:`fused_qkv_attention`);
    wp: (H, D, C) int8; mult/bias: (3, H, D) float32; pvec: (4, C) float32
    [mult_p, bias_p, s_qact3, s_qact2]; scalars: (4,) float32 [s_a, c1,
    1/s1, s1/s2]; lis_wide as K1's.  Returns the updated residual stream
    (B, Npad, C) float32 (rows at or past ``n_real`` are computed from the
    padding).

    A CUDA tensor runs ``csrc/qkv_attention.cu`` (K8's launches, then the
    proj GEMM on the wgmma mainloop, ``wgmma_gemm.cuh``, with the fences in
    its epilogue, over :func:`proj_scratch` and :func:`proj_kmajor`); a CPU
    tensor runs :func:`fused_attention_block_plain`."""
    _check_contract(bits, lis, "fused_attention_block")
    args = (x_i8, h, wq, wk, wv, wp, mult, bias, pvec, scalars)
    if route(*args) == "cpu":
        return fused_attention_block_plain(*args, n_real=n_real, bits=bits,
                                           lis=lis, lis_wide=lis_wide)
    b, npad, cin = x_i8.shape
    heads, _, d = wq.shape
    c = wp.shape[-1]
    wkm = _heads_kmajor(x_i8, wq, wk, wv)
    check_for_kernel(x_i8, "x_i8", torch.int8, 3)
    check_for_kernel(h, "h", torch.float32, 3)
    check_for_kernel(wp, "wp", torch.int8, 3)
    check_for_kernel(pvec, "pvec", torch.float32, 2)
    check_for_kernel(scalars, "scalars", torch.float32, 1)
    require(wp.shape[:2] == (heads, d) and h.shape == (b, npad, c)
            and pvec.shape == (4, c),
            f"wp {tuple(wp.shape)}, h {tuple(h.shape)} and pvec "
            f"{tuple(pvec.shape)} do not match {heads} heads of {d} and x "
            f"{tuple(x_i8.shape)}")
    require(b * npad > 0, f"fused_attention_block: empty input "
            f"{tuple(x_i8.shape)}")
    require(scalars.numel() == 4, "scalars must hold [s_a, c1, 1/s1, s1/s2]")
    require(0 < n_real <= min(npad, MAX_KEYS),
            f"n_real={n_real}: the kernel takes 1..min(Npad, {MAX_KEYS}) keys")
    require(d <= 64 and d % 4 == 0,
            f"head_dim={d}: the kernel takes multiples of 4 up to 64")
    kp = wkm.shape[1]
    x2 = pad_k(x_i8.view(b * npad, cin), kp)
    require_tma_operand(x2, "x_i8")
    wpk = proj_kmajor(wp)
    attn = proj_scratch(b * npad, heads, d, x_i8.device)
    require_tma_operand(attn, "attn")
    ka = attn.shape[1]
    gp = device_plan(b * npad, 3 * heads * d, kp, x_i8.device)
    pp = device_plan(b * npad, c, ka, x_i8.device)
    ap = _attention_plan(b, heads, npad, d, n_real, lis, x_i8.device)
    qkv = torch.empty((b, npad, 3 * heads * d), dtype=torch.int8,
                      device=x_i8.device)
    out = torch.empty((b, npad, c), dtype=torch.float32, device=x_i8.device)
    err = load_library().dvt_attention_block(
        x2.data_ptr(), h.data_ptr(), wkm.data_ptr(), wpk.data_ptr(),
        _v1_mb(mult, bias, wq).data_ptr(), pvec.data_ptr(),
        scalars.data_ptr(), qkv.data_ptr(), attn.data_ptr(), out.data_ptr(),
        b, npad, kp, heads, d, c, n_real, lis_code(lis, lis_wide), ka,
        *gp.launch_args(), *pp.launch_args(), *ap.launch_args(),
        torch.cuda.current_stream(x_i8.device).cuda_stream)
    check(err, "fused_attention_block")
    fused_attention_block.launches += 1
    return out


fused_attention_block.launches = 0


def proj_kmajor(wp: torch.Tensor) -> torch.Tensor:
    """K7a's proj weight (H, D, C) as the (C, Ka) K-major copy its GEMM
    reads: ``wp.reshape(H * D, C).T``, H * D zero-padded to Ka, a multiple
    of 16 (``gemm.kmajor``), made once per weight tensor and kept
    (``gemm.per_weight``: the reshaped view is a new tensor each call)."""
    heads, d, c = wp.shape
    return per_weight(lambda: kmajor(wp.reshape(heads * d, c)), wp,
                      "proj_kmajor")


def proj_scratch(rows: int, heads: int, d: int, device) -> torch.Tensor:
    """The (rows, Ka) int8 attention codes between K7a's core and its proj
    GEMM: the core writes head h's D columns of a row at h * D, and the
    GEMM reads rows of Ka = H * D rounded up to 16 bytes (TMA's row
    stride).  The pad columns stay unwritten: they meet the zero rows of
    :func:`proj_kmajor`'s copy, whose integer products are 0 whatever they
    hold."""
    return torch.empty((rows, round_up(heads * d, TMA_ALIGN)),
                       dtype=torch.int8, device=device)


def proj_gemm_footprint(rows, cout, k, device) -> dict:
    """{"registers", "local_bytes", "smem_bytes", "blocks_per_sm"} of K7a's
    proj GEMM (the wgmma mainloop with the fences' epilogue) for a (rows,
    k) @ (k, cout) product on ``device``, at its plan's tile
    (``local_bytes`` > 0 means spills).  Needs a card."""
    import ctypes
    plan = device_plan(rows, cout, round_up(k, TMA_ALIGN), device)
    out = [ctypes.c_int() for _ in range(4)]
    check(load_library().dvt_block_proj_footprint(
        plan.bm, plan.bn, plan.blocks, plan.smem, *map(ctypes.byref, out)),
        "dvt_block_proj_footprint")
    return dict(zip(("registers", "local_bytes", "smem_bytes",
                     "blocks_per_sm"), (o.value for o in out)))


def core_footprint(batch, heads, npad, d, n_real, device, lis=True) -> dict:
    """{"registers", "local_bytes", "smem_bytes", "blocks_per_sm"} of the
    attention core that the wrappers launch for these shapes on
    ``device``, at its plan's warps and shared memory
    (``cudaFuncGetAttributes`` and the occupancy API; ``local_bytes`` > 0
    means spills).  Needs a card."""
    import ctypes
    plan = _attention_plan(batch, heads, npad, d, n_real, lis, device)
    out = [ctypes.c_int() for _ in range(4)]
    check(load_library().dvt_attention_core_footprint(
        n_real, d, int(lis), plan.warps, plan.smem,
        *map(ctypes.byref, out)),
        "dvt_attention_core_footprint")
    return dict(zip(("registers", "local_bytes", "smem_bytes",
                     "blocks_per_sm"), (o.value for o in out)),
                warps=plan.warps, grid=plan.grid)


def qkv_gemm_footprint(rows, c3, k, device) -> dict:
    """{"registers", "smem_bytes", "blocks_per_sm"} of the qkv GEMM (the
    wgmma mainloop with the requant epilogue) for a (rows, k) @ (k, c3)
    product on ``device``, at its plan's tile.  Needs a card."""
    plan = device_plan(rows, c3, -(-k // 16) * 16, device)
    return gemm_footprint(load_library().dvt_qkv_gemm_footprint, plan)
