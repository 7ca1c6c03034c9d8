"""Fused Swin window attention: scores, relative-position bias, shift mask,
Log-Int-Softmax (or the float softmax) and attn@v in one kernel
(counterpart of ``diffvit_tpu/ops/pallas/attention.py::
fused_swin_attention`` and ``::fused_swin_attention_v2``).

Per window w and head h, with scalars = [c1, s_a1, 1/s_a2, s_a2, c2]:

    a1c = clip(rint(q_h @ k_h^T * c1))                 (qact_attn1 codes)
    af  = a1c * s_a1 + bias[h]                         (fake-quant bias)
    a2c = clip(rint(af * (1/s_a2)))                    (qact2 codes)
    am  = a2c + mask_div[w mod nW]                     (shift mask / s_a2)
    w   = LogIntSoftmax(am) on the s_a2 grid           (2^-code)
    o   = clip(rint((w @ v_h) * c2))                   (qact3 codes)

``1/s_a2`` is a multiply, as in the Pallas kernel (the reference's
non-kernel path divides; the two agree for power-of-two scales).  The LIS
is ``attention.lis_body_plain`` (exact int64 row sum, ``fast=False``) and
attn@v the exact integer sum of K1's plain version.

With ``lis=False`` the weights are the float softmax of ``am * s_a2`` over
the real keys, rounded to bfloat16 (``attention._softmax_weights_plain``,
taken in float64 as K1's), and attn@v is summed in float64 and rounded
once.  The shift mask puts weights near e^-100 (bfloat16 subnormals)
beside weights near 1, too wide a spread for an exact float64 sum, so a
weight below ``WEIGHT_FLOOR`` = 2^-32 counts as 0, in the kernel and here
alike: the weights left are multiples of 2^-39, their products with int8
values sum to at most 2^13, and every partial sum fits 53 bits, so the
sum is exact in any order and no device's handling of subnormals matters.
A dropped weight moves ``o`` by less than 2^-19, far below the float32
rounding of the reference's own sum.

One CUDA kernel (``csrc/swin_attention.cu``, on the tensor-core core of
``attention_mma.cuh``; its blocks from ``attn_plan.swin_attention_plan``)
serves both contracts: the wrapper passes the element strides of qkv's
(window, slot, head, row) axes and of the output's (window, head, row)
axes, so v1 may be a strided view of the natural qkv layout, taken
without a copy.
"""
from __future__ import annotations

import torch

from ..quant import int_matmul
from . import check_for_kernel, require, route
from .attention import (_softmax_weights_plain, weighted_values,
                        lis_body_plain)
from .attn_plan import swin_attention_plan
from .build import check, load_library
from .gemm import sm_count

MAX_KEYS = 64  # keys per window the kernel holds: two blocks of 32
MAX_HEAD_DIM = 64
WEIGHT_FLOOR = 2.0**-32  # float-softmax weights below it count as 0


def swin_attention_plain(q, k, v, bias_q, mask_div, scalars, *, n_real,
                         n_windows, bits=4, lis=True):
    """The specification.  q, k, v: (Bw, H, npad, D) int8 (views are
    fine); bias_q: (H, npad, npad) float32; mask_div: (nW, npad, npad)
    float32 or None; scalars: (5,) float32.  Returns (Bw, H, npad, D) int8
    on the qact3 grid; keys at or past ``n_real`` are masked out.  ``lis``:
    the Log-Int-Softmax, else the float softmax (``bits`` unused)."""
    bw, heads, npad, _ = q.shape
    scores = int_matmul(q, k.transpose(-1, -2)).to(torch.float32)
    a1c = torch.clamp(torch.round(scores * scalars[0]), -128, 127)
    af = a1c * scalars[1] + bias_q
    am = torch.clamp(torch.round(af * scalars[2]), -128, 127)
    if mask_div is not None:
        am = (am.reshape(bw // n_windows, n_windows, heads, npad, npad)
              + mask_div[None, :, None]).reshape(bw, heads, npad, npad)
    col_ok = torch.arange(npad, device=q.device) < n_real
    if lis:
        weights = lis_body_plain(am, scalars[3], bits, col_ok, fast=False)
        acc = weighted_values(weights, v).to(torch.float32) * 2.0**-15
    else:
        weights = _softmax_weights_plain(am, scalars[3], col_ok)
        weights = torch.where(weights < WEIGHT_FLOOR, 0.0, weights)
        acc = torch.matmul(weights, v.to(torch.float64)).to(torch.float32)
    o = torch.round(acc * scalars[4])
    return torch.clamp(o, -128, 127).to(torch.int8)


def _check_contract(name, bits, lis):
    if lis and bits > 4:
        raise NotImplementedError(f"{name}: LIS supports bits <= 4 only")


def _launch(qkv5, out4, bias_q, mask_div, scalars, n_real, n_windows, lis):
    """Run ``csrc/swin_attention.cu`` on qkv5, a (Bw, 3, H, npad, D) int8
    view, into out4, a (Bw, H, npad, D) int8 view of the output."""
    bw, _, heads, npad, d = qkv5.shape
    require(qkv5.dtype == torch.int8 and out4.dtype == torch.int8,
            "qkv and out must be int8")
    strides = list(qkv5.stride()[:4]) + list(out4.stride()[:3])
    require(qkv5.stride(-1) == 1 and out4.stride(-1) == 1
            and all(s % 4 == 0 for s in strides)
            and qkv5.data_ptr() % 4 == 0 and out4.data_ptr() % 4 == 0,
            "qkv and out need a contiguous last axis and 4-byte aligned rows")
    check_for_kernel(bias_q, "bias_q", torch.float32, 3)
    check_for_kernel(scalars, "scalars", torch.float32, 1)
    require(tuple(bias_q.shape) == (heads, npad, npad),
            f"bias_q {tuple(bias_q.shape)}: expected {(heads, npad, npad)}")
    require(scalars.numel() == 5,
            "scalars must hold [c1, s_a1, 1/s_a2, s_a2, c2]")
    if mask_div is not None:
        check_for_kernel(mask_div, "mask_div", torch.float32, 3)
        require(tuple(mask_div.shape) == (n_windows, npad, npad),
                f"mask_div {tuple(mask_div.shape)}: expected "
                f"{(n_windows, npad, npad)}")
    require(bw % n_windows == 0,
            f"Bw={bw} is not a multiple of n_windows={n_windows}")
    require(0 < n_real <= min(npad, MAX_KEYS),
            f"n_real={n_real}: the kernel takes 1..min(npad, {MAX_KEYS}) keys")
    require(d % 4 == 0 and d <= MAX_HEAD_DIM,
            f"head_dim={d}: the kernel takes multiples of 4 up to "
            f"{MAX_HEAD_DIM}")
    plan = swin_attention_plan(bw, heads, npad, d, n_real, bool(lis),
                               sm_count(qkv5.device))
    err = load_library().dvt_swin_attention(
        qkv5.data_ptr(), bias_q.data_ptr(),
        None if mask_div is None else mask_div.data_ptr(),
        scalars.data_ptr(), out4.data_ptr(), bw, heads, npad, d, n_real,
        n_windows, int(lis), *strides, *plan.launch_args(),
        torch.cuda.current_stream(qkv5.device).cuda_stream)
    check(err, "fused_swin_attention")


def _tensors(*ts):
    return [t for t in ts if t is not None]


def fused_swin_attention(qkv_i8, bias_q, mask_div, scalars, *, num_heads,
                         n_real, n_windows, bits=4, lis=True):
    """K4, the v1 contract.  qkv_i8: (Bw, 3, H, npad, D) int8 on the
    attn.qact1 grid, contiguous or a view with a contiguous last axis;
    bias_q: (H, npad, npad) float32 fake-quantized relative-position bias;
    mask_div: (nW, npad, npad) float32 shift mask over s_a2, or None
    (window w takes mask w mod nW); scalars: (5,) float32
    [c1, s_a1, 1/s_a2, s_a2, c2].  Returns (Bw, H, npad, D) int8 on the
    qact3 grid.  ``lis``: the Log-Int-Softmax (``bits`` <= 4), else the
    float softmax rounded to bfloat16 (any ``bits``).

    A CUDA tensor runs ``csrc/swin_attention.cu``; a CPU tensor runs
    :func:`swin_attention_plain`."""
    _check_contract("fused_swin_attention", bits, lis)
    bw, three, heads, npad, d = qkv_i8.shape
    require(three == 3 and heads == num_heads,
            f"qkv {tuple(qkv_i8.shape)}: expected (Bw, 3, {num_heads}, "
            "npad, D)")
    if route(*_tensors(qkv_i8, bias_q, mask_div, scalars)) == "cpu":
        return swin_attention_plain(
            qkv_i8[:, 0], qkv_i8[:, 1], qkv_i8[:, 2], bias_q, mask_div,
            scalars, n_real=n_real, n_windows=n_windows, bits=bits, lis=lis)
    out = torch.empty((bw, heads, npad, d), dtype=torch.int8,
                      device=qkv_i8.device)
    _launch(qkv_i8, out, bias_q, mask_div, scalars, n_real, n_windows, lis)
    fused_swin_attention.launches += 1
    return out


def fused_swin_attention_v2(qkv_i8, bias_q, mask_div, scalars, *, num_heads,
                            head_dim, n_real, n_windows, bits=4, lis=True):
    """K4b, the natural contract.  qkv_i8: (Bw, npad, 3C) int8 with columns
    [q|k|v] x head x head_dim, as the qkv linear emits it.  Returns
    (Bw, npad, C) int8 on the qact3 grid in the same head-major column
    order.  The other arguments are :func:`fused_swin_attention`'s.

    A CUDA tensor runs ``csrc/swin_attention.cu``; a CPU tensor runs
    :func:`swin_attention_plain`."""
    _check_contract("fused_swin_attention_v2", bits, lis)
    bw, npad, c3 = qkv_i8.shape
    c = num_heads * head_dim
    require(c3 == 3 * c, f"qkv {tuple(qkv_i8.shape)}: expected 3C = {3 * c}")
    view = qkv_i8.view(bw, npad, 3, num_heads, head_dim) \
        .permute(0, 2, 3, 1, 4)
    if route(*_tensors(qkv_i8, bias_q, mask_div, scalars)) == "cpu":
        o = swin_attention_plain(
            view[:, 0], view[:, 1], view[:, 2], bias_q, mask_div, scalars,
            n_real=n_real, n_windows=n_windows, bits=bits, lis=lis)
        return o.permute(0, 2, 1, 3).reshape(bw, npad, c)
    out = torch.empty((bw, npad, c), dtype=torch.int8, device=qkv_i8.device)
    _launch(view, out.view(bw, npad, num_heads, head_dim).permute(0, 2, 1, 3),
            bias_q, mask_div, scalars, n_real, n_windows, lis)
    fused_swin_attention_v2.launches += 1
    return out


fused_swin_attention.launches = 0
fused_swin_attention_v2.launches = 0


def footprint(windows, heads, npad, d, n_real, device, lis=True) -> dict:
    """{"registers", "local_bytes", "smem_bytes", "blocks_per_sm"} of the
    kernel that the wrappers launch for these shapes on ``device``, at its
    plan's warps and shared memory (``local_bytes`` > 0 means spills).
    Needs a card."""
    import ctypes
    plan = swin_attention_plan(windows, heads, npad, d, n_real, bool(lis),
                               sm_count(device))
    out = [ctypes.c_int() for _ in range(4)]
    check(load_library().dvt_swin_attention_footprint(
        d, int(lis), plan.warps, plan.smem, *map(ctypes.byref, out)),
        "dvt_swin_attention_footprint")
    return dict(zip(("registers", "local_bytes", "smem_bytes",
                     "blocks_per_sm"), (o.value for o in out)),
                warps=plan.warps, windows_per_block=plan.windows,
                grid=plan.grid)
