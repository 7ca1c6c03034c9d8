"""Log-Int-Softmax (LIS; counterpart of ``diffvit_tpu/ops/lis.py``): the
i-BERT integer exponential, the integer softmax, and the log2 quantization
of its inverse to ``bit_type`` codes, dequantized to ``2^-code`` with the
saturated codes at 0.

``int_exp`` and ``lis_tail_plain`` are the arithmetic that every LIS of the
port runs: the float LIS of calibration and of the fake-quant forward here,
and the fused kernels' LIS row (``kernels/attention.lis_body_plain``, the
plain version the CUDA kernels are held to).  Where the reference's values
depend on summation order or on an approximate transcendental, these
differ from it on purpose:

* ``2^(32-q)`` and ``floor(log2 y)`` are exact (exponent bits), where
  XLA's ``exp2``/``log2`` on the CPU are off by an ulp for some integers;
* the row sum of the integer exponentials is exact, rounded once to
  float32 (:func:`wide_row_sum`, an int64 sum wherever ``lis_sum_fits``
  holds); the reference sums float32 terms of up to 2^68 in its own order.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .bit_types import BitType
from .quant import exp2, floor_log2, pow2

# float32 roundings of the reference's weakly typed Python constants
_X0 = float(np.float32(-0.6931))
_B = float(np.float32(0.96963238 / 0.35815147))
_C = float(np.float32(1.0 / 0.35815147))
_A = float(np.float32(0.35815147))
_NUDGE = float(np.float32(4.0 / 3.0 * (1.0 + 2.0**-17)))


# the reference's lower bound on the softmax scale: its floor trick for q
# holds for |x0_int| < 1.2e5 (``diffvit_tpu/ops/pallas/attention.py:62-70``);
# above it every integer exponential is below 2^68
LIS_MIN_SCALE = 2.0**-17


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


def _const(scale, v):
    # a constant over a tensor: torch computes ``number / t`` as
    # ``t.reciprocal() * number``, two roundings where the kernels and the
    # reference take one IEEE quotient
    return torch.full_like(scale, v)


def _int_polynomial(x_int, scaling_factor):
    """2nd-order polynomial of exp on [-ln2, 0] on the integer grid:
    (z, a * s^2)."""
    b_int = torch.floor(_const(scaling_factor, _B) / scaling_factor)
    c_int = torch.floor(_const(scaling_factor, _C)
                        / (scaling_factor * scaling_factor))
    z = x_int * (x_int + b_int) + c_int
    return z, _A * (scaling_factor * scaling_factor)


def int_exp(x_int, scale, fast: bool = False):
    """The integer exponential of the shifted scores ``x_int`` (<= 0, float32
    carrier) at ``scale``, n = 32: the range reduction x = q * x0 + r, the
    polynomial, ``max(floor(poly * 2^(32-q)), 0)``.  ``fast``: without the
    floor and the max, which the fused kernels drop where ``lis_fast_ok``
    proves them no-ops on integer scores."""
    x0_int = torch.floor(_const(scale, _X0) / scale)
    x_int = torch.maximum(x_int, 32.0 * x0_int)
    q = torch.floor(x_int / x0_int)
    e = _int_polynomial(x_int - x0_int * q, scale)[0] * pow2(32.0 - q)
    return e if fast else torch.clamp(torch.floor(e), min=0.0)


def lis_tail_plain(exp_sum: torch.Tensor, exp_int: torch.Tensor,
                   bits: int = 4):
    """The folded log2 quantization of ``_lis_body``: m = rint(exp_sum /
    exp_int), y = 4m/3 * (1 + 2^-17), code = floor(log2 y), taken exactly
    from the exponent bits.  Returns the int32 weight 2^(15 - code), 0 where
    y >= 2^(2^bits) saturates (and for masked columns, where exp_int = 0)."""
    if bits > 4:
        raise NotImplementedError(
            "LIS tail supports bits <= 4 only (the reference's uint4)")
    y = torch.round(exp_sum / exp_int) * _NUDGE
    code = torch.frexp(y).exponent - 1
    keep = y < 2.0 ** (2**bits)
    shift = torch.where(keep, 15 - code, 0)
    w = torch.ones_like(shift) << shift
    return torch.where(keep, w, 0).to(torch.int32)


def log_round(x):
    """Nearest-power-of-two exponent biased like the reference: floor(log2
    x), plus one iff (x - 2^f) >= 2^(f-1); exact."""
    f = floor_log2(x)
    bump = (x - exp2(f)) >= exp2(f - 1.0)
    return f + bump.to(f.dtype)


def wide_row_sum(exp_int: torch.Tensor) -> torch.Tensor:
    """The exact row sum (last axis, kept) of integer exponentials
    (non-negative integer float32 below 2^68), rounded once to float32, as
    ``csrc/lis.cuh``'s ``wide_add`` / ``wide_to_float`` take it: each term
    split at 2^32 into two exact int64 limbs, each limb summed, the carry
    of the low sum moved into the high one, and the total t = hi * 2^32 +
    lo rounded to nearest even: as an int64 below 2^63, else with its bits
    below 2^16 folded into one sticky bit (which lies below the rounding
    position of such a t).  Where the int64 sum fits, it equals the int64
    sum rounded once."""
    h = torch.floor(exp_int * 2.0**-32)
    hi = h.to(torch.int64).sum(-1, keepdim=True)
    lo = (exp_int - h * 2.0**32).to(torch.int64).sum(-1, keepdim=True)
    hi = hi + (lo >> 32)
    lo = lo & 0xFFFFFFFF
    small = hi < 2**31
    narrow = ((torch.where(small, hi, 0) << 32) | lo).to(torch.float32)
    v = (hi << 16) | (lo >> 16) | ((lo & 0xFFFF) != 0).to(torch.int64)
    return torch.where(small, narrow, v.to(torch.float32) * 2.0**16)


def _int_exp(x_int, scaling_factor, n: int = 32):
    """Integer exp via the range reduction x = q * (-ln2) + r:
    (exp_int, its scaling factor).  n = 32 only (the reference's)."""
    if n != 32:
        raise NotImplementedError("int_exp takes n = 32 (the reference's)")
    s = scaling_factor
    return int_exp(x_int, s), _A * (s * s) / 2.0**32


def int_softmax_from_int(x_int, scaling_factor):
    """(exp_int, exp_sum) of integer scores ``x_int`` (float32 carrier) at
    ``scaling_factor`` (a float32 tensor), shifted by the row max."""
    x_int = x_int - torch.amax(x_int, -1, keepdim=True)
    exp_int = int_exp(x_int, scaling_factor)
    return exp_int, wide_row_sum(exp_int)


def int_softmax(x, scaling_factor):
    """(exp_int, exp_sum) of the float logits ``x`` on the
    ``scaling_factor`` grid (``x / scaling_factor`` need not be integer:
    calibration passes the raw logits)."""
    return int_softmax_from_int(x / scaling_factor, scaling_factor)


def _lis_tail(exp_int, exp_sum, bit_type: BitType):
    """The dequantized weights ``2^-code`` (float32), 0 where saturated."""
    w = lis_tail_plain(exp_sum, exp_int, bit_type.bits)
    return w.to(torch.float32) * 2.0**-15


def log_int_softmax(x, scaling_factor, bit_type: BitType):
    """Full LIS of the float logits ``x``: integer softmax, log2
    quantization to ``bit_type``, dequantized ``2^-code`` (float32, exact
    powers of two) with the saturated codes at 0."""
    return _lis_tail(*int_softmax(x, scaling_factor), bit_type)


def log_int_softmax_from_int(x_int: torch.Tensor, scaling_factor,
                             bit_type: BitType) -> torch.Tensor:
    """LIS over every column of the integer scores ``x_int`` (float32
    carrier) at the softmax scale ``scaling_factor`` (a float32 tensor):
    the fused kernels' LIS row (``lis_body_plain``, slow form) on all
    columns, dequantized."""
    return _lis_tail(*int_softmax_from_int(x_int, scaling_factor), bit_type)
