"""Integer LayerNorm (counterpart of ``diffvit_tpu/ops/int_layernorm.py``).

``int_ln_codes`` is the M·2^-N arithmetic that both ``int_layernorm``
(float32 out, Swin's patch norm) and ``models/vit_int._ln_int8`` (int8
codes out) run, so the exactness fixes below hold for both:

* the row sums are exact int64 sums (the reference sums float32 values,
  whose total depends on the summation order once it passes 2^24);
* the mean and std divide by a device tensor: CUDA torch turns division by
  a Python number into a multiply by its reciprocal, which is not the IEEE
  quotient;
* the root is taken in float64 and rounded to float32 (the correctly
  rounded root); CUDA torch's float32 ``sqrt`` is not correctly rounded.
"""
from __future__ import annotations

import numpy as np
import torch

from .quant import floor_log2, pow2


def get_mn(x: torch.Tensor):
    """Fixed-point decomposition A ≈ M · 2^-N with a 7-bit mantissa.
    ``2^N`` is built exactly."""
    bit = 7
    n = torch.clamp(bit - floor_log2(x), 0, 31)
    m = torch.clamp(torch.floor(x * pow2(n)), 0, 2 ** (bit + 1) - 1)
    return m, n


def int_ln_codes(x_q, weight, bias, in_scale, out_scale):
    """Integer LN over the last axis of the float32 input codes ``x_q`` on
    the per-channel ``in_scale`` grid.  Returns the float32 output codes on
    the ``out_scale`` grid, rounded and not clipped."""
    c = weight.shape[-1]
    in_scale = in_scale.expand(c)
    in_scale1 = in_scale.min()
    return ln_codes(x_q * torch.round(in_scale / in_scale1), in_scale1,
                    weight, bias, out_scale)


def ln_codes(x_q, in_scale1, weight, bias, out_scale, std_floor=None):
    """:func:`int_ln_codes` after the channel fold: ``x_q`` are the input
    codes times ``round(in_scale / in_scale1)``, on the grid of the scalar
    ``in_scale1``.  ``std_floor``: a least std (the resident kernel's, so
    that an all-equal row stays finite; ``torch.maximum`` keeps a NaN)."""
    c = weight.shape[-1]
    out_scale = out_scale.expand(c)
    xi = x_q.to(torch.int64)
    sum_x = xi.sum(-1).to(torch.float32)
    sum_x2 = (xi * xi).sum(-1).to(torch.float32)
    c_t = sum_x.new_full((), float(c))
    mean = (sum_x / c_t) * in_scale1
    var = (c * sum_x2 - sum_x * sum_x).to(torch.float64)
    std = (in_scale1 / c_t) * torch.sqrt(var).to(torch.float32)
    if std_floor is not None:
        std = torch.maximum(std, std.new_full((), std_floor))
    a = (in_scale1 / std)[..., None] * weight / out_scale
    m, n = get_mn(torch.abs(a))
    p2n = pow2(n)
    b = torch.round((bias - (mean / std)[..., None] * weight)
                    / out_scale * p2n)
    return torch.round((torch.sign(a) * m * x_q + b) / p2n)


def mlp_block_ln_codes(codes, r, s_min, lnw_out, lnb_out, rescale, c):
    """The integer LN of the whole-MLP-block kernel K7b, in its own order
    (``diffvit_tpu/ops/pallas/mlp.py:182-193``), which is not
    :func:`ln_codes`'s: the weight and bias arrive divided by the output
    scale (``lnw_out``, ``lnb_out``), ``a = (s_min / std) * lnw_out`` and
    ``b = rint((lnb_out - (mean / std) * lnw_out) * 2^n)``.  ``codes`` are
    the float32 qact2 codes of the rows, ``r = rint(in_scale / s_min)``,
    ``c`` the width as a float32 tensor.  The sums are exact int64 sums
    rounded once to float32 and the root is taken in float64 and rounded
    once, as in :func:`ln_codes`.  Returns the float32 codes, rescaled and
    clipped to int8 values."""
    x_q = codes * r
    xi = x_q.to(torch.int64)
    sum_x = xi.sum(-1, keepdim=True).to(torch.float32)
    sum_x2 = (xi * xi).sum(-1, keepdim=True).to(torch.float32)
    mean = (sum_x / c) * s_min
    var = (c * sum_x2 - sum_x * sum_x).to(torch.float64)
    std = (s_min / c) * torch.sqrt(var).to(torch.float32)
    a = (s_min / std) * lnw_out
    m, n = get_mn(torch.abs(a))
    p2n = pow2(n)
    b = torch.round((lnb_out - (mean / std) * lnw_out) * p2n)
    y = torch.round((torch.sign(a) * m * x_q + b) / p2n)
    return torch.clamp(torch.round(y * rescale), -128, 127)


def int_layernorm(x, weight, bias, in_scale, out_scale, *,
                  out_scale_channel=None):
    """Integer LayerNorm of the fake-quantized float32 ``x`` (values on the
    ``in_scale`` grid), returned as float32 values on the ``out_scale``
    grid.  ``out_scale_channel``: a per-channel factor multiplied into
    ``out_scale`` (the SmoothQuant channel scale of the consuming linear,
    as the reference's argument of that name).  The reference's
    ``in_scale_expand`` is folded into ``in_scale`` by the caller."""
    c = x.shape[-1]
    in_scale = in_scale.expand(c)
    if out_scale_channel is not None:
        out_scale = out_scale * out_scale_channel
    out_scale = out_scale.expand(c)
    x_q = torch.round(x / in_scale)
    return int_ln_codes(x_q, weight, bias, in_scale, out_scale) * out_scale


def float_layernorm(x, weight, bias, eps: float = 1e-6):
    """Plain float LayerNorm over the last axis of float32 ``x`` (``int_norm``
    off), as the reference writes it: the population variance, ``(x - mean)
    / sqrt(var + eps) * w + b``.  The reference's float32 value depends on
    the order of its sums, which XLA, CPU torch and CUDA each choose
    differently; here it is computed in float64 and rounded once to
    float32, so the card and the CPU agree, and the reference within an
    ulp."""
    xd = x.to(torch.float64)
    mean = xd.mean(-1, keepdim=True)
    var = ((xd - mean) ** 2).mean(-1, keepdim=True)
    y = (xd - mean) / torch.sqrt(var + float(np.float32(eps))) \
        * weight.to(torch.float64) + bias.to(torch.float64)
    return y.to(torch.float32)
