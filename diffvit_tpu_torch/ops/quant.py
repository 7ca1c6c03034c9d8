"""Uniform quantize/dequantize primitives (counterpart of
``diffvit_tpu/ops/quant.py``).  Scales and zero-points are float32 tensors
that broadcast over the trailing channel axis; ``torch.round`` rounds half
to even, like ``jnp.round``.

Powers of two and ``floor(log2 x)`` come from exponent bits (``pow2``,
``floor_log2``), where the reference takes XLA's ``exp2``/``log2``: they
are exact on every device, and the PoT scale a calibration picks is one of
them."""
from __future__ import annotations

import torch

from .bit_types import BitType


def quantize(x, scale, zero_point, bit_type: BitType):
    """x -> integer grid (still float dtype), clamped to the bit-type bounds."""
    q = torch.round(x / scale + zero_point)
    return torch.clamp(q, bit_type.lower_bound, bit_type.upper_bound)


def dequantize(q, scale, zero_point):
    return (q - zero_point) * scale


def fake_quant(x, scale, zero_point, bit_type: BitType):
    """quantize-then-dequantize."""
    return dequantize(quantize(x, scale, zero_point, bit_type),
                      scale, zero_point)


def pow2(n: torch.Tensor) -> torch.Tensor:
    """Exact float32 ``2^n`` for integer-valued ``n`` in [-126, 127], built
    from the exponent bits (``torch.pow``/``exp2`` are not guaranteed exact
    on every device)."""
    return ((n.to(torch.int32) + 127) << 23).view(torch.float32)


def exp2(y: torch.Tensor) -> torch.Tensor:
    """``2^y`` of a float32 tensor: exact (:func:`pow2`) where ``y`` is an
    integer in [-126, 127], ``torch.exp2`` elsewhere (fractions, the
    subnormal range, +-inf, nan)."""
    ok = (y == torch.round(y)) & (y >= -126) & (y <= 127)
    return torch.where(ok, pow2(torch.where(ok, y, 0.0)), torch.exp2(y))


def floor_log2(x: torch.Tensor) -> torch.Tensor:
    """Exact ``floor(log2 x)`` (float32) of a positive finite float32 (the
    subnormals too), from its exponent bits; ``floor(log2 x)`` of 0, inf
    and nan.  ``log2`` itself rounds differently on the CPU and on CUDA
    just below powers of two; the exponent does not."""
    ok = torch.isfinite(x) & (x > 0)
    e = (torch.frexp(torch.where(ok, x, 1.0)).exponent - 1).to(x.dtype)
    return torch.where(ok, e, torch.floor(torch.log2(x)))


def log2_quant(x, bit_type: BitType):
    """Log2 quantization of softmax outputs: codes = clamp(round(-log2 x),
    0, 2^bits - 1) and the mask of saturated entries (rounds >= 2^bits),
    which dequantize to 0.  ``round(-log2 x)`` is taken exactly: with x =
    m * 2^e (m in [1/2, 1)) it is -e + (m < sqrt(1/2)), which no float32
    ties; 0, inf and nan go through ``log2``."""
    ok = torch.isfinite(x) & (x > 0)
    m, e = torch.frexp(torch.where(ok, x, 1.0))
    rounds = torch.where(ok, (-e).to(x.dtype) + (m < 0.5 ** 0.5).to(x.dtype),
                         torch.round(-torch.log2(x)))
    mask = rounds >= 2**bit_type.bits
    return torch.clamp(rounds, 0, 2**bit_type.bits - 1), mask


def log2_dequant(codes, mask):
    """``2^-code``, saturated entries zeroed."""
    return torch.where(mask, 0.0, exp2(-codes))


def round_ln(x, mode: str | None = None):
    """PoT exponent of ``x``: floor or ceil of log2 x, or (``mode`` None)
    the nearest power of two measured linearly, floor(log2 x) + 1 iff (x -
    2^y) > (2^(y+1) - x) (the reference's ``round_ln``).  Exact: y from the
    exponent bits, the two differences exact in float32."""
    y = floor_log2(x)
    if mode == "floor":
        return y
    if mode == "ceil":
        ok = torch.isfinite(x) & (x > 0)
        return torch.where(ok, y + (x != exp2(y)).to(y.dtype),
                           torch.ceil(torch.log2(x)))
    out = (x - exp2(y)) > (exp2(y + 1.0) - x)
    return out.to(y.dtype) + y


def lp_loss(pred, tgt, p: float = 2.0, reduction: str = "none"):
    """L_p error metric: ``reduction`` "none" sums over axis 1 before the
    mean, anything else is the mean of every element."""
    err = torch.abs(pred - tgt) ** p
    if reduction == "none":
        return torch.mean(torch.sum(err, dim=1))
    return torch.mean(err)


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact ``(..., K) int8 @ (K, N) int8 -> int32`` (batched operands
    broadcast as in ``torch.matmul``).

    torch's own int8 matmul returns int8 and wraps around on the CPU, and
    CUDA matmuls take no integers at all.  So: on the CPU both operands go
    to int32; on CUDA the product runs as float32 matmuls over K-chunks of
    at most 1024, each exact (|chunk sum| <= 1024*128*128 = 2^24) and
    converted to int32 before the chunks are added.  TF32 would drop
    mantissa bits, so it is switched off for these matmuls."""
    if a.device.type == "cpu":
        return torch.matmul(a.to(torch.int32), b.to(torch.int32))
    if a.device.type != "cuda":
        raise ValueError(f"int_matmul: unsupported device {a.device}")
    torch.backends.cuda.matmul.allow_tf32 = False
    k = a.shape[-1]
    out = None
    for k0 in range(0, k, 1024):
        part = torch.matmul(a[..., k0:k0 + 1024].to(torch.float32),
                            b[..., k0:k0 + 1024, :].to(torch.float32))
        part = part.to(torch.int32)
        out = part if out is None else out + part
    return out
