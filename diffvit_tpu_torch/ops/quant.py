"""Uniform quantize/dequantize primitives (counterpart of
``diffvit_tpu/ops/quant.py``).  Scales and zero-points are float32 tensors
that broadcast over the trailing channel axis; ``torch.round`` rounds half
to even, like ``jnp.round``."""
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
