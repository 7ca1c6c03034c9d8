"""Integer LayerNorm helpers (counterpart of
``diffvit_tpu/ops/int_layernorm.py``)."""
from __future__ import annotations

import torch

from .quant import pow2


def floor_log2(x: torch.Tensor) -> torch.Tensor:
    """Exact ``floor(log2 x)`` of a positive finite float32, from its
    exponent bits (float32).  ``log2`` itself rounds differently on the CPU
    and on CUDA just below powers of two; the exponent does not."""
    return (torch.frexp(x).exponent - 1).to(torch.float32)


def get_mn(x: torch.Tensor):
    """Fixed-point decomposition A ≈ M · 2^-N with a 7-bit mantissa.
    ``2^N`` is built exactly."""
    bit = 7
    normal = torch.isfinite(x) & (x > 0)  # 0, inf and nan go through log2
    log2x = torch.where(normal, floor_log2(x), torch.log2(x))
    n = torch.clamp(bit - log2x, 0, 31)
    m = torch.clamp(torch.floor(x * pow2(n)), 0, 2 ** (bit + 1) - 1)
    return m, n
