"""Log-Int-Softmax on integer scores (counterpart of
``diffvit_tpu/ops/lis.py::log_int_softmax_from_int``), for the integer
forward's unfused attention (a float proj site)."""
from __future__ import annotations

import torch

from .bit_types import BitType
from .kernels.attention import lis_body_plain


def log_int_softmax_from_int(x_int: torch.Tensor, scaling_factor,
                             bit_type: BitType) -> torch.Tensor:
    """LIS over every column of the integer scores ``x_int`` (float32
    carrier) at the softmax scale ``scaling_factor`` (a float32 tensor):
    the dequantized weights ``2^-code``, 0 where the code saturates.

    The same arithmetic as the fused kernels' LIS row (``lis_body_plain``,
    slow form), whose row sum is exact where the reference's float32 sum
    depends on its order; the weights are exact powers of two."""
    col_ok = torch.ones(x_int.shape[-1], dtype=torch.bool,
                        device=x_int.device)
    w = lis_body_plain(x_int, scaling_factor, bit_type.bits, col_ok)
    return w.to(torch.float32) * 2.0**-15
