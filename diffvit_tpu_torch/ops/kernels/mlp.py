"""Integer MLP: fc1 -> polynomial GELU -> qact1 -> fc2 -> PTF qact2
(counterpart of ``diffvit_tpu/ops/pallas/mlp.py::fused_int_mlp``).

The CUDA kernel is ``csrc/int_mlp.cu``; the plain version below is its
exact specification.  Every product and sum rounds on its own (the kernel
is built with ``-fmad=false``).  A jitted XLA computation contracts
``a*b + c`` into one fused multiply-add, so where the reference runs fused
its codes can differ on rare rounding-boundary elements; against the
interpret-mode Pallas kernel the codes agree exactly."""
from __future__ import annotations

import numpy as np
import torch

from ..quant import int_matmul
from . import check_for_kernel, require, route
from .build import check, load_library

# Chebyshev fit of (Phi(sqrt(u)) - 0.5)/sqrt(u) on u in [0, 4.8^2], monomial
# form in s = 2u/4.8^2 - 1 (diffvit_tpu/ops/pallas/mlp.py:40-46)
GELU_P = (
    1.472124915e-01, -7.297722655e-02, 5.292239887e-02, -4.063959391e-02,
    3.055344378e-02, -2.162323356e-02, 1.431964120e-02, -9.132027657e-03,
    5.130726935e-03, -2.055695227e-03, 1.023744687e-03, -9.600747865e-04,
    3.919371191e-04,
)
GELU_B2 = 4.8 * 4.8

# float32 roundings of the weakly typed constants, as Python floats
_P32 = tuple(float(np.float32(c)) for c in GELU_P)
_B2 = float(np.float32(GELU_B2))
_TWO_OVER_B2 = float(np.float32(2.0 / GELU_B2))


def gelu_poly(x: torch.Tensor) -> torch.Tensor:
    """Division- and exp-free GELU: x * clip(0.5 + x*P(min(x^2, 4.8^2)), 0, 1)
    with P the degree-12 fit above (``_gelu_poly``, ``mlp.py:49``)."""
    u = torch.clamp(x * x, max=_B2)
    s = u * _TWO_OVER_B2 - 1.0
    p = _P32[-1] * s + _P32[-2]
    for coef in _P32[-3::-1]:
        p = p * s + coef
    phi = torch.clamp(0.5 + x * p, 0.0, 1.0)
    return x * phi


def fused_int_mlp_plain(x_i8, w1, w2, mult1, bias1, mult2, bias2, out_scale,
                        s_q1, *, emit_codes=False):
    """Plain PyTorch version of :func:`fused_int_mlp`."""
    hid, cout = w1.shape[1], w2.shape[1]
    out_b = out_scale.expand(cout)
    mid = int_matmul(x_i8, w1).to(torch.float32) * mult1.expand(hid) \
        + bias1.expand(hid)
    g = torch.clamp(torch.round(gelu_poly(mid) * (1.0 / s_q1)), -128, 127)
    y = int_matmul(g.to(torch.int8), w2).to(torch.float32) \
        * mult2.expand(cout) + bias2.expand(cout)
    codes = torch.clamp(torch.round(y * (1.0 / out_b)), -128, 127)
    return codes.to(torch.int8) if emit_codes else codes * out_b


def fused_int_mlp(x_i8, w1, w2, mult1, bias1, mult2, bias2, out_scale, s_q1,
                  *, emit_codes=False):
    """x_i8: (R, Cin) int8 tokens; w1: (Cin, Hid) int8; w2: (Hid, Cout) int8;
    mult*/bias*: per-output-channel float32 (or broadcastable); out_scale:
    the mlp.qact2 (PTF) scale; s_q1: the mlp.qact1 scale.
    Returns (R, Cout) float32 on the mlp.qact2 grid — or, with
    ``emit_codes=True``, the (R, Cout) int8 mlp.qact2 codes.  Unlike the
    Pallas kernel, R needs no padding (the TPU's block_rows/sub/interpret
    knobs have no counterpart).

    A CUDA tensor runs ``csrc/int_mlp.cu``; a CPU tensor runs
    :func:`fused_int_mlp_plain`."""
    args = (x_i8, w1, w2, mult1, bias1, mult2, bias2, out_scale, s_q1)
    if route(*args) == "cpu":
        return fused_int_mlp_plain(*args, emit_codes=emit_codes)
    rows, cin = x_i8.shape
    hid, cout = w1.shape[1], w2.shape[1]
    check_for_kernel(x_i8, "x_i8", torch.int8, 2)
    check_for_kernel(w1, "w1", torch.int8, 2)
    check_for_kernel(w2, "w2", torch.int8, 2)
    require(w1.shape[0] == cin and w2.shape[0] == hid,
            f"w1 {tuple(w1.shape)} / w2 {tuple(w2.shape)} do not chain from "
            f"x {tuple(x_i8.shape)}")
    require(cin % 32 == 0 and hid % 32 == 0 and cout % 16 == 0,
            f"Cin={cin} and Hid={hid} must be multiples of 32, Cout={cout} "
            "of 16")
    f32 = torch.float32
    vec = [t.expand(n).to(f32).contiguous()
           for t, n in ((mult1, hid), (bias1, hid), (mult2, cout),
                        (bias2, cout), (out_scale, cout))]
    inv_out = 1.0 / vec[4]
    s_q1_inv = (1.0 / s_q1).to(f32).reshape(1)
    hidden = torch.empty((rows, hid), dtype=torch.int8, device=x_i8.device)
    out = torch.empty((rows, cout), dtype=torch.int8 if emit_codes else f32,
                      device=x_i8.device)
    err = load_library().dvt_int_mlp(
        x_i8.data_ptr(), w1.data_ptr(), w2.data_ptr(), vec[0].data_ptr(),
        vec[1].data_ptr(), vec[2].data_ptr(), vec[3].data_ptr(),
        inv_out.data_ptr(), vec[4].data_ptr(), s_q1_inv.data_ptr(),
        hidden.data_ptr(), out.data_ptr(), rows, cin, hid, cout,
        int(emit_codes), torch.cuda.current_stream(x_i8.device).cuda_stream)
    check(err, "fused_int_mlp")
    fused_int_mlp.launches += 1
    return out


fused_int_mlp.launches = 0
