"""Integer MLP: fc1 -> polynomial GELU -> qact1 -> fc2 -> PTF qact2
(counterpart of ``diffvit_tpu/ops/pallas/mlp.py::fused_int_mlp``, K2), and
the whole MLP half-block with its fences and integer LN
(``::fused_int_mlp_block``, K7b).

The CUDA kernels are ``csrc/int_mlp.cu`` and ``csrc/int_mlp_block.cu``,
both on the Hopper GEMM mainloop (``wgmma_gemm.cuh``) with the weights'
cached K-major copies (``gemm.kmajor``); the plain versions below
are their exact specifications.  Every product
and sum rounds on its own (the kernels are built with ``-fmad=false``).  A
jitted XLA computation contracts ``a*b + c`` into one fused multiply-add,
so where the reference runs fused its codes can differ on rare
rounding-boundary elements: against the interpret-mode Pallas kernel K2's
codes agree exactly on most operands, and differ by 1 on a few codes in
ten thousand on others (2 of 6,272 on a random Swin block's,
``tests/test_torch_swin.py``)."""
from __future__ import annotations

import numpy as np
import torch

from ..int_layernorm import mlp_block_ln_codes
from ..quant import int_matmul
from . import check_for_kernel, require, route
from .build import check, load_library
from .gemm import (device_plan, gemm_footprint, kmajor, pad_k, per_weight,
                   require_tma_operand, round_up)

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


def _mlp_vectors(mult1, bias1, mult2, bias2, out_scale, s_q1, hid, cout):
    """The float32 vectors the kernel reads, in its argument order: mult1,
    bias1 (Hid,), mult2, bias2, 1/out_scale, out_scale (Cout,), 1/s_q1
    (1,), each a new contiguous tensor."""
    f32 = torch.float32
    vec = [t.expand(n).to(f32).clone(memory_format=torch.contiguous_format)
           for t, n in ((mult1, hid), (bias1, hid), (mult2, cout),
                        (bias2, cout), (out_scale, cout))]
    return (*vec[:4], 1.0 / vec[4], vec[4],
            (1.0 / s_q1).to(f32).reshape(1))


def fused_int_mlp(x_i8, w1, w2, mult1, bias1, mult2, bias2, out_scale, s_q1,
                  *, emit_codes=False):
    """x_i8: (R, Cin) int8 tokens; w1: (Cin, Hid) int8; w2: (Hid, Cout) int8;
    mult*/bias*: per-output-channel float32 (or broadcastable); out_scale:
    the mlp.qact2 (PTF) scale; s_q1: the mlp.qact1 scale.
    Returns (R, Cout) float32 on the mlp.qact2 grid — or, with
    ``emit_codes=True``, the (R, Cout) int8 mlp.qact2 codes.  Unlike the
    Pallas kernel, R needs no padding (the TPU's block_rows/sub/interpret
    knobs have no counterpart), and any Cin, Hid and Cout are taken.

    A CUDA tensor runs ``csrc/int_mlp.cu``; a CPU tensor runs
    :func:`fused_int_mlp_plain`.  On the card ``x_i8`` must be 16-byte
    aligned (TMA reads it; ``ValueError`` otherwise)."""
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
    require(rows > 0, "fused_int_mlp: no rows")
    f32 = torch.float32
    vec = per_weight(lambda: _mlp_vectors(mult1, bias1, mult2, bias2,
                                          out_scale, s_q1, hid, cout),
                     mult1, bias1, mult2, bias2, out_scale, s_q1, hid, cout)
    w1k, w2k = kmajor(w1), kmajor(w2)
    cin_p, hid_p = w1k.shape[1], w2k.shape[1]
    x_p = pad_k(x_i8, cin_p)
    require_tma_operand(x_p, "x_i8")
    dev = x_i8.device
    plan1 = device_plan(rows, hid, cin_p, dev)
    plan2 = device_plan(rows, cout, hid_p, dev)
    # the row stride rounds Hid up to 16 bytes for TMA; fc2's weight has
    # zero K columns there, so the unwritten pad bytes add nothing
    hidden = torch.empty((rows, hid_p), dtype=torch.int8, device=dev)
    out = torch.empty((rows, cout), dtype=torch.int8 if emit_codes else f32,
                      device=dev)
    err = load_library().dvt_int_mlp(
        x_p.data_ptr(), w1k.data_ptr(), w2k.data_ptr(),
        *(t.data_ptr() for t in vec),
        hidden.data_ptr(), out.data_ptr(), rows, cin_p, hid, hid_p, cout,
        int(emit_codes), *plan1.launch_args(), *plan2.launch_args(),
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, "fused_int_mlp")
    fused_int_mlp.launches += 1
    return out


fused_int_mlp.launches = 0


def footprint(rows: int, cin: int, hid: int, cout: int, device) -> dict:
    """{"fc1": {...}, "fc2": {...}, "fc2_f32": {...}}: the registers,
    shared memory and blocks an SM of the kernels that
    :func:`fused_int_mlp` launches for ``rows`` rows on ``device`` (fc2
    with codes out, and with float32 out), each with its plan's tile.
    Needs a card."""
    entry = load_library().dvt_int_mlp_footprint
    fc1 = device_plan(rows, hid, round_up(cin, 16), device)
    fc2 = device_plan(rows, cout, round_up(hid, 16), device)
    return {"fc1": gemm_footprint(entry, fc1, 1),
            "fc2": gemm_footprint(entry, fc2, 2),
            "fc2_f32": gemm_footprint(entry, fc2, 3)}


# ---- K7b: the whole MLP half-block on the float32 residual stream ----

def mlp_block_vectors(y, w1, w2, mult1, bias1, mult2, bias2, mlp_out_scale,
                      s_q1, ln, ln_in_scale, ln_out_scale, ln_rescale, s3,
                      s4_vec):
    """The Pallas wrapper's fold (``mlp.py:246-264``) of
    :func:`fused_int_mlp_block`'s arguments, in float32 on the arguments'
    device, every reciprocal and quotient one IEEE division by a tensor:
    v (10, C) [1/s3, s3, 1/s2, s2, 1/s4, s4, r = rint(s2 / s2min), lnw/out,
    lnb/out, rescale (ones when absent)], v1 (2, Hid) [mult1, bias1], v2
    (4, C) [mult2, bias2, out_scale, 1/out_scale] and scal (3,) [s2min,
    1/s_q1, C], where s2 is ``ln_in_scale``."""
    f32, dev = torch.float32, mult1.device
    cin, hid, cout = y.shape[-1], w1.shape[1], w2.shape[1]

    def bc(t, n=cin):
        return torch.as_tensor(t, dtype=f32, device=dev).expand(n)

    def inv(t):
        return torch.ones_like(t) / t

    in_scale = bc(ln_in_scale)
    s2min = in_scale.min()
    out_sc = bc(ln_out_scale)
    v = torch.stack([
        inv(bc(s3)), bc(s3), inv(in_scale), in_scale, inv(bc(s4_vec)),
        bc(s4_vec), torch.round(in_scale / s2min), bc(ln["w"]) / out_sc,
        bc(ln["b"]) / out_sc,
        bc(ln_rescale) if ln_rescale is not None
        else torch.ones(cin, dtype=f32, device=dev)])
    v1 = torch.stack([bc(mult1, hid), bc(bias1, hid)])
    out_b = bc(mlp_out_scale, cout)
    v2 = torch.stack([bc(mult2, cout), bc(bias2, cout), out_b, inv(out_b)])
    scal = torch.stack([s2min, inv(torch.as_tensor(s_q1, dtype=f32,
                                                   device=dev).reshape(())),
                        torch.tensor(float(cin), dtype=f32, device=dev)])
    return v, v1, v2, scal


def fused_int_mlp_block_plain(y, h, w1, w2, mult1, bias1, mult2, bias2,
                              mlp_out_scale, s_q1, *, ln, ln_in_scale,
                              ln_out_scale, ln_rescale, s3, s2_vec, s4_vec):
    """Plain PyTorch version of :func:`fused_int_mlp_block`:
    ``_mlp_block_kernel`` op for op on the folded vectors."""
    del s2_vec  # unused, as in the Pallas wrapper (see fused_int_mlp_block)
    v, v1, v2, scal = mlp_block_vectors(
        y, w1, w2, mult1, bias1, mult2, bias2, mlp_out_scale, s_q1, ln,
        ln_in_scale, ln_out_scale, ln_rescale, s3, s4_vec)
    yq = torch.clamp(torch.round(y * v[0]), -128, 127) * v[1]      # qact3
    codes2 = torch.clamp(torch.round((h + yq) * v[2]), -128, 127)  # qact2
    h2 = codes2 * v[3]
    x_i8 = mlp_block_ln_codes(codes2, v[6], scal[0], v[7], v[8], v[9],
                              scal[2]).to(torch.int8)
    mid = int_matmul(x_i8, w1).to(torch.float32) * v1[0] + v1[1]
    g = torch.clamp(torch.round(gelu_poly(mid) * scal[1]), -128, 127)
    ym = int_matmul(g.to(torch.int8), w2).to(torch.float32) * v2[0] + v2[1]
    ym = torch.clamp(torch.round(ym * v2[3]), -128, 127) * v2[2]  # mlp.qact2
    hn = h2 + ym                                                   # residual
    return torch.clamp(torch.round(hn * v[4]), -128, 127) * v[5]   # qact4


def fused_int_mlp_block(y, h, w1, w2, mult1, bias1, mult2, bias2,
                        mlp_out_scale, s_q1, *, ln, ln_in_scale, ln_out_scale,
                        ln_rescale, s3, s2_vec, s4_vec):
    """The MLP half of a block on the float32 residual stream (the Pallas
    ``fused_int_mlp_block``, K7b): attn.qact3 of the proj output ``y``,
    the residual add to ``h``, the qact2 fence, its integer LN
    (:func:`~diffvit_tpu_torch.ops.int_layernorm.mlp_block_ln_codes`),
    fc1, the polynomial GELU, the qact1 requant, fc2, the mlp.qact2 fence,
    the residual add and the qact4 fence.

    y, h: (R, C) float32; w1: (C, Hid), w2: (Hid, C) int8; mult*/bias*:
    per-channel float32; mlp_out_scale: the mlp.qact2 scale; s_q1: the
    mlp.qact1 scale; ln: {"w", "b"}; ln_in_scale: the qact2 scale (the
    fence's and the LN input's grid); ln_out_scale: the fc1 input grid;
    ln_rescale: the norm2 channel-grid conversion or None; s3: the
    attn.qact3 scale; s4_vec: the qact4 scale.  ``s2_vec`` is accepted and
    unused, as in the Pallas wrapper, whose qact2 fence takes
    ``ln_in_scale``.  Returns (R, C) float32, the residual stream after
    qact4.  R needs no padding; the TPU's block_rows/sub/interpret knobs
    have no counterpart.

    A CUDA tensor runs ``csrc/int_mlp_block.cu``; a CPU tensor runs
    :func:`fused_int_mlp_block_plain`."""
    kw = dict(ln=ln, ln_in_scale=ln_in_scale, ln_out_scale=ln_out_scale,
              ln_rescale=ln_rescale, s3=s3, s2_vec=s2_vec, s4_vec=s4_vec)
    args = (y, h, w1, w2, mult1, bias1, mult2, bias2, mlp_out_scale, s_q1)
    tensors = [t for t in (*args, *ln.values(), ln_in_scale, ln_out_scale,
                           ln_rescale, s3, s4_vec)
               if isinstance(t, torch.Tensor)]
    if route(*tensors) == "cpu":
        return fused_int_mlp_block_plain(*args, **kw)
    rows, c = y.shape
    hid = w1.shape[1]
    check_for_kernel(y, "y", torch.float32, 2)
    check_for_kernel(h, "h", torch.float32, 2)
    check_for_kernel(w1, "w1", torch.int8, 2)
    check_for_kernel(w2, "w2", torch.int8, 2)
    require(h.shape == y.shape and w1.shape[0] == c
            and w2.shape == (hid, c),
            f"y {tuple(y.shape)}, h {tuple(h.shape)}, w1 {tuple(w1.shape)} "
            f"and w2 {tuple(w2.shape)} do not chain")
    require(rows > 0 and c % 32 == 0 and hid % 32 == 0,
            f"R={rows} must be positive, C={c} and Hid={hid} multiples of 32")
    # the folded vectors depend on the block's constants alone (y gives
    # only C): kept per weight, as fused_int_mlp keeps its own
    packed = per_weight(lambda: [t.contiguous() for t in mlp_block_vectors(
        y, w1, w2, mult1, bias1, mult2, bias2, mlp_out_scale, s_q1, ln,
        ln_in_scale, ln_out_scale, ln_rescale, s3, s4_vec)],
        w1, w2, mult1, bias1, mult2, bias2, mlp_out_scale, s_q1, ln["w"],
        ln["b"], ln_in_scale, ln_out_scale, ln_rescale, s3, s4_vec, c)
    dev = y.device
    w1k, w2k = kmajor(w1), kmajor(w2)
    hid_p = w2k.shape[1]
    plan1, plan2 = _block_plans(rows, c, hid, dev)
    x_codes = torch.empty((rows, c), dtype=torch.int8, device=dev)
    h2 = torch.empty((rows, c), dtype=torch.float32, device=dev)
    # the row stride rounds Hid up to 16 bytes for TMA; fc2's weight has
    # zero K columns there, so the unwritten pad bytes add nothing
    hidden = torch.empty((rows, hid_p), dtype=torch.int8, device=dev)
    out = torch.empty((rows, c), dtype=torch.float32, device=dev)
    v, v1, v2, scal = (t.data_ptr() for t in packed)
    err = load_library().dvt_int_mlp_block(
        y.data_ptr(), h.data_ptr(), v, w1k.data_ptr(), w2k.data_ptr(), v1,
        v2, scal, x_codes.data_ptr(), h2.data_ptr(), hidden.data_ptr(),
        out.data_ptr(), rows, c, hid, hid_p, *plan1.launch_args(),
        *plan2.launch_args(), torch.cuda.current_stream(dev).cuda_stream)
    check(err, "fused_int_mlp_block")
    fused_int_mlp_block.launches += 1
    return out


def _block_plans(rows, c, hid, device):
    """K7b's fc1 and fc2 plans (``gemm_plan``) on ``device``."""
    return (device_plan(rows, hid, round_up(c, 16), device),
            device_plan(rows, c, round_up(hid, 16), device))


fused_int_mlp_block.launches = 0


def mlp_block_footprint(rows: int, c: int, hid: int, device) -> dict:
    """{"fc1": {...}, "fc2": {...}}: the registers, shared memory and
    blocks an SM of the two GEMM kernels that :func:`fused_int_mlp_block`
    launches for ``rows`` rows on ``device``, each with its plan's tile.
    Needs a card."""
    entry = load_library().dvt_int_mlp_block_footprint
    fc1, fc2 = _block_plans(rows, c, hid, device)
    return {"fc1": gemm_footprint(entry, fc1, 1),
            "fc2": gemm_footprint(entry, fc2, 2)}
