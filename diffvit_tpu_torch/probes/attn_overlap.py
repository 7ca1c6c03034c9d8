"""Probe P5: what K1's LIS chain costs on the card.

The counterpart of ``scripts/ab_attn_overlap_r3.py``.  Its Pallas kernel
``_nv_kernel`` (``:75``, via ``v2_nv`` ``:102``, called at ``:105``) is K1's
structure with the LIS replaced by ``attn = a * 2^-7`` in bfloat16 over all
Npad keys:

    qkv  = clip(rint(x_i8 @ w * mult/s1 + bias/s1))
    a    = clip(rint(q_h @ k_h^T * c1))
    out  = clip(rint((a * 2^-7) @ v_h * s1/s2))

Its kernel is K1's two launches as K1 runs them, the qkv GEMM on the TMA +
``wgmma`` mainloop and the tensor-core core with K1's plans, with that
weight rule in place of the LIS (``csrc/probes/attn_nv.cu`` on
``csrc/qkv_core.cuh``).  :func:`legs` times K1 (LIS and float softmax),
this kernel and K8's ``_v3``/``_v4``/``_v5`` at the script's B=256, each
chained 12 deep, and reports K1 minus this kernel: the LIS step's cost.
``VARIANTS`` lists what it times, so that a caller can hold each kernel
at the legs' arguments."""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..ops.kernels import attention, check_for_kernel, require, route
from ..ops.kernels.attn_plan import attention_plan
from ..ops.kernels.build import check, load_library
from ..ops.kernels.gemm import (gemm_plan, kmajor, pad_k, per_weight,
                                require_tma_operand, round_up, sm_count)
from ..ops.quant import int_matmul
from .timing import REPEATS, rounds_ms, run_main, spread

NP, N, H, D = 200, 197, 6, 64  # DeiT-S: Npad, tokens, heads, head dim
C = H * D
BATCH, DEPTH = 256, 12


def qkv_attention_nv_plain(x_i8, w_all, mult, bias, scalars, *, num_heads,
                           head_dim):
    """Plain PyTorch version of :func:`qkv_attention_nv`.  The sum of the
    products a * v is exact in int32, and times 2^-7 it is the float32 sum
    of the bfloat16 weights a * 2^-7 times v (multiples of 2^-7 below
    2^15)."""
    mb = attention.fold_requant(mult, bias, scalars[2], w_all.shape[1])
    qkv = attention.qkv_projection_plain(x_i8, w_all, mb)
    b, npad, _ = qkv.shape
    t = qkv.reshape(b, npad, 3, num_heads, head_dim).permute(2, 0, 3, 1, 4)
    scores = int_matmul(t[0], t[1].transpose(-1, -2))
    a = torch.clamp(torch.round(scores.to(torch.float32) * scalars[1]),
                    -128, 127)
    o = int_matmul(a.to(torch.int8), t[2]).to(torch.float32) * 2.0**-7
    return torch.clamp(torch.round(o * scalars[3]), -128, 127) \
        .to(torch.int8)


def launch_plans(batch, npad, cin, num_heads, head_dim, sms):
    """K1's plans for the two launches: the qkv GEMM's
    (``gemm.gemm_plan`` for (B*Npad, Kp) @ (Kp, 3C)) and the core's
    (``attn_plan.attention_plan`` over every one of the Npad keys)."""
    kp = round_up(cin, 16)
    return (gemm_plan(batch * npad, 3 * num_heads * head_dim, kp, sms),
            attention_plan(batch, num_heads, npad, head_dim, npad, True, sms))


def qkv_attention_nv(x_i8, w_all, mult, bias, scalars, *, num_heads,
                     head_dim):
    """x_i8: (B, Npad, Cin) int8; w_all: (Cin, 3C) int8, columns [slot,
    head, d]; mult/bias: (3C,) float32 (or broadcastable); scalars: (4,)
    float32 [s_a, c1, 1/s1, s1/s2].  Returns (B, H, Npad, D) int8.  A CUDA
    tensor runs ``csrc/probes/attn_nv.cu``; a CPU tensor
    :func:`qkv_attention_nv_plain`."""
    if route(x_i8, w_all, mult, bias, scalars) == "cpu":
        return qkv_attention_nv_plain(x_i8, w_all, mult, bias, scalars,
                                      num_heads=num_heads,
                                      head_dim=head_dim)
    check_for_kernel(x_i8, "x_i8", torch.int8, 3)
    check_for_kernel(w_all, "w_all", torch.int8, 2)
    check_for_kernel(scalars, "scalars", torch.float32, 1)
    b, npad, cin = x_i8.shape
    c3 = 3 * num_heads * head_dim
    require(w_all.shape == (cin, c3),
            f"w_all {tuple(w_all.shape)} does not match x {tuple(x_i8.shape)}"
            f" and {num_heads} heads of {head_dim}")
    require(scalars.numel() == 4, "scalars must hold [s_a, c1, 1/s1, s1/s2]")
    require(0 < npad <= attention.MAX_KEYS and b > 0,
            f"Npad={npad}: the kernel takes 1..{attention.MAX_KEYS} keys")
    require(head_dim <= 64 and head_dim % 4 == 0,
            f"head_dim={head_dim}: the kernel takes multiples of 4 up to 64")
    mb = per_weight(
        lambda: attention.fold_requant(mult, bias, scalars[2], c3)
        .contiguous(), mult, bias, scalars, c3, "p5_mb")
    wk = kmajor(w_all)
    x2 = pad_k(x_i8.reshape(b * npad, cin), wk.shape[1])
    require_tma_operand(x2, "x_i8")
    gp, ap = launch_plans(b, npad, cin, num_heads, head_dim,
                          sm_count(x_i8.device))
    qkv = torch.empty((b, npad, c3), dtype=torch.int8, device=x_i8.device)
    out = torch.empty((b, num_heads, npad, head_dim), dtype=torch.int8,
                      device=x_i8.device)
    err = load_library("probes").dvt_probe_qkv_attention_nv(
        x2.data_ptr(), wk.data_ptr(), mb.data_ptr(), scalars.data_ptr(),
        qkv.data_ptr(), out.data_ptr(), b, npad, wk.shape[1], num_heads,
        head_dim, *gp.launch_args(), *ap.launch_args(),
        torch.cuda.current_stream(x_i8.device).cuda_stream)
    check(err, "qkv_attention_nv", "probes")
    qkv_attention_nv.launches += 1
    return out


def core_footprint(batch=BATCH, dev=None):
    """{"registers", "local_bytes", "smem_bytes", "blocks_per_sm", "warps"}
    of the linear core at the legs' geometry and ``batch``'s plan on the
    current card.  Needs a card."""
    dev = dev or torch.device("cuda", torch.cuda.current_device())
    _, ap = launch_plans(batch, NP, C, H, D, sm_count(dev))
    out = [ctypes.c_int() for _ in range(4)]
    check(load_library("probes").dvt_probe_linear_core_footprint(
        NP, D, ap.warps, ap.smem, *map(ctypes.byref, out)),
        "dvt_probe_linear_core_footprint", "probes")
    return dict(zip(("registers", "local_bytes", "smem_bytes",
                     "blocks_per_sm"), (o.value for o in out)),
                warps=ap.warps)


qkv_attention_nv.launches = 0


def inputs(dev, batch=BATCH):
    """The script's operands, seeded: x (B, Npad, C) int8, w_all (C, 3C)
    int8 in [-8, 8), mult 2^-9, bias ~ N(0, 0.01), scalars [2^-4, 0.05, 24,
    1.3]."""
    rng = np.random.default_rng(0)
    t = lambda a, dt: torch.tensor(np.asarray(a), dtype=dt, device=dev)  # noqa
    x = t(rng.integers(-128, 128, (batch, NP, C)), torch.int8)
    w_all = t(rng.integers(-8, 8, (C, 3 * C)), torch.int8)
    mult = torch.full((3 * C,), 2.0**-9, dtype=torch.float32, device=dev)
    bias = t(rng.standard_normal(3 * C) * 0.01, torch.float32)
    scalars = t([2.0**-4, 0.05, 24.0, 1.3], torch.float32)
    return x, w_all, mult, bias, scalars


_HEADS = dict(num_heads=H, head_dim=D)
_K8 = dict(_HEADS, n_real=N, bits=4, lis=True)
# name -> (wrapper, its keyword arguments), as the script lists them; each
# takes (x_i8, w_all, mult, bias, scalars) and returns (B, H, Npad, D) int8
VARIANTS = {
    "k1_lis": (attention.fused_qkv_attention_v2,
               dict(_HEADS, n_real=N, bits=4, lis=True, lis_fast=True)),
    "k1_softmax": (attention.fused_qkv_attention_v2,
                   dict(_HEADS, n_real=N, bits=4, lis=False)),
    "p5_linear": (qkv_attention_nv, _HEADS),
    "v3": (attention.fused_qkv_attention_v3, _K8),
    "v4_group2": (attention.fused_qkv_attention_v4, dict(_K8, group=2)),
    "v4_group4": (attention.fused_qkv_attention_v4, dict(_K8, group=4)),
    "v5": (attention.fused_qkv_attention_v5, _K8),
}


def legs(dev):
    """Each variant chained DEPTH deep (its output, back in the (B, Npad, C)
    layout, feeds the next call, as ``ab_attn_overlap_r3.py:148-155`` chains
    them) at B = BATCH: ms per chain, and K1 minus P5, each as the median,
    min and max over the rounds (``timing``)."""
    x, *ops = inputs(dev)

    def chain(fn, kw):
        def run():
            xi = x
            for _ in range(DEPTH):
                xi = fn(xi, *ops, **kw).transpose(1, 2).reshape(BATCH, NP, C)
        return run

    rounds = rounds_ms({name: chain(fn, kw)
                        for name, (fn, kw) in VARIANTS.items()})
    costs = [{"lis_cost_ms": r["k1_lis"] - r["p5_linear"],
              "softmax_cost_ms": r["k1_softmax"] - r["p5_linear"]}
             for r in rounds]
    return {"batch": BATCH, "depth": DEPTH, "repeats": REPEATS,
            "ms": spread(rounds), **spread(costs)}


def main():
    run_main("attn_overlap", legs)


if __name__ == "__main__":
    main()
