"""Probe P3: K2's structure in five modes, to see what its GELU costs and
what a software-pipelined K loop, and issuing the next sub-block's fc1
before the current GELU, buy.

The counterpart of ``scripts/overlap_probe_mlp.py``, whose Pallas kernel
``_kernel`` (``:36``, built at ``:95``, called at ``:97``) runs, per
sub-block of rows,

    mid  = (x_i8 @ w1) * mult1 + bias1
    g    = gelu(mid) [dot, pipelined, staged], gelu(g_src) [input],
           mid [nogelu]
    h    = clip(rint(g * s_q1_inv))
    y    = (h @ w2) * mult2 + bias2
    out  = clip(rint(y * inv_out)) * out_scale + mid[:, :Cout] * 1e-8

``pipelined``: the K loop double-buffered (``cp.async``), and the next
sub-block's fc1, its loads and its first ``mma``, issued before the current
GELU; ``staged``, a fifth mode the script does not have: the same K loop
with each GELU after its own sub-block's loop, which separates what the
staged loop buys from what the early issue costs.  v1 = [mult1, bias1] (2,
Hid); v2 = [mult2, bias2, out_scale, inv_out] (4, Cout); scal = [s_q1_inv].
The kernels are ``csrc/probes/overlap_mlp.cu``.  :func:`legs` times the
five modes and the port's K2 (``fused_int_mlp``) at the script's DeiT-S
b=256 geometry."""
from __future__ import annotations

import numpy as np
import torch

from ..ops.kernels import check_for_kernel, mlp, require, route
from ..ops.kernels.build import check, load_library
from ..ops.quant import int_matmul
from .timing import REPEATS, occupancy, rounds_ms, run_main, spread

CIN, HID = 384, 1536  # DeiT-S MLP
ROWS = 99 * 512       # 197 tokens x 256 images, padded to 512-row blocks
MODES = ("dot", "input", "nogelu", "pipelined", "staged")


def overlap_mlp_plain(x_i8, w1, w2, v1, v2, g_src, scal, mode):
    """Plain PyTorch version of mode ``mode`` (``pipelined`` and ``staged``
    compute what ``dot`` computes)."""
    require(mode in MODES, f"unknown mode {mode!r}")
    cout = w2.shape[1]
    mid = int_matmul(x_i8, w1).to(torch.float32) * v1[0] + v1[1]
    src = g_src if mode == "input" else mid
    g = src if mode == "nogelu" else mlp.gelu_poly(src)
    h = torch.clamp(torch.round(g * scal[0]), -128, 127).to(torch.int8)
    y = int_matmul(h, w2).to(torch.float32) * v2[0] + v2[1]
    codes = torch.clamp(torch.round(y * v2[3]), -128, 127)
    return codes * v2[2] + mid[:, :cout] * 1e-8


def _wrapper(mode):
    def fn(x_i8, w1, w2, v1, v2, g_src, scal):
        args = (x_i8, w1, w2, v1, v2, g_src, scal)
        if route(*args) == "cpu":
            return overlap_mlp_plain(*args, mode)
        for t, name, dt in ((x_i8, "x_i8", torch.int8), (w1, "w1", torch.int8),
                            (w2, "w2", torch.int8), (v1, "v1", torch.float32),
                            (v2, "v2", torch.float32),
                            (g_src, "g_src", torch.float32)):
            check_for_kernel(t, name, dt, 2)
        check_for_kernel(scal, "scal", torch.float32, 1)
        rows, cin = x_i8.shape
        hid = w1.shape[1]
        require(w1.shape == (cin, hid) and w2.shape == (hid, cin)
                and hid >= cin,
                f"w1 {tuple(w1.shape)} / w2 {tuple(w2.shape)} do not chain "
                f"from x {tuple(x_i8.shape)} back to its width through a "
                "hidden width at least as wide (the keep-alive reads "
                "mid[:, :Cin])")
        require(v1.shape == (2, hid) and v2.shape == (4, cin)
                and g_src.shape == (rows, hid) and scal.numel() == 1,
                "v1 (2, Hid), v2 (4, Cin), g_src (rows, Hid), scal (1,)")
        require(rows > 0 and cin % 32 == 0 and hid % 32 == 0,
                f"Cin={cin} and Hid={hid} must be multiples of 32")
        require(all(t.data_ptr() % 16 == 0 for t in (x_i8, w1, w2)),
                "x_i8, w1 and w2 must be 16-byte aligned (16-byte loads)")
        hidden = torch.empty((rows, hid), dtype=torch.int8, device=x_i8.device)
        keep = torch.empty((rows, cin), dtype=torch.float32,
                           device=x_i8.device)
        out = torch.empty_like(keep)
        err = load_library("probes").dvt_probe_overlap_mlp(
            *(t.data_ptr() for t in args), hidden.data_ptr(), keep.data_ptr(),
            out.data_ptr(), rows, cin, hid, MODES.index(mode),
            torch.cuda.current_stream(x_i8.device).cuda_stream)
        check(err, f"mlp_{mode}", "probes")
        fn.launches += 1
        return out

    fn.__name__ = fn.__qualname__ = f"mlp_{mode}"
    fn.__doc__ = (f"Mode {mode}: x_i8 (rows, Cin) int8, w1 (Cin, Hid), w2 "
                  "(Hid, Cin) int8, v1 (2, Hid), v2 (4, Cin), g_src (rows, "
                  "Hid), scal (1,) float32 -> (rows, Cin) float32.  A CUDA "
                  "tensor runs csrc/probes/overlap_mlp.cu; a CPU tensor "
                  "overlap_mlp_plain.")
    fn.launches = 0
    return fn


mlp_dot, mlp_input, mlp_nogelu, mlp_pipelined, mlp_staged = \
    (_wrapper(m) for m in MODES)
KERNELS = {f.__name__: f for f in (mlp_dot, mlp_input, mlp_nogelu,
                                   mlp_pipelined, mlp_staged)}


def fc1_occupancy(mode):
    """{"registers", "smem_bytes", "blocks_per_sm"} of mode ``mode``'s fc1
    kernel on the current card.  Needs a card."""
    return occupancy(load_library("probes")
                     .dvt_probe_overlap_mlp_fc1_occupancy, MODES.index(mode))


def inputs(dev, rows=ROWS):
    """The script's operands, seeded: x = clip(rint(N(0, 1) * 10)) int8, w1
    and w2 int8 in [-127, 127], v1 = [1e-3, 0], v2 = [1e-3, 0, 0.05, 20],
    g_src N(0, 1), scal [16]."""
    rng = np.random.default_rng(0)
    t = lambda a, dt: torch.tensor(np.asarray(a), dtype=dt, device=dev)  # noqa
    x = t(np.clip(np.round(rng.standard_normal((rows, CIN)) * 10), -128,
                  127), torch.int8)
    w1 = t(rng.integers(-127, 128, (CIN, HID)), torch.int8)
    w2 = t(rng.integers(-127, 128, (HID, CIN)), torch.int8)
    v1 = t(np.outer([1e-3, 0.0], np.ones(HID)), torch.float32)
    v2 = t(np.outer([1e-3, 0.0, 0.05, 20.0], np.ones(CIN)), torch.float32)
    g_src = t(rng.standard_normal((rows, HID), dtype=np.float32),
              torch.float32)
    scal = t([16.0], torch.float32)
    return x, w1, w2, v1, v2, g_src, scal


def production_args(x_i8, w1, w2, v1, v2, g_src, scal):
    """The port's K2 (``fused_int_mlp``) arguments on the same operands:
    mult1, bias1, mult2, bias2, the out scale and s_q1 = 1/s_q1_inv;
    float32 out."""
    return x_i8, w1, w2, v1[0], v1[1], v2[0], v2[1], v2[2], 1.0 / scal[0]


def legs(dev):
    """ms per call of A (GELU from the dot), B (GELU from an input), C (no
    GELU), P (pipelined), S (staged) and D (the port's K2,
    ``fused_int_mlp``, on the same operands) at ROWS rows, and the
    differences that answer the script's questions, each as the median,
    min and max over the rounds (``timing``); and each mode's fc1
    footprint (registers, shared memory, blocks an SM), which bounds how
    many warps hide its latency."""
    args = inputs(dev)
    k2 = production_args(*args)
    rounds = rounds_ms({
        "A_gelu_from_dot": lambda: mlp_dot(*args),
        "B_gelu_from_input": lambda: mlp_input(*args),
        "C_no_gelu": lambda: mlp_nogelu(*args),
        "P_pipelined": lambda: mlp_pipelined(*args),
        "S_staged": lambda: mlp_staged(*args),
        "D_production": lambda: mlp.fused_int_mlp(*k2)})
    answers = [{"gelu_cost_ms": r["A_gelu_from_dot"] - r["C_no_gelu"],
                "input_over_dot": r["B_gelu_from_input"]
                / r["A_gelu_from_dot"],
                "pipelined_over_dot": r["P_pipelined"] / r["A_gelu_from_dot"],
                "staged_over_dot": r["S_staged"] / r["A_gelu_from_dot"],
                "production_over_dot": r["D_production"]
                / r["A_gelu_from_dot"]}
               for r in rounds]
    return {"rows": ROWS, "repeats": REPEATS, "ms": spread(rounds),
            **spread(answers),
            "fc1_footprint": {mode: fc1_occupancy(mode) for mode in MODES}}


def main():
    run_main("overlap_mlp", legs)


if __name__ == "__main__":
    main()
