"""Probe P2: does SIMT work overlap tensor-core work in one kernel, and does
a data dependency on the product change that?

The counterpart of ``scripts/overlap_probe.py``, whose ``build`` (``:71``)
makes five Pallas kernels over the same shapes, y = a @ b (bfloat16,
float32 out) and chain(x) = 220 steps of x = tanh(x) + 0.25 x:

    dot_only          o = y,             o2 = v
    vpu_only          o = 0,             o2 = chain(v)
    dot_vpu_consume   o = chain(y),      o2 = v
    dot_vpu_in_join   o = y + chain(v),  o2 = v
    dot_vpu_in_split  o = y,             o2 = chain(v)

One kernel per mode, ``csrc/probes/overlap.cu``: TMA and bf16 ``wgmma``
products on the served GEMMs' ring and roles, v and both outputs streamed
in 16-byte vectors, and the chain (``tanhf``) on the consumer warpgroups,
between each stage's ``wgmma`` commit and wait in the input-rooted modes;
its plan is ``ops/kernels/overlap_plan.overlap_plan``.  :func:`legs` sizes
the chain so that ``vpu_only`` takes about as long as ``dot_only``, from a
line through ``vpu_only``'s time at two chain lengths (a floor, the bytes
every mode moves, and a slope a step), then times the five modes and
reports /sum and /max.  :func:`chain_instructions` counts a chain step's
instructions in the built library's SASS (the bound of the chain
modes)."""
from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from ..ops.kernels import check_for_kernel, require, route
from ..ops.kernels.build import (check, find_nvcc, library_path,
                                 load_library)
from ..ops.kernels.gemm import sm_count
from ..ops.kernels.overlap_plan import overlap_plan
from .timing import REPEATS, rounds_ms, run_main, spread

ROWS, K, N = 64 * 512, 512, 512  # the script's 64 grid steps of 512 rows
ITERS = 220                      # the script's chain length
MODES = ("dot_only", "vpu_only", "dot_vpu_consume", "dot_vpu_in_join",
         "dot_vpu_in_split")


def vpu_chain(x, iters):
    """``iters`` steps of x = tanh(x) + 0.25 x (``_vpu_chain``, ``:32``)."""
    for _ in range(iters):
        x = torch.tanh(x) + 0.25 * x
    return x


def dot_plain(a, b):
    """a @ b of bfloat16 operands: the exact float64 sum, rounded once to
    float32 (the products are exact; only the kernel's summation order
    differs)."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)) \
        .to(torch.float32)


def overlap_plain(a, b, v, mode, iters=ITERS):
    """Plain PyTorch version of mode ``mode``: (o, o2)."""
    if mode == "vpu_only":
        return torch.zeros_like(v), vpu_chain(v, iters)
    y = dot_plain(a, b)
    if mode == "dot_only":
        return y, v.clone()
    if mode == "dot_vpu_consume":
        return vpu_chain(y, iters), v.clone()
    if mode == "dot_vpu_in_join":
        return y + vpu_chain(v, iters), v.clone()
    if mode == "dot_vpu_in_split":
        return y, vpu_chain(v, iters)
    raise ValueError(f"unknown mode {mode!r}")


DOT_TOL = 2.0**-13   # of sum_k |a_ik b_kj|
CHAIN_TOL = 2.0**-18  # of max(1, |chain|)


def compare(mode, a, b, got, want, iters=ITERS):
    """Hold mode ``mode``'s outputs ``got`` against ``want`` (pairs (o,
    o2)) for a chain of ``iters`` steps; returns (share of elements within
    tolerance, max |got - want|, whether every element passes).

    * y = a @ b: within y_tol = DOT_TOL * sum_k |a_ik b_kj| of the exact
      sum.  The products are exact in float32; a float32 sum of K = 512
      terms in any order is within (K - 1) 2^-24 = 2^-15 of that sum of
      magnitudes, and the factor 4 leaves room for a tensor core's
      accumulation, which need not round to nearest.
    * chain(x): within chain_tol = CHAIN_TOL * max(1, |chain(x)|).  The map
      contracts by about 0.65 a step near its fixed points (+-1.03), so the
      roundings of tanh (2 ulp) and of the add settle at a few ulp; near 0
      it expands by 1.25 a step, but there an error is as small as x.
    * chain(y) (consume): the map x -> tanh(x) + 0.25 x is strictly
      increasing, so the chain of any y' within y_tol of the exact y lies
      between chain(y - y_tol) and chain(y + y_tol) (float64); that
      interval, widened by chain_tol for the float32 chain's roundings.
    * copies of v and the zero output: exact."""
    a64, b64 = a.to(torch.float64), b.to(torch.float64)
    y = y_tol = None
    if mode != "vpu_only":
        y = torch.matmul(a64, b64)
        y_tol = DOT_TOL * torch.matmul(a64.abs(), b64.abs())
    chain_tol = [CHAIN_TOL * torch.clamp(w.to(torch.float64).abs(), min=1.0)
                 for w in want]
    if mode == "dot_vpu_consume":
        # o against the interval, o2 (a copy of v) against want exactly
        lo = vpu_chain(y - y_tol, iters) - chain_tol[0]
        hi = vpu_chain(y + y_tol, iters) + chain_tol[0]
        o = got[0].to(torch.float64)
        within = [(lo <= o) & (o <= hi), got[1] == want[1]]
        errs = [float((o - want[0].to(torch.float64)).abs().max()),
                float((got[1] - want[1]).abs().max())]
    else:
        tol = {"dot_only": lambda: (y_tol, 0.0),
               "vpu_only": lambda: (0.0, chain_tol[1]),
               "dot_vpu_in_join": lambda: (y_tol + chain_tol[0], 0.0),
               "dot_vpu_in_split": lambda: (y_tol, chain_tol[1])}[mode]()
        within, errs = [], []
        for g, w, t in zip(got, want, tol):
            err = (g.to(torch.float64) - w.to(torch.float64)).abs()
            within.append(err <= t)
            errs.append(float(err.max()))
    share = float(torch.cat([w.flatten() for w in within]).float().mean())
    return share, max(errs), all(bool(w.all()) for w in within)


def _wrapper(mode):
    def fn(a, b, v, *, iters=ITERS):
        if route(a, b, v) == "cpu":
            return overlap_plain(a, b, v, mode, iters)
        check_for_kernel(a, "a", torch.bfloat16, 2)
        check_for_kernel(b, "b", torch.bfloat16, 2)
        check_for_kernel(v, "v", torch.float32, 2)
        (m, k), n = a.shape, b.shape[1]
        require(b.shape[0] == k and v.shape == (m, n),
                f"a {tuple(a.shape)}, b {tuple(b.shape)}, v {tuple(v.shape)} "
                "do not match")
        require(iters >= 0, f"iters={iters}")
        plan = overlap_plan(m, n, k, sm_count(a.device))
        o, o2 = torch.empty_like(v), torch.empty_like(v)
        err = load_library("probes").dvt_probe_overlap(
            a.data_ptr(), b.data_ptr(), v.data_ptr(), o.data_ptr(),
            o2.data_ptr(), m, n, k, MODES.index(mode), iters,
            *plan.launch_args(),
            torch.cuda.current_stream(a.device).cuda_stream)
        check(err, mode, "probes")
        fn.launches += 1
        return o, o2

    fn.__name__ = fn.__qualname__ = mode
    fn.__doc__ = (f"Mode {mode}: a (M, K) bfloat16, b (K, N) bfloat16, v (M, "
                  "N) float32 -> (o, o2), (M, N) float32 each; M and N "
                  "multiples of 64, K of 32.  A CUDA tensor runs "
                  "csrc/probes/overlap.cu; a CPU tensor overlap_plain.")
    fn.launches = 0
    return fn


dot_only, vpu_only, dot_vpu_consume, dot_vpu_in_join, dot_vpu_in_split = \
    (_wrapper(m) for m in MODES)
KERNELS = {f.__name__: f for f in (dot_only, vpu_only, dot_vpu_consume,
                                   dot_vpu_in_join, dot_vpu_in_split)}


def inputs(dev, rows=ROWS, n=N, k=K):
    """a (rows, k) and b (k, n) bfloat16 and v (rows, n) float32, all
    N(0, 1); the script's N and K unless given."""
    rng = np.random.default_rng(0)
    t = lambda shape, dt: torch.tensor(  # noqa: E731
        rng.standard_normal(shape, dtype=np.float32), device=dev).to(dt)
    return t((rows, k), torch.bfloat16), t((k, n), torch.bfloat16), \
        t((rows, n), torch.float32)


def footprint(mode, rows=ROWS, dev=None):
    """{"registers" (a thread at launch), "local_bytes" (spills),
    "smem_bytes", "blocks_per_sm"} of mode ``mode``'s kernel at its plan
    for ``rows`` rows, and the plan's register split by role.  Needs a
    card."""
    dev = dev or torch.device("cuda", torch.cuda.current_device())
    plan = overlap_plan(rows, N, K, sm_count(dev))
    out = [ctypes.c_int() for _ in range(4)]
    check(load_library("probes").dvt_probe_overlap_footprint(
        MODES.index(mode), plan.smem, *map(ctypes.byref, out)),
        "dvt_probe_overlap_footprint", "probes")
    f = dict(zip(("registers", "local_bytes", "smem_bytes", "blocks_per_sm"),
                 (o.value for o in out)))
    f["roles"] = {r.name: dict(warps=r.warps, registers=r.registers)
                  for r in plan.roles}
    return f


SIZING = (0, ITERS)  # the chain lengths of the sizing fit


def size_chain(rounds):
    """The chain length for the legs from sizing rounds of ``dot_only`` and
    of ``vpu_only`` at the two SIZING lengths: a line t_vpu(iters) = floor
    + slope * iters through them (per round, then the medians), and the
    length at which the line meets dot_only's time, iters = (t_dot -
    floor) / slope, at least 1: the script's rule (vpu_only about as long
    as dot_only; ITERS * t_dot / t_vpu(ITERS) took the floor as 0).  The
    floor is the bytes every mode moves (vpu_only with no steps copies v
    and writes zeros).  Returns ({"floor_ms", "slope_ms", each as the
    median, min and max over the rounds}, iters, the reason the answer is
    inconclusive or None).  Inconclusive where dot_only's median lies
    within its spread (max - min) of the floor: dot_only then took the
    bytes every mode moves, and the ratios would measure the bytes, not the
    pipes; and where the sized chain's work (slope * iters) comes to less
    than the floor: every mode is then bound by the bytes it moves, and the
    chain is too small a share of each to show whether it overlaps."""
    short, long_ = SIZING
    fit = []
    for r in rounds:
        slope = (r[f"vpu_only_{long_}"] - r[f"vpu_only_{short}"]) \
            / (long_ - short)
        fit.append({"floor_ms": r[f"vpu_only_{short}"] - slope * short,
                    "slope_ms": slope})
    fit = spread(fit)
    dot = spread(rounds)["dot_only"]
    floor, slope = fit["floor_ms"]["median"], fit["slope_ms"]["median"]
    iters = max(1, round((dot["median"] - floor) / slope)) if slope > 0 \
        else ITERS
    reason = None
    if dot["median"] - floor <= dot["max"] - dot["min"]:
        reason = (f"dot_only ({dot['median']:.4f} ms) is within its spread "
                  f"({dot['max'] - dot['min']:.4f} ms) of vpu_only's floor "
                  f"({floor:.4f} ms): it took the bytes every mode moves, so "
                  "the ratios measure the bytes, not the pipes")
    elif slope * iters < floor:
        reason = (f"the chain's {iters} steps take {slope * iters:.4f} ms, "
                  f"less than vpu_only's floor ({floor:.4f} ms): every mode "
                  "is bound by the bytes it moves, so the ratios measure "
                  "the bytes, not the pipes")
    return fit, iters, reason


def legs(dev):
    """The chain length from :func:`size_chain` (sizing rounds of dot_only
    and of vpu_only at the SIZING lengths), then every mode's ms at that
    length, /sum and /max, each as the median, min and max over the rounds
    (``timing``), and the script's verdicts on the medians: consume
    serializes (> 0.8 of the sum), split overlaps (< 0.75).  INCONCLUSIVE,
    with its reason and the ratios beside it, where dot_only sits at the
    floor or the chain came out too short."""
    a, b, v = inputs(dev)

    def run(mode, iters):
        return lambda: KERNELS[mode](a, b, v, iters=iters)

    sizing = rounds_ms({"dot_only": run("dot_only", ITERS),
                        **{f"vpu_only_{n}": run("vpu_only", n)
                           for n in SIZING}})
    fit, iters, reason = size_chain(sizing)
    rounds = rounds_ms({mode: run(mode, iters) for mode in MODES})
    out = {"rows": ROWS, "repeats": REPEATS, "sizing_ms": spread(sizing),
           **fit, "iters": iters, "ms": spread(rounds)}
    ratios = []
    for r in rounds:
        total, most = r["dot_only"] + r["vpu_only"], max(r["dot_only"],
                                                         r["vpu_only"])
        ratios.append({f"{m}_over_{k}": r[m] / d for m in MODES[2:]
                       for k, d in (("sum", total), ("max", most))})
    ratio = spread(ratios)
    ms = out["ms"]
    if reason is None and ms["vpu_only"]["median"] \
            < 0.5 * ms["dot_only"]["median"]:
        reason = "the chain is too short"
    consume_serial = ratio["dot_vpu_consume_over_sum"]["median"] > 0.8
    split_overlaps = ratio["dot_vpu_in_split_over_sum"]["median"] < 0.75
    verdict = f"INCONCLUSIVE: {reason}" if reason else \
        "HOLDS" if consume_serial and split_overlaps else "CHANGED"
    return dict(out, **ratio, consume_serializes=consume_serial,
                split_overlaps=split_overlaps, verdict=verdict)


# SASS opcodes by the unit that runs them: the special-function unit (16
# results a clock an SM on an H100) and the float32 pipe (128 a clock)
SFU_OPS = ("MUFU",)
FP32_OPS = ("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FSET", "FCHK",
            "FSWZADD")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                   r"([A-Z][A-Z0-9_.]*)([^;]*)")
_LABEL = re.compile(r"^\s*\.(L_x_\d+):")
_TARGET = re.compile(r"`?\(\.(L_x_\d+)\)|\s(0x[0-9a-f]+)\b")


def sass_loops(sass: str) -> list[dict]:
    """The loops of one function's SASS (``cuobjdump -sass`` text): each
    backward branch (to a label, or to an address, as cuobjdump prints
    it) and the instructions from its target to the branch, as
    {"opcodes": [...], "branches": branches inside}."""
    labels, at, opcodes, loops = {}, {}, [], []
    for line in sass.splitlines():
        lab = _LABEL.match(line)
        if lab:
            labels[lab.group(1)] = len(opcodes)
            continue
        ins = _INSN.search(line)
        if not ins:
            continue
        at[int(ins.group(1), 16)] = len(opcodes)
        opcodes.append(ins.group(2))
        target = _TARGET.search(ins.group(3))
        if not (ins.group(2).startswith("BRA") and target):
            continue
        start = labels.get(target.group(1)) if target.group(1) \
            else at.get(int(target.group(2), 16))
        if start is not None:  # a backward branch: its target came first
            body = opcodes[start:]
            loops.append({"opcodes": body, "branches": sum(
                op.startswith("BRA") for op in body[:-1])})
    return loops


def count_chain(sass: str, steps: int = 32) -> dict:
    """A chain step's instructions from vpu_only's SASS: the innermost loop
    with at least ``steps`` special-function instructions (the chain's
    step loop, whose body is 32 steps: ``chain`` in overlap.cu), by unit,
    each divided by ``steps``."""
    loops = [lp for lp in sass_loops(sass)
             if sum(op.startswith(SFU_OPS) for op in lp["opcodes"]) >= steps]
    require(loops, f"no loop of {steps} special-function instructions or "
            "more in the SASS")
    body = min(loops, key=lambda lp: len(lp["opcodes"]))  # the innermost
    ops = body["opcodes"]
    base = [op.split(".")[0] for op in ops]
    mufu = sum(op in SFU_OPS for op in base)
    fp32 = sum(op in FP32_OPS for op in base)
    return {"sfu": mufu / steps, "fp32": fp32 / steps,
            "other": (len(ops) - mufu - fp32) / steps,
            "instructions": len(ops) / steps, "loop_instructions": len(ops),
            "loop_branches": body["branches"],
            "mufu": sorted({op for op in ops if op.startswith("MUFU")})}


def chain_instructions(path: Path | None = None) -> dict:
    """:func:`count_chain` of the vpu_only kernel in the built probes
    library's SASS, read by the CUDA toolkit's ``cuobjdump``.  Needs the
    library built (on the card's machine)."""
    path = path or library_path("probes")
    tool = shutil.which("cuobjdump") or str(Path(find_nvcc()).with_name(
        "cuobjdump"))
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    name = "overlap_kernelILi1EE"  # overlap_kernel<1>: vpu_only
    funcs = re.split(r"\n\s*Function : ", sass)
    body = [f for f in funcs if f.split("\n", 1)[0].find(name) >= 0]
    require(len(body) == 1, f"{len(body)} functions named *{name}* in "
            f"{path.name}'s SASS")
    return dict(count_chain(body[0]), function=body[0].split("\n", 1)[0]
                .strip())


def main():
    run_main("overlap", legs)


if __name__ == "__main__":
    main()
