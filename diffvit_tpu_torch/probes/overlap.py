"""Probe P2: does SIMT work overlap tensor-core work in one kernel, and does
a data dependency on the mma result change that?

The counterpart of ``scripts/overlap_probe.py``, whose ``build`` (``:70``,
call at ``:71``) makes five Pallas kernels over the same shapes, y = a @ b
(bfloat16, float32 out) and chain(x) = 220 steps of x = tanh(x) + 0.25 x:

    dot_only          o = y,             o2 = v
    vpu_only          o = 0,             o2 = chain(v)
    dot_vpu_consume   o = chain(y),      o2 = v
    dot_vpu_in_join   o = y + chain(v),  o2 = v
    dot_vpu_in_split  o = y,             o2 = chain(v)

One kernel per mode, ``csrc/probes/overlap.cu`` (a bf16 ``mma.sync`` tile;
the chain with ``tanhf``).  :func:`legs` sizes the chain so that it takes
about as long as the dot alone, as the script sized its 220 steps, then
times the five modes and reports /sum and /max."""
from __future__ import annotations

import numpy as np
import torch

from ..ops.kernels import check_for_kernel, require, route
from ..ops.kernels.build import check, load_library
from .timing import REPEATS, medians, rounds_ms, run_main, spread

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
        require(m % 64 == 0 and n % 64 == 0 and k % 32 == 0 and m * n > 0,
                f"M={m} and N={n} must be multiples of 64, K={k} of 32")
        require(iters >= 0, f"iters={iters}")
        o, o2 = torch.empty_like(v), torch.empty_like(v)
        err = load_library("probes").dvt_probe_overlap(
            a.data_ptr(), b.data_ptr(), v.data_ptr(), o.data_ptr(),
            o2.data_ptr(), m, n, k, MODES.index(mode), iters,
            torch.cuda.current_stream(a.device).cuda_stream)
        check(err, mode, "probes")
        fn.launches += 1
        return o, o2

    fn.__name__ = fn.__qualname__ = mode
    fn.__doc__ = (f"Mode {mode}: a (M, K) bfloat16, b (K, N) bfloat16, v (M, "
                  "N) float32 -> (o, o2), (M, N) float32 each.  A CUDA tensor "
                  "runs csrc/probes/overlap.cu; a CPU tensor overlap_plain.")
    fn.launches = 0
    return fn


dot_only, vpu_only, dot_vpu_consume, dot_vpu_in_join, dot_vpu_in_split = \
    (_wrapper(m) for m in MODES)
KERNELS = {f.__name__: f for f in (dot_only, vpu_only, dot_vpu_consume,
                                   dot_vpu_in_join, dot_vpu_in_split)}


def inputs(dev, rows=ROWS):
    """a (rows, K) and b (K, N) bfloat16 and v (rows, N) float32, all
    N(0, 1)."""
    rng = np.random.default_rng(0)
    t = lambda shape, dt: torch.tensor(  # noqa: E731
        rng.standard_normal(shape, dtype=np.float32), device=dev).to(dt)
    return t((rows, K), torch.bfloat16), t((K, N), torch.bfloat16), \
        t((rows, N), torch.float32)


def legs(dev):
    """The chain length that makes vpu_only take about as long as dot_only
    (ITERS * t_dot / t_vpu(ITERS), the script's sizing rule, on the
    medians), then every mode's ms at that length, /sum and /max, each as
    the median, min and max over the rounds (``timing``), and the script's
    verdicts on the medians: consume serializes (> 0.8 of the sum), split
    overlaps (< 0.75)."""
    a, b, v = inputs(dev)

    def run(mode, iters):
        return lambda: KERNELS[mode](a, b, v, iters=iters)

    sizing = medians(rounds_ms({"dot_only": run("dot_only", ITERS),
                                "vpu_only": run("vpu_only", ITERS)}))
    iters = max(1, round(ITERS * sizing["dot_only"] / sizing["vpu_only"]))
    rounds = rounds_ms({mode: run(mode, iters) for mode in MODES})
    out = {"rows": ROWS, "repeats": REPEATS,
           f"vpu_only_ms_at_{ITERS}": sizing["vpu_only"], "iters": iters,
           "ms": spread(rounds)}
    ms = medians(rounds)
    if ms["vpu_only"] < 0.5 * ms["dot_only"]:
        return dict(out, verdict="INCONCLUSIVE: the chain is too short")
    ratios = []
    for r in rounds:
        total, most = r["dot_only"] + r["vpu_only"], max(r["dot_only"],
                                                         r["vpu_only"])
        ratios.append({f"{m}_over_{k}": r[m] / d for m in MODES[2:]
                       for k, d in (("sum", total), ("max", most))})
    ratio = spread(ratios)
    consume_serial = ratio["dot_vpu_consume_over_sum"]["median"] > 0.8
    split_overlaps = ratio["dot_vpu_in_split_over_sum"]["median"] < 0.75
    return dict(out, **ratio, consume_serializes=consume_serial,
                split_overlaps=split_overlaps,
                verdict="HOLDS" if consume_serial and split_overlaps
                else "CHANGED")


def main():
    run_main("overlap", legs)


if __name__ == "__main__":
    main()
