"""Probe P4: what ingesting a b=64 batch costs, from pageable against pinned
host memory, beside device buffers.

The counterpart of ``scripts/ab_regime_discriminate.py``.  Its Pallas kernel
``_sum_kernel`` (``:45``; called by ``pallas_sum`` ``:51`` at ``:52`` and by
``xla_plus_mosaic_step`` ``:63`` at ``:66``) sums a float32 array into every
element of an (8, 128) float32 tile.  Here that is :func:`tile_sum`
(``csrc/probes/ingest.cu``: two passes in float64, rounded once, so the
result does not depend on the order of the blocks).  :func:`legs` feeds it a
(64, 3, 224, 224) uint8 batch (9.6 MB), cast to float32 on the device as
XLA cast it, from six sources in one process."""
from __future__ import annotations

import numpy as np
import torch

from ..ops.kernels import check_for_kernel, require, route
from ..ops.kernels.build import check, load_library
from .timing import REPEATS, rounds_ms, run_main, spread

SHAPE = (64, 3, 224, 224)  # a b=64 uint8 batch, 9.6 MB
FLAT = (9408, 1024)        # the script's float32 view of it
PARTIALS = 264             # blocks of the first pass (csrc/probes/ingest.cu)


def tile_sum_plain(x):
    """Plain PyTorch version of :func:`tile_sum`: the float64 sum, rounded
    once to float32, in every element of an (8, 128) tile."""
    total = x.to(torch.float64).sum().to(torch.float32)
    return total.expand(8, 128).contiguous()


def tile_sum(x):
    """x: float32, any shape, contiguous, a multiple of 4 elements.  Returns
    (8, 128) float32, each element the sum of x.  A CUDA tensor runs
    ``csrc/probes/ingest.cu``; a CPU tensor :func:`tile_sum_plain`."""
    if route(x) == "cpu":
        return tile_sum_plain(x)
    check_for_kernel(x, "x", torch.float32, x.dim())
    require(x.numel() % 4 == 0, f"x has {x.numel()} elements, not a "
            "multiple of 4")
    partial = torch.empty(PARTIALS, dtype=torch.float64, device=x.device)
    out = torch.empty((8, 128), dtype=torch.float32, device=x.device)
    err = load_library("probes").dvt_probe_tile_sum(
        x.data_ptr(), partial.data_ptr(), out.data_ptr(), x.numel(),
        torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "tile_sum", "probes")
    tile_sum.launches += 1
    return out


tile_sum.launches = 0


def legs(dev):
    """ms per step of six legs, each step a token update tok = tok / 2 +
    f(batch) as the script's: 1 the same device buffer; 2 eight fresh device
    buffers in turn; 3 a pageable host array copied in each step; 4 a
    pinned host tensor copied with non_blocking=True; 5 the script's leg 3,
    the device buffer feeding only a torch.sum while the kernel runs on a
    (1176, 1024) device constant of 0.5; 6 leg 1 again (drift).  In every
    leg the uint8 -> float32 cast is a torch op on the device.  Each number
    is the median, min and max over the rounds (``timing``)."""
    rng = np.random.default_rng(0)
    host = [rng.integers(0, 255, SHAPE).astype(np.uint8) for _ in range(8)]
    fresh = [torch.from_numpy(h).to(dev) for h in host]
    same = fresh[0]
    pinned = torch.from_numpy(host[0]).pin_memory()
    const = torch.full((1176, 1024), 0.5, dtype=torch.float32, device=dev)
    tok = [torch.zeros((), dtype=torch.float32, device=dev)]
    i = [0]

    def consume(xd):
        xf = xd.reshape(FLAT).to(torch.float32)
        tok[0] = tok[0] * 0.5 + tile_sum(xf)[0, 0] * 1e-9

    def nxt():
        i[0] += 1
        return i[0]

    def sum_beside_kernel():
        s = torch.sum(same, dtype=torch.int32).to(torch.float32)
        m = tile_sum(const)[0, 0]
        tok[0] = tok[0] * 0.5 + s + 0.0 * m

    def same_buffer():
        consume(same)

    rounds = rounds_ms({
        "1_same_device_buffer": same_buffer,
        "2_fresh_device_buffers": lambda: consume(fresh[nxt() % 8]),
        "3_pageable_host_copy": lambda: consume(
            torch.from_numpy(host[0]).to(dev)),
        "4_pinned_host_copy": lambda: consume(
            pinned.to(dev, non_blocking=True)),
        "5_sum_beside_kernel_on_constant": sum_beside_kernel,
        "6_same_device_buffer_again": same_buffer})
    ratios = [{"pageable_over_pinned": r["3_pageable_host_copy"]
               / r["4_pinned_host_copy"],
               "drift": r["6_same_device_buffer_again"]
               / r["1_same_device_buffer"]} for r in rounds]
    return {"batch_bytes": int(np.prod(SHAPE)), "repeats": REPEATS,
            "ms_per_step": spread(rounds), **spread(ratios),
            "finite": bool(torch.isfinite(tok[0]))}


def main():
    run_main("ingest", legs)


if __name__ == "__main__":
    main()
