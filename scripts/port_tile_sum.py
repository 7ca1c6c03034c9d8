"""Probe P4's kernel (``tile_sum``) timed on the card, and optionally its legs.

    python3 scripts/port_tile_sum.py [label] [--legs] [--sweep]

One JSON line each, for ``ingest.tile_sum`` on the legs' b = 64 uint8
batch cast to float32 (9408 x 1024), on the (1176, 1024) constant of
halves and on 528 elements (where the data cost nothing, so the time is
the kernel's fixed cost), and for ``torch.sum(x, dtype=torch.float64)``
on the same inputs (the function in one PyTorch call; the port never
calls it): the time by CUDA events (mean of 20 calls, host included), the
device time by kernel name (``torch.profiler``, mean of 10 calls,
profiled again up to three times while it records none), the kernel's
launches a call, and the output bit for bit against ``tile_sum_plain``.
Repeated calls find the inputs in the 50 MB L2 cache; the ``cold`` lines
read a 128 MB buffer before each call (so the input comes from device
memory, with no dirty lines to write back) and give the sum kernels'
device time alone.

With ``--sweep`` (a tree whose ``ingest`` has ``plan``): the same at both
large inputs for rings of other blocks an SM, stage counts and stage
sizes (``plan``'s arguments), and the served ring with a share shorter
than its full stages cut into ``stages`` shorter copies (``fitted``: at
(1176, 1024), 6 copies of 6,096 bytes in place of 32 KB and 4.5 KB); and
the kernel's fixed cost part by part (``tail``, without the data): one
block with no copy, one block with a 16-byte copy, and a block an SM
with a 16-byte copy each over 528 elements.  Every ``tile_sum`` line
also gives the sum kernels' device span a call, from the start of its
first kernel to the end of its last (the parent's two passes and the gap
between them; the median of 10 calls).  With ``--legs``, then ``ingest.legs`` once (its answers:
``pageable_over_pinned`` and ``drift`` with their spreads).

Each line carries ``label`` (default "tree").  The package is imported
from this script's checkout unless ``PYTHONPATH`` names another, so
running it with ``PYTHONPATH`` at a parent commit's checkout and without,
in turns within one call, compares the two on the same inputs.  Needs a
CUDA card; imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

# after PYTHONPATH's entries, so that PYTHONPATH can name another checkout
sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from diffvit_tpu_torch.ops.kernels.gemm import round_up, sm_count  # noqa: E402
from diffvit_tpu_torch.probes import ingest  # noqa: E402


def events_ms(fn, iters=20):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_by_kernel(fn, iters=10, tries=3):
    """Device milliseconds of one call by kernel name, after a warm-up,
    and the sum kernels' span a call: from the start of a call's first to
    the end of its last (with the parent's two passes, the gap between
    them too), the median over the calls (the profiler's first launches
    can stall; None where the profiler gives no kernel times)."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        times = {e.key: getattr(e, "self_device_time_total", 0) / 1e3 / iters
                 for e in prof.key_averages()}
        times = {k: v for k, v in times.items() if v > 0}
        if times:
            return times, span_ms(prof, iters)
    raise RuntimeError("torch.profiler saw no device time")


def span_ms(prof, iters):
    kernels = sorted((e.time_range.start, e.time_range.end, e.name)
                     for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and any(s in e.name for s in SUM_KERNELS))
    starts = [i for i, k in enumerate(kernels)
              if any(s in k[2] for s in FIRST_KERNELS)]
    if len(starts) != iters:
        return None
    ends = starts[1:] + [len(kernels)]
    return float(np.median([kernels[j - 1][1] - kernels[i][0]
                            for i, j in zip(starts, ends)])) / 1e3


# the sum kernels of either tree: the parent's two passes, the ring
SUM_KERNELS = ("partial_kernel", "final_kernel", "tile_sum_kernel")
FIRST_KERNELS = ("partial_kernel", "tile_sum_kernel")  # a call's first
# (blocks an SM, stages, most bytes a stage) of --sweep
RINGS = ((1, 6, 32768), (1, 4, 32768), (1, 8, 16384), (2, 3, 32768),
         (2, 4, 16384), (4, 3, 16384))


def timed(label, smi, name, at, fn, **extra):
    """One line: events ms and device ms of ``fn``; ``cold``: ``fn`` reads
    128 MB first, and the line counts the sum kernels alone."""
    times, span = device_by_kernel(fn)
    line = dict(tree=label, nvidia_smi=smi, kernel=name, at=at,
                ms=events_ms(fn), device_ms=sum(times.values()), **extra)
    if extra.get("cold"):  # the events also time the 128 MB read
        line["events_ms_with_flush"] = line.pop("ms")
        line["device_ms"] = sum(v for k, v in times.items()
                                if any(s in k for s in SUM_KERNELS))
    if name == "tile_sum":
        line["device_span_ms"] = span
    line["device_by_kernel"] = times
    print(json.dumps(line), flush=True)


def launch(x, p, want):
    """``ingest._launch`` by plan ``p``, checked once against ``want``."""
    got = ingest._launch(x, p)
    if not torch.equal(got, want):
        raise RuntimeError(f"tile_sum differs from the plain version by {p}")
    return lambda: ingest._launch(x, p)


def sweep(label, smi, xs, flush, sms):
    for at, x in xs.items():
        if x.numel() < 1 << 20:
            continue
        want = ingest.tile_sum_plain(x)
        rings = [(ring, ingest.plan(x.numel(), sms, *ring)) for ring in RINGS]
        served = ingest.plan(x.numel(), sms)
        fit = round_up(-(-4 * served.share // served.stages), 16)
        if fit < served.stage_bytes:  # the share cut into `stages` copies
            rings.append(("fitted", dataclasses.replace(
                served, stage_bytes=fit,
                smem=ingest.RING_OFFSET + served.stages * fit)))
        for ring, p in rings:
            fn = launch(x, p, want)
            timed(label, smi, "tile_sum", at, fn, ring=ring,
                  stage_bytes=p.stage_bytes)
            timed(label, smi, "tile_sum", at, lambda: (flush.sum(), fn()),
                  ring=ring, stage_bytes=p.stage_bytes, cold=True)
    # the fixed cost, part by part: one block with no copy, one block with
    # a 16-byte copy, 132 blocks with a 16-byte copy each
    x = xs["528 elements"]
    for at, p in (("0 elements", ingest.plan(0, sms)),
                  ("4 elements", ingest.plan(4, sms)),
                  ("528 elements", ingest.plan(528, sms, stage_bytes=16))):
        xp = x[:p.n]
        timed(label, smi, "tile_sum", at,
              launch(xp, p, ingest.tile_sum_plain(xp)), ring="tail",
              grid=p.grid, copies=sum(len(p.stage_ranges(b))
                                      for b in range(p.grid)))


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    label = args[0] if args else "tree"
    if not torch.cuda.is_available():
        sys.exit("port_tile_sum: no CUDA card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    rng = np.random.default_rng(0)
    xs = {"b=64 uint8 batch": torch.tensor(
        rng.integers(0, 255, ingest.SHAPE, dtype=np.uint8), device=dev)
        .reshape(ingest.FLAT).to(torch.float32),
          "1176x1024 halves": torch.full((1176, 1024), 0.5, device=dev),
          "528 elements": torch.tensor(rng.integers(0, 255, 528),
                                       dtype=torch.float32, device=dev)}
    flush = torch.ones(32 << 20, dtype=torch.float32, device=dev)
    for at, x in xs.items():
        before = ingest.tile_sum.launches
        equal = torch.equal(ingest.tile_sum(x), ingest.tile_sum_plain(x))
        launches = ingest.tile_sum.launches - before
        timed(label, smi, "tile_sum", at, lambda: ingest.tile_sum(x),
              launches_a_call=launches, bit_equal=equal)
        timed(label, smi, "tile_sum", at, lambda: (
            flush.sum(), ingest.tile_sum(x)), cold=True)
        timed(label, smi, "torch.sum", at,
              lambda: torch.sum(x, dtype=torch.float64))
    if "--sweep" in sys.argv:
        sweep(label, smi, xs, flush, sm_count(dev))
    if "--legs" in sys.argv:
        print(json.dumps(dict(tree=label, legs=ingest.legs(dev))), flush=True)


if __name__ == "__main__":
    main()
