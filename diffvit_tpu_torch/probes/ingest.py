"""Probe P4: what ingesting a b=64 batch costs, from pageable against pinned
host memory, beside device buffers.

The counterpart of ``scripts/ab_regime_discriminate.py``.  Its Pallas kernel
``_sum_kernel`` (``:45``; called by ``pallas_sum`` ``:51`` at ``:52`` and by
``xla_plus_mosaic_step`` ``:63`` at ``:66``) sums a float32 array into every
element of an (8, 128) float32 tile.  Here that is :func:`tile_sum`
(``csrc/probes/ingest.cu``: one launch of persistent blocks, each streaming
a contiguous share of the input through a ring of bulk asynchronous copies
and summing it in float64; the last block to finish sums the partials in a
fixed order and rounds once, so the result does not depend on the order of
the blocks).  :func:`plan` lays out the launch.  :func:`legs` feeds it a
(64, 3, 224, 224) uint8 batch (9.6 MB), cast to float32 on the device as
XLA cast it, from six sources in one process."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.kernels import check_for_kernel, require, route
from ..ops.kernels.build import check, load_library
from ..ops.kernels.gemm import H100_SMS, round_up, sm_count
from .timing import REPEATS, rounds_ms, run_main, spread

SHAPE = (64, 3, 224, 224)  # a b=64 uint8 batch, 9.6 MB
FLAT = (9408, 1024)        # the script's float32 view of it

# the launch (csrc/probes/ingest.cu): blocks of eight consumer warps and a
# producer warp, each with a ring of `stages` stages of `stage_bytes`
# (plan's defaults below)
STAGE_BYTES = 32768
STAGES = 6
MAX_STAGES = 8           # the kernel's barrier slots (kMaxStages)
RING_OFFSET = 128        # the barriers before the stages (kRingOffset)
SM_SMEM = 233_472        # shared memory of an SM, of which the card keeps
BLOCK_RESERVED = 1024    # this much a block


@dataclasses.dataclass(frozen=True)
class SumPlan:
    """One launch over ``n`` float32 elements: ``grid`` blocks, block ``b``
    summing ``[b * share, min(n, (b + 1) * share))`` through ``stages``
    ring stages of ``stage_bytes``, with ``smem`` bytes of dynamic shared
    memory."""
    n: int
    share: int
    grid: int
    stage_bytes: int
    stages: int
    smem: int

    def block_range(self, b: int) -> tuple[int, int]:
        lo = min(self.n, b * self.share)
        return lo, min(self.n, lo + self.share)

    def stage_ranges(self, b: int) -> list[tuple[int, int]]:
        """The element ranges of block ``b``'s bulk copies, in order."""
        lo, hi = self.block_range(b)
        per = self.stage_bytes // 4
        return [(at, min(hi, at + per)) for at in range(lo, hi, per)]

    def launch_args(self) -> tuple[int, ...]:
        """The numbers the C entry takes, in its order."""
        return (self.n, self.share, self.grid, self.stage_bytes, self.stages,
                self.smem)


def plan(n: int, sms: int = H100_SMS, blocks: int = 1, stages: int = STAGES,
         stage_bytes: int = STAGE_BYTES) -> SumPlan:
    """The launch for ``n`` elements (a multiple of 4) on a card of ``sms``
    SMs with ``blocks`` blocks an SM, each a ring of ``stages`` stages of
    ``stage_bytes``: at most one block a full stage of input (so a small
    input takes few blocks), each block's share a multiple of 4 elements
    (every copy then starts and ends on a 16-byte boundary of a 16-byte
    aligned input), and no block without input unless ``n`` is 0."""
    require(n >= 0 and n % 4 == 0, f"n={n}: the kernel takes a multiple of "
            "4 elements")
    require(blocks >= 1 and 2 <= stages <= MAX_STAGES
            and stage_bytes >= 16 and stage_bytes % 16 == 0
            and blocks * (RING_OFFSET + stages * stage_bytes
                          + BLOCK_RESERVED) <= SM_SMEM,
            f"no ring of {stages} x {stage_bytes} bytes at {blocks} blocks "
            "an SM")
    grid = max(1, min(sms * blocks, -(-n // (stage_bytes // 4))))
    share = round_up(-(-n // grid), 4)
    if share:
        grid = -(-n // share)
    return SumPlan(n=n, share=share, grid=grid, stage_bytes=stage_bytes,
                   stages=stages, smem=RING_OFFSET + stages * stage_bytes)


def tile_sum_plain(x):
    """Plain PyTorch version of :func:`tile_sum`: the float64 sum, rounded
    once to float32, in every element of an (8, 128) tile."""
    total = x.to(torch.float64).sum().to(torch.float32)
    return total.expand(8, 128).contiguous()


_SCRATCH: dict = {}


def _scratch(device: torch.device, stream: torch.cuda.Stream, grid: int):
    """The partials (at least ``grid``) and the ticket of the launches on
    ``stream``: made at the first call on it (the ticket zeroed) and kept,
    the partials grown where a plan has more blocks (each launch leaves the
    ticket 0), so a call allocates only its output, and no two streams
    share them."""
    key = (device.index, stream.cuda_stream)
    partials, ticket = _SCRATCH.get(key, (None, None))
    if ticket is None:
        ticket = torch.zeros(1, dtype=torch.int32, device=device)
    if partials is None or partials.numel() < grid:
        partials = torch.empty(grid, dtype=torch.float64, device=device)
    _SCRATCH[key] = partials, ticket
    return partials, ticket


def tile_sum(x):
    """x: float32, any shape, contiguous, a multiple of 4 elements.  Returns
    (8, 128) float32, each element the sum of x.  A CUDA tensor runs
    ``csrc/probes/ingest.cu`` (one launch, :func:`plan`'s); a CPU tensor
    :func:`tile_sum_plain`."""
    if route(x) == "cpu":
        return tile_sum_plain(x)
    check_for_kernel(x, "x", torch.float32, x.dim())
    require(x.numel() % 4 == 0, f"x has {x.numel()} elements, not a "
            "multiple of 4")
    return _launch(x, plan(x.numel(), sm_count(x.device)))


def _launch(x, p: SumPlan):
    """One launch of the kernel on ``x`` (checked by the caller) by plan
    ``p``, on the current stream."""
    dev = torch.device("cuda", x.device.index if x.device.index is not None
                       else torch.cuda.current_device())
    stream = torch.cuda.current_stream(dev)
    partials, ticket = _scratch(dev, stream, p.grid)
    out = torch.empty((8, 128), dtype=torch.float32, device=dev)
    err = load_library("probes").dvt_probe_tile_sum(
        x.data_ptr(), partials.data_ptr(), ticket.data_ptr(), out.data_ptr(),
        *p.launch_args(), stream.cuda_stream)
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
