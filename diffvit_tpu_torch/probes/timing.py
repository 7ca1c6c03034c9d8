"""Device time of a chain of calls, from CUDA events, repeated for a median
and a spread; and a kernel's footprint (registers, shared memory, blocks an
SM), read beside its time.

Every probe's legs take the same counts, for one reason: a leg's answer is
a difference or a ratio of a few percent, so each timing must be well
above the events' resolution (~0.5 us) and the spread between repeats must
be seen beside it.  ``WARMUP`` calls absorb a kernel's first-call costs
(the module load, the caching allocator's first blocks); ``STEPS`` calls a
timing put even the shortest leg (P4's ~0.03 ms kernel) above 0.3 ms;
``REPEATS`` rounds, each timing every leg of a probe in turn, give a median
and a (min, max) spread and let slow drift of the clocks touch every leg
alike."""
from __future__ import annotations

import ctypes
import json
import statistics

import torch

from ..ops.kernels.build import check

WARMUP, STEPS, REPEATS = 2, 10, 5


def chain_ms(fn, steps: int = STEPS, warmup: int = WARMUP) -> float:
    """Milliseconds per call of ``fn``: CUDA events around ``steps`` calls
    after ``warmup`` calls.  The calls run in order on one CUDA stream, so
    no data-carried token is needed to chain them.  Raises without a
    card."""
    if not torch.cuda.is_available():
        raise RuntimeError("chain_ms times on a CUDA card, and there is none")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / steps


def rounds_ms(fns: dict) -> list[dict]:
    """``REPEATS`` rounds; in each, every function of ``fns`` (name -> fn)
    timed by :func:`chain_ms` in turn.  Each function is called
    ``REPEATS * (WARMUP + STEPS)`` times."""
    return [{name: chain_ms(fn) for name, fn in fns.items()}
            for _ in range(REPEATS)]


def spread(rounds: list[dict]) -> dict:
    """name -> {"median", "min", "max"} of each number over the rounds."""
    return {name: {"median": statistics.median(r[name] for r in rounds),
                   "min": min(r[name] for r in rounds),
                   "max": max(r[name] for r in rounds)}
            for name in rounds[0]}


def medians(rounds: list[dict]) -> dict:
    return {name: s["median"] for name, s in spread(rounds).items()}


def occupancy(entry, index: int) -> dict:
    """{"registers", "smem_bytes", "blocks_per_sm"} of kernel ``index`` of a
    probe library entry ``entry(index, &registers, &smem, &blocks)``.
    Needs a card."""
    out = [ctypes.c_int() for _ in range(3)]
    check(entry(index, *map(ctypes.byref, out)), entry.__name__, "probes")
    return dict(zip(("registers", "smem_bytes", "blocks_per_sm"),
                    (o.value for o in out)))


def run_main(probe: str, legs) -> None:
    """Run ``legs(device)`` on the card and print its answer as one JSON
    line: the ``main()`` of each probe module."""
    if not torch.cuda.is_available():
        raise SystemExit(f"{probe}: needs a CUDA card")
    print(json.dumps({"probe": probe, **legs(torch.device("cuda", 0))}))
