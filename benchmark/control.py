"""The readings of the check's control: the reference computed one
precision below the configuration's (bfloat16 for its float32 requant
arithmetic, float32 for its float64 steps), put in the program's place,
at a cell's own batch and sample size, on each seed given.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

One JSON line a seed: the numbers the check compares (``gap_steps``,
``mismatch_pct``) for the control against the reference.  The smallest
over the seeds is each number's upper reading (PERF.md).  Needs a card;
the benchmark's own runs do not run it."""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

from harness import cells, check, models  # noqa: E402


def readings(cell, seed: int, device: str = "cuda") -> dict:
    """The control's numbers on ``seed``: the images of as many calls as a
    run checks, at the cell's batch."""
    spec, tr = cell.spec, cell.traffic
    rng_model, rng_pixels, rng_order, _ = models.streams(seed)
    ip = models.int_model(spec, rng_model)
    pool = models.codes_pool(spec, ip, tr["pool_images"], rng_pixels)
    n = min(tr["check_batches"] * tr["batch"], len(pool))
    codes = pool[rng_order.permutation(len(pool))[:n]]
    want = check.reference_logits(spec, ip, codes, device)
    got = check.reference_logits(spec, ip, codes, device, control=True)
    return check.numbers(spec, ip, got, want)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control.py: needs a CUDA card", file=sys.stderr)
        return 2
    cell = cells.load(HERE.parent, args.workload)
    for seed in args.seeds:
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "control": readings(cell, seed)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
