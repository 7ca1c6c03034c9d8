"""Run one cell of the benchmark of ``diffvit_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for.  Prints one JSON line last on standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer metrics), ``device``, ``build_s``
(the seconds of set-up that built or loaded the kernels' libraries: the
build's in the first run of a checkout) and, traced, ``breakdown``; then
``check``, each number compared with its limit, which are also the last
lines on standard error.  Exits non-zero, and prints no
result, without a CUDA card, with fewer cards than the cell asks for, or
where ``jax``, ``jaxlib``, ``flax`` or ``diffvit_tpu`` was loaded."""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

from harness import cells, drive, guard  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # USE_FLAX=0: a library that would load JAX by itself does not
    os.environ.setdefault("USE_FLAX", "0")
    cell = cells.load(HERE.parent, args.workload)
    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"run.py: {cell.name} needs {cell.chips} CUDA card(s), this "
              f"machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = drive.run(cell, args.seed, args.seconds, bool(args.trace))
    loaded = guard.jax_modules()
    if loaded:
        print(f"run.py: JAX modules loaded in this process: {loaded}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    print(f"build_s {result['build_s']!r}", file=sys.stderr, flush=True)
    for k, v in result["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
