"""The guard that the run loaded no JAX: the top-level name of every
module in ``sys.modules`` (the part before the first dot) compared whole,
so that ``diffvit_tpu_torch`` is not taken for ``diffvit_tpu``."""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "diffvit_tpu"})


def jax_modules(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (default: the
    loaded ones)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)
