"""Synthetic calibration data (the port's copy of ``gaussian_calibration``
in ``diffvit_tpu/data/synthetic.py``): the reference's --mode 1 source,
pure Gaussian noise.  The same numpy generator gives the same batch in
both packages."""
from __future__ import annotations

import numpy as np


def gaussian_calibration(batch_size: int, seed: int = 0, input_size: int = 224):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        (batch_size, 3, input_size, input_size)).astype(np.float32)
