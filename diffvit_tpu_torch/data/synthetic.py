"""Synthetic data (the port's copy of ``diffvit_tpu/data/synthetic.py``):
``gaussian_calibration``, the reference's --mode 1 source, pure Gaussian
noise; ``make_fake_imagefolder``, a small ImageFolder of JPEGs on disk for
tests and smoke runs.  The same numpy generator gives the same data in
both packages."""
from __future__ import annotations

import os

import numpy as np
from PIL import Image


def gaussian_calibration(batch_size: int, seed: int = 0, input_size: int = 224):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        (batch_size, 3, input_size, input_size)).astype(np.float32)


def make_fake_imagefolder(root, num_classes=4, per_class=8, size=224, seed=0,
                          texture="noise"):
    """Write a deterministic fake ImageFolder tree of JPEGs under ``root``
    (``diffvit_tpu/data/synthetic.py``'s, the same files for the same
    arguments).  ``size``: an int for square images or (width, height).
    ``texture``: ``"noise"``, each class a colour with sigma-40 noise;
    ``"photo"``, a colour with smooth waves and sigma-8 grain."""
    rng = np.random.default_rng(seed)
    w, h = (size, size) if isinstance(size, int) else size
    base_colors = rng.integers(0, 255, size=(num_classes, 3))
    for c in range(num_classes):
        cdir = os.path.join(root, f"class_{c:03d}")
        os.makedirs(cdir, exist_ok=True)
        for i in range(per_class):
            if texture == "photo":
                yy, xx = np.mgrid[0:h, 0:w]
                fx, fy = rng.uniform(20, 80, 2)
                px, py = rng.uniform(0, 6.3, 2)
                waves = 45 * np.sin(xx / fx + px) + 35 * np.cos(yy / fy + py)
                img = np.clip(
                    base_colors[c][None, None, :] + waves[:, :, None]
                    + rng.normal(0, 8, size=(h, w, 3)), 0, 255
                ).astype(np.uint8)
            else:
                img = np.clip(
                    base_colors[c][None, None, :]
                    + rng.normal(0, 40, size=(h, w, 3)), 0, 255
                ).astype(np.uint8)
            Image.fromarray(img).save(os.path.join(cdir, f"img_{i:04d}.jpg"))
    return root
