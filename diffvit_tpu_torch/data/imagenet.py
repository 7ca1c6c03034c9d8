"""The ImageNet normalization constants and the uint8 pixel -> int8 input
code table (the port's copy of that part of
``diffvit_tpu/data/imagenet.py``)."""
from __future__ import annotations

import numpy as np

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def input_code_lut(scale, zero_point, mean=IMAGENET_MEAN, std=IMAGENET_STD,
                   qmin=-128, qmax=127):
    """(3, 256) int8 LUT composing ToTensor+Normalize with the model's input
    fake-quant: ``lut[c][v]`` is the int8 code the integer path derives for
    a uint8 pixel ``v`` in channel ``c``
    (``_requant_i8(fake_quant(normalize(v)))``).

    Built in float32 numpy with the exact op sequence of the device path —
    normalize, then quantize/round/clip (``qmin``/``qmax``: the qact_input
    bit type's bounds) and the integer path's requant — so the codes are
    those of the float32 wire."""
    v = np.arange(256, dtype=np.float32)
    mean32 = np.asarray(mean, np.float32).reshape(-1)
    std32 = np.asarray(std, np.float32).reshape(-1)
    norm = np.stack([(v / np.float32(255.0) - m) / s
                     for m, s in zip(mean32, std32)])  # (3, 256) f32
    scale = np.float32(np.asarray(scale).reshape(()))
    zp = np.float32(np.asarray(zero_point).reshape(()))
    q = np.clip(np.round(norm / scale + zp), qmin, qmax)
    xq = (q - zp) * scale
    codes = np.clip(np.round(xq / scale), -128, 127)
    return codes.astype(np.int8)
