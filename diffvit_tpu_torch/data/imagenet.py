"""The ImageNet normalization constants, the uint8 normalize on the
model's device and the uint8 pixel -> int8 input code table (the port's
copy of that part of ``diffvit_tpu/data/imagenet.py``)."""
from __future__ import annotations

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_lut(mean=IMAGENET_MEAN, std=IMAGENET_STD) -> np.ndarray:
    """(3, 256) float32: ToTensor + Normalize of every uint8 pixel value per
    channel, ``(v / 255 - mean) / std`` in float32 numpy, the host
    pipeline's own values."""
    v = np.arange(256, dtype=np.float32)
    mean32 = np.asarray(mean, np.float32).reshape(-1)
    std32 = np.asarray(std, np.float32).reshape(-1)
    return np.stack([(v / np.float32(255.0) - m) / s
                     for m, s in zip(mean32, std32)])


def device_normalize(x: torch.Tensor, mean=IMAGENET_MEAN, std=IMAGENET_STD,
                     lut=None):
    """ToTensor + Normalize of a uint8 NCHW batch on its own device, as a
    gather from :func:`normalize_lut` (``diffvit_tpu/data/imagenet.py:
    25-53``): exact on every device, where ``(x / 255 - mean) / std``
    computed there may differ by an ulp.  Any other dtype passes through.
    ``lut``: that table as a tensor on ``x``'s device, where the caller
    keeps one (it then stands for ``mean`` and ``std``)."""
    if x.dtype != torch.uint8:
        return x
    if lut is None:
        lut = torch.tensor(normalize_lut(mean, std), device=x.device)
    xi = x.long()
    return torch.stack([lut[c][xi[:, c]] for c in range(3)], 1)


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
    norm = normalize_lut(mean, std)
    scale = np.float32(np.asarray(scale).reshape(()))
    zp = np.float32(np.asarray(zero_point).reshape(()))
    q = np.clip(np.round(norm / scale + zp), qmin, qmax)
    xq = (q - zp) * scale
    codes = np.clip(np.round(xq / scale), -128, 127)
    return codes.astype(np.int8)
