"""The native resampler on decoded pixels (``csrc/host/preproc.cpp``, in the
host library of ``data/native_decode.py``): the port's counterpart of
``diffvit_tpu/data/native_preproc.py``.

The resample replicates Pillow's fixed-point convolution bit for bit, so
:func:`build_native_transform` gives the float32 input that
``data/imagenet.build_transform`` gives, with PIL left only the decode;
:func:`preprocess_batch` spreads a batch over OpenMP threads in one C
call."""
from __future__ import annotations

import ctypes

import numpy as np

from .imagenet import IMAGENET_MEAN, IMAGENET_STD
from .native_decode import _F32P, _U8P, _resize_to, load_library


def preprocess_array(rgb_u8, *, input_size=224, crop_pct=0.875,
                     mean=IMAGENET_MEAN, std=IMAGENET_STD):
    """uint8 HWC RGB -> float32 CHW: torchvision's Resize (shorter side to
    ``input_size / crop_pct``, bicubic) + CenterCrop + ToTensor +
    Normalize."""
    lib = load_library()
    rgb_u8 = np.ascontiguousarray(rgb_u8, np.uint8)
    h, w, _ = rgb_u8.shape
    out = np.empty((3, input_size, input_size), np.float32)
    mean_a = np.asarray(mean, np.float32)
    std_a = np.asarray(std, np.float32)
    lib.preprocess_rgb(rgb_u8.ctypes.data_as(_U8P), h, w,
                       out.ctypes.data_as(_F32P),
                       _resize_to(input_size, crop_pct), input_size,
                       mean_a.ctypes.data_as(_F32P),
                       std_a.ctypes.data_as(_F32P))
    return out


def preprocess_batch(rgb_list, *, input_size=224, crop_pct=0.875,
                     mean=IMAGENET_MEAN, std=IMAGENET_STD):
    """List of uint8 HWC arrays -> (N, 3, size, size) float32 in one C
    call."""
    lib = load_library()
    arrs = [np.ascontiguousarray(a, np.uint8) for a in rgb_list]
    n = len(arrs)
    out = np.empty((n, 3, input_size, input_size), np.float32)
    srcs = (_U8P * n)(*[a.ctypes.data_as(_U8P) for a in arrs])
    shs = (ctypes.c_int * n)(*[a.shape[0] for a in arrs])
    sws = (ctypes.c_int * n)(*[a.shape[1] for a in arrs])
    mean_a = np.asarray(mean, np.float32)
    std_a = np.asarray(std, np.float32)
    lib.preprocess_batch(srcs, shs, sws, n, out.ctypes.data_as(_F32P),
                         _resize_to(input_size, crop_pct), input_size,
                         mean_a.ctypes.data_as(_F32P),
                         std_a.ctypes.data_as(_F32P))
    return out


def build_native_transform(input_size=224, mean=IMAGENET_MEAN,
                           std=IMAGENET_STD, crop_pct=0.875):
    """``data/imagenet.build_transform`` with the native resampler: PIL
    decodes (``convert("RGB")``), the host library does the rest."""

    def transform(img):
        rgb = np.asarray(img.convert("RGB"), np.uint8)
        return preprocess_array(rgb, input_size=input_size,
                                crop_pct=crop_pct, mean=mean, std=std)

    return transform
