"""ctypes bindings of the native JPEG pipeline (``csrc/host/decode.cpp`` and
``preproc.cpp``, one host library built by ``ops/kernels/build.py``): the
port's counterpart of ``diffvit_tpu/data/native_decode.py``, with its
functions, shapes, dtypes and errors.

``decode_preprocess(path_or_bytes)`` stands for PIL's decode plus the eval
transform (``data/imagenet.build_transform``) in one C call: libjpeg's
JDCT_ISLOW decode (the method PIL uses, from the libjpeg PIL loads) into
the bit-exact-Pillow resample, crop and normalize of ``preproc.cpp``.  A
file that libjpeg cannot decode to RGB (not a JPEG, CMYK, truncated) raises
``ValueError``.  The batch entries are one C call each: the images are
spread over OpenMP threads, and ``ctypes`` releases the Python lock for the
call.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np

from ..ops.kernels import build

_U8P = ctypes.POINTER(ctypes.c_uint8)
_F32P = ctypes.POINTER(ctypes.c_float)
_I8P = ctypes.POINTER(ctypes.c_int8)


def load_library() -> ctypes.CDLL:
    """The host library, built at first use and loaded once a process."""
    return build.load_library("host")


def apply_code_lut(batch_u8, lut):
    """NCHW (or CHW) uint8 batch -> int8 input codes of the same shape
    through the (3, 256) int8 table ``lut`` (``data/imagenet.
    input_code_lut``), in one pass."""
    lib = load_library()
    x = np.ascontiguousarray(batch_u8)
    if x.dtype != np.uint8:
        raise TypeError(f"apply_code_lut expects uint8, got {x.dtype}")
    chw = x.ndim == 3
    if chw:
        x = x[None]
    if x.ndim != 4 or x.shape[1] != 3:
        raise ValueError(f"expected NCHW with C=3, got shape {x.shape}")
    lut = np.ascontiguousarray(lut, np.int8)
    if lut.shape != (3, 256):
        raise ValueError(f"lut must be (3, 256), got {lut.shape}")
    out = np.empty(x.shape, np.int8)
    lib.apply_code_lut(x.ctypes.data_as(_U8P), lut.ctypes.data_as(_I8P),
                       out.ctypes.data_as(_I8P), x.shape[0],
                       x.shape[2] * x.shape[3])
    return out[0] if chw else out


def _u8ptr(b):
    return ctypes.cast(ctypes.c_char_p(b), _U8P)


def _read(path_or_bytes) -> bytes:
    if isinstance(path_or_bytes, (bytes, bytearray)):
        return bytes(path_or_bytes)
    with open(path_or_bytes, "rb") as f:
        return f.read()


def _resize_to(input_size, crop_pct) -> int:
    return int(math.floor(input_size / crop_pct))


def decode_rgb(path_or_bytes):
    """JPEG -> uint8 HWC RGB array (PIL's pixels)."""
    lib = load_library()
    buf = _read(path_or_bytes)
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = lib.jpeg_shape(_u8ptr(buf), len(buf), ctypes.byref(h),
                        ctypes.byref(w))
    if rc:
        raise ValueError(f"not a decodable JPEG (rc={rc})")
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.jpeg_decode_rgb(_u8ptr(buf), len(buf), out.ctypes.data_as(_U8P))
    if rc:
        raise ValueError(f"JPEG decode failed (rc={rc})")
    return out


def decode_preprocess(path_or_bytes, *, input_size=224, crop_pct=0.875,
                      mean=(0.485, 0.456, 0.406),
                      std=(0.229, 0.224, 0.225), fast=False):
    """JPEG -> float32 CHW model input, one C call.  ``fast=True`` decodes
    in the DCT domain near the resample target (libjpeg's scale_num /
    scale_denom): several-fold cheaper on large JPEGs, and not bit-exact
    against the default full decode."""
    lib = load_library()
    buf = _read(path_or_bytes)
    out = np.empty((3, input_size, input_size), np.float32)
    mean_a = np.asarray(mean, np.float32)
    std_a = np.asarray(std, np.float32)
    fn = lib.jpeg_decode_preprocess_fast if fast \
        else lib.jpeg_decode_preprocess
    rc = fn(_u8ptr(buf), len(buf), out.ctypes.data_as(_F32P),
            _resize_to(input_size, crop_pct), input_size,
            mean_a.ctypes.data_as(_F32P), std_a.ctypes.data_as(_F32P))
    if rc:
        raise ValueError(f"JPEG decode failed (rc={rc})")
    return out


def decode_preprocess_u8(path_or_bytes, *, input_size=224, crop_pct=0.875,
                         fast=False):
    """JPEG -> the uint8 CHW crop before normalization: the host-to-device
    wire format (``data/imagenet.device_normalize`` on the device gives
    the float32 input bit for bit)."""
    lib = load_library()
    buf = _read(path_or_bytes)
    out = np.empty((3, input_size, input_size), np.uint8)
    rc = lib.jpeg_decode_preprocess_u8(
        _u8ptr(buf), len(buf), out.ctypes.data_as(_U8P),
        _resize_to(input_size, crop_pct), input_size, int(fast))
    if rc:
        raise ValueError(f"JPEG decode failed (rc={rc})")
    return out


def _batch(paths_or_bytes):
    bufs = [_read(p) for p in paths_or_bytes]
    n = len(bufs)
    srcs = (_U8P * n)(*[_u8ptr(b) for b in bufs])
    lens = (ctypes.c_ulong * n)(*[len(b) for b in bufs])
    # bufs stays referenced by the caller while the C call reads srcs
    return bufs, srcs, lens, (ctypes.c_int * n)()


def _check_status(status):
    bad = [i for i, s in enumerate(status) if s]
    if bad:
        raise ValueError(f"JPEG decode failed for batch items {bad[:8]}")


def decode_preprocess_batch_u8(paths_or_bytes, *, input_size=224,
                               crop_pct=0.875, fast=False):
    """List of JPEG paths or bytes -> (N, 3, size, size) uint8 (see
    :func:`decode_preprocess_u8`) in one C call."""
    lib = load_library()
    bufs, srcs, lens, status = _batch(paths_or_bytes)
    out = np.empty((len(bufs), 3, input_size, input_size), np.uint8)
    lib.jpeg_decode_preprocess_batch_u8(
        srcs, lens, len(bufs), out.ctypes.data_as(_U8P),
        _resize_to(input_size, crop_pct), input_size, status, int(fast))
    _check_status(status)
    return out


def decode_preprocess_batch(paths_or_bytes, *, input_size=224,
                            crop_pct=0.875, mean=(0.485, 0.456, 0.406),
                            std=(0.229, 0.224, 0.225), fast=False):
    """List of JPEG paths or bytes -> (N, 3, size, size) float32 in one C
    call.  ``fast``: the DCT-scaled decode (see :func:`decode_preprocess`)."""
    lib = load_library()
    bufs, srcs, lens, status = _batch(paths_or_bytes)
    out = np.empty((len(bufs), 3, input_size, input_size), np.float32)
    mean_a = np.asarray(mean, np.float32)
    std_a = np.asarray(std, np.float32)
    lib.jpeg_decode_preprocess_batch(
        srcs, lens, len(bufs), out.ctypes.data_as(_F32P),
        _resize_to(input_size, crop_pct), input_size,
        mean_a.ctypes.data_as(_F32P), std_a.ctypes.data_as(_F32P), status,
        int(fast))
    _check_status(status)
    return out
