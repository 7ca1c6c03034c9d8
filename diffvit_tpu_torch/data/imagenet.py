"""The ImageNet data pipeline of the port (counterpart of
``diffvit_tpu/data/imagenet.py``): the torchvision-parity eval transform on
PIL (``build_transform``), ``ImageFolder`` and the threaded ``DataLoader``,
``NativeJpegLoader`` (a batch decoded and preprocessed in one call to the
host library, ``data/native_decode.py``), the codes wire
(``input_code_lut``, ``encode_input``, ``CodesLoader``), the uint8
normalize on the model's device, and ``DevicePrefetcher``, the
host-to-device stage (pinned memory and a side CUDA stream).

Batches are NCHW numpy: float32 normalized pixels, or with
``normalize=False`` the uint8 crop, the host-to-device wire format."""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import itertools
import math
import os
import queue
import subprocess
import threading

import numpy as np
import torch
from PIL import Image

from ..utils import tracing
from . import native_decode

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".webp")

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


def encode_input(x, lut) -> np.ndarray:
    """Apply :func:`input_code_lut` on the host: a uint8 NCHW (or CHW) batch
    -> int8 input codes of the same shape, through the host library's
    one-pass ``apply_code_lut``; by numpy indexing, with the same codes,
    only where that library cannot be built or loaded."""
    x = np.asarray(x)
    if x.dtype != np.uint8:
        raise TypeError(f"encode_input expects uint8 pixels, got {x.dtype}")
    try:
        native_decode.load_library()
    except (OSError, subprocess.CalledProcessError):
        pass  # no g++ or libjpeg here (FileNotFoundError is an OSError)
    else:
        return native_decode.apply_code_lut(x, lut)
    if x.ndim == 3:
        return np.stack([lut[c][x[c]] for c in range(3)], 0)
    return np.stack([lut[c][x[:, c]] for c in range(3)], 1)


class CodesLoader:
    """Wrap an (images, labels) loader so that the images arrive as int8
    input codes (``encode_input`` on the loader's side).  Goes in front of
    ``DevicePrefetcher`` and ``engine.validate``."""

    def __init__(self, loader, lut):
        self.loader, self.lut = loader, np.asarray(lut)

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for imgs, labels in self.loader:
            yield encode_input(imgs, self.lut), labels


def build_transform(input_size=224, interpolation="bicubic",
                    mean=IMAGENET_MEAN, std=IMAGENET_STD, crop_pct=0.875,
                    normalize=True):
    """fn(PIL.Image) -> float32 CHW array: torchvision's Resize (shorter
    side to ``input_size / crop_pct``) + CenterCrop + ToTensor + Normalize.
    ``normalize=False`` stops at the uint8 CHW crop."""
    size = int(math.floor(input_size / crop_pct))
    resample = {
        "bicubic": Image.BICUBIC,
        "lanczos": Image.LANCZOS,
        "hamming": Image.HAMMING,
        "bilinear": Image.BILINEAR,
    }[interpolation]
    mean = np.asarray(mean, np.float32).reshape(3, 1, 1)
    std = np.asarray(std, np.float32).reshape(3, 1, 1)

    def transform(img: Image.Image):
        img = img.convert("RGB")
        w, h = img.size
        # torchvision's Resize(int): the long side truncates,
        # int(size * long / short); rounding moves the crop by a pixel
        if w <= h:
            ow, oh = size, max(1, int(size * h / w))
        else:
            oh, ow = size, max(1, int(size * w / h))
        if (ow, oh) != (w, h):
            img = img.resize((ow, oh), resample)
        left = int(round((ow - input_size) / 2.0))
        top = int(round((oh - input_size) / 2.0))
        img = img.crop((left, top, left + input_size, top + input_size))
        arr = np.asarray(img, np.uint8).transpose(2, 0, 1)  # HWC -> CHW
        if not normalize:
            return arr
        return (arr.astype(np.float32) / 255.0 - mean) / std

    transform.params = dict(input_size=input_size, interpolation=interpolation,
                            mean=tuple(mean.reshape(-1).tolist()),
                            std=tuple(std.reshape(-1).tolist()),
                            crop_pct=crop_pct, normalize=normalize)
    return transform


class ImageFolder:
    """torchvision's ImageFolder: the classes are the sorted
    subdirectories, the samples sorted within a class."""

    def __init__(self, root, transform):
        self.root = root
        self.transform = transform
        self.classes = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self.samples = []
        for c in self.classes:
            cdir = os.path.join(root, c)
            for fn in sorted(os.listdir(cdir)):
                if fn.lower().endswith(IMG_EXTENSIONS):
                    self.samples.append((os.path.join(cdir, fn),
                                         self.class_to_idx[c]))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        path, label = self.samples[i]
        with Image.open(path) as img:
            return self.transform(img), label


class DataLoader:
    """Threaded batcher: yields (images NCHW, labels int32) numpy batches.
    The images of the next batch are decoded in a thread pool while the
    current one is consumed.  ``shuffle``: a fresh order every epoch,
    keyed by (seed, epoch); epoch 0 keeps ``default_rng(seed)``."""

    def __init__(self, dataset, batch_size, shuffle=False, num_workers=16,
                 drop_last=False, seed=0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.seed = seed
        self._epoch = 0  # advances with every shuffled __iter__

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else math.ceil(
            n / self.batch_size)

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            key = self.seed if self._epoch == 0 else (self.seed, self._epoch)
            np.random.default_rng(key).shuffle(order)
            self._epoch += 1
        nb = len(self)
        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            def submit(bi):
                idxs = order[bi * self.batch_size:(bi + 1) * self.batch_size]
                return [pool.submit(self.dataset.__getitem__, i)
                        for i in idxs]

            pending = submit(0) if nb else None
            for bi in range(nb):
                futs = pending
                pending = submit(bi + 1) if bi + 1 < nb else None
                out = [f.result() for f in futs]
                imgs = np.stack([o[0] for o in out])
                labels = np.asarray([o[1] for o in out], np.int32)
                yield imgs, labels


class NativeJpegLoader:
    """The native counterpart of :class:`DataLoader` over an
    :class:`ImageFolder` of JPEGs (``diffvit_tpu/data/imagenet.py``'s):
    each batch decodes and preprocesses in one call to the host library
    (libjpeg's JDCT_ISLOW decode into the Pillow-exact resample, crop and
    normalize; OpenMP across the images, the Python lock released), while
    one background thread prepares the next batch.  The batches equal
    DataLoader's bit for bit.

    ``emit``: ``"f32"``, the normalized float32 input; ``"u8"``, the uint8
    crop (the wire format: ``device_normalize`` on the device gives the
    float32 input); ``"codes"``, the uint8 crop through ``code_lut``
    (``IntModel.input_lut``) into int8 input codes, no work left on the
    device.  ``fast``: the DCT-scaled decode, several-fold cheaper on large
    JPEGs and not bit-exact (items that fall back to PIL stay exact).
    ``input_size``, ``crop_pct``, ``mean`` and ``std`` come from the
    dataset transform's ``params`` (``build_transform`` sets them) and must
    agree with it where given.  An item that libjpeg refuses (not a JPEG,
    CMYK, truncated: a ``ValueError``) goes through PIL, as DataLoader
    would take it."""

    def __init__(self, dataset: ImageFolder, batch_size, drop_last=False,
                 input_size=None, crop_pct=None, mean=None, std=None,
                 fast=False, emit="f32", code_lut=None):
        native_decode.load_library()  # build or raise before any batch
        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.fast = bool(fast)
        if emit not in ("f32", "u8", "codes"):
            raise ValueError(
                f"emit must be 'f32', 'u8' or 'codes', got {emit!r}")
        if (emit == "codes") != (code_lut is not None):
            raise ValueError("emit='codes' requires code_lut (and code_lut "
                             "requires emit='codes')")
        self.code_lut = None if code_lut is None else \
            np.ascontiguousarray(code_lut, np.int8)
        self.emit = emit
        # the dataset transform's geometry and normalization, so that native
        # and PIL-fallback items of one batch are preprocessed alike
        tf_params = getattr(getattr(dataset, "transform", None), "params",
                            None)
        defaults = dict(input_size=224, crop_pct=0.875, mean=IMAGENET_MEAN,
                        std=IMAGENET_STD)
        explicit = dict(input_size=input_size, crop_pct=crop_pct,
                        mean=mean, std=std)
        self.kw = {}
        for k, v in explicit.items():
            if v is None:
                v = tf_params[k] if tf_params is not None else defaults[k]
            if tf_params is not None and \
                    not np.allclose(np.asarray(v, np.float64),
                                    np.asarray(tf_params[k], np.float64)):
                raise ValueError(
                    f"NativeJpegLoader {k}={v!r} disagrees with the "
                    f"dataset transform's {k}={tf_params[k]!r}; native and "
                    "PIL-fallback items would be preprocessed differently")
            self.kw[k] = v
        if tf_params is not None and tf_params["interpolation"] != "bicubic":
            raise ValueError(
                "the native pipeline implements bicubic resampling only; "
                f"dataset transform uses {tf_params['interpolation']!r}")
        if emit == "f32" and tf_params is not None \
                and not tf_params.get("normalize", True):
            raise ValueError(
                "emit='f32' normalizes, but the dataset transform has "
                "normalize=False: PIL-fallback items would stay uint8; "
                "use emit='u8' with an un-normalized consumer instead")
        self._u8_transform = build_transform(
            input_size=self.kw["input_size"], crop_pct=self.kw["crop_pct"],
            normalize=False)

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else math.ceil(
            n / self.batch_size)

    def _pil_fallback(self, idx):
        if self.emit == "f32":
            return self.dataset[idx][0]
        # u8 and codes: the uint8 crop of the same geometry (codes batches
        # take the table after assembly)
        with Image.open(self.dataset.samples[idx][0]) as img:
            return self._u8_transform(img)

    def _make(self, idxs):
        samples = [self.dataset.samples[i] for i in idxs]
        labels = np.asarray([s[1] for s in samples], np.int32)
        paths = [s[0] for s in samples]
        if self.emit == "f32":
            kw = self.kw
            batch_fn = native_decode.decode_preprocess_batch
            item_fn = native_decode.decode_preprocess
        else:
            kw = dict(input_size=self.kw["input_size"],
                      crop_pct=self.kw["crop_pct"])
            batch_fn = native_decode.decode_preprocess_batch_u8
            item_fn = native_decode.decode_preprocess_u8
        try:
            imgs = batch_fn(paths, fast=self.fast, **kw)
        except ValueError:
            # an item libjpeg refuses: item by item, PIL for the refused
            outs = []
            for i, p in zip(idxs, paths):
                try:
                    outs.append(item_fn(p, fast=self.fast, **kw))
                except ValueError:
                    outs.append(self._pil_fallback(i))
            imgs = np.stack(outs)
        if self.emit == "codes":
            imgs = native_decode.apply_code_lut(imgs, self.code_lut)
        return imgs, labels

    def __iter__(self):
        nb = len(self)
        order = np.arange(len(self.dataset))
        with cf.ThreadPoolExecutor(1) as pool:
            def submit(bi):
                idxs = order[bi * self.batch_size:(bi + 1) * self.batch_size]
                return pool.submit(self._make, idxs)

            pending = submit(0) if nb else None
            for bi in range(nb):
                fut = pending
                pending = submit(bi + 1) if bi + 1 < nb else None
                yield fut.result()


class DevicePrefetcher:
    """The host-to-device stage between a loader and the model: a feeder
    thread takes each (images, labels) batch from ``loader`` and starts its
    copy to ``device`` while the model runs on the batch before it.

    On a CUDA device the images go through pinned host memory and are
    copied with ``non_blocking`` on a side stream; the consumer's stream
    waits on the copy's event before the batch is yielded, and the tensor
    is recorded on that stream, so its memory is not reused early.  At most
    ``depth`` batches are copied ahead of the one being consumed.  Yields
    ``(images, labels)`` in loader order: the images a tensor on
    ``device`` (on ``"cpu"``, the batch as a tensor), the labels as the
    loader gave them.  A loader error is raised in the consumer; a
    consumer that stops early stops the feeder.

    ``sharding`` (``parallel.mesh.batch_sharding``): only this rank's dp
    slice of each batch is copied, and the images come as a
    ``parallel.mesh.DPBatch`` of it (the models take it as it is).

    While a recording is on (``utils/tracing.py``), the consumer's wait
    for batch k is the span ``dvt.feed.wait`` with key k (the last one
    the wait for the loader's end); the feeder thread records none."""

    def __init__(self, loader, depth=2, device="cuda", sharding=None):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.loader = loader
        self.depth = depth
        self.device = torch.device(device)
        self.sharding = sharding

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        dev = self.device
        cuda = dev.type == "cuda"
        side = torch.cuda.Stream(dev) if cuda else None
        items: "queue.Queue" = queue.Queue()
        slots = threading.Semaphore(self.depth)
        stop = threading.Event()
        end = object()

        def acquire():
            # a slot for one more batch in flight, unless the consumer left
            while not stop.is_set():
                if slots.acquire(timeout=0.1):
                    return True
            return False

        def copy(imgs):
            if self.sharding is None:
                return to_device(imgs)
            part = self.sharding(np.asarray(imgs))
            out, done = to_device(part.local)
            return dataclasses.replace(part, local=out), done

        def to_device(imgs):
            host = torch.from_numpy(np.ascontiguousarray(imgs))
            if not cuda:
                return host.to(dev), None
            host = host.pin_memory()
            with torch.cuda.stream(side):
                out = host.to(dev, non_blocking=True)
                done = torch.cuda.Event()
                done.record(side)
            return out, done

        def feeder():
            try:
                for imgs, labels in self.loader:
                    if not acquire():
                        return
                    items.put((*copy(imgs), labels))
                items.put(end)
            except BaseException as e:  # raised in the consumer
                items.put(e)

        t = threading.Thread(target=feeder, daemon=True)
        t.start()
        try:
            for k in itertools.count():
                with tracing.span("dvt.feed.wait", k):
                    item = items.get()
                if item is end:
                    break
                if isinstance(item, BaseException):
                    raise item
                imgs, done, labels = item
                if done is not None:
                    stream = torch.cuda.current_stream(dev)
                    stream.wait_event(done)
                    getattr(imgs, "local", imgs).record_stream(stream)
                slots.release()
                yield imgs, labels
        finally:
            stop.set()
            t.join(timeout=5.0)
