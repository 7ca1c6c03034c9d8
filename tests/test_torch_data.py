"""The port's data pipeline against the JAX package's, on the CPU: the
eval transform, ImageFolder, the threaded DataLoader and its shuffles, the
codes wire, the fake ImageFolder and the preprocessing table, each equal
(tolerance 0) on the same inputs; and DevicePrefetcher through the six
cases of tests/test_device_prefetch.py, on the CPU (the CUDA stream path
is held on the card, tests/test_torch_cuda.py)."""
import os
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from diffvit_tpu.data import imagenet as jimagenet
from diffvit_tpu.data import synthetic as jsynthetic
from diffvit_tpu.models import registry as jregistry

from diffvit_tpu_torch import QuantConfig, engine
from diffvit_tpu_torch.data import imagenet, synthetic
from diffvit_tpu_torch.models import registry
from diffvit_tpu_torch.models.vit import ViTSpec
from diffvit_tpu_torch.testing import random_int_model

from test_torch_calibrate import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """A fake ImageFolder written by each package (3 classes of 4)."""
    root = tmp_path_factory.mktemp("fake")
    kw = dict(num_classes=3, per_class=4, size=(48, 36), seed=1)
    synthetic.make_fake_imagefolder(str(root / "port"), **kw)
    jsynthetic.make_fake_imagefolder(str(root / "jax"), **kw)
    return root


def test_fake_imagefolder_equals_jax(folder):
    """The same files, byte for byte, both textures."""
    for sub in ("class_000", "class_002"):
        names = sorted(os.listdir(folder / "port" / sub))
        assert names == sorted(os.listdir(folder / "jax" / sub))
        for n in names:
            assert (folder / "port" / sub / n).read_bytes() == \
                (folder / "jax" / sub / n).read_bytes()
    a = synthetic.make_fake_imagefolder(str(folder / "p2"), 1, 1, 40,
                                        texture="photo")
    b = jsynthetic.make_fake_imagefolder(str(folder / "j2"), 1, 1, 40,
                                         texture="photo")
    f = "class_000/img_0000.jpg"
    assert open(os.path.join(a, f), "rb").read() == \
        open(os.path.join(b, f), "rb").read()


def test_preprocessing_table_equals_jax():
    assert registry.MODEL_NAMES == jregistry.MODEL_NAMES
    for name in registry.MODEL_NAMES:
        assert registry.preprocessing_for(name).__dict__ == \
            jregistry.preprocessing_for(name).__dict__


def _images():
    rng = np.random.default_rng(0)
    sizes = [(300, 200), (200, 300), (224, 224), (256, 256), (500, 375),
             (97, 61)]
    return [Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
            for w, h in sizes] + [
        Image.fromarray(rng.integers(0, 256, (80, 90), dtype=np.uint8))]


@pytest.mark.parametrize("normalize", [True, False], ids=["f32", "u8"])
@pytest.mark.parametrize("family", ["deit", "vit", "swin"])
def test_build_transform_equals_jax(family, normalize):
    """Exact: the same arrays (dtype and values) for wide, tall, square,
    odd and greyscale images, under each family's constants; the long side
    truncates."""
    pp = registry.PREPROCESSING[family]
    kw = dict(mean=pp.mean, std=pp.std, crop_pct=pp.crop_pct,
              normalize=normalize)
    t, tj = imagenet.build_transform(**kw), jimagenet.build_transform(**kw)
    assert t.params == tj.params
    for img in _images():
        got, want = t(img), tj(img)
        assert got.dtype == want.dtype and got.shape == (3, 224, 224)
        np.testing.assert_array_equal(got, want)


def test_image_folder_and_loader_equal_jax(folder):
    """Equal samples and classes; equal batches in order, unshuffled and
    shuffled, for epochs 0 and 1 (a fresh order each epoch), with the
    ragged last batch and with drop_last."""
    tf = imagenet.build_transform(input_size=32, crop_pct=0.875)
    tfj = jimagenet.build_transform(input_size=32, crop_pct=0.875)
    ds = imagenet.ImageFolder(str(folder / "port"), tf)
    dsj = jimagenet.ImageFolder(str(folder / "port"), tfj)
    assert ds.samples == dsj.samples and ds.classes == dsj.classes
    assert len(ds) == 12 and ds.class_to_idx == dsj.class_to_idx
    for shuffle, drop_last in ((False, False), (True, True), (True, False)):
        dl = imagenet.DataLoader(ds, 5, shuffle=shuffle, num_workers=3,
                                 drop_last=drop_last, seed=4)
        dlj = jimagenet.DataLoader(dsj, 5, shuffle=shuffle, num_workers=3,
                                   drop_last=drop_last, seed=4)
        assert len(dl) == len(dlj) == (2 if drop_last else 3)
        orders = []
        for _epoch in range(2):
            got, want = list(dl), list(dlj)
            assert len(got) == len(want) == len(dl)
            for (x, y), (xj, yj) in zip(got, want):
                assert x.dtype == np.float32 and y.dtype == np.int32
                np.testing.assert_array_equal(x, xj)
                np.testing.assert_array_equal(y, yj)
            orders.append(np.concatenate([y for _, y in got]))
        if shuffle:  # the epochs differ
            assert not np.array_equal(orders[0], orders[1])


def test_codes_wire_equals_jax(folder):
    """encode_input (NCHW and CHW) and CodesLoader give JAX's codes."""
    lut = imagenet.input_code_lut(np.float32(2.0**-5), np.float32(0.0))
    np.testing.assert_array_equal(
        lut, jimagenet.input_code_lut(np.float32(2.0**-5), np.float32(0.0)))
    x = np.random.default_rng(2).integers(0, 256, (3, 3, 8, 8),
                                          dtype=np.uint8)
    np.testing.assert_array_equal(imagenet.encode_input(x, lut),
                                  jimagenet.encode_input(x, lut))
    np.testing.assert_array_equal(imagenet.encode_input(x[0], lut),
                                  jimagenet.encode_input(x[0], lut))
    with pytest.raises(TypeError, match="uint8"):
        imagenet.encode_input(x.astype(np.float32), lut)
    tf = imagenet.build_transform(input_size=32, normalize=False)
    ds = imagenet.ImageFolder(str(folder / "port"), tf)
    dl = imagenet.DataLoader(ds, 5, num_workers=2)
    got, want = imagenet.CodesLoader(dl, lut), jimagenet.CodesLoader(dl, lut)
    assert len(got) == len(want) == 3
    for (c, y), (cj, yj) in zip(got, want):
        assert c.dtype == np.int8
        np.testing.assert_array_equal(c, cj)
        np.testing.assert_array_equal(y, yj)


# ---- DevicePrefetcher: tests/test_device_prefetch.py's cases, on the CPU --

class _ListLoader:
    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def _batches(n=5, bs=4):
    rng = np.random.default_rng(0)
    return [(rng.standard_normal((bs, 3, 8, 8)).astype(np.float32),
             rng.integers(0, 10, bs).astype(np.int32)) for _ in range(n)]


def test_prefetch_yields_identical_batches_in_order():
    batches = _batches()
    pf = imagenet.DevicePrefetcher(_ListLoader(batches), depth=2,
                                   device="cpu")
    assert len(pf) == len(batches)
    got = list(pf)
    assert len(got) == len(batches)
    for (di, dl), (hi, hl) in zip(got, batches):
        assert isinstance(di, torch.Tensor) and di.device.type == "cpu"
        np.testing.assert_array_equal(di.numpy(), hi)
        np.testing.assert_array_equal(np.asarray(dl), hl)


def test_prefetch_reiterable_and_consumable():
    batches = _batches(3)
    pf = imagenet.DevicePrefetcher(_ListLoader(batches), depth=1,
                                   device="cpu")
    for _ in range(2):  # a fresh feeder thread per epoch
        outs = [d.sum(dim=(1, 2, 3)).numpy() for d, _ in pf]
        want = [b[0].sum(axis=(1, 2, 3)) for b in batches]
        for o, w in zip(outs, want):
            np.testing.assert_allclose(o, w, rtol=1e-5)


def test_prefetch_early_break_does_not_hang():
    pf = imagenet.DevicePrefetcher(_ListLoader(_batches(64)), depth=2,
                                   device="cpu")
    before = threading.active_count()
    for i, _ in enumerate(pf):
        if i == 1:
            break  # the feeder must see the stop event and exit
    assert threading.active_count() <= before


def test_prefetch_loader_errors_surface_in_consumer():
    class Boom(_ListLoader):
        def __iter__(self):
            yield self.batches[0]
            raise RuntimeError("decode exploded")

    it = iter(imagenet.DevicePrefetcher(Boom(_batches(2)), depth=2,
                                        device="cpu"))
    next(it)
    with pytest.raises(RuntimeError, match="decode exploded"):
        next(it)


def test_prefetch_depth_validation_and_bound():
    """depth < 1 is refused; the feeder runs at most ``depth`` batches
    ahead of the consumer."""
    with pytest.raises(ValueError, match="depth"):
        imagenet.DevicePrefetcher(_ListLoader([]), depth=0)
    pulled = []

    class Counting(_ListLoader):
        def __iter__(self):
            for i, b in enumerate(self.batches):
                pulled.append(i)
                yield b

    pf = imagenet.DevicePrefetcher(Counting(_batches(12)), depth=3,
                                   device="cpu")
    for i, _ in enumerate(pf):
        threading.Event().wait(0.02)  # let the feeder run ahead
        # consumed i + 1 batches; at most 3 more copied, one more pulled
        assert len(pulled) <= i + 1 + 3 + 1


def test_validate_through_prefetcher():
    """engine.validate consumes a DevicePrefetcher transparently: the same
    (loss, Prec@1, Prec@5) as over the loader itself."""
    spec = ViTSpec("pf_tiny", embed_dim=64, depth=2, num_heads=2,
                   num_classes=4)
    m = engine.IntModel(random_int_model(spec, seed=0), spec,
                        QuantConfig(), "cpu")
    rng = np.random.default_rng(1)
    batches = [(rng.standard_normal((2, 3, 224, 224)).astype(np.float32),
                rng.integers(0, 4, 2).astype(np.int32)) for _ in range(2)]
    base = engine.validate(m, _ListLoader(batches), print_freq=0)
    pf = engine.validate(m, imagenet.DevicePrefetcher(
        _ListLoader(batches), device="cpu"), print_freq=0)
    assert base == pf
