"""The port's ``NativeJpegLoader`` (``diffvit_tpu_torch/data/imagenet.py``)
against the JAX package's and against the PIL route (the port's
``DataLoader``, with ``CodesLoader`` for the codes), on the CPU, bit for
bit: every emit (``f32``, ``u8``, ``codes``), exact and fast, a last
partial batch, ``drop_last``, the transform's parameters derived and
checked, the per-item PIL fallback (grayscale decodes natively; CMYK, a
PNG named .jpg and a truncated JPEG go to PIL, which refuses the truncated
one unless ``ImageFile.LOAD_TRUNCATED_IMAGES`` is set), and each of JAX's
refusals with the same exception type."""
import os
import shutil

import numpy as np
import pytest
from PIL import ImageFile

from diffvit_tpu.data import imagenet as jim

from diffvit_tpu_torch.data import imagenet, native_decode
from diffvit_tpu_torch.data.synthetic import (make_fake_imagefolder,
                                              write_odd_images)

from test_torch_calibrate import one_torch_thread  # noqa: F401

LUT = imagenet.input_code_lut(0.019, -2)


@pytest.fixture(scope="module")
def roots(tmp_path_factory, smooth_jpeg):
    """``plain``: 2 classes of 5 photo JPEGs (130 x 90) and a third class
    of 2 smooth 700 x 500 JPEGs (scaled by the fast mode); ``odd``: the
    plain folder plus a grayscale, a CMYK and a PNG-named-.jpg file;
    ``truncated``: the odd folder plus a truncated JPEG."""
    base = tmp_path_factory.mktemp("loader")
    plain = str(base / "plain")
    make_fake_imagefolder(plain, num_classes=2, per_class=5, size=(130, 90),
                          seed=6, texture="photo")
    os.makedirs(os.path.join(plain, "class_big"))
    for i in range(2):
        smooth_jpeg(os.path.join(plain, "class_big", f"{i}.jpg"), 700, 500,
                    seed=i)
    odd = str(base / "odd")
    shutil.copytree(plain, odd)
    paths = write_odd_images(os.path.join(odd, "class_000"), seed=7)
    truncated = str(base / "truncated")
    shutil.copytree(odd, truncated)
    os.remove(paths["truncated"])
    return {"plain": plain, "odd": odd, "truncated": truncated}


def _datasets(root, normalize=True, **kw):
    return (imagenet.ImageFolder(root, imagenet.build_transform(
                normalize=normalize, **kw)),
            jim.ImageFolder(root, jim.build_transform(normalize=normalize,
                                                      **kw)))


def _pil_route(ds, emit):
    loader = imagenet.DataLoader(ds, 4, num_workers=2)
    return list(loader if emit != "codes" else
                imagenet.CodesLoader(loader, LUT))


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gi.dtype == wi.dtype and gi.shape == wi.shape
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("emit", ["f32", "u8", "codes"])
def test_batches_equal_jax_and_the_pil_route(roots, emit, fast):
    """12 images in batches of 5, 5, 2 against JAX's; in batches of 4, the
    exact mode is the PIL route's batches and the fast one is not."""
    ds, jds = _datasets(roots["plain"], normalize=emit == "f32")
    lut = LUT if emit == "codes" else None
    got = list(imagenet.NativeJpegLoader(ds, 5, emit=emit, code_lut=lut,
                                         fast=fast))
    assert [len(b[1]) for b in got] == [5, 5, 2]
    _assert_batches_equal(got, list(jim.NativeJpegLoader(
        jds, 5, emit=emit, code_lut=lut, fast=fast)))
    by4 = list(imagenet.NativeJpegLoader(ds, 4, emit=emit, code_lut=lut,
                                         fast=fast))
    if fast:
        assert not np.array_equal(by4[-1][0], _pil_route(ds, emit)[-1][0])
    else:
        _assert_batches_equal(by4, _pil_route(ds, emit))


def test_drop_last_and_len(roots):
    ds, _ = _datasets(roots["plain"])
    loader = imagenet.NativeJpegLoader(ds, 5, drop_last=True, emit="u8")
    assert len(loader) == 2
    assert [b[0].shape[0] for b in loader] == [5, 5]
    assert len(imagenet.NativeJpegLoader(ds, 5)) == 3


@pytest.mark.parametrize("emit", ["f32", "u8", "codes"])
def test_refused_items_fall_back_to_pil(roots, emit, monkeypatch):
    """The CMYK and PNG files go through PIL, item by item; the grayscale
    one decodes natively; every batch equals JAX's and the PIL route's."""
    ds, jds = _datasets(roots["odd"], normalize=emit == "f32")
    lut = LUT if emit == "codes" else None
    loader = imagenet.NativeJpegLoader(ds, 4, emit=emit, code_lut=lut)
    fell_back = []
    fallback = loader._pil_fallback
    monkeypatch.setattr(loader, "_pil_fallback",
                        lambda i: fell_back.append(i) or fallback(i))
    got = list(loader)
    names = [os.path.basename(ds.samples[i][0]) for i in fell_back]
    assert sorted(names) == ["cmyk.jpg", "png.jpg"]
    _assert_batches_equal(got, _pil_route(ds, emit))
    _assert_batches_equal(got, list(jim.NativeJpegLoader(
        jds, 4, emit=emit, code_lut=lut)))


def test_truncated_file_goes_to_pil(roots, monkeypatch):
    """PIL refuses the truncated JPEG, so the loader raises as the PIL
    route raises; with ImageFile.LOAD_TRUNCATED_IMAGES set, PIL pads it and
    the batches equal the PIL route's and JAX's (JAX's library pads it
    itself)."""
    ds, jds = _datasets(roots["truncated"], normalize=False)
    with pytest.raises(OSError, match="truncated"):
        _pil_route(ds, "u8")
    with pytest.raises(OSError, match="truncated"):
        list(imagenet.NativeJpegLoader(ds, 4, emit="u8"))
    monkeypatch.setattr(ImageFile, "LOAD_TRUNCATED_IMAGES", True)
    got = list(imagenet.NativeJpegLoader(ds, 4, emit="u8"))
    _assert_batches_equal(got, _pil_route(ds, "u8"))
    _assert_batches_equal(got, list(jim.NativeJpegLoader(jds, 4,
                                                         emit="u8")))


def test_parameters_come_from_the_transform(roots):
    kw = dict(mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5), crop_pct=0.9,
              input_size=112)
    ds, _ = _datasets(roots["plain"], **kw)
    loader = imagenet.NativeJpegLoader(ds, 4)
    assert loader.kw == kw
    _assert_batches_equal(list(loader), _pil_route(ds, "f32"))


# JAX's refusals: the loader's arguments, the dataset by its transform
REFUSALS = {
    "emit": dict(emit="f16"),
    "codes_without_lut": dict(emit="codes"),
    "lut_without_codes": dict(emit="u8", code_lut=LUT),
    "disagreeing_crop_pct": dict(crop_pct=0.9),
    "disagreeing_mean": dict(mean=(0.5, 0.5, 0.5)),
    "bilinear": dict(dataset="bilinear"),
    "f32_of_an_unnormalized_transform": dict(dataset="unnormalized"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_jax_refusals_raise_the_same_type(roots, case):
    transforms = dict(plain={}, bilinear=dict(interpolation="bilinear"),
                      unnormalized=dict(normalize=False))
    errors = {}
    for pkg, m in (("torch", imagenet), ("jax", jim)):
        kw = dict(REFUSALS[case])
        tf = m.build_transform(**transforms[kw.pop("dataset", "plain")])
        with pytest.raises(ValueError) as e:
            m.NativeJpegLoader(m.ImageFolder(roots["plain"], tf), 4, **kw)
        errors[pkg] = str(e.value)
    assert errors["torch"].split()[:3] == errors["jax"].split()[:3]


def test_a_library_that_cannot_build_raises(roots, monkeypatch):
    """No fallback hides the library: the loader raises its build error."""
    def fail():
        raise FileNotFoundError("no g++ on PATH")
    monkeypatch.setattr(native_decode, "load_library", fail)
    ds, _ = _datasets(roots["plain"])
    with pytest.raises(FileNotFoundError, match="g\\+\\+"):
        imagenet.NativeJpegLoader(ds, 4)
