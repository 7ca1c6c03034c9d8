"""The port's native JPEG pipeline (``diffvit_tpu_torch/data/native_decode.py``
and ``native_preproc.py`` over the host library built from
``csrc/host``) against the JAX package's native library and against PIL,
on the CPU, bit for bit (tolerance 0) wherever the decode is exact:
``decode_rgb``, ``decode_preprocess`` (exact and fast), the uint8 forms,
both batch entries, ``apply_code_lut`` and ``encode_input``, the resampler
on decoded arrays (``preprocess_array``, ``preprocess_batch``,
``build_native_transform``).  The fast mode is held to
tests/test_native_fast_decode.py's bounds against the exact one.  Files
libjpeg refuses (CMYK, a PNG named .jpg, a truncated JPEG) raise
``ValueError``; the host library's build is renamed into place, and names
a missing compiler, header or libjpeg.

torch and the host library share one OpenMP runtime (torch's
``libgomp.so.1``, loaded with torch): ``one_torch_thread`` sets its
thread count to 1 for the calls made here."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from PIL import Image, ImageFile

from diffvit_tpu.data import native_decode as jax_nd
from diffvit_tpu.data import native_preproc as jax_np
from diffvit_tpu.data.imagenet import build_transform as jax_build_transform

from diffvit_tpu_torch.data import imagenet, native_decode, native_preproc
from diffvit_tpu_torch.data.synthetic import (make_fake_imagefolder,
                                              write_odd_images)
from diffvit_tpu_torch.ops.kernels import build

from test_torch_calibrate import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def files(tmp_path_factory, smooth_jpeg):
    """JPEGs from make_fake_imagefolder (photo texture, 130 x 90), one
    700 x 500 smooth JPEG that the fast mode decodes scaled, and the odd
    files of ``write_odd_images``."""
    root = tmp_path_factory.mktemp("native")
    make_fake_imagefolder(str(root / "folder"), num_classes=2, per_class=3,
                          size=(130, 90), seed=4, texture="photo")
    jpegs = sorted(str(p) for p in (root / "folder").rglob("*.jpg"))
    big = str(root / "big.jpg")
    smooth_jpeg(big, 700, 500, seed=1)
    odd = write_odd_images(str(root), seed=5)
    return {"jpegs": jpegs + [big, odd["gray"]], "odd": odd}


def _pil(path, **kw):
    with Image.open(path) as img:
        return imagenet.build_transform(**kw)(img)


def test_decode_rgb_equals_jax_and_pil(files):
    for p in files["jpegs"]:
        got = native_decode.decode_rgb(p)
        with Image.open(p) as img:
            want = np.asarray(img.convert("RGB"))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, jax_nd.decode_rgb(p))
        with open(p, "rb") as f:  # bytes in place of a path
            np.testing.assert_array_equal(
                native_decode.decode_rgb(f.read()), got)


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_decode_preprocess_equals_jax(files, fast):
    """Both emits, exact and fast, against JAX's native library; the
    exact mode also against PIL + build_transform."""
    for p in files["jpegs"]:
        f32 = native_decode.decode_preprocess(p, fast=fast)
        u8 = native_decode.decode_preprocess_u8(p, fast=fast)
        assert f32.dtype == np.float32 and f32.shape == (3, 224, 224)
        assert u8.dtype == np.uint8 and u8.shape == (3, 224, 224)
        np.testing.assert_array_equal(
            f32, jax_nd.decode_preprocess(p, fast=fast))
        np.testing.assert_array_equal(
            u8, jax_nd.decode_preprocess_u8(p, fast=fast))
        if not fast:
            np.testing.assert_array_equal(f32, _pil(p))
            np.testing.assert_array_equal(u8, _pil(p, normalize=False))


def test_non_default_geometry_and_normalization(files):
    kw = dict(input_size=96, crop_pct=0.9, mean=(0.5,) * 3, std=(0.5,) * 3)
    for p in files["jpegs"][:2]:
        got = native_decode.decode_preprocess(p, **kw)
        np.testing.assert_array_equal(got, _pil(p, **kw))
        np.testing.assert_array_equal(got, jax_nd.decode_preprocess(p, **kw))


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_batches_equal_jax_and_the_items(files, fast):
    paths = files["jpegs"]
    f32 = native_decode.decode_preprocess_batch(paths, fast=fast)
    u8 = native_decode.decode_preprocess_batch_u8(paths, fast=fast)
    assert f32.shape == u8.shape == (len(paths), 3, 224, 224)
    np.testing.assert_array_equal(
        f32, jax_nd.decode_preprocess_batch(paths, fast=fast))
    np.testing.assert_array_equal(
        u8, jax_nd.decode_preprocess_batch_u8(paths, fast=fast))
    for i, p in enumerate(paths):
        np.testing.assert_array_equal(
            f32[i], native_decode.decode_preprocess(p, fast=fast))
        np.testing.assert_array_equal(
            u8[i], native_decode.decode_preprocess_u8(p, fast=fast))


def test_u8_through_device_normalize_equals_f32(files):
    """The uint8 wire normalized on the (CPU) device is the float32 emit,
    bit for bit."""
    paths = files["jpegs"]
    u8 = native_decode.decode_preprocess_batch_u8(paths)
    got = imagenet.device_normalize(torch.from_numpy(u8)).numpy()
    np.testing.assert_array_equal(
        got, native_decode.decode_preprocess_batch(paths))


def test_fast_mode_is_close_to_exact(files):
    """tests/test_native_fast_decode.py's bounds: on the 700 x 500 image
    the scaled decode differs, by a mean of < 0.05 (normalized units) and
    a correlation of > 0.998; where no downscale applies it is exact."""
    big = files["jpegs"][-2]
    exact = native_decode.decode_preprocess(big)
    fast = native_decode.decode_preprocess(big, fast=True)
    assert not np.array_equal(exact, fast)
    assert np.abs(exact - fast).mean() < 0.05
    assert np.corrcoef(exact.reshape(-1), fast.reshape(-1))[0, 1] > 0.998
    small = files["jpegs"][0]
    np.testing.assert_array_equal(
        native_decode.decode_preprocess(small, fast=True),
        native_decode.decode_preprocess(small))


@pytest.mark.parametrize("kind", ["cmyk", "png", "truncated"])
def test_refused_files_raise_value_error(files, kind):
    """libjpeg cannot give RGB for these: every entry raises ValueError,
    a batch naming the item, as JAX's does for CMYK and PNG."""
    p = files["odd"][kind]
    for fn in (native_decode.decode_rgb, native_decode.decode_preprocess,
               native_decode.decode_preprocess_u8):
        with pytest.raises(ValueError, match="JPEG"):
            fn(p)
    paths = [files["jpegs"][0], p]
    with pytest.raises(ValueError, match=r"batch items \[1\]"):
        native_decode.decode_preprocess_batch(paths)
    with pytest.raises(ValueError, match=r"batch items \[1\]"):
        native_decode.decode_preprocess_batch_u8(paths)
    if kind != "truncated":
        with pytest.raises(ValueError):
            jax_nd.decode_rgb(p)


def test_truncated_file_is_refused_as_pil_refuses_it(files, monkeypatch):
    """PIL raises on a truncated JPEG unless ImageFile.LOAD_TRUNCATED_IMAGES
    is set, and then pads it with grey.  The port refuses it (its loaders
    then hand it to PIL); JAX's library pads it as PIL does with the flag
    set."""
    p = files["odd"]["truncated"]
    with pytest.raises(OSError, match="truncated"):
        _pil(p, normalize=False)
    monkeypatch.setattr(ImageFile, "LOAD_TRUNCATED_IMAGES", True)
    np.testing.assert_array_equal(jax_nd.decode_preprocess_u8(p),
                                  _pil(p, normalize=False))


def test_apply_code_lut_equals_jax_and_numpy(files):
    lut = imagenet.input_code_lut(0.021, 3)
    x = native_decode.decode_preprocess_batch_u8(files["jpegs"][:3])
    want = np.stack([lut[c][x[:, c]] for c in range(3)], 1)
    got = native_decode.apply_code_lut(x, lut)
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_nd.apply_code_lut(x, lut))
    np.testing.assert_array_equal(native_decode.apply_code_lut(x[0], lut),
                                  want[0])
    np.testing.assert_array_equal(imagenet.encode_input(x, lut), want)
    np.testing.assert_array_equal(imagenet.encode_input(x[1], lut), want[1])
    with pytest.raises(TypeError, match="uint8"):
        native_decode.apply_code_lut(x.astype(np.float32), lut)
    with pytest.raises(ValueError, match="C=3"):
        native_decode.apply_code_lut(x[:, :2], lut)
    with pytest.raises(ValueError, match="lut"):
        native_decode.apply_code_lut(x, lut[:2])


def test_encode_input_falls_back_only_on_build_errors(files, monkeypatch):
    """The numpy codes where the library cannot be built or loaded; any
    other error, and a wrong input, still raise."""
    lut = imagenet.input_code_lut(0.021, 3)
    x = native_decode.decode_preprocess_batch_u8(files["jpegs"][:2])
    want = native_decode.apply_code_lut(x, lut)
    with pytest.raises(TypeError, match="uint8"):
        imagenet.encode_input(x.astype(np.float32), lut)
    with pytest.raises(ValueError, match="C=3"):
        imagenet.encode_input(x[:, :2], lut)
    for err in (FileNotFoundError("no g++"), OSError("cannot load"),
                subprocess.CalledProcessError(1, ["g++"])):
        def fail(err=err):
            raise err
        monkeypatch.setattr(native_decode, "load_library", fail)
        np.testing.assert_array_equal(imagenet.encode_input(x, lut), want)

    def other():
        raise RuntimeError("not a build error")
    monkeypatch.setattr(native_decode, "load_library", other)
    with pytest.raises(RuntimeError, match="not a build error"):
        imagenet.encode_input(x, lut)


@pytest.mark.parametrize("shape", [(300, 400), (400, 300), (224, 224),
                                   (257, 311), (120, 500)])
def test_preprocess_array_equals_jax_and_pil(shape, rng):
    """tests/test_native_preproc.py's shapes: square, tall and wide."""
    rgb = rng.integers(0, 256, size=(*shape, 3)).astype(np.uint8)
    got = native_preproc.preprocess_array(rgb)
    np.testing.assert_array_equal(
        got, imagenet.build_transform()(Image.fromarray(rgb)))
    np.testing.assert_array_equal(got, jax_np.preprocess_array(rgb))
    kw = dict(crop_pct=0.9, mean=(0.5,) * 3, std=(0.5,) * 3)
    np.testing.assert_array_equal(
        native_preproc.preprocess_array(rgb, **kw),
        jax_build_transform(**kw)(Image.fromarray(rgb)))


def test_preprocess_batch_and_native_transform(rng):
    imgs = [rng.integers(0, 256, size=(rng.integers(200, 400),
                                       rng.integers(200, 400), 3)
                         ).astype(np.uint8) for _ in range(4)]
    out = native_preproc.preprocess_batch(imgs)
    assert out.shape == (4, 3, 224, 224)
    np.testing.assert_array_equal(out, jax_np.preprocess_batch(imgs))
    tf = native_preproc.build_native_transform(crop_pct=0.9)
    ref = imagenet.build_transform(crop_pct=0.9)
    for i, a in enumerate(imgs):
        np.testing.assert_array_equal(
            out[i], native_preproc.preprocess_array(a))
        img = Image.fromarray(a).convert("L")  # the transform converts
        np.testing.assert_array_equal(tf(img), ref(img))


_BUILD_ONE = textwrap.dedent("""
    import sys
    from pathlib import Path
    from diffvit_tpu_torch.ops.kernels import build
    build.BUILD_DIR = Path(sys.argv[1])
    lib = build.load_library("host")
    import numpy as np
    from diffvit_tpu_torch.data import native_decode
    x = np.arange(3 * 4 * 5, dtype=np.uint8).reshape(3, 4, 5)
    lut = np.tile(np.arange(-128, 128, dtype=np.int8), (3, 1))
    assert (native_decode.apply_code_lut(x, lut) == x.astype(np.int16) - 128).all()
    print(build.library_path("host"))
""")


def test_two_processes_building_at_once_load_one_library(tmp_path):
    """Each compiles into a temporary name and renames it into place: both
    load the same library, and no temporary or half-written file stays."""
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_ONE,
                               str(tmp_path)], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    assert [p.name for p in tmp_path.iterdir()] == [
        os.path.basename(paths.pop())]


def test_build_names_what_is_missing(monkeypatch, tmp_path):
    """No g++, a PIL without libjpeg, a missing header: each raises, naming
    it; nothing is left in the build directory."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "library_path",
                        lambda kind="kernels": tmp_path / f"{kind}.so")
    with monkeypatch.context() as m:
        m.setenv("PATH", str(tmp_path))
        with pytest.raises(FileNotFoundError, match="g\\+\\+"):
            build.build("host")
    with monkeypatch.context() as m:
        # a source whose header is missing: g++ names it
        (tmp_path / "decode.cpp").write_text("#include <jpeglib_absent.h>\n")
        bad = build.Library("libdvt_host", tmp_path, (), build.HOST_ENTRIES,
                            host=True)
        m.setitem(build.LIBRARIES, "host", bad)
        with pytest.raises(build.HostBuildError, match="jpeglib_absent.h"):
            build.build("host")
        (tmp_path / "decode.cpp").unlink()
    assert list(tmp_path.iterdir()) == []
    build.pil_libjpeg.cache_clear()
    try:
        monkeypatch.setattr(build.subprocess, "run",
                            lambda *a, **k: subprocess.CompletedProcess(
                                a, 0, stdout="\tlibz.so.1 => /lib/libz.so.1"))
        with pytest.raises(FileNotFoundError, match="links none"):
            build.pil_libjpeg()
    finally:
        monkeypatch.undo()
        build.pil_libjpeg.cache_clear()
    assert build.pil_libjpeg().name.startswith("libjpeg")
