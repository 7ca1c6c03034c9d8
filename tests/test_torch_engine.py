"""The port's serving engine: a JAX ``save_int_model`` artifact served by
the port's ``load_int_model``/``IntModel`` against the JAX engine, the
reference's validate report, and the port running without JAX and without
the JAX package (its own copies of the shared modules, held here against
the originals)."""
import ast
import dataclasses
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from diffvit_tpu.config import QuantConfig
from diffvit_tpu.data import imagenet as jax_imagenet
from diffvit_tpu.engine import QuantizedViT
from diffvit_tpu.engine import load_int_model as jax_load_int_model
from diffvit_tpu.models import vit
from diffvit_tpu.ops import bit_types as jax_bit_types
from diffvit_tpu.utils import metrics as jax_metrics
from diffvit_tpu.utils import serialize as jax_serialize

import diffvit_tpu_torch
from diffvit_tpu_torch import engine
from diffvit_tpu_torch.data import imagenet
from diffvit_tpu_torch.ops import bit_types
from diffvit_tpu_torch.utils import metrics, serialize
from diffvit_tpu_torch.models.vit import ViTSpec
from diffvit_tpu_torch.testing import random_int_model

from test_torch_calibrate import one_torch_thread  # noqa: F401

TINY = vit.ViTSpec("test_tiny", embed_dim=64, depth=2, num_heads=2,
                   num_classes=10)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_paths_agree(got, ref):
    """tests/test_pallas_attention.py::_assert_paths_agree."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert np.mean(got == ref) > 0.995, np.mean(got == ref)
    np.testing.assert_allclose(got, ref, atol=0.05)
    np.testing.assert_array_equal(got.argmax(1), ref.argmax(1))


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    params = vit.init_params(TINY, jax.random.PRNGKey(0))
    m = QuantizedViT(TINY, QuantConfig(), params=params)
    m.calibrate(np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                             (2, 3, 224, 224))))
    path = str(tmp_path_factory.mktemp("art") / "deit.npz")
    m.save_int_model(path)
    pixels = np.random.default_rng(0).integers(0, 256, (3, 3, 224, 224),
                                               dtype=np.uint8)
    return path, pixels


def test_served_artifact_matches_jax_engine(artifact):
    path, pixels = artifact
    served = engine.load_int_model(path, "cpu")
    assert served.spec.embed_dim == 64 and served.cfg == QuantConfig()
    codes = served.encode(pixels)
    assert codes.dtype == np.int8 and codes.shape == pixels.shape
    got = served(pixels).numpy()
    np.testing.assert_array_equal(served(codes).numpy(), got)
    want = np.asarray(jax_load_int_model(path)(pixels))
    _assert_paths_agree(got, want)
    np.testing.assert_array_equal(served.input_lut,
                                  jax_load_int_model(path).input_lut)


def test_port_artifact_loads_in_jax_engine(artifact, tmp_path):
    """engine.save_int_model writes the JAX package's artifact format."""
    _, pixels = artifact
    spec = ViTSpec("t", embed_dim=64, depth=2, num_heads=2, num_classes=10)
    path = str(tmp_path / "random.npz")
    engine.save_int_model(path, random_int_model(spec, seed=2), spec,
                          QuantConfig())
    got = engine.load_int_model(path, "cpu")(pixels).numpy()
    served = jax_load_int_model(path)
    assert served.spec.embed_dim == 64
    _assert_paths_agree(got, np.asarray(served(pixels)))


def test_validate_prints_reference_format(artifact):
    path, pixels = artifact
    served = engine.load_int_model(path, "cpu")
    loader = [(pixels, np.array([1, 2, 3])), (pixels[:2], np.array([4, 5]))]
    lines = []
    loss, top1, top5 = engine.validate(served, loader, print_freq=1,
                                       log=lines.append)
    assert len(lines) == 3
    assert re.fullmatch(
        r"Test: \[0/2\]\tTime \d+\.\d{3} \(\d+\.\d{3}\)\t"
        r"Loss \d+\.\d{4} \(\d+\.\d{4}\)\tPrec@1 \d+\.\d{3} \(\d+\.\d{3}\)\t"
        r"Prec@5 \d+\.\d{3} \(\d+\.\d{3}\)", lines[0]), lines[0]
    assert re.fullmatch(r" \* Prec@1 \d+\.\d{3} Prec@5 \d+\.\d{3} "
                        r"Time \d+\.\d{3}", lines[-1]), lines[-1]
    assert 0.0 <= top1 <= top5 <= 100.0 and np.isfinite(loss)


# ---- the uint8 wire where the codes wire cannot stand for it --------------

SPEC64 = ViTSpec("t64", embed_dim=64, depth=2, num_heads=2, num_classes=10)
NORM = ((0.5, 0.4, 0.3), (0.25, 0.2, 0.3))


def _float_patch_model(zp):
    """A float patch site (slot 0 = -1) behind a qact_input of scale 2^-6
    and zero-point ``zp``: for ``zp`` != 0 the int8 code clips q - zp."""
    bc = (-1,) + (4,) * (4 * SPEC64.depth + 1)
    ip = random_int_model(SPEC64, seed=3, bit_config=bc)
    ip["qact_input"] = {"scale": np.float32(2.0**-6), "zp": np.float32(zp)}
    ip["sym_acts"] = zp == 0
    return SPEC64, ip


def _no_input_quant_model():
    spec = dataclasses.replace(SPEC64, input_quant=False)
    return spec, random_int_model(spec, seed=3)


@pytest.mark.parametrize("case,input_norm", [
    ("float_patch_zp", None), ("no_input_quant", None),
    ("float_patch_zp", NORM), ("no_input_quant", NORM), ("codes", NORM)],
    ids=["float_patch_zp", "no_input_quant", "float_patch_zp-norm",
         "no_input_quant-norm", "codes-norm"])
def test_uint8_wire_matches_float32_wire_and_jax(artifact, tmp_path, case,
                                                 input_norm):
    """uint8 pixels against the float32 wire of the same pixels, in the
    port (bit for bit) and against the JAX IntModel on both wires, for a
    float patch behind a nonzero input zero-point and for
    ``input_quant=False`` (both normalize on the device: no codes wire,
    int8 codes refused), and for a model with a codes wire under a custom
    ``input_norm`` (the LUT's codes are the float32 wire's)."""
    spec, ip = {"float_patch_zp": lambda: _float_patch_model(-15.0),
                "no_input_quant": _no_input_quant_model,
                "codes": lambda: (SPEC64, random_int_model(SPEC64, seed=3)),
                }[case]()
    kw = {} if input_norm is None else {"input_norm": input_norm}
    path = str(tmp_path / "m.npz")
    engine.save_int_model(path, ip, spec, QuantConfig())
    served = engine.load_int_model(path, "cpu", **kw)
    jax_served = jax_load_int_model(path, **kw)
    pixels = artifact[1]
    normalized = np.array(jax_imagenet.device_normalize(
        jax.numpy.asarray(pixels), *(input_norm or ())))
    np.testing.assert_array_equal(
        imagenet.device_normalize(torch.tensor(pixels),
                                  *(input_norm or ())).numpy(), normalized)
    got = served(pixels).numpy()
    np.testing.assert_array_equal(served(normalized).numpy(), got)
    np.testing.assert_array_equal(served(torch.tensor(pixels)).numpy(), got)
    _assert_paths_agree(got, np.asarray(jax_served(pixels)))
    _assert_paths_agree(got, np.asarray(jax_served(normalized)))
    assert not np.array_equal(got[0], got[1])
    if case == "codes":
        np.testing.assert_array_equal(served.input_lut, jax_served.input_lut)
        np.testing.assert_array_equal(served(served.encode(pixels)).numpy(),
                                      got)
        assert not np.array_equal(
            served.input_lut, engine.load_int_model(path, "cpu").input_lut)
    else:
        assert served.input_lut is None
        match = "input_quant" if case == "no_input_quant" else "zero-point"
        for refused in (served.encode, lambda x: served(x.astype(np.int8))):
            with pytest.raises(ValueError, match=match):
                refused(pixels)


def test_float_patch_with_zero_zp_keeps_the_codes_wire():
    """Everywhere else the LUT stays: a float patch behind zp = 0 takes
    codes, and they give the float32 wire's logits."""
    spec, ip = _float_patch_model(0.0)
    served = engine.IntModel(ip, spec, QuantConfig(), "cpu")
    pixels = np.random.default_rng(1).integers(0, 256, (2, 3, 224, 224),
                                               dtype=np.uint8)
    assert served.input_lut is not None
    normalized = imagenet.device_normalize(torch.tensor(pixels))
    np.testing.assert_array_equal(served(pixels).numpy(),
                                  served(normalized).numpy())


def test_clipped_codes_would_miss_the_float32_wire():
    """The fault the refusal guards against: with zp = -15 the LUT's codes
    clip q - zp at 127, and a float patch fed codes * scale departs from
    the float32 wire."""
    spec, ip = _float_patch_model(-15.0)
    served = engine.IntModel(ip, spec, QuantConfig(), "cpu")
    pixels = np.random.default_rng(1).integers(0, 256, (2, 3, 224, 224),
                                               dtype=np.uint8)
    site = ip["qact_input"]
    lut = imagenet.input_code_lut(site["scale"], site["zp"])
    codes = np.stack([lut[c][pixels[:, c]] for c in range(3)], 1)
    assert (codes == 127).mean() > 0.01  # the clip is reached
    from diffvit_tpu_torch.models import vit_int
    with torch.inference_mode():
        clipped = vit_int.forward_q_int(served.ip, spec, served.cfg,
                                        torch.tensor(codes)).numpy()
    assert np.mean(clipped == served(pixels).numpy()) < 0.995


def test_port_runs_without_jax(tmp_path):
    """The port in a process where jax, jaxlib, optax, scipy and
    matplotlib cannot be imported: the served forwards, calibration, the
    recovery passes and the analysis toolkit run, ``analysis.plotting``
    imports, and drawing raises ``ImportError``."""
    code = (
        "import sys\n"
        "class Absent:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'optax', "
        "'scipy', 'matplotlib'):\n"
        "            raise ImportError(f'{name} is absent here')\n"
        "sys.meta_path.insert(0, Absent())\n"
        "import numpy as np\n"
        "import diffvit_tpu_torch, diffvit_tpu_torch.engine as e\n"
        "import diffvit_tpu_torch.models.vit_int\n"
        "import diffvit_tpu_torch.models.swin_int\n"
        "import diffvit_tpu_torch.ops.kernels.swin_attention\n"
        "from diffvit_tpu_torch.models.swin import SwinSpec\n"
        "from diffvit_tpu_torch.models.vit import ViTSpec\n"
        "from diffvit_tpu_torch.testing import random_int_model, "
        "random_swin_int_model\n"
        "cfg = diffvit_tpu_torch.QuantConfig()\n"
        "spec = ViTSpec('t', embed_dim=64, depth=1, num_heads=2, "
        "num_classes=10)\n"
        "m = e.IntModel(random_int_model(spec), spec, cfg, 'cpu')\n"
        "out = m(np.zeros((1, 3, 224, 224), np.uint8))\n"
        "assert out.shape == (1, 10)\n"
        "spec = SwinSpec('s', embed_dim=32, depths=(2, 1), "
        "num_heads=(2, 4), img_size=56, num_classes=10)\n"
        "m = e.IntModel(random_swin_int_model(spec), spec, cfg, 'cpu')\n"
        "out = m(np.zeros((1, 3, 56, 56), np.uint8))\n"
        "assert out.shape == (1, 10)\n"
        "from diffvit_tpu_torch.ops.bit_types import BIT_TYPE_DICT\n"
        "fq = diffvit_tpu_torch.QuantConfig(smoothquant=False, "
        "bit_w=BIT_TYPE_DICT['int8'])\n"
        "spec = ViTSpec('t', embed_dim=64, depth=1, num_heads=2, "
        "num_classes=10)\n"
        "m = e.IntModel(random_int_model(spec, fq), spec, fq, 'cpu')\n"
        "out = m(np.zeros((1, 3, 224, 224), np.uint8))\n"
        "assert out.shape == (1, 10)\n"
        "import torch\n"
        "from diffvit_tpu_torch.models.vit import init_params\n"
        "q = e.QuantizedViT(spec, cfg, device='cpu', params=init_params("
        "spec, torch.Generator().manual_seed(0), 'cpu'))\n"
        "x = np.random.default_rng(0).standard_normal((1, 3, 224, 224))"
        ".astype(np.float32)\n"
        "q.calibrate(x)\n"
        "assert len(q.adaround(x, steps=2, max_rows=64)) == 6\n"
        "assert len(q.qat(x, steps=1)) == 1\n"
        "assert len(q.bias_correct(x)) == 6\n"
        "assert q.prepare_int()(x).shape == (1, 10)\n"
        "from diffvit_tpu_torch.analysis import cka_drivers, datagen, pgd\n"
        "from diffvit_tpu_torch.analysis import ddv\n"
        "g = datagen.generate_data(q.params, spec, batch_size=3, "
        "iters_per_epoch=1, epochs=1)\n"
        "q.calibrate(g)\n"
        "b = [(np.concatenate([x, x + 1, x - 1]), [1, 2, 3])]\n"
        "assert cka_drivers.compute_cka_internal(q, lambda: iter(b), "
        "cka_iter=1, result_name=sys.argv[1], log=len).shape == (8, 8)\n"
        "assert pgd.AttackPGD(q, num_steps=1, quant=False).gen_adv_inputs("
        "x, [1]).shape == x.shape\n"
        "assert len(ddv.compute_ddv(q, x, x + 0.05)) == 6\n"
        "from diffvit_tpu_torch.analysis import (ddv_hessian, hessian, "
        "modeldiff, plotting, restore)\n"
        "x2 = np.concatenate([x, x * 0.5])\n"
        "d = ddv_hessian.DDVHessian(q, q, (x2, None), x2 + 0.05, "
        "layer_indices=4, max_iter=1)\n"
        "names, traces = d.trace()\n"
        "assert len(names) == len(traces) == 3 and np.isfinite(traces)"
        ".all()\n"
        "e, _ = hessian.top_eigenvalues(q.params, spec, x2, [1, 2], "
        "max_iter=1, names=['head.weight'])\n"
        "assert len(e) == 1 and np.isfinite(e[0])\n"
        "fwd = lambda t: q(t, quant=False)\n"
        "assert modeldiff.gen_profiling_inputs_blackbox(fwd, fwd, x2, "
        "max_iterations=1).shape == x2.shape\n"
        "res = restore.run_restore_sweep(q, [(x, [1])], [(0,)], log=len)\n"
        "assert [r[0] for r in res] == [(), (0,)]\n"
        "try:\n"
        "    plotting.plot_ckalist_resume([np.eye(2)], sys.argv[1])\n"
        "except ImportError:\n"
        "    pass\n"
        "else:\n"
        "    raise AssertionError('drew without matplotlib')\n"
        "assert 'matplotlib' not in sys.modules, 'matplotlib was imported'\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert 'optax' not in sys.modules, 'optax was imported'\n"
        "assert 'scipy' not in sys.modules, 'scipy was imported'\n"
        "bad = [m for m in sys.modules\n"
        "       if m == 'diffvit_tpu' or m.startswith('diffvit_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code,
                          str(tmp_path / "cka")], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def _imported_modules(path):
    """Every absolute module name that ``path`` imports."""
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _module_level_imports(path):
    """Every absolute module name that ``path`` imports when it is
    imported (outside its functions)."""
    tree = ast.parse(open(path).read(), filename=path)
    todo = list(tree.body)
    while todo:
        node = todo.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        todo.extend(ast.iter_child_nodes(node))


def test_port_imports_nothing_of_jax_or_the_jax_package():
    """No jax, jaxlib, optax, scipy or diffvit_tpu anywhere in the package
    or in chip_smoke.py, and no matplotlib at import time (the card's
    machine does not have it)."""
    pkg = os.path.dirname(diffvit_tpu_torch.__file__)
    files = [os.path.join(d, f) for d, _, fs in os.walk(pkg)
             for f in fs if f.endswith(".py")]
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) > 20
    bad = [(os.path.relpath(f, REPO), m) for f in files
           for m in _imported_modules(f)
           if m.split(".")[0] in ("jax", "jaxlib", "optax", "scipy",
                                  "diffvit_tpu")]
    assert not bad, bad
    bad = [(os.path.relpath(f, REPO), m) for f in files
           for m in _module_level_imports(f)
           if m.split(".")[0] == "matplotlib"]
    assert not bad, bad
    plotting = os.path.join(pkg, "analysis", "plotting.py")
    assert "matplotlib" in set(m.split(".")[0]
                               for m in _imported_modules(plotting))


@pytest.mark.parametrize("kw", [
    {}, {"smoothquant": False}, {"ptf": False, "lis": False,
                                 "smoothquant": False},
    {"bit_w": "int8"}], ids=["default", "sq_off", "legacy", "int8"])
def test_quant_config_copy_matches_jax(kw):
    def make(cls, bits):
        return cls(**{k: bits[v] if k == "bit_w" else v
                      for k, v in kw.items()})
    jax_cfg = make(QuantConfig, jax_bit_types.BIT_TYPE_DICT)
    port_cfg = make(diffvit_tpu_torch.QuantConfig, bit_types.BIT_TYPE_DICT)
    assert port_cfg.to_dict() == jax_cfg.to_dict()
    assert port_cfg == jax_cfg and jax_cfg == port_cfg
    back = diffvit_tpu_torch.QuantConfig.from_dict(port_cfg.to_dict())
    assert back == port_cfg and back.bit_w is port_cfg.bit_w
    assert type(back.bit_w) is bit_types.BitType
    assert (back.bit_s.name, back.int_norm) == (jax_cfg.bit_s.name,
                                                 jax_cfg.int_norm)


def test_shared_module_copies_match_jax(tmp_path):
    assert [dataclasses.astuple(b) for b in bit_types.BIT_TYPE_LIST] == \
        [dataclasses.astuple(b) for b in jax_bit_types.BIT_TYPE_LIST]
    assert (imagenet.IMAGENET_MEAN, imagenet.IMAGENET_STD) == \
        (jax_imagenet.IMAGENET_MEAN, jax_imagenet.IMAGENET_STD)
    for scale, zp in ((2.0**-5, 0.0), (0.0173, 3.0)):
        np.testing.assert_array_equal(
            imagenet.input_code_lut(scale, zp),
            jax_imagenet.input_code_lut(scale, zp))
    rng = np.random.default_rng(0)
    out, target = rng.standard_normal((16, 10)), rng.integers(0, 10, 16)
    assert metrics.accuracy(out, target, (1, 5)) == \
        jax_metrics.accuracy(out, target, (1, 5))
    assert metrics.cross_entropy(out, target) == \
        jax_metrics.cross_entropy(out, target)
    # the artifact schema: each package reads the other's file, and the
    # manifests are the same bytes
    tree = {"a/b": [np.arange(3, dtype=np.int8), None, (1, 2.5, True)],
            "c": {"d": np.ones((2, 2), np.float32), "s": "x"}}
    for save, load in ((serialize.save_pytree, jax_serialize.load_pytree),
                       (jax_serialize.save_pytree, serialize.load_pytree)):
        path = str(tmp_path / f"{save.__module__}.npz")
        save(path, tree, meta={"k": 1})
        got, meta = load(path)
        assert meta == {"k": 1} and got["c"]["s"] == "x"
        assert got["a/b"][2] == (1, 2.5, True) and got["a/b"][1] is None
        np.testing.assert_array_equal(got["c"]["d"], tree["c"]["d"])
    manifests = [np.load(str(tmp_path / f"{m}.npz"))["__manifest__"]
                 for m in (serialize.__name__, jax_serialize.__name__)]
    np.testing.assert_array_equal(*manifests)
    with pytest.raises(serialize.ArtifactError):
        serialize.load_pytree(__file__)  # not an .npz artifact
