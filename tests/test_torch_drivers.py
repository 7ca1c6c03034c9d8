"""The port's analysis drivers (``diffvit_tpu_torch/drivers``) on the CPU,
each on a registered TINY DeiT (64 wide, 2 blocks) with ``--device cpu``
over a fake ImageFolder with ``train/`` and ``val/``.  The restore sweep
runs beside the JAX package's root driver on the same checkpoint (a
``.pth`` state dict both packages load): the lines of
``restore_1_layers.txt`` are equal apart from ``Time``."""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import layerwise_quant_compare as jax_restore_driver
from diffvit_tpu.models import vit as jvit

from diffvit_tpu_torch.data.synthetic import make_fake_imagefolder
from diffvit_tpu_torch.drivers import (ddv_cka_calc, ddv_hessian_calc,
                                       layerwise_quant_compare, modeldiff_p2)
from diffvit_tpu_torch.models import vit

from test_torch_calibrate import one_torch_thread  # noqa: F401

TINY_KW = dict(embed_dim=64, depth=2, num_heads=2, num_classes=10)
NAME = "deit_test"


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A fake ImageFolder (train/: 8 images, val/: 8) and a DeiT state
    dict of the TINY spec (weights 0.02 N(0, 1), norms near 1)."""
    root = tmp_path_factory.mktemp("drivers")
    for split, seed in (("train", 0), ("val", 1)):
        make_fake_imagefolder(str(root / split), num_classes=4, per_class=2,
                              seed=seed)
    g = torch.Generator().manual_seed(3)
    spec = vit.ViTSpec(NAME, **TINY_KW)
    c, hid, ps = spec.embed_dim, spec.hidden_dim, spec.patch_size
    shapes = {"cls_token": (1, 1, c), "pos_embed": (1, spec.seq_len, c),
              "patch_embed.proj.weight": (c, 3, ps, ps),
              "patch_embed.proj.bias": (c,), "norm.weight": (c,),
              "norm.bias": (c,), "head.weight": (10, c), "head.bias": (10,)}
    for i in range(spec.depth):
        for n, s in (("norm1", (c,)), ("norm2", (c,)),
                     ("attn.qkv", (3 * c, c)), ("attn.proj", (c, c)),
                     ("mlp.fc1", (hid, c)), ("mlp.fc2", (c, hid))):
            shapes[f"blocks.{i}.{n}.weight"] = s
            shapes[f"blocks.{i}.{n}.bias"] = s[:1]
    sd = {k: (1.0 if "norm" in k and k.endswith("weight") else 0.0)
          + 0.02 * torch.randn(*s, generator=g) for k, s in shapes.items()}
    ckpt = root / "tiny.pth"
    torch.save({"model": sd}, ckpt)
    return root, str(ckpt)


@pytest.fixture
def tiny_registered(monkeypatch):
    monkeypatch.setitem(vit.VIT_SPECS, NAME, vit.ViTSpec(NAME, **TINY_KW))
    monkeypatch.setitem(jvit.VIT_SPECS, NAME, jvit.ViTSpec(NAME, **TINY_KW))


def _lines(path):
    return [ln.rsplit(" Time ", 1)[0] for ln in open(path)]


def test_restore_driver_matches_jax_driver(data, tiny_registered,
                                           tmp_path, monkeypatch, capsys):
    root, ckpt = data
    argv = [NAME, str(root), "--mode", "1", "--calib-batchsize", "4",
            "--val-batchsize", "4", "--num-workers", "2", "--k", "1",
            "--limit", "2", "--checkpoint", ckpt]
    files = {}
    for name, main, extra in (
            ("jax", jax_restore_driver.main, []),
            ("port", layerwise_quant_compare.main, ["--device", "cpu"])):
        os.makedirs(tmp_path / name)
        monkeypatch.chdir(tmp_path / name)
        main(argv + extra)
        files[name] = _lines(tmp_path / name / "restore_1_layers.txt")
    out = capsys.readouterr().out
    assert files["port"] == files["jax"] and len(files["jax"]) == 3
    assert files["port"][1].startswith("Restore Index: [0], Prec@1 ")
    assert out.count("Restore Index: [1], ") == 2
    explicit = layerwise_quant_compare.main(
        argv + ["--device", "cpu", "--combinations", "[(0, 5), 3]"])
    assert [r[0] for r in explicit] == [(), (0, 5), (3,)]


def test_ddv_hessian_driver(data, tiny_registered, capsys):
    """One batch of 2, the tap blocks.1.mlp (index 10, 7 weights), two
    probes a trace: the names and the normalized trace in [0, 1]."""
    root, ckpt = data
    names, mean = ddv_hessian_calc.main([
        NAME, str(root), "--calib-batchsize", "2", "--batch-num", "1",
        "--layer-index", "10", "--max-iter", "2", "--num-workers", "2",
        "--checkpoint", ckpt, "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == ("Calculating the sensitivities via the averaged "
                      "Hessian trace...")
    assert out[1] == "batch 0: done" and out[2] == str(names)
    assert len(names) == 7 and names[-1] == "blocks.1.mlp.fc1.weight"
    assert out[-1].startswith("***Trace:  [")
    assert min(mean) == 0 and max(mean) == 1 and len(mean) == 7


def test_modeldiff_driver(data, tiny_registered, capsys):
    root, ckpt = data
    sims = modeldiff_p2.main([
        NAME, str(root), "--mode", "1", "--calib-batchsize", "2",
        "--seed-batch", "2", "--pgd-steps", "2", "--checkpoint", ckpt,
        "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert len(sims) == len(out) == 4 * 2 + 2
    assert out[0].startswith("patch_embed.proj layer similarity: ")
    assert all(np.isfinite(v) for v in sims.values())


def test_ddv_cka_driver(data, tiny_registered, tmp_path, capsys):
    """One pass of one batch of 2, one PGD step: the heatmap pickled, its
    sub-maps and PNGs drawn, the diagonal printed."""
    root, ckpt = data
    base = tmp_path / "cka"
    diag = ddv_cka_calc.main([
        NAME, str(root), "--cka-batch", "2", "--cka-iter", "1",
        "--cka-batch-iter", "0", "--pgd-steps", "1", "--num-workers", "2",
        "--base-dir", str(base), "--result-name", "r",
        "--checkpoint", ckpt, "--device", "cpu"])
    with open(base / "r" / "r_heatmap.pkl", "rb") as f:
        heat = pickle.load(f)
    assert heat.shape == (10, 10)
    np.testing.assert_array_equal(diag, np.diagonal(heat))
    assert {"cka_qkv.pkl", "cka_qkv.png", "full.png",
            "r_heatmap_diagonal.png"} <= set(os.listdir(base / "r"))
    assert capsys.readouterr().out.splitlines()[-1].startswith(
        "diagonal_values: [")


def test_drivers_run_as_modules():
    """``python3 -m diffvit_tpu_torch.drivers.<name> --help``."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name in ("layerwise_quant_compare", "ddv_hessian_calc",
                 "modeldiff_p2", "ddv_cka_calc"):
        res = subprocess.run(
            [sys.executable, "-m", f"diffvit_tpu_torch.drivers.{name}",
             "--help"], cwd=repo, capture_output=True, text=True,
            timeout=120, env=dict(os.environ, PYTHONPATH=repo))
        assert res.returncode == 0, res.stderr
        assert "--device {cuda,cpu}" in res.stdout
