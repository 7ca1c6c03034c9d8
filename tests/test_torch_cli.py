"""The port's serving entry points against the JAX package's, on the CPU:
``IntModel(microbatch=)`` (bit-equal to the unchunked forward on both
routes, and held to JAX's ``IntModel(microbatch=)`` by the JAX suite's
rule between two integer paths, tests/test_pallas_attention.py::
_assert_paths_agree), and the CLI ``python3 -m diffvit_tpu_torch.cli``:
``--load-int`` of a TINY artifact saved by JAX, over a fake ImageFolder,
prints the report that JAX's ``engine.validate`` prints over JAX's
``DataLoader`` (the same loss, Prec@1 and Prec@5 lines, the times aside),
on each wire and route; ``--quant --mode 1 --int-path --save-int`` writes
an artifact JAX serves; every flag whose machinery is not ported exits
naming its ROADMAP item."""
import re

import jax
import numpy as np
import pytest
import torch

from diffvit_tpu.config import QuantConfig
from diffvit_tpu.data import imagenet as jimagenet
from diffvit_tpu.engine import QuantizedViT as JaxQuantizedViT
from diffvit_tpu.engine import load_int_model as jax_load_int_model
from diffvit_tpu.engine import validate as jax_validate
from diffvit_tpu.models import vit

from diffvit_tpu_torch import cli, engine
from diffvit_tpu_torch.data.synthetic import make_fake_imagefolder
from diffvit_tpu_torch.models.registry import preprocessing_for
from diffvit_tpu_torch.models.vit import VIT_SPECS, ViTSpec

TINY_KW = dict(embed_dim=64, depth=2, num_heads=2, num_classes=10)
TINY = vit.ViTSpec("test_tiny", **TINY_KW)
TINY_T = ViTSpec("test_tiny", **TINY_KW)


def _assert_paths_agree(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert np.mean(got == ref) > 0.995, np.mean(got == ref)
    np.testing.assert_allclose(got, ref, atol=0.05)
    np.testing.assert_array_equal(got.argmax(1), ref.argmax(1))


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """A TINY int-model calibrated and saved by JAX, and a fake ImageFolder
    (3 classes of 2 images) under ``<root>/val``."""
    root = tmp_path_factory.mktemp("cli")
    params = vit.init_params(TINY, jax.random.PRNGKey(0))
    m = JaxQuantizedViT(TINY, QuantConfig(), params=params)
    m.calibrate(np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                             (2, 3, 224, 224))))
    path = str(root / "tiny.npz")
    m.save_int_model(path)
    make_fake_imagefolder(str(root / "val"), num_classes=3, per_class=2,
                          size=(80, 60), seed=3)
    return path, root


@pytest.mark.parametrize("resident", [False, True], ids=["K1+K2", "K6"])
def test_microbatch_is_bit_equal_and_agrees_with_jax(artifact, resident):
    """b = 7 in chunks of 3 (the last zero-padded): the unchunked logits,
    bit for bit; JAX's IntModel(microbatch=3) by _assert_paths_agree."""
    path, _ = artifact
    x = np.random.default_rng(0).integers(0, 256, (7, 3, 224, 224),
                                          dtype=np.uint8)
    whole = engine.load_int_model(path, "cpu", resident=resident)
    chunked = engine.load_int_model(path, "cpu", resident=resident,
                                    microbatch=3)
    got = chunked(x).numpy()
    assert got.shape == (7, 10)
    np.testing.assert_array_equal(got, whole(x).numpy())
    want = jax_load_int_model(path, resident=resident, microbatch=3)(x)
    _assert_paths_agree(got, np.asarray(want))
    with pytest.raises(ValueError, match="microbatch"):
        engine.load_int_model(path, "cpu", microbatch=0)


def _report(lines):
    """The report lines with their times taken out."""
    return [re.sub(r"Time \S+( \(\S+\))?", "Time", ln) for ln in lines
            if "Prec@1" in ln]


@pytest.fixture(scope="module")
def jax_report(artifact):
    path, root = artifact
    pp = preprocessing_for("deit_tiny")
    ds = jimagenet.ImageFolder(str(root / "val"), jimagenet.build_transform(
        mean=pp.mean, std=pp.std, crop_pct=pp.crop_pct))
    lines = []
    res = jax_validate(jax_load_int_model(path),
                       jimagenet.DataLoader(ds, 4, num_workers=2),
                       print_freq=1, log=lines.append)
    return res, _report(lines)


@pytest.mark.parametrize("flags", [
    ["--wire", "f32"], ["--wire", "u8"], ["--wire", "u8", "--resident"],
    ["--wire", "f32", "--device-prefetch", "0"]],
    ids=["f32", "u8-codes", "u8-codes-resident", "f32-no-prefetch"])
def test_cli_load_int_prints_jax_report(artifact, jax_report, capsys,
                                        flags):
    """The port CLI serving JAX's artifact prints JAX's report: the same
    loss, Prec@1 and Prec@5 on every batch line and the summary."""
    path, root = artifact
    res = cli.main(["deit_tiny", str(root), "--load-int", path, "--device",
                    "cpu", "--val-batchsize", "4", "--num-workers", "2",
                    "--print-freq", "1", *flags])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "Model: deit_tiny"
    assert out[1].startswith(f"Serving int artifact: {path} (test_tiny)")
    assert out[2] == "None"  # no --quant: the reference prints bit_config
    want_res, want_lines = jax_report
    assert _report(out) == want_lines and len(want_lines) == 3
    assert res == pytest.approx(want_res, abs=5e-5)


def test_cli_calibrates_bakes_and_saves(artifact, tmp_path, capsys,
                                        monkeypatch):
    """--quant --mode 1 --int-path --save-int on a registered TINY DeiT:
    Gaussian calibration, validation through the baked integer model on
    the codes wire, and an artifact that JAX's engine serves with the
    port's logits (_assert_paths_agree)."""
    _, root = artifact
    monkeypatch.setitem(VIT_SPECS, "deit_test", TINY_T)
    out_path = str(tmp_path / "baked.npz")
    loss, top1, top5 = cli.main([
        "deit_test", str(root), "--quant", "--mode", "1", "--int-path",
        "--calib-batchsize", "2", "--save-int", out_path, "--device", "cpu",
        "--val-batchsize", "6", "--num-workers", "2", "--wire", "u8"])
    out = capsys.readouterr().out.splitlines()
    assert out[:4] == ["Model: deit_test", "Calibrating with Gaussian noise...",
                       f"Saved int artifact: {out_path}",
                       str([4] * vit.num_bit_slots(TINY))]
    assert out[-1].startswith(" * Prec@1") and np.isfinite(loss)
    x = np.random.default_rng(1).integers(0, 256, (2, 3, 224, 224),
                                          dtype=np.uint8)
    _assert_paths_agree(engine.load_int_model(out_path, "cpu")(x).numpy(),
                        np.asarray(jax_load_int_model(out_path)(x)))


def _given(dest):
    """The flag of ``dest`` on a command line, at its default value (or
    its first choice; 1 where the default is None)."""
    a = next(a for a in cli.build_parser()._actions if a.dest == dest)
    if a.nargs == 0:
        return [a.option_strings[0]]
    value = a.choices[0] if a.choices else a.default
    return [a.option_strings[0], str(1 if value is None else value)]


REFUSED = [(_given(d), item) for d, item in cli.NOT_PORTED.items()] + [
    (["--mode", "2"], 8)]


@pytest.mark.parametrize("flags,item", REFUSED,
                         ids=[f[0][0] for f in REFUSED[:-1]] + ["--mode-2"])
def test_unported_flags_exit_naming_their_roadmap_item(flags, item):
    """Given on the command line (even at its default value), each flag
    whose machinery is not ported exits before any work, naming its item."""
    with pytest.raises(SystemExit, match=rf"ROADMAP Queue 1, item {item}:"):
        cli.main(["deit_tiny", "/nonexistent", "--quant", *flags])


def test_swin_and_flag_combinations_are_refused():
    with pytest.raises(SystemExit, match="Queue 1, item 4"):
        cli.main(["swin_tiny", "/nonexistent", "--quant", "--device", "cpu"])
    with pytest.raises(SystemExit, match="requires --quant"):
        cli.main(["deit_tiny", "/x", "--save-int", "a.npz"])
    with pytest.raises(SystemExit, match="mutually exclusive"):
        cli.main(["deit_tiny", "/x", "--quant", "--save-int", "a.npz",
                  "--load-int", "b.npz"])
    with pytest.raises(SystemExit):  # argparse: cuda or cpu only
        cli.main(["deit_tiny", "/x", "--device", "tpu"])
    args = cli.parse_args(["deit_small", "/d", "--quant"])
    assert (args.model, args.data, args.tp, args.qat_lr) == \
        ("deit_small", "/d", 1, 1e-5)
    assert torch.device(args.device).type == "cuda"
